"""The benchmark of `aesfhe_tpu_torch` on an NVIDIA H100: a harness driven
by `BENCHMARK.json` (`python3 -m fhebench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`).  See `run.py`."""
