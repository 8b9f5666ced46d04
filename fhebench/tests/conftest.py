"""A temporary checkout of the benchmark: `BENCHMARK.json` and `fhebench/`
copied, the program linked, and a small configuration, mix and metric that
the CPU can run added as new files and entries only."""
import json
import os
import shutil

import pytest

from fhebench.run import ROOT

SMALL_CONFIG = {
    "name": "bitsliced-deep",
    "source": "the port's deep profile: N=2^12, 48 levels, no bootstrap",
    "profile": "deep",
    "params": {"n": 4096, "max_level": 48, "scale_bits": 28,
               "num_special_primes": 6, "alpha": 6, "dnum": 9,
               "secret_hamming": None, "error_std": 3.2},
    "pipeline": "bitsliced",
    "refresh": {"bootstrap": "none"},
    "blocks_per_batch": 128,
    "aes_key": "000102030405060708090a0b0c0d0e0f",
    "fips_block0": True,
    "guarantee": "every block equals AES-128 (FIPS-197) exactly",
    "assumed": [],
    "reduced": [],
}
SMALL_MIX = {"loop": "closed", "clients": 1, "direction": "encrypt",
             "rounds_per_cipher": 1, "batches": 2, "refresh": False}
NEW_METRIC = '''"""Requests over the window."""


def read(run):
    return run.requests / run.seconds if run.seconds > 0 else None
'''
SMALL_CELL = "bitsliced-deep.one"


def make_checkout(dest, with_program=True):
    shutil.copytree(ROOT / "fhebench", dest / "fhebench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if with_program:
        os.symlink(ROOT / "aesfhe_tpu_torch", dest / "aesfhe_tpu_torch")
    return dest


def add_small_cell(dest):
    """The new configuration, mix and metric, as files and entries."""
    h = dest / "fhebench"
    (h / "configs" / "bitsliced-deep.json").write_text(
        json.dumps(SMALL_CONFIG))
    (h / "traffic" / "one.json").write_text(json.dumps(SMALL_MIX))
    (h / "metrics" / "requests_per_s.py").write_text(NEW_METRIC)
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bitsliced-deep",
                             "source": SMALL_CONFIG["source"],
                             "file": "fhebench/configs/bitsliced-deep.json",
                             "reduced": [], "why": "a CPU-sized config"})
    bench["workloads"].append({"name": SMALL_CELL,
                               "config": "bitsliced-deep", "traffic": "one",
                               "chips": 1, "why": "a CPU-sized cell"})
    bench["end_to_end"].append({"name": "requests_per_s", "unit": "req/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": [SMALL_CELL]})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture
def small_checkout(tmp_path):
    return add_small_cell(make_checkout(tmp_path))
