"""Multi-process runner: every process runs this same module; the global
mesh spans all of them.  Counterpart of `scripts/run_multihost.py`.

    torchrun --nproc-per-node 2 -m aesfhe_tpu_torch.run_multihost
    torchrun --nnodes 2 --node-rank R --master-addr H0 --master-port 29511 \\
        --nproc-per-node 8 -m aesfhe_tpu_torch.run_multihost
    ... --device cpu          (host tensors over gloo)

(or set MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK per process by hand).
Runs the sharded 4-step NTT (parallel.dist_ntt) across the processes and
holds it bit for bit to the single-process transform; prints the summary
as one JSON line from rank 0 and MULTIHOST OK from every rank.  A rank
drives its own card over NCCL, or several ranks share one card over gloo.
With AESFHE_HEARTBEAT_DIR set, each rank beats a heartbeat file and rank 0
reports stale peers; the check runs under a watchdog
(AESFHE_STEP_TIMEOUT_S, default 600 s) that aborts a wedged rank with exit
code 87 (parallel/failure.py).
"""
from __future__ import annotations

import argparse
import json
import os

import torch.distributed as dist

from .parallel import multihost
from .parallel.failure import Heartbeat, Watchdog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="aesfhe_tpu_torch.run_multihost")
    ap.add_argument("--profile", default="tiny")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = multihost.init_multihost(device=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    print(f"proc {rank}/{world} on {dev} ({dist.get_backend()})", flush=True)
    hb_dir = os.environ.get("AESFHE_HEARTBEAT_DIR")
    hb = Heartbeat(hb_dir, rank).start() if hb_dir else None
    wd = Watchdog(float(os.environ.get("AESFHE_STEP_TIMEOUT_S", "600")))
    try:
        with wd.step("multihost_ntt_check"):
            summary = multihost.multihost_ntt_check(profile=args.profile,
                                                    device=dev)
        if hb is not None:
            summary["stale_processes"] = hb.stale(max_age_s=30.0,
                                                  expect=range(world))
        if rank == 0:
            print(json.dumps(summary), flush=True)
        print("MULTIHOST OK", flush=True)
    finally:
        if hb is not None:
            hb.stop()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
