"""Two processes through `python -m aesfhe_tpu_torch.run_multihost` on the
CPU (gloo, torchrun's environment variables set by hand): the distributed
4-step NTT across the process boundary, bit-exact to the one-process
transform, with heartbeat files and the watchdog armed (mirrors
tests/test_multihost.py)."""
import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_ntt(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2",
               AESFHE_HEARTBEAT_DIR=str(tmp_path / "hb"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "aesfhe_tpu_torch.run_multihost",
         "--device", "cpu"], env=dict(env, RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("multihost run timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out}"
        assert "MULTIHOST OK" in out, out
    summary = json.loads(next(line for line in outs[0].splitlines()
                              if line.startswith("{")))
    assert summary["processes"] == 2 and summary["backend"] == "gloo"
    assert summary["fwd_exact"] and summary["roundtrip_exact"]
    assert summary["stale_processes"] == []
