"""A configuration, a mix and a metric added as new files and entries run
without an edit to any file the harness has; and the harness refuses to
run without a card or without the program."""
import filecmp
import json
import os
import subprocess
import sys

import pytest

from fhebench.run import ROOT
from fhebench.tests.conftest import SMALL_CELL, make_checkout

RUN_SMALL = ("import json, sys\n"
             "from fhebench import cell, run\n"
             f"c = cell.load({SMALL_CELL!r}, run.ROOT)\n"
             "print(json.dumps(run.run_cell(c, 2 ** 31 + 99, 0.1, False, "
             "device='cpu')))\n")


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_new_files_run_without_edits(small_checkout):
    harness = small_checkout / "fhebench"
    # no file that the harness had was changed
    for path in (ROOT / "fhebench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts and \
                ".cache" not in path.parts:
            assert filecmp.cmp(path, harness / path.relative_to(
                ROOT / "fhebench"), shallow=False), path
    out = subprocess.run([sys.executable, "-c", RUN_SMALL],
                         cwd=small_checkout, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"block_rounds_per_s", "setup_s",
                                   "requests_per_s"}
    assert res["metrics"]["requests_per_s"]["unit"] == "req/s"
    assert list(res)[-1] == "checks"


def test_no_card_no_result(small_checkout):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m", "fhebench.run", "--workload",
                          SMALL_CELL, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=small_checkout, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    bare = make_checkout(tmp_path, with_program=False)
    bench = json.loads((bare / "BENCHMARK.json").read_text())
    out = subprocess.run([sys.executable, "-m", "fhebench.run", "--workload",
                          bench["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=bare,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
