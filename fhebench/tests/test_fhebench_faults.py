"""A run whose timed path is broken underneath comes out not correct: the
whole run is driven (keys, batches, warm-up, window, the check) on the CPU
at a small cell, past the harness's look for a card, with the program's
request broken in each way this benchmark's cells can break: a step that
returns its state unchanged, half the batch left out, an answer altered
where it is produced, an answer that never comes.  (A cell of one chip has no exchange to leave out.)
A sound run of the same cell comes out correct.  Each run is a process of
its own in a temporary checkout, as the benchmark's runs are."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fhebench.tests.conftest import SMALL_CELL


def unchanged(orig):
    def fault(self, st):
        return st
    return fault


def half_left_out(orig):
    def fault(self, st):
        got = self.decrypt(orig(self, st))
        came = self.decrypt(st)
        n = (got.size // 32) * 16          # the second half of the blocks
        got[n:] = came[n:]
        return self.encrypt(got)
    return fault


def altered(orig):
    def fault(self, st):
        got = self.decrypt(orig(self, st))
        got[21] ^= np.uint8(0x04)
        return self.encrypt(got)
    return fault


def lost(orig):
    def fault(self, st):
        orig(self, st)
        return None
    return fault


FAULTS = {"sound": None, "unchanged": unchanged,
          "half_left_out": half_left_out, "altered": altered, "lost": lost}
DRIVE = ("import json, sys\n"
         "from fhebench import cell, run\n"
         "from fhebench.tests.test_fhebench_faults import FAULTS\n"
         f"c = cell.load({SMALL_CELL!r}, run.ROOT)\n"
         "fault = FAULTS[sys.argv[1]]\n"
         "if fault is not None:\n"
         "    c.pipeline.System.run = fault(c.pipeline.System.run)\n"
         "print(json.dumps(run.run_cell(c, 2 ** 31 + 7, 0.1, False, "
         "device='cpu')))\n")


@pytest.mark.parametrize("name", list(FAULTS))
def test_faults_come_out_not_correct(small_checkout, name):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", DRIVE, name],
                         cwd=small_checkout, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["attempted"] >= 1
    checks = {k: v["value"] for k, v in res["checks"].items()}
    if name == "sound":
        assert res["correct"] and res["failed"] == 0
        assert checks == {"wrong_bytes": 0, "unchecked_answers": 0}
    else:
        assert not res["correct"] and res["failed"] >= 1
        missing = "unchecked_answers" if name == "lost" else "wrong_bytes"
        assert checks[missing] >= 1
