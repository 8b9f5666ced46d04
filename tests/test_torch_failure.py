"""The port's failure detection and elastic recovery
(aesfhe_tpu_torch.parallel.failure), mirroring tests/test_failure.py:
heartbeat staleness, the watchdog firing on a wedged step, run_elastic's
retries, and an elastic restart that resumes from the bit-sliced
pipeline's per-round checkpoints after an injected crash, with port keys
generated in-process."""
import time

import numpy as np
import pytest
import torch

from aesfhe_tpu_torch.parallel.failure import (WATCHDOG_EXIT_CODE, Heartbeat,
                                               Watchdog, run_elastic)


def test_heartbeat_staleness(tmp_path):
    hb0 = Heartbeat(tmp_path, 0, interval_s=0.05).start()
    hb1 = Heartbeat(tmp_path, 1, interval_s=0.05).start()
    try:
        time.sleep(0.2)
        assert hb0.stale(max_age_s=1.0, expect=[0, 1]) == []
        # stop proc 1's beater: it must go stale while proc 0 stays live
        hb1.stop()
        time.sleep(0.5)
        assert hb0.stale(max_age_s=0.3, expect=[0, 1]) == [1]
        # a never-started peer is reported missing
        assert 2 in hb0.stale(max_age_s=0.3, expect=[0, 1, 2])
    finally:
        hb0.stop()
        hb1.stop()


def test_watchdog_fires_on_wedged_step():
    fired = []
    wd = Watchdog(0.1, on_timeout=fired.append)
    with wd.step("hung-collective"):
        time.sleep(0.4)                  # injected wedge
    assert fired == ["hung-collective"]
    assert wd.fired == "hung-collective"
    fired2 = []
    wd2 = Watchdog(5.0, on_timeout=fired2.append)
    with wd2.step("ok"):
        pass
    assert fired2 == []
    assert WATCHDOG_EXIT_CODE == 87


def test_run_elastic_retries_then_succeeds():
    calls = []

    def step(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("injected fault")
        return "done"

    assert run_elastic(step, max_restarts=3) == "done"
    assert calls == [0, 1, 2]
    with pytest.raises(RuntimeError, match="failed after 2 attempts"):
        run_elastic(lambda a: (_ for _ in ()).throw(ValueError("x")),
                    max_restarts=1)


@pytest.fixture
def _one_torch_thread():
    """The small ring's ops are dispatch-bound: one thread runs them as
    fast and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
def test_elastic_resume_from_round_checkpoint(tmp_path, _one_torch_thread):
    """Injected crash after round 1 + elastic restart: the second attempt
    resumes from the checkpoint (round 2 onward) instead of recomputing
    round 1, and the final state equals an uninterrupted 2-round run
    (`slow`: four bit-sliced rounds, ~8 s on the CPU)."""
    rounds = 2
    from aesfhe_tpu_torch.core.params import CKKSParams
    from aesfhe_tpu_torch.ops.xor_service import EngineWrapper, XORConfig
    from aesfhe_tpu_torch.pipeline import AESFHE128Bitsliced

    # two bit-sliced rounds need 2 * 14 + 1 levels; a small ring keeps the
    # four round evaluations of this test to seconds on the CPU
    params = CKKSParams(n=1 << 8, max_level=30, scale_bits=28,
                        num_special_primes=4)
    wrap = EngineWrapper(XORConfig(params=params, rotation_steps=(),
                                   device="cpu"),
                         rng=np.random.default_rng(0))
    key = bytes(range(16))
    state = np.random.default_rng(0).integers(0, 256, params.slot_count,
                                              dtype=np.uint8)
    rounds_run = []

    class _Crashing(AESFHE128Bitsliced):
        def _save_checkpoint(self, d, r, st):
            super()._save_checkpoint(d, r, st)
            rounds_run.append(r)
            if r == 1 and rounds_run.count(1) == 1:
                raise RuntimeError("injected crash after round 1")

    aes = _Crashing(wrap, key)
    st0 = aes.encrypt_state(state)
    ckpt = tmp_path / "ckpt"
    out = run_elastic(
        lambda attempt: aes.encrypt_rounds(st0, rounds=rounds,
                                           checkpoint_dir=str(ckpt)),
        max_restarts=1)
    assert rounds_run == list(range(1, rounds + 1))
    want = AESFHE128Bitsliced(wrap, key).encrypt_rounds(st0, rounds=rounds)
    for a, b in zip(out.bits, want.bits):
        assert torch.equal(a.data, b.data) and a.scale == b.scale
