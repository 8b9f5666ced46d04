"""The bit-sliced inverse cipher of the port (`AESFHE128Bitsliced.
decrypt_round`, `run_full_aes.run_inverse_round`) on the CPU: the
equivalent inverse cipher's round keys against FIPS-197 Appendix C.1's
listing, and the rounds on prod_boot's primes at N=2^10 (prod_boot's chain
on the small ring, as tests/test_torch_zeta.py builds it), each decoded
exactly against the same round in the clear and checked for its levels.
A real bootstrap on these primes at N=2^10 raises in EvalMod
(tests/test_torch_fused_boot.py), so a recrypt stands in for it: decrypt,
encrypt afresh and drop to the fused bootstrap's exit level 19.  The stage
counters are timed under the profiler and left alone without it.  The
whole cipher round by round, and noise_trace's stage trace of it, are
`slow`.  Imports no JAX."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aesfhe_tpu_torch import noise_trace, run_full_aes, trace
from aesfhe_tpu_torch.aes_tables import AES_SBOX, aes128_partial, shift_rows
from aesfhe_tpu_torch.core import rns
from aesfhe_tpu_torch.core.params import CKKSParams, get_params
from aesfhe_tpu_torch.keyexp import (equivalent_inverse_keys,
                                     expand_key_128, inv_mix_columns)
from aesfhe_tpu_torch.ops.bitplane import BitState
from aesfhe_tpu_torch.ops.xor_service import EngineWrapper, XORConfig
from aesfhe_tpu_torch.pipeline import AESFHE128Bitsliced

KEY = bytes(range(16))
PROD_SMALL = dict(n=1 << 10, max_level=54, scale_bits=27,
                  num_special_primes=8, secret_hamming=192)
BOOT_EXIT = 19
WORK = AESFHE128Bitsliced.ROUND_DEPTH + 1
# FIPS-197 C.1, EQUIVALENT INVERSE CIPHER: round[k].ik_sch = dw[10 - k]
IK_SCH = {0: "13111d7fe3944a17f307a78b4d2b30c5",
          1: "13aa29be9c8faff6f770f58000f7bf03",
          2: "1362a4638f2586486bff5a76f7874a83",
          3: "8d82fc749c47222be4dadc3e9c7810f5",
          4: "72e3098d11c5de5f789dfe1578a2cccb",
          9: "8c56dff0825dd3f9805ad3fc8659d7fd",
          10: "000102030405060708090a0b0c0d0e0f"}
# round[k].is_row -> round[k].im_col
IM_COL = {"bd6e7c3df2b5779e0b61216e8b10b689":
          "4773b91ff72f354361cb018ea1e6cf2c",
          "fde3bad205e5d0d73547964ef1fe37f1":
          "2d7e86a339d9393ee6570a1101904e16",
          "d1876c0f79c4300ab45594add66ff41f":
          "39daee38f4f1a82aaf432410c36d45b9"}


def test_equivalent_inverse_keys_fips197_c1():
    dw = equivalent_inverse_keys(expand_key_128(KEY))
    for k, h in IK_SCH.items():
        assert dw[10 - k].tobytes().hex() == h
    for row, col in IM_COL.items():
        got = inv_mix_columns(np.frombuffer(bytes.fromhex(row), np.uint8))
        assert got.tobytes().hex() == col


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prod_small(tmp_path_factory):
    """The pipeline on prod_boot's primes at N=2^10 (its primes are 1 mod
    2^17, hence NTT-friendly on the small ring too), the recrypt as its
    refresh, and a state of random blocks."""
    with pytest.MonkeyPatch.context() as mp:
        find = rns.find_ntt_primes
        mp.setattr(rns, "find_ntt_primes",
                   lambda bits, two_n, count, skip=(): find(bits, 1 << 17,
                                                            count, skip))
        params = CKKSParams(**PROD_SMALL)
    assert params.all_primes == get_params("prod_boot").all_primes
    wrap = EngineWrapper(XORConfig(params=params, rotation_steps=(),
                                   device="cpu"),
                         rng=np.random.default_rng(19))
    eng = wrap.engine
    calls = []

    def recrypt(ct):
        calls.append(ct.level)
        return eng._drop(wrap.encrypt(wrap.decrypt(ct), device=True),
                         BOOT_EXIT)

    aes = AESFHE128Bitsliced(wrap, KEY, refresh=recrypt)
    state = run_full_aes.make_state(eng.slot_count, 7)
    return SimpleNamespace(aes=aes, eng=eng, state=state, calls=calls)


def _leaving(env, i: int) -> np.ndarray:
    """The clear state inverse round i of 10 leaves: SubBytes and
    ShiftRows of AES round 9 - i (InvMixColumns undid its MixColumns and
    AddRoundKey(dw) its key); the plaintexts after round 10."""
    s = env.state
    if i == 10:
        return s
    return np.concatenate([
        shift_rows(AES_SBOX[aes128_partial(s[b:b + 16], KEY, 9 - i)])
        for b in range(0, len(s), 16)])


def _ciphertexts(env) -> np.ndarray:
    s = env.state
    return np.concatenate([aes128_partial(s[b:b + 16], KEY, 10)
                           for b in range(0, len(s), 16)])


def _encrypted(env, clear, level):
    st = env.aes.encrypt_state(clear)
    return BitState([env.eng._drop(b, level) for b in st.bits])


# key-switches of each kind of round: InvSubBytes 30, InvShiftRows 48,
# InvMixColumns' hoisted rotations 48 and products 110, the cleanse 16; a
# refresh adds 4 conjugations and its cleanse's 16
KEYSWITCHES = {1: 252, 2: 272, 10: 98}


@pytest.mark.parametrize("i", sorted(KEYSWITCHES))
def test_inverse_round_exact_from_the_work_level(prod_small, i):
    """Round 1 from the AES ciphertexts at the work level, rounds 2 and 10
    from the state the round before leaves (as the refresh takes it): each
    decodes exactly; round 1 runs out no level it lacks and the others
    exit with levels to spare; a round after the first refreshes once
    (four pair-packed calls)."""
    env = prod_small
    eng = env.eng
    clear = _ciphertexts(env) if i == 1 else _leaving(env, i - 1)
    st = _encrypted(env, clear, WORK)
    eng.reset_counters()
    env.calls.clear()
    out = run_full_aes.run_inverse_round(env.aes, st, i, 10)
    assert np.array_equal(env.aes.decrypt_state(out), _leaving(env, i))
    assert eng.counters["keyswitch"] == KEYSWITCHES[i]
    assert len(env.calls) == (0 if i == 1 else 4)
    assert out.level >= (0 if i == 1 else 1)
    if i == 10:
        assert out.level == WORK - 5     # InvSubBytes, InvShiftRows + ARK


def test_partial_inverse_round(prod_small):
    """decrypt_rounds(., 1), the inverse of a one-round cipher: the
    MixColumns of round 1 undone first (dw[1] folded, a cleanse), then
    InvSubBytes and InvShiftRows with w[0] folded, from the work level."""
    env = prod_small
    s = env.state
    one = np.concatenate([aes128_partial(s[b:b + 16], KEY, 1)
                          for b in range(0, len(s), 16)])
    out = env.aes.decrypt_rounds(_encrypted(env, one, WORK), rounds=1)
    assert np.array_equal(env.aes.decrypt_state(out), s)
    assert out.level >= 1


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("profiled", [True, False])
def test_stage_counters(prod_small, profiled):
    """Under the profiler the inverse round's stages add their host-clock
    nanoseconds to `aes.sub_bytes_ns` and `aes.shift_mix_ns`; without it
    the counters stay.  (The profiler's event tree of a round takes ~20 s
    to build here: tests/test_torch_trace.py holds the spans' nesting on
    the forward round, whose stages open through the same trace.stage.)"""
    env = prod_small
    eng = env.eng
    keys = ["aes.sub_bytes_ns", "aes.shift_mix_ns"]
    st = _encrypted(env, _leaving(env, 9), WORK)
    before = {k: eng.counters[k] for k in keys}
    env.aes.refresh, refresh = None, env.aes.refresh
    try:
        if profiled:
            with _cpu_profile():
                out = run_full_aes.run_inverse_round(env.aes, st, 10, 10)
            assert all(eng.counters[k] > before[k] for k in keys)
        else:
            out = run_full_aes.run_inverse_round(env.aes, st, 10, 10)
            assert {k: eng.counters[k] for k in keys} == before
    finally:
        env.aes.refresh = refresh
    assert np.array_equal(env.aes.decrypt_state(out), env.state)


def test_stage_off_adds_nothing():
    """With no profiler a stage is its body alone."""
    eng = SimpleNamespace(device=torch.device("cpu"), counters={})
    assert not trace.on()
    with trace.stage(eng, "sub_bytes"):
        pass
    assert eng.counters == {}
    with _cpu_profile():
        with trace.stage(eng, "sub_bytes"):
            pass
    assert eng.counters["aes.sub_bytes_ns"] > 0


@pytest.mark.slow
def test_inverse_cipher_round_by_round(prod_small):
    """The whole inverse cipher through run_inverse_round from the AES
    ciphertexts at the work level, every round's output decoded exactly
    against the clear state; 36 refresh calls; the plaintexts at the end."""
    env = prod_small
    st = _encrypted(env, _ciphertexts(env), WORK)
    env.calls.clear()
    for i in range(1, 11):
        st = run_full_aes.run_inverse_round(env.aes, st, i, 10)
        assert np.array_equal(env.aes.decrypt_state(st), _leaving(env, i)), i
    assert len(env.calls) == 36
    assert np.array_equal(env.aes.decrypt_state(st), env.state)


def test_folded_masks_outlive_the_round_cache(prod_small, monkeypatch):
    """A cipher's key-folded InvMixColumns masks (9 round keys x 8 planes x
    4 rows) stay encoded while the round's LRU turns over, so a second
    cipher encodes none of them."""
    svc = prod_small.aes.svc
    encoded = []

    def encode(vec, level, scale, device):
        encoded.append(level)
        return SimpleNamespace(level=level, scale=scale)

    monkeypatch.setattr(prod_small.eng, "encode", encode)
    monkeypatch.setattr(svc, "_pt_cache", {})
    monkeypatch.setattr(svc, "_fold_cache", {})
    keys = [("rowf", r, bytes([key]), k)
            for key in range(9) for k in range(8) for r in range(4)]
    for cipher in range(2):
        encoded.clear()
        for key in keys:
            svc._cached_pt(key, np.ones(1), level=3, folded=True)
            svc._cached_pt(("ark",) + key, np.ones(1), level=3)
        assert len(encoded) == (2 if cipher == 0 else 1) * len(keys)


@pytest.mark.slow
def test_noise_trace_follows_the_inverse_round(prod_small, capsys):
    """noise_trace.trace_inverse drives run_inverse_round itself: a line a
    stage (the refresh's cleanse included), none with a wrong byte, the
    plaintexts at the end, and the wrappers gone afterwards."""
    env = prod_small
    noise_trace.trace_inverse(env.aes, 6)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "wrong bytes" in ln]
    # input; round 1: ARK, InvSubBytes, InvShiftRows, InvMixColumns and
    # the cleanse; rounds 2-9 besides: the refresh and its cleanse; round
    # 10: the refresh and its cleanse, InvSubBytes, InvShiftRows
    assert len(lines) == 1 + 5 + 8 * 6 + 4
    assert all(ln.endswith("wrong bytes 0") for ln in lines)
    assert "plaintexts equal" in out
    assert "_refresh" not in vars(env.aes)
    assert not set(noise_trace._CLEAR) & set(vars(env.aes.svc))
