"""The slice as a whole: bit-sliced AES-128 rounds through the reference
(aesfhe_tpu) and the port (aesfhe_tpu_torch, on the CPU) from the same
ciphertexts and keys, carried across with interop.py, on the deep profile.

Both start from the reference's fresh encryption dropped to the uniform
work level ROUND_DEPTH * rounds + 1 (as scripts/run_full_aes.py drops its
state).  The decrypted bytes must equal each other and the plain AES
oracle; the decoded slots of every plane must agree within 1e-3 (the sign
margin is 1): the two packages encode their round plaintexts with
different complex64 FFTs, so the residues differ in the last units while
the decoded values agree to ~1e-5.

The side-by-side runs are `slow`: the reference's round alone costs ~27 s
of JAX compiles on the CPU.  The port's own round against the oracle stays
in the default run."""
import numpy as np
import pytest
import torch

from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu.core.keys import GaloisKeySet as JGaloisKeySet
from aesfhe_tpu.ops.bitplane import BitState as JBitState
from aesfhe_tpu.ops.xor_service import EngineWrapper as JEngineWrapper
from aesfhe_tpu.pipeline import AESFHE128Bitsliced as JAES
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.aes_tables import aes128_partial
from aesfhe_tpu_torch.context import EngineContext
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import get_params
from aesfhe_tpu_torch.ops.bitplane import BitState
from aesfhe_tpu_torch.ops.xor_service import EngineWrapper
from aesfhe_tpu_torch.pipeline import AESFHE128Bitsliced

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
SEED = 99
SLOT_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores, and torch's default pool of one
    thread per core then stalls in its barriers (a 7 s round took minutes);
    two threads run these tests as fast when alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _RefCtx:
    """The reference's session key family in EngineContext's shape, with a
    private copy of the rotation key dict (the service adds keys to it)."""

    def __init__(self, E):
        self.engine = E["eng"]
        self.secret_key = E["sk"]
        self.public_key = E["pk"]
        self.relinearization_key = E["rlk"]
        self.conjugation_key = E["conj"]
        self.rotation_key = JGaloisKeySet(keys=dict(E["rot"].keys))
        self.bootstrap_key = None


def _key(k):
    return interop.switch_key(np.asarray(k.b), np.asarray(k.a),
                              getattr(k, "cap", None), device="cpu")


@pytest.fixture(scope="module")
def both(deep_engine):
    """(reference AES, port AES, plaintext state, reference fresh state)."""
    with pytest.MonkeyPatch.context() as mp:
        # the service's missing rotation keys and the encryption noise come
        # from the reference's module generator: pin it for this module only
        mp.setattr(jkeys, "_rng", np.random.default_rng(SEED))
        jwrap = JEngineWrapper(ctx=_RefCtx(deep_engine))
        jaes = JAES(jwrap, KEY)
        sc = jwrap.engine.slot_count
        state = np.random.default_rng(SEED).integers(0, 256, sc,
                                                     dtype=np.uint8)
        jst = jaes.encrypt_state(state)
    sk = deep_engine["sk"]
    teng = Engine(get_params("deep"), device="cpu")
    ctx = EngineContext.from_keys(
        teng,
        secret=interop.secret_key(np.asarray(sk.s_eval), sk.s_coeff,
                                  device="cpu"),
        public=interop.public_key(np.asarray(deep_engine["pk"].b),
                                  np.asarray(deep_engine["pk"].a),
                                  device="cpu"),
        relin=_key(deep_engine["rlk"]), conj=_key(deep_engine["conj"]),
        rotation=interop.galois_keys(
            {g: (np.asarray(k.b), np.asarray(k.a), k.cap)
             for g, k in jwrap.rot_key.keys.items()
             if g in {teng.params.rot_galois_elt(s) for s in
                      (1, 2, 3, -1, -2, -3, 4, 8, 12, -4, -8, -12)}},
            device="cpu"))
    taes = AESFHE128Bitsliced(EngineWrapper(ctx=ctx), KEY)
    return jaes, taes, state, jst


def _inputs(both, rounds):
    """The reference's fresh planes at the work level, and their copies."""
    jaes, taes, state, jst = both
    work = JAES.ROUND_DEPTH * rounds + 1
    jin = JBitState([jaes.eng.engine._drop(b, work) for b in jst.bits])
    tin = BitState([interop.ciphertext(np.asarray(b.data), b.scale,
                                       device="cpu") for b in jin.bits])
    want = np.concatenate([aes128_partial(state[b:b + 16], KEY, rounds)
                           for b in range(0, len(state), 16)])
    return jin, tin, want


def test_port_round_matches_oracle(both):
    """One round of the port from the reference's ciphertexts and keys."""
    _, taes, _, _ = both
    _, tin, want = _inputs(both, 1)
    teng = taes.eng.engine
    teng.reset_counters()
    tout = taes.encrypt_rounds(tin, rounds=1)
    assert teng.counters["keyswitch"] == 180
    assert tout.level == 0
    assert np.array_equal(taes.decrypt_state(tout), want)


@pytest.mark.slow
@pytest.mark.parametrize("rounds", [1, 2])
def test_rounds_match_reference_and_oracle(both, rounds):
    jaes, taes, _, _ = both
    jeng, teng = jaes.eng.engine, taes.eng.engine
    jin, tin, want = _inputs(both, rounds)
    jeng.reset_counters()
    teng.reset_counters()
    jout = jaes.encrypt_rounds(jin, rounds=rounds)
    tout = taes.encrypt_rounds(tin, rounds=rounds)
    assert {k: teng.counters[k] for k in jeng.counters} == jeng.counters
    # the port's own bootstrap phase counters: no bootstrap, no profiler
    assert all(teng.counters[k] == 0 for k in teng.counters
               if k not in jeng.counters)
    assert teng.counters["keyswitch"] == 180 * rounds

    assert np.array_equal(jaes.decrypt_state(jout), want)
    assert np.array_equal(taes.decrypt_state(tout), want)
    for jb, tb in zip(jout.bits, tout.bits, strict=True):
        assert tb.level == jb.level and tb.scale == jb.scale
        vj = np.real(jaes.eng.decrypt(jb))
        vt = np.real(taes.eng.decrypt(tb))
        assert np.max(np.abs(vt - vj)) < SLOT_TOL
