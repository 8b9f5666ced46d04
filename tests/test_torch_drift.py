"""prod_boot's prime chain on a small ring: one bit-sliced AES round through
the reference (aesfhe_tpu) and the port (aesfhe_tpu_torch, on the CPU) from
the same ciphertexts and keys, compared after every stage.

prod_boot's rescale primes stray from Delta = 2^27 by up to 25% at the top
of its chain (deep's by <0.7%), and the round tracks scales exactly, so the
modules' bit-exact tests on tiny/deep never reach the drifted scales this
chain produces.  Here the ring is cut to N = 2^10 while the primes stay
prod_boot's (q = 1 mod 2^17 is also 1 mod 2^11, so the same chain is
NTT-friendly at the small ring): the scale arithmetic is prod_boot's, and
only the noise is smaller.

The two packages round their complex64 plaintext encodes differently, and
where the round's scale collapses that difference alone is amplified into
O(1) slot differences.  So the port's device encode is routed through the
reference's here: the rest of the round must then give the same residues,
level and scale as the reference after every stage, bit for bit.

    python -m pytest tests/test_torch_drift.py -m slow -s

prints, per start level and stage: level, scale/Delta, and over the 8
planes the smallest |slot| and the largest | |slot| - 1 | (every slot
should be +-1).  `slow`: the reference's round compiles ~15 levels of JAX
programs on the CPU."""
import numpy as np
import pytest
import torch

from aesfhe_tpu.core import dev_encoding as jdev
from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu.core import rns as jrns
from aesfhe_tpu.core.engine import Engine as JEngine
from aesfhe_tpu.core.keys import GaloisKeySet as JGaloisKeySet
from aesfhe_tpu.core.params import CKKSParams as JCKKSParams
from aesfhe_tpu.ops.bitplane import BitState as JBitState
from aesfhe_tpu.ops.xor_service import EngineWrapper as JEngineWrapper
from aesfhe_tpu.pipeline import AESFHE128Bitsliced as JAES
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.context import EngineContext
from aesfhe_tpu_torch.core import dev_encoding as tdev
from aesfhe_tpu_torch.core import rns as trns
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import CKKSParams, get_params
from aesfhe_tpu_torch.ops.bitplane import BitState
from aesfhe_tpu_torch.ops.xor_service import EngineWrapper
from aesfhe_tpu_torch.pipeline import AESFHE128Bitsliced

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
SEED = 5
PROD_TWO_N = 1 << 17
SMALL = dict(n=1 << 10, max_level=54, scale_bits=27, num_special_primes=8,
             secret_hamming=192)
STEPS = (1, 2, 3, -1, -2, -3, 4, 8, 12, -4, -8, -12)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _RefCtx:
    def __init__(self, eng, sk):
        self.engine = eng
        self.secret_key = sk
        self.public_key = eng.create_public_key(sk)
        self.relinearization_key = eng.create_relinearization_key(sk)
        self.conjugation_key = eng.create_conjugation_key(sk)
        self.rotation_key = JGaloisKeySet(keys={})
        self.bootstrap_key = None


def _key(k):
    return interop.switch_key(np.asarray(k.b), np.asarray(k.a), k.cap,
                              device="cpu")


@pytest.fixture(scope="module")
def both():
    """(reference AES, port AES, plaintext state, reference fresh state) on
    prod_boot's primes at N = 2^10."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jrns, trns):
            def prod_primes(bits, two_n, count, skip=(),
                            _find=mod.find_ntt_primes):
                return _find(bits, PROD_TWO_N, count, skip)
            mp.setattr(mod, "find_ntt_primes", prod_primes)
        jp, tp = JCKKSParams(**SMALL), CKKSParams(**SMALL)
    prod = get_params("prod_boot")
    assert tp.all_primes == prod.all_primes == jp.all_primes
    assert tp.groups == prod.groups

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkeys, "_rng", np.random.default_rng(SEED))
        jeng = JEngine(jp)
        jwrap = JEngineWrapper(ctx=_RefCtx(jeng, jeng.create_secret_key()))
        jaes = JAES(jwrap, KEY)
        state = np.random.default_rng(SEED).integers(0, 256, jp.slot_count,
                                                     dtype=np.uint8)
        jst = jaes.encrypt_state(state)
    teng = Engine(tp, device="cpu")
    sk = jwrap.secret_key
    ctx = EngineContext.from_keys(
        teng,
        secret=interop.secret_key(np.asarray(sk.s_eval), sk.s_coeff,
                                  device="cpu"),
        public=interop.public_key(np.asarray(jwrap.public_key.b),
                                  np.asarray(jwrap.public_key.a),
                                  device="cpu"),
        relin=_key(jwrap.relin_key), conj=_key(jwrap.conj_key),
        rotation=interop.galois_keys(
            {g: (np.asarray(k.b), np.asarray(k.a), k.cap)
             for g, k in jwrap.rot_key.keys.items()}, device="cpu"))
    taes = AESFHE128Bitsliced(EngineWrapper(ctx=ctx), KEY)
    assert set(taes.eng.rot_key.keys) == {tp.rot_galois_elt(s % tp.slot_count)
                                          for s in STEPS}
    return jaes, taes, state, jst


@pytest.mark.slow
@pytest.mark.parametrize("start", [43, 29])
def test_round_stages_match_reference(both, start, monkeypatch):
    """The reference's fresh planes dropped to `start`, then AddRoundKey,
    SubBytes, ShiftRows, MixColumns and the cleanse in both packages."""
    jaes, taes, _, jst = both
    jeng = jaes.eng.engine

    def ref_encode(params, tabs, vec, level, scale):
        return interop.to_tensor(np.asarray(jdev.encode_eval_dev(
            jeng.params, jeng.tabs, vec, level, scale)), device="cpu")

    monkeypatch.setattr(tdev, "encode_eval_dev", ref_encode)
    delta = jeng.params.scale
    jst = JBitState([jeng._drop(b, start) for b in jst.bits])
    tst = BitState([interop.ciphertext(np.asarray(b.data), b.scale,
                                       device="cpu") for b in jst.bits])
    stages = (("ark", lambda a, st: a.svc.xor_plain(st, a.round_keys[0])),
              ("sub", lambda a, st: a.svc.sub_bytes(st)),
              ("shift", lambda a, st: a.svc.shift_rows(st)),
              ("mix", lambda a, st: a.svc.mix_columns(st)),
              ("cleanse", lambda a, st: a.svc.cleanse(st)))
    print(f"\nstart level {start} (prod_boot primes, N=2^10)")
    for tag, stage in stages:
        jst, tst = stage(jaes, jst), stage(taes, tst)
        smallest, worst = np.inf, 0.0
        for jb, tb in zip(jst.bits, tst.bits, strict=True):
            assert tb.level == jb.level and tb.scale == jb.scale, tag
            assert np.array_equal(interop.to_numpy(tb.data),
                                  np.asarray(jb.data)), tag
            v = np.abs(np.real(jaes.eng.decrypt(jb)))
            smallest = min(smallest, float(v.min()))
            worst = max(worst, float(np.max(np.abs(v - 1))))
        print(f"  {tag:8s} level {jst.level:2d}  scale/Delta "
              f"{jst.bits[0].scale / delta:.6g}  min|v| {smallest:.3e}  "
              f"max||v|-1| {worst:.3e}", flush=True)
