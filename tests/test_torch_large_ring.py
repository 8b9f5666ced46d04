"""One key-switch through both packages at N=2^18, the first ring of the
two-pass NTT kernel: bench.py's AESFHE_BENCH_LOGN=18 profile
(CKKSParams(n=2^18, max_level=16, scale_bits=28, num_special_primes=4)),
on the CPU, where every kernel's wrapper runs its plain version.  And the
large key-switch set's shape (7 q-primes of 29-30 bits, scale 2^29, K = 2,
a dense secret), which chip_smoke.py runs at N=2^20, at N=2^16 through both
packages from the same seeded keys: its decode errors are the reference's.

Engine.relinearize (a random degree-2 ciphertext), Engine.rotate by one
slot (the Galois permutation of 2^17 slots) and the rescale after it give
the reference's residues, torch.equal.  The keys are random residues capped
at the ciphertexts' level (`SwitchKey.cap`: q_0..q_5 and the 4 specials,
two digits of 4 + 2 limbs): residue equality needs no valid key, and a
capped key keeps each switch to ten rows.  The kernels themselves are held
against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu.core.ciphertext import Ciphertext as JCiphertext
from aesfhe_tpu.core.engine import Engine as JEngine
from aesfhe_tpu.core.keys import GaloisKeySet as JGaloisKeySet
from aesfhe_tpu.core.keys import SwitchKey as JSwitchKey
from aesfhe_tpu.core.params import CKKSParams as JCKKSParams
from aesfhe_tpu_torch import bench, interop
from aesfhe_tpu_torch.core import ops_impl
from aesfhe_tpu_torch.core.ciphertext import Ciphertext
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.keys import GaloisKeySet
from aesfhe_tpu_torch.core.params import CKKSParams

LOGN, LEVELS = 18, 16
LEVEL = 5              # two digits at this level: 4 + 2 limbs
SCALE = 2.0 ** 28
# chip_smoke.py's LARGE_KS (N=2^20) on 2^16
LARGE_KS = dict(n=1 << 16, max_level=6, scale_bits=29, num_special_primes=2)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _key(p, rng):
    """Random residues of a switch key capped at LEVEL: [dnum_l, l+1+K, N]
    over q_0..q_l | specials (uint32)."""
    rows = ops_impl._rows(p, LEVEL, True)
    q = np.asarray(p.all_primes, dtype=np.int64)[rows]
    dnum = len(p.ks_tables(LEVEL)["groups"])
    return [(rng.integers(0, 1 << 62, (dnum, len(rows), p.n)) % q[:, None]
             ).astype(np.uint32) for _ in range(2)]


def _ct(p, rng, degree):
    q = np.asarray(p.q_primes[:LEVEL + 1], dtype=np.int64)
    return (rng.integers(0, 1 << 62, (degree + 1, LEVEL + 1, p.n))
            % q[:, None]).astype(np.uint32)


def _same(got: Ciphertext, want: JCiphertext):
    assert got.scale == want.scale
    assert torch.equal(got.data, interop.to_tensor(np.asarray(want.data),
                                                   device="cpu"))


def test_relinearize_rotate_rescale_match_reference_at_2_18():
    """At N=2^18: relinearize, then rotate by one slot and rescale the
    rotation, through both packages from the same random capped keys and
    ciphertexts: the same residues and scales at every step."""
    tp = bench.bench_params(LOGN, LEVELS)
    jp = JCKKSParams(n=1 << LOGN, max_level=LEVELS, scale_bits=28,
                     num_special_primes=4)
    assert tp.all_primes == jp.all_primes and tp.groups == jp.groups
    assert len(tp.ks_tables(LEVEL)["groups"]) == 2
    teng, jeng = Engine(tp, device="cpu"), JEngine(jp)
    rng = np.random.default_rng(LOGN)
    b, a = _key(tp, rng)
    c3 = _ct(tp, rng, 2)
    got = teng.relinearize(Ciphertext(interop.to_tensor(c3, device="cpu"),
                                      SCALE),
                           interop.switch_key(b, a, LEVEL, device="cpu"))
    want = jeng.relinearize(JCiphertext(jnp.asarray(c3), SCALE),
                            JSwitchKey(jnp.asarray(b), jnp.asarray(a), LEVEL))
    _same(got, want)
    g = tp.rot_galois_elt(1)
    assert g == jp.rot_galois_elt(1)
    b, a = _key(tp, rng)
    c2 = _ct(tp, rng, 1)
    got = teng.rotate(Ciphertext(interop.to_tensor(c2, device="cpu"), SCALE),
                      GaloisKeySet({g: interop.switch_key(b, a, LEVEL,
                                                          device="cpu")}), 1)
    want = jeng.rotate(JCiphertext(jnp.asarray(c2), SCALE),
                       JGaloisKeySet({g: JSwitchKey(jnp.asarray(b),
                                                    jnp.asarray(a), LEVEL)}),
                       1)
    _same(got, want)
    got, want = teng._rescale(got), jeng._rescale(want)
    assert got.level == want.level == LEVEL - 1
    _same(got, want)


def test_large_ks_decode_error_is_the_references():
    """LARGE_KS's shape at N=2^16 through both packages, keys from seed 0 on
    each side (the reference's module RNG put back afterwards), x uniform in
    [-1, 1] encrypted by the port and carried across: the product (rescaled
    at degree 2), its relinearization, the product relinearized before its
    rescale, and the rotation by one slot have the same residues and scales,
    and decrypt to the same slots on both sides.  Both read the large
    errors chip_smoke.py prints for this set, and the reference's arithmetic
    explains them: the product rescaled at degree 2 rounds a term of s^2
    (a dense secret), so relinearizing first decodes within 1%; the
    rotation's digits lie in [0, Q_j), not centred, so their mean
    multiplies the key's noise at the slots evaluated nearest X = 1 (slot
    0: X^1), where the error peaks."""
    tp, jp = CKKSParams(**LARGE_KS), JCKKSParams(**LARGE_KS)
    assert tp.all_primes == jp.all_primes and tp.secret_hamming is None
    teng = Engine(tp, device="cpu", rng=np.random.default_rng(0))
    jeng = JEngine(jp)
    saved, jkeys._rng = jkeys._rng, np.random.default_rng(0)
    try:
        jsk = jeng.create_secret_key()
        jpk = jeng.create_public_key(jsk)
        jrlk = jeng.create_relinearization_key(jsk)
        jrot = jeng.create_fixed_rotation_key(jsk, [1])
    finally:
        jkeys._rng = saved
    del jpk
    tsk = teng.create_secret_key()
    tpk = teng.create_public_key(tsk)
    trlk = teng.create_relinearization_key(tsk)
    trot = teng.create_fixed_rotation_key(tsk, [1])
    x = np.random.default_rng(2).uniform(-1, 1, tp.slot_count)
    ct = teng.encrypt(x, tpk)
    jct = JCiphertext(jnp.asarray(interop.to_numpy(ct.data)), ct.scale)
    tsq, jsq = teng.multiply(ct, ct), jeng.multiply(jct, jct)
    got = dict(square=tsq, relin=teng.relinearize(tsq, trlk),
               relin_first=teng.multiply(ct, ct, trlk),
               rotate=teng.rotate(ct, trot, 1))
    ref = dict(square=jsq, relin=jeng.relinearize(jsq, jrlk),
               relin_first=jeng.multiply(jct, jct, jrlk),
               rotate=jeng.rotate(jct, jrot, 1))
    want = dict(square=x * x, relin=x * x, relin_first=x * x,
                rotate=np.roll(x, 1))
    err = {}
    for k in got:
        _same(got[k], ref[k])
        slots = teng.decrypt(got[k], tsk)
        assert np.array_equal(slots, np.asarray(jeng.decrypt(ref[k], jsk)))
        err[k] = np.abs(slots - want[k])
    assert err["relin"].max() > 0.05 and err["rotate"].max() > 0.05
    assert err["relin_first"].max() < 0.01
    assert err["rotate"].argmax() == 0 and tp.slot_exp[0] == 1
