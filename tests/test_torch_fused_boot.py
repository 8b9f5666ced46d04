"""The port's fused bootstrap, dense and small bootstrap flavors, `.npz`
serialization and the bit-sliced pipeline's checkpoint/resume against the
reference (aesfhe_tpu), on the CPU.

Chain (a) is tests/test_bootstrap.py's boot chain (n=2^9, 34 levels, a
30-bit first prime, 4 specials, h=16), as in tests/test_torch_bootstrap.py.
Keys are generated in-process from seeded numpy generators (no on-disk key
cache).

Default run: on (a), the port's FusedBootstrap on the CPU equals its eager
bootstrap residue for residue with the same tracked scale; the wrapper's
fused path keeps one instance across input levels; a level or scale
mismatch raises; the dense key's BSGS split and steps and the small key's
flavor equal the reference's; `_apply_linear_map` equals the reference's on
a 32-coefficient ring; ciphertexts and keys written by either package load
in the other; `params_fingerprint` and the checkpoint digest equal the
reference's; the checkpoint files, the resume of encrypt_rounds and its
refusals.

`slow`: a checkpointed bit-sliced run on boot_tiny resumed after round 1
equals one run straight through (three rounds, ~13 s); the port's fused
bootstrap against the reference's FusedBootstrap on (a) and on (b)
(tests/test_torch_bootstrap.py's prod-shaped chain); the whole dense
bootstrap through both packages on a 64-coefficient ring; and
on prod_boot's primes at N=2^10 both packages' bootstraps raise the same
ZeroDivisionError in EvalMod (the tracked scale underflows to 0.0)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesfhe_tpu import bootstrap as jbs
from aesfhe_tpu import pipeline as jpipeline
from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu.core import rns as jrns
from aesfhe_tpu.core.ciphertext import Ciphertext as JCiphertext
from aesfhe_tpu.core.engine import Engine as JEngine
from aesfhe_tpu.core.params import CKKSParams as JCKKSParams
from aesfhe_tpu.core.params import get_params as jget_params
from aesfhe_tpu.utils import serialization as jser
from aesfhe_tpu_torch import bootstrap as tbs
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.core import keys as tkeys
from aesfhe_tpu_torch.core import rns as trns
from aesfhe_tpu_torch.core.ciphertext import Ciphertext
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.keys import GaloisKeySet
from aesfhe_tpu_torch.core.params import CKKSParams, get_params
from aesfhe_tpu_torch.keyexp import expand_key_128
from aesfhe_tpu_torch.ops.bitplane import BitState
from aesfhe_tpu_torch.ops.xor_service import EngineWrapper, XORConfig
from aesfhe_tpu_torch.pipeline import AESFHE128Bitsliced
from aesfhe_tpu_torch.utils import serialization as tser

SEED = 3
KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
CHAINS = dict(
    a=dict(n=1 << 9, max_level=34, scale_bits=27, first_prime_bits=30,
           num_special_primes=4, secret_hamming=16),
    b=dict(n=1 << 10, max_level=54, scale_bits=27, num_special_primes=8,
           secret_hamming=192))
HI_PREC = dict(a=False, b=True)
# rings small enough for the dense maps' slot-by-slot diagonals
RING32 = dict(n=1 << 5, max_level=4, scale_bits=26, num_special_primes=2)
RING64 = dict(n=1 << 6, max_level=24, scale_bits=27, first_prime_bits=30,
              num_special_primes=4, secret_hamming=8)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return interop.to_tensor(np.asarray(a), device="cpu")


def _key(k):
    return interop.switch_key(np.asarray(k.b), np.asarray(k.a),
                              getattr(k, "cap", None), device="cpu")


def _jkey(k):
    return jkeys.SwitchKey(b=jnp.asarray(interop.to_numpy(k.b)),
                           a=jnp.asarray(interop.to_numpy(k.a)), cap=k.cap)


def _packed(eng, pk, seed=9, level=0):
    """p0 + i p1 of two random +-1 planes at `level`, as the refresh packs
    two bit planes."""
    sc = eng.slot_count
    rng = np.random.default_rng(seed)
    p0 = 1.0 - 2.0 * rng.integers(0, 2, sc)
    p1 = 1.0 - 2.0 * rng.integers(0, 2, sc)
    ct = eng.add(eng._drop(eng.encrypt(p0, pk), level),
                 eng.multiply_i(eng._drop(eng.encrypt(p1, pk), level)))
    return ct, p0 + 1j * p1


@pytest.fixture(scope="module")
def wrap_a():
    """A fused-boot wrapper on chain (a), keys from SEED, and the eager
    bootstrap of a level-3 input (dropped to 0), computed once."""
    w = EngineWrapper(XORConfig(params=CKKSParams(**CHAINS["a"]), device="cpu",
                                rotation_steps=(), use_bootstrap=True,
                                fused_boot=True),
                      rng=np.random.default_rng(SEED))
    eng = w.engine
    ct, want = _packed(eng, w.public_key, level=3)
    eager = eng.bootstrap(eng._drop(ct, 0), w.relin_key, w.conj_key,
                          w.boot_key)
    return SimpleNamespace(w=w, ct=ct, msg=want, eager=eager)


# ---------------------------------------------------------------------------
# FusedBootstrap and the wrapper's fused path
# ---------------------------------------------------------------------------

def test_fused_cpu_equals_eager(wrap_a):
    """On the CPU FusedBootstrap captures nothing and runs the eager
    bootstrap at its static input scale: residues and tracked scale equal
    the eager bootstrap's; the counters tick as for one bootstrap."""
    w, eng = wrap_a.w, wrap_a.w.engine
    low = eng._drop(wrap_a.ct, 0)
    fb = tbs.FusedBootstrap(eng, w.relin_key, w.conj_key, w.boot_key, low)
    assert fb.graph is None and fb.warm_out is None and fb.deltas == {}
    assert (fb.in_level, fb.in_scale, fb.out_scale) == (0, low.scale, None)
    eng.reset_counters()
    out = fb(low)
    assert eng.counters["bootstrap"] == 1
    assert eng.counters["keyswitch"] > 0
    assert torch.equal(out.data, wrap_a.eager.data)
    assert out.scale == wrap_a.eager.scale == fb.out_scale
    assert np.max(np.abs(w.decrypt(out) - wrap_a.msg)) < 0.35


def test_wrapper_fused_path_one_instance_across_levels(wrap_a):
    """EngineWrapper(fused_boot=True).bootstrap drops to level 0 first, so
    inputs at levels 3 and 5 of one scale share one instance, and both
    equal the eager bootstrap; it takes no phase list, and times its
    phases into the engine's counters under a profiler."""
    w, eng = wrap_a.w, wrap_a.w.engine
    w.fused_instances.clear()
    ct5, msg5 = _packed(eng, w.public_key, seed=10, level=5)
    out3, out5 = w.bootstrap(wrap_a.ct), w.bootstrap(ct5)
    assert len(w.fused_instances) == 1
    (key, inst), = w.fused_instances.items()
    assert key == round(float(np.log2(wrap_a.ct.scale)) * 1e4)
    assert inst.in_level == 0
    assert torch.equal(out3.data, wrap_a.eager.data)
    assert out3.scale == out5.scale == wrap_a.eager.scale
    assert np.max(np.abs(w.decrypt(out5) - msg5)) < 0.35
    # the synchronising phase list is gone; the fused path, which it could
    # not time, adds its phase times to the counters under a profiler
    with pytest.raises(TypeError, match="phases"):
        w.bootstrap(wrap_a.ct, phases=[])
    keys = [f"boot.{p}_ns" for p in tbs._PhaseTimer.PHASES]
    before = [eng.counters[k] for k in keys]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = w.bootstrap(wrap_a.ct)
    assert torch.equal(out.data, wrap_a.eager.data)
    assert all(eng.counters[k] > b for k, b in zip(keys, before))


def test_fused_signature_mismatch_raises(wrap_a):
    w, eng = wrap_a.w, wrap_a.w.engine
    low = eng._drop(wrap_a.ct, 0)
    fb = tbs.FusedBootstrap(eng, w.relin_key, w.conj_key, w.boot_key, low)
    with pytest.raises(ValueError, match="level"):
        fb(eng._drop(wrap_a.ct, 1))
    with pytest.raises(ValueError, match="scale"):
        fb(Ciphertext(low.data, low.scale * (1 + 1e-6)))
    dense = tbs.BootstrapKey(rot=w.boot_key.rot, factored=False)
    with pytest.raises(NotImplementedError):
        tbs.FusedBootstrap(eng, w.relin_key, w.conj_key, dense, low)


# ---------------------------------------------------------------------------
# Key flavors
# ---------------------------------------------------------------------------

def test_dense_and_small_keys_equal_reference(wrap_a, monkeypatch):
    """create_bootstrap_key(small=, factored=): the step set each package
    would generate, the dense BSGS split, and the small flavor's fields;
    the context's small key shares the regular key's Galois set."""
    steps = {}

    def grab(side):
        def gen(*args):
            steps[side] = sorted(args[-1])
            return "rot"
        return gen

    monkeypatch.setattr(jbs, "gen_rotation_keys", grab("ref"))
    monkeypatch.setattr(tbs, "gen_rotation_keys", grab("port"))
    for kw in (RING32, CHAINS["a"]):
        jp, tp = JCKKSParams(**kw), CKKSParams(**kw)
        jeng = SimpleNamespace(params=jp, tabs=None)
        teng = SimpleNamespace(params=tp, tabs=None, rng=None)
        for small in (False, True):
            for factored in (None, False):
                jk = jbs.create_bootstrap_key(jeng, None, small=small,
                                              factored=factored)
                tk = tbs.create_bootstrap_key(teng, None, small=small,
                                              factored=factored)
                assert steps["port"] == steps["ref"]
                for f in ("small", "factored", "baby", "giant", "K",
                          "cheb_deg", "double_angles", "prescale", "hi_prec",
                          "hi_scale"):
                    assert getattr(tk, f) == getattr(jk, f), f
                assert [g["baby_steps"] for g in tk.stc_plan] == \
                    [g["baby_steps"] for g in jk.stc_plan]
    ctx = wrap_a.w.ctx
    assert ctx.small_bootstrap_key.small and not ctx.bootstrap_key.small
    assert ctx.small_bootstrap_key.rot is ctx.bootstrap_key.rot
    assert ctx.small_bootstrap_key.double_angles == 2


def _ref_and_port(kw, seed):
    """Both packages' engines on one ring, the port's keys (relin, conj and
    the dense map's Galois keys) and the same keys as the reference's."""
    jp, tp = JCKKSParams(**kw), CKKSParams(**kw)
    teng = Engine(tp, device="cpu", rng=np.random.default_rng(seed))
    sk = teng.create_secret_key()
    pk = teng.create_public_key(sk)
    rlk = teng.create_relinearization_key(sk)
    conj = teng.create_conjugation_key(sk)
    tbk = tbs.create_bootstrap_key(teng, sk, factored=False)
    jeng = JEngine(jp)
    jrot = jkeys.GaloisKeySet(keys={g: _jkey(k)
                                    for g, k in tbk.rot.keys.items()})
    jbk = jbs.create_bootstrap_key(jeng, None, factored=False, rot=jrot)
    jsk = jkeys.SecretKey(jnp.asarray(interop.to_numpy(sk.s_eval)),
                          sk.s_coeff)
    return SimpleNamespace(teng=teng, jeng=jeng, sk=sk, jsk=jsk, pk=pk,
                           rlk=rlk, conj=conj, jrlk=_jkey(rlk),
                           jconj=_jkey(conj), tbk=tbk, jbk=jbk)


def test_apply_linear_map_equals_reference():
    """The dense BSGS map (hoisted babies, per giant a plaintext
    multiply-accumulate and one rotation) on a 32-coefficient ring, from
    the same ciphertext and keys: residues, level and scale equal; the
    diagonals are cached on the key, keyed (tag, d, level)."""
    S = _ref_and_port(RING32, 5)
    tp = S.teng.params
    sc = tp.slot_count
    assert (S.tbk.baby, S.tbk.giant) == (4, 4)
    x = np.random.default_rng(2).standard_normal(sc) * 0.5
    ct = S.teng.encrypt(x, S.pk)
    jct = JCiphertext(jnp.asarray(interop.to_numpy(ct.data)), ct.scale)
    f_a, _ = tbs._cts_diag(tp, sc)
    got = tbs._apply_linear_map(S.teng, ct, f_a, "cts_a", S.tbk)
    want = jbs._apply_linear_map(S.jeng, jct, f_a, "cts_a", S.jbk)
    assert (got.level, got.scale) == (want.level, want.scale)
    assert torch.equal(got.data, _t(want.data))
    assert sorted(S.tbk.diags) == [("cts_a", d, tp.top_level)
                                   for d in range(sc)]
    assert (S.tbk.diag_misses, S.tbk.diag_hits) == (sc, 0)
    again = tbs._apply_linear_map(S.teng, ct, f_a, "cts_a", S.tbk)
    assert torch.equal(again.data, got.data) and S.tbk.diag_hits == sc
    dec = S.teng.decrypt(got, S.sk)
    mat = np.stack([f_a(d) for d in range(sc)])         # mat[d, k]
    dense = np.zeros((sc, sc), dtype=complex)
    for d in range(sc):
        for k in range(sc):
            dense[k, (k - d) % sc] = mat[d, k]
    assert np.max(np.abs(dec - dense @ x)) < 1e-3


# ---------------------------------------------------------------------------
# Serialization and checkpoint/resume
# ---------------------------------------------------------------------------

def test_serialization_round_trips_between_packages(wrap_a, tmp_path):
    """A ciphertext and a key set (secret, public, relin, conj and a
    rotation set with a level-capped key) written by either package load in
    the other, equal array for array; the file layout is the reference's."""
    w, eng = wrap_a.w, wrap_a.w.engine
    p = eng.params
    g_full = sorted(w.boot_key.rot.keys)[0]
    g_cap = p.rot_galois_elt(3)
    rot = GaloisKeySet(keys={
        g_full: w.boot_key.rot.keys[g_full],
        g_cap: tkeys.gen_galois_key(p, eng.tabs, w.secret_key, g_cap,
                                    np.random.default_rng(1), lvl_cap=5)})
    fam = dict(secret=w.secret_key, public=w.public_key, relin=w.relin_key,
               conj=w.conj_key, rotation=rot)
    ct = wrap_a.ct

    tser.save_ciphertext(tmp_path / "t_ct.npz", ct)
    tser.save_keys(tmp_path / "t_keys.npz", **fam)
    z = np.load(tmp_path / "t_ct.npz")
    assert z["data"].dtype == np.uint32 and str(z["kind"]) == "ciphertext"
    jct = jser.load_ciphertext(tmp_path / "t_ct.npz")
    assert jct.scale == ct.scale
    assert np.array_equal(np.asarray(jct.data), interop.to_numpy(ct.data))
    jfam = jser.load_keys(tmp_path / "t_keys.npz")
    assert np.array_equal(np.asarray(jfam["secret"].s_eval),
                          interop.to_numpy(w.secret_key.s_eval))
    assert np.array_equal(jfam["secret"].s_coeff, w.secret_key.s_coeff)
    for name in ("public", "relin", "conj"):
        for part in ("b", "a"):
            assert np.array_equal(np.asarray(getattr(jfam[name], part)),
                                  interop.to_numpy(getattr(fam[name], part)))
    assert sorted(jfam["rotation"].keys) == sorted(rot.keys)
    for g, k in rot.keys.items():
        jk = jfam["rotation"].keys[g]
        assert jk.cap == k.cap
        assert np.array_equal(np.asarray(jk.a), interop.to_numpy(k.a))

    # the reference writes, the port reads: the same objects come back
    jser.save_ciphertext(tmp_path / "j_ct.npz", jct)
    jser.save_keys(tmp_path / "j_keys.npz", **jfam)
    back = tser.load_ciphertext(tmp_path / "j_ct.npz", device="cpu")
    assert back.scale == ct.scale and torch.equal(back.data, ct.data)
    tfam = tser.load_keys(tmp_path / "j_keys.npz", device="cpu")
    assert torch.equal(tfam["secret"].s_eval, w.secret_key.s_eval)
    assert np.array_equal(tfam["secret"].s_coeff, w.secret_key.s_coeff)
    assert tfam["secret"].s_coeff.dtype == np.int8
    for name in ("public", "relin", "conj"):
        for part in ("b", "a"):
            assert torch.equal(getattr(tfam[name], part),
                               getattr(fam[name], part))
    for g, k in rot.keys.items():
        tk = tfam["rotation"].keys[g]
        assert tk.cap == k.cap
        assert torch.equal(tk.b, k.b) and torch.equal(tk.a, k.a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tser.load_ciphertext(tmp_path / "j_ct.npz")


def test_fingerprint_and_run_digest_equal_reference():
    for prof in ("tiny", "boot_tiny", "prod_boot"):
        tp, jp = get_params(prof), jget_params(prof)
        assert tser.params_fingerprint(tp) == jser.params_fingerprint(jp)
        for key in (KEY, bytes(range(16, 32))):
            rk = expand_key_128(key)

            def side(p):
                return SimpleNamespace(eng=SimpleNamespace(
                    engine=SimpleNamespace(params=p)), round_keys=rk)
            assert AESFHE128Bitsliced._run_digest(side(tp)) == \
                jpipeline.AESFHE128Bitsliced._run_digest(side(jp))


def test_checkpoint_save_load_and_refusals(wrap_a, tmp_path):
    """The round files and the marker written last; a round without its
    marker is not resumed; encrypt_rounds resumes after the deepest saved
    round (here all of them: only the closing AddRoundKey runs); another
    AES key, or planes without a manifest, are refused."""
    w, eng = wrap_a.w, wrap_a.w.engine
    aes = AESFHE128Bitsliced(w, KEY)
    st = BitState([eng._drop(wrap_a.ct, 1 + k % 3) for k in range(8)])
    d = tmp_path / "ckpt"
    assert aes._load_checkpoint(d, 10) == (None, 0)
    aes._save_checkpoint(d, 1, st)
    aes._save_checkpoint(d, 2, st)
    (d / "round02.complete").unlink()
    assert sorted(x.name for x in d.iterdir()) == \
        ["manifest.json", "round01.complete"] + \
        [f"round01_plane{k}.npz" for k in range(8)] + \
        [f"round02_plane{k}.npz" for k in range(8)]
    got, r = aes._load_checkpoint(d, 10)
    assert r == 1
    for a, b in zip(got.bits, st.bits, strict=True):
        assert a.scale == b.scale and torch.equal(a.data, b.data)
    out = aes.encrypt_rounds(st, rounds=1, checkpoint_dir=d)
    want = aes.svc.xor_plain(st, aes.round_keys[1])
    for a, b in zip(out.bits, want.bits, strict=True):
        assert torch.equal(a.data, b.data)
    with pytest.raises(RuntimeError, match="different run"):
        AESFHE128Bitsliced(w, bytes(16))._load_checkpoint(d, 10)
    (d / "manifest.json").unlink()
    with pytest.raises(RuntimeError, match="no manifest"):
        aes._load_checkpoint(d, 10)


@pytest.mark.slow
def test_checkpoint_resume_equals_straight_run(tmp_path):
    """Two bit-sliced rounds on boot_tiny from the work level 29 with a
    checkpoint directory; resumed after round 1 (round 2's marker removed)
    and after round 2, the residues equal the straight run's; another AES
    key, or planes without a manifest, are refused."""
    w = EngineWrapper(XORConfig(profile="boot_tiny", rotation_steps=(),
                                device="cpu"),
                      rng=np.random.default_rng(SEED))
    aes = AESFHE128Bitsliced(w, KEY)
    eng = w.engine
    work = aes.ROUND_DEPTH * 2 + 1
    state = np.random.default_rng(4).integers(0, 256, eng.slot_count,
                                              dtype=np.uint8)
    st0 = BitState([eng._drop(b, work) for b in
                    aes.encrypt_state(state).bits])
    d = tmp_path / "ckpt"
    straight = aes.encrypt_rounds(st0, rounds=2, checkpoint_dir=d)
    files = sorted(x.name for x in d.iterdir())
    assert files == ["manifest.json", "round01.complete"] + \
        [f"round01_plane{k}.npz" for k in range(8)] + \
        ["round02.complete"] + [f"round02_plane{k}.npz" for k in range(8)]
    (d / "round02.complete").unlink()
    resumed = aes.encrypt_rounds(st0, rounds=2, checkpoint_dir=d)
    assert (d / "round02.complete").exists()
    from_end = aes.encrypt_rounds(st0, rounds=2, checkpoint_dir=d)
    for out in (resumed, from_end):
        for a, b in zip(out.bits, straight.bits, strict=True):
            assert a.scale == b.scale and torch.equal(a.data, b.data)
    other = AESFHE128Bitsliced(w, bytes(16))
    with pytest.raises(RuntimeError, match="different run"):
        other.encrypt_rounds(st0, rounds=2, checkpoint_dir=d)
    (d / "manifest.json").unlink()
    with pytest.raises(RuntimeError, match="no manifest"):
        aes.encrypt_rounds(st0, rounds=2, checkpoint_dir=d)


# ---------------------------------------------------------------------------
# Through both packages (slow)
# ---------------------------------------------------------------------------

def _ref_family(jp, hi_prec):
    """The reference's seeded key family and bootstrap key, and a
    pair-packed level-0 input."""
    jeng = JEngine(jp, use_bootstrap=True)
    sk = jeng.create_secret_key()
    pk = jeng.create_public_key(sk)
    rlk = jeng.create_relinearization_key(sk)
    conj = jeng.create_conjugation_key(sk)
    jbk = jbs.create_bootstrap_key(jeng, sk, hi_prec=hi_prec)
    packed, _ = _packed(jeng, pk)
    return jeng, sk, rlk, conj, jbk, packed


def _port_bk(tp, jbk):
    return interop.bootstrap_key(
        tp, {g: (np.asarray(k.b), np.asarray(k.a), k.cap)
             for g, k in jbk.rot.keys.items()},
        K=jbk.K, cheb_deg=jbk.cheb_deg, double_angles=jbk.double_angles,
        prescale=jbk.prescale, hi_prec=jbk.hi_prec, hi_scale=jbk.hi_scale,
        small=jbk.small, factored=jbk.factored, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("chain", ["a", "b"])
def test_fused_matches_reference_fused(chain, monkeypatch):
    """The reference's FusedBootstrap (XLA programs) and the port's, built
    from the same keys and sample: equal residues and static scales."""
    jp, tp = JCKKSParams(**CHAINS[chain]), CKKSParams(**CHAINS[chain])
    monkeypatch.setattr(jkeys, "_rng", np.random.default_rng(SEED))
    jeng, _, rlk, conj, jbk, packed = _ref_family(jp, HI_PREC[chain])
    jfb = jbs.FusedBootstrap(jeng, rlk, conj, jbk, packed)
    jout = jfb(packed)
    teng = Engine(tp, device="cpu")
    tin = interop.ciphertext(np.asarray(packed.data), packed.scale,
                             device="cpu")
    tfb = tbs.FusedBootstrap(teng, _key(rlk), _key(conj), _port_bk(tp, jbk),
                             tin)
    tout = tfb(tin)
    assert (tfb.in_level, tfb.in_scale) == (jfb.in_level, jfb.in_scale)
    assert tfb.out_scale == jfb.out_scale == tout.scale == jout.scale
    assert torch.equal(tout.data, _t(jout.data))


@pytest.mark.slow
def test_dense_bootstrap_matches_reference():
    """The whole dense bootstrap (ModRaise, two CoeffToSlot maps, the
    conjugation split, EvalMod on both halves, two SlotToCoeff maps) on a
    64-coefficient ring through both packages: equal residues and scale."""
    S = _ref_and_port(RING64, 6)
    ct, msg = _packed(S.teng, S.pk)
    ct = Ciphertext(ct.data, ct.scale)
    jct = JCiphertext(jnp.asarray(interop.to_numpy(ct.data)), ct.scale)
    got = tbs.bootstrap(S.teng, ct, S.rlk, S.conj, S.tbk)
    want = jbs.bootstrap(S.jeng, jct, S.jrlk, S.jconj, S.jbk)
    assert (got.level, got.scale) == (want.level, want.scale)
    assert torch.equal(got.data, _t(want.data))
    assert np.max(np.abs(S.teng.decrypt(got, S.sk) - msg)) < 0.35


@pytest.mark.slow
def test_eval_mod_scale_underflow_is_the_references(monkeypatch):
    """prod_boot's primes at N=2^10 with the hi-precision tier: in both
    packages the same first EvalMod double angle's pair product tracks its
    scale down to 0.0 and the add after it raises ZeroDivisionError.  The
    top of this chain's rescale primes strays up to 25% from Delta, and the
    Chebyshev squarings square that drift (s -> s^2 / (q q')); at N=2^16
    the same primes bootstrap, since CoeffToSlot takes one more group and
    EvalMod starts lower."""
    with monkeypatch.context() as mp:
        for mod in (jrns, trns):
            def prod_primes(bits, two_n, count, skip=(),
                            _find=mod.find_ntt_primes):
                return _find(bits, 1 << 17, count, skip)
            mp.setattr(mod, "find_ntt_primes", prod_primes)
        kw = dict(CHAINS["b"])
        jp, tp = JCKKSParams(**kw), CKKSParams(**kw)
    assert tp.all_primes == get_params("prod_boot").all_primes
    monkeypatch.setattr(jkeys, "_rng", np.random.default_rng(SEED))
    jeng, _, rlk, conj, jbk, packed = _ref_family(jp, True)
    teng = Engine(tp, device="cpu")
    tin = interop.ciphertext(np.asarray(packed.data), packed.scale,
                             device="cpu")
    logs = {}
    for name, eng in (("ref", jeng), ("port", teng)):
        log = logs[name] = []

        def pair(a, b, r=None, _f=eng.multiply_pair, _log=log):
            out = _f(a, b, r)
            _log.append((a.level, out.level, out.scale))
            return out
        monkeypatch.setattr(eng, "multiply_pair", pair)
    with pytest.raises(ZeroDivisionError):
        jbs.bootstrap(jeng, packed, rlk, conj, jbk)
    with pytest.raises(ZeroDivisionError):
        tbs.bootstrap(teng, tin, _key(rlk), _key(conj), _port_bk(tp, jbk))
    assert logs["port"] == logs["ref"]
    assert logs["ref"][-1][2] == 0.0
    assert all(s > 0 for _, _, s in logs["ref"][:-1])
