"""The port's host tables, RNS arithmetic and NTT against the reference,
bit for bit (torch.equal on the same uint32 bits), plus the import rule:
importing every module of the port loads neither jax nor aesfhe_tpu."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesfhe_tpu.core import ntt as jntt
from aesfhe_tpu.core import rns as jrns
from aesfhe_tpu.core.params import get_params as jparams
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.core import ntt as tntt
from aesfhe_tpu_torch.core import rns as trns
from aesfhe_tpu_torch.core.params import get_params as tparams

ALL = ["tiny", "test", "deep", "hp", "boot_tiny", "prod", "prod_boot",
       "prod_hp"]
SMALL = ["tiny", "test", "deep", "hp", "boot_tiny"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("profile", ALL)
def test_prime_chains(profile):
    jp, tp = jparams(profile), tparams(profile)
    assert tp.q_primes == jp.q_primes
    assert tp.special_primes == jp.special_primes
    assert tp.groups == jp.groups and tp.dnum == jp.dnum
    assert tp.rescale_primes == jp.rescale_primes


@pytest.mark.parametrize("profile", SMALL)
def test_full_tables(profile):
    jp, tp = jparams(profile), tparams(profile)
    for name in ("w", "w_sh", "wi", "wi_sh", "ninv", "ninv_sh", "q"):
        assert np.array_equal(getattr(tp.tables, name),
                              getattr(jp.tables, name)), name
    assert tp.tables.psi == jp.tables.psi
    for name in ("q_arr", "qinv_arr", "r2_arr", "magic_arr", "sigma",
                 "pos_of_exp", "slot_pos", "conj_slot_pos", "xhalf_sign_neg",
                 "zeta4", "psi_c_pow", "psi_c_pow_inv"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name)), name
    for g in (tp.conj_galois_elt, tp.rot_galois_elt(1), tp.rot_galois_elt(-3)):
        assert g in (jp.conj_galois_elt, jp.rot_galois_elt(1),
                     jp.rot_galois_elt(-3))
        assert np.array_equal(tp.galois_perm(g), jp.galois_perm(g))
    for level in (0, tp.top_level // 2, tp.top_level):
        tk, jk = tp.ks_tables(level), jp.ks_tables(level)
        assert np.array_equal(tk["basis"], jk["basis"])
        for a, b in zip(tk["groups"], jk["groups"], strict=True):
            assert a["limbs"] == b["limbs"]
            for k in ("inv_w", "inv_sh", "conv_w", "conv_sh"):
                assert np.array_equal(a[k], b[k]), (level, k)
        tm, jm = tp.md_tables(level), jp.md_tables(level)
        for k in jm:
            assert np.array_equal(tm[k], jm[k]), (level, k)


def _u32(rng, n, q):
    """Random uint32 with 0, q-1, q and the top values forced in."""
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    x[:5] = [0, q - 1, q, (1 << 32) - 1, 1 << 31]
    return x


def _res(rng, n, q):
    """Random canonical residues < q, with 0 and q-1."""
    x = rng.integers(0, q, n, dtype=np.uint32)
    x[:2] = [0, q - 1]
    return x


@pytest.mark.parametrize("q", [tparams("tiny").q_primes[0],
                               tparams("deep").q_primes[7],
                               tparams("prod_boot").special_primes[-1],
                               (1 << 30) - 35])
def test_rns_functions(q):
    """Each primitive on its stated domain: add/sub/neg on canonical
    residues; mont_mul with a < q and any uint32 b; shoup_mul, to_mont,
    from_mont and barrett_reduce on any uint32 (x >= q included)."""
    rng = np.random.default_rng(q % 1000)
    n = 4096
    qinv, r2 = jrns.montgomery_consts(q)
    rinv = trns.mont_rinv(q)
    a, b = _res(rng, n, q), _res(rng, n, q)
    x = _u32(rng, n, q)
    w = int(rng.integers(1, q))
    ja, jb, jx = jnp.asarray(a), jnp.asarray(b), jnp.asarray(x)
    jq = jnp.uint32(q)

    def t(v):
        return trns.widen(interop.to_tensor(np.asarray(v, dtype=np.uint32),
                                            device="cpu"))

    def same(got, want):
        assert torch.equal(trns.narrow(got),
                           interop.to_tensor(np.asarray(want), device="cpu"))

    same(trns.add_mod(t(a), t(b), q), jrns.add_mod(ja, jb, jq))
    same(trns.sub_mod(t(a), t(b), q), jrns.sub_mod(ja, jb, jq))
    same(trns.neg_mod(t(a), q), jrns.neg_mod(ja, jq))
    same(trns.mont_mul(t(a), t(x), q, rinv),
         jrns.mont_mul(ja, jx, jq, jnp.uint32(qinv)))
    same(trns.shoup_mul(t(x), w, q),
         jrns.shoup_mul(jx, jnp.uint32(w),
                        jnp.uint32(jrns.shoup_precompute(w, q)), jq))
    same(trns.to_mont(t(x), q, r2, rinv),
         jrns.to_mont(jx, jq, jnp.uint32(qinv), jnp.uint32(r2)))
    same(trns.from_mont(t(x), q, rinv),
         jrns.from_mont(jx, jq, jnp.uint32(qinv)))
    same(trns.barrett_reduce(t(x), q),
         jrns.barrett_reduce(jx, jq, jnp.uint32(jrns.barrett_magic(q))))
    assert trns.montgomery_consts(q) == (qinv, r2)
    assert trns.shoup_precompute(w, q) == jrns.shoup_precompute(w, q)


def test_crt_to_centered_float():
    p = tparams("deep")
    primes = p.q_primes[:6]
    rng = np.random.default_rng(3)
    v = rng.integers(-(1 << 50), 1 << 50, 512)
    res = np.stack([np.mod(v, q) for q in primes]).astype(np.uint64)
    got = trns.crt_to_centered_float(res, primes)
    assert np.array_equal(got, jrns.crt_to_centered_float(res, primes))
    assert np.array_equal(got, v.astype(np.float64))


@pytest.mark.parametrize("profile", ["tiny", "test"])
def test_ntt_fwd_inv(profile):
    """Against the reference NTT the CPU backend runs (ops_impl.ntt_rows
    picks ntt.ntt_fwd there; its MXU form is asserted equal upstream)."""
    p, jp = tparams(profile), jparams(profile)
    t = p.tables
    rng = np.random.default_rng(11)
    x = np.stack([rng.integers(0, q, p.n, dtype=np.uint32)
                  for q in p.all_primes])
    x2 = np.stack([x, x[:, ::-1].copy()])           # a leading batch axis
    q = torch.as_tensor(p.all_primes, dtype=torch.int64)

    def c64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64))

    fwd = tntt.ntt_fwd(c64(x2), c64(t.w), q)
    jt = jp.tables
    want = jntt.ntt_fwd(jnp.asarray(x2), jnp.asarray(jt.w),
                        jnp.asarray(jt.w_sh), jnp.asarray(jt.q))
    assert torch.equal(trns.narrow(fwd),
                       interop.to_tensor(np.asarray(want), device="cpu"))
    inv = tntt.ntt_inv(fwd, c64(t.wi), q, c64(t.ninv))
    want_inv = jntt.ntt_inv(want, jnp.asarray(jt.wi), jnp.asarray(jt.wi_sh),
                            jnp.asarray(jt.q), jnp.asarray(jt.ninv),
                            jnp.asarray(jt.ninv_sh))
    assert torch.equal(trns.narrow(inv),
                       interop.to_tensor(np.asarray(want_inv), device="cpu"))
    assert torch.equal(trns.narrow(inv), interop.to_tensor(x2, device="cpu"))


def test_interop_round_trip():
    """uint32 arrays -> the port's objects -> the same arrays, bits intact
    (values >= 2^31 included)."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1 << 32, (2, 3, 16), dtype=np.uint64)
    data = data.astype(np.uint32)
    ct = interop.ciphertext(data, 2.0 ** 27, device="cpu")
    assert ct.data.dtype == torch.int32 and ct.level == 2
    back, scale = interop.ciphertext_arrays(ct)
    assert np.array_equal(back, data) and scale == 2.0 ** 27
    key = interop.switch_key(data, data[::-1].copy(), cap=4, device="cpu")
    b, a, cap = interop.switch_key_arrays(key)
    assert np.array_equal(b, data) and np.array_equal(a, data[::-1])
    assert cap == 4
    with pytest.raises(TypeError, match="uint32"):
        interop.to_tensor(data.astype(np.int64), device="cpu")


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py's imports)
    leaves jax and aesfhe_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import aesfhe_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'aesfhe_tpu' or m.startswith('aesfhe_tpu.')]\n"
        "assert not bad, bad\n"
        "assert {'aesfhe_tpu_torch.bootstrap', 'aesfhe_tpu_torch.run_full_aes',"
        " 'aesfhe_tpu_torch.profile_round', 'aesfhe_tpu_torch.__main__',"
        " 'aesfhe_tpu_torch.coeffs.generate', 'aesfhe_tpu_torch.coeffs.cache',"
        " 'aesfhe_tpu_torch.utils.aes_utils', 'aesfhe_tpu_torch.ops.zeta',"
        " 'aesfhe_tpu_torch.ops.gf_service', 'aesfhe_tpu_torch.ops.sbox_service',"
        " 'aesfhe_tpu_torch.ops.shiftrows_service',"
        " 'aesfhe_tpu_torch.ops.mixcolumns_service',"
        " 'aesfhe_tpu_torch.ops.round_service',"
        " 'aesfhe_tpu_torch.ops.shift_mix_variants',"
        " 'aesfhe_tpu_torch.zeta_trace', 'aesfhe_tpu_torch.graft_entry',"
        " 'aesfhe_tpu_torch.run_multihost', 'aesfhe_tpu_torch.parallel.mesh',"
        " 'aesfhe_tpu_torch.parallel.comm', 'aesfhe_tpu_torch.parallel.comm_ledger',"
        " 'aesfhe_tpu_torch.parallel.dist_keyswitch',"
        " 'aesfhe_tpu_torch.parallel.mesh_engine',"
        " 'aesfhe_tpu_torch.parallel.dist_ntt', 'aesfhe_tpu_torch.parallel.batch',"
        " 'aesfhe_tpu_torch.parallel.failure', 'aesfhe_tpu_torch.parallel.launch',"
        " 'aesfhe_tpu_torch.parallel.multihost', 'aesfhe_tpu_torch.bench'}"
        " <= set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('aesfhe_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 44


def test_cli_demo_xor_needs_a_card_unless_told_cpu(capsys):
    """`python -m aesfhe_tpu_torch demo-xor` runs on the card by default:
    without one it raises; with --device cpu it runs and exits 0."""
    from aesfhe_tpu_torch.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["demo-xor"])
    with pytest.raises(SystemExit) as done:
        main(["demo-xor", "--profile", "tiny", "--device", "cpu"])
    assert done.value.code == 0
    assert "correct=True" in capsys.readouterr().out


# the chains of each special-prime count K: 2 (tiny), 3 (test), 4
# (boot_tiny), 6 (deep), 8 (prod_boot's shape on N=2^10), at a level each
VHAT_CASES = [("tiny", 4), ("test", 10), ("boot_tiny", 30), ("deep", 20),
              ("prod_shape_n1024", 16)]


def _params_pair(name):
    if name == "prod_shape_n1024":
        from aesfhe_tpu.core.params import CKKSParams as JP
        from aesfhe_tpu_torch.core.params import CKKSParams as TP
        kw = dict(n=1 << 10, max_level=54, scale_bits=27,
                  num_special_primes=8, secret_hamming=192)
        return JP(**kw), TP(**kw)
    return jparams(name), tparams(name)


@pytest.mark.parametrize("name,level", VHAT_CASES)
def test_mod_down_vhat_at_half_integers(name, level):
    """The fused mod-down's f32 overshoot estimate v_hat = round(sum_i
    y_i/p_i) on inputs built so that every coefficient's sum lies within a
    few 1e-8 of a half-integer, where the float32 summation order decides
    the rounding: the port's residues equal the reference's compiled
    mod-down on every coefficient (2 x N of them, both components)."""
    import functools

    import jax
    from aesfhe_tpu.core import ops_impl as jops
    from aesfhe_tpu.core.engine import Engine as JEngine
    from aesfhe_tpu_torch.core import ops_impl as tops
    from aesfhe_tpu_torch.core.engine import Engine
    jp, tp = _params_pair(name)
    K, lp1, n = tp.num_special, level + 1, tp.n
    tabs = Engine(tp, device="cpu").tabs
    ref = jax.jit(functools.partial(jops._mod_down_specials, jp,
                                    JEngine(jp).tabs), static_argnums=1)
    rng = np.random.default_rng(level)
    ps = np.asarray(tp.special_primes, dtype=np.int64)
    # y_i = d_i * (P/p_i)^-1 mod p_i; pick y, set y_0 so sum_i y_i/p_i sits
    # at a half-integer to within 40/p_0, and invert to the special limbs
    y = rng.integers(0, 1 << 62, (2, K, n)) % ps[:, None]
    rest = (y[:, 1:] / ps[1:, None]).sum(1)
    y0 = np.round((np.ceil(rest - 0.5) + 0.5 - rest) * ps[0]).astype(np.int64)
    y[:, 0] = np.clip(y0 + rng.integers(-40, 41, (2, n)), 0, ps[0] - 1)
    inv_w = np.asarray(tp.md_tables(level)["inv_w"], dtype=np.int64)
    w = np.array([pow(int(a), -1, int(p)) for a, p in zip(inv_w, ps)])
    d = torch.as_tensor((y * w[:, None]) % ps[:, None])
    tr = tabs.rows(np.arange(tp.num_q, tp.num_q + K))
    spec = tops.ntt_rows(trns.to_mont(d, tr.q.reshape(K, 1),
                                      tr.r2.reshape(K, 1),
                                      tr.rinv.reshape(K, 1)), tr)
    qs = np.asarray(tp.q_primes[:lp1], dtype=np.int64)
    xq = torch.as_tensor(rng.integers(0, 1 << 62, (2, lp1, n)) % qs[:, None])
    x = torch.cat([xq, spec], dim=1)
    got = tops._mod_down_specials(tp, tabs, x, level)
    want = ref(jnp.asarray(interop.to_numpy(x.int())), level)
    assert torch.equal(got.int(), interop.to_tensor(np.asarray(want),
                                                    device="cpu"))
