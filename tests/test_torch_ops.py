"""The port's ops_impl primitives against the reference's, bit for bit, on
the tiny and deep profiles with the reference's keys carried across
(interop.py).  Inputs are random residues from a numpy seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu.core import ops_impl as jops
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.core import ops_impl as tops
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import get_params


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores, and torch's default pool of one
    thread per core then stalls in its barriers (a 7 s round took minutes);
    two threads run these tests as fast when alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["tiny", "deep"])
def pair(request):
    """(reference engine dict, port engine on the CPU, profile name)."""
    E = request.getfixturevalue(f"{request.param}_engine")
    return E, Engine(get_params(request.param), device="cpu"), request.param


def _rand(p, rows, lead, seed):
    """uint32 residues [*lead, len(rows), N] under the rows' primes."""
    rng = np.random.default_rng(seed)
    qs = np.asarray(p.all_primes, dtype=np.int64)[np.asarray(rows)]
    x = rng.integers(0, 1 << 62, tuple(lead) + (len(rows), p.n))
    return (x % qs[:, None]).astype(np.uint32)


def _same(got: torch.Tensor, want):
    assert torch.equal(got, interop.to_tensor(np.asarray(want), device="cpu"))


def _t(a):
    return interop.to_tensor(np.asarray(a), device="cpu")


def _key(jkey):
    return interop.switch_key(np.asarray(jkey.b), np.asarray(jkey.a),
                              getattr(jkey, "cap", None), device="cpu")


def test_elementwise_and_sums(pair):
    E, teng, _ = pair
    jeng = E["eng"]
    p = teng.params
    lvl = min(5, p.top_level)
    rows = tops._rows(p, lvl, False)
    a, b = _rand(p, rows, (2,), 1), _rand(p, rows, (2,), 2)
    jp, jt, tt = jeng.params, jeng.tabs, teng.tabs
    for name in ("ct_add", "ct_sub", "ct_tensor"):
        _same(getattr(tops, name)(p, tt, _t(a), _t(b)),
              getattr(jops, name)(jp, jt, jnp.asarray(a), jnp.asarray(b)))
    _same(tops.ct_negate(p, tt, _t(a)), jops.ct_negate(jp, jt, jnp.asarray(a)))
    pt = _rand(p, rows, (), 3)
    _same(tops.ct_mul_dense_pt(p, tt, _t(a), _t(pt)),
          jops.ct_mul_dense_pt(jp, jt, jnp.asarray(a), jnp.asarray(pt)))
    # scalar-constant tables from the engines themselves (same encoding)
    for value, scale in ((0.37 - 1.25j, p.scale), (1j, 1.0)):
        tc = teng._scalar_mul_consts(value, scale, lvl, mont=False)
        jc = jeng._scalar_mul_consts(value, scale, lvl, mont=False)
        _same(tc, jc)
        _same(tops.ct_mul_scalar_pt(p, tt, _t(a), tc),
              jops.ct_mul_scalar_pt(jp, jt, jnp.asarray(a), jc))
    tm = teng._scalar_mul_consts(-0.5 + 2j, p.scale, lvl, mont=True)
    jm = jeng._scalar_mul_consts(-0.5 + 2j, p.scale, lvl, mont=True)
    _same(tm, jm)
    _same(tops.ct_add_scalar_pt(p, tt, _t(a), tm),
          jops.ct_add_scalar_pt(jp, jt, jnp.asarray(a), jm))
    K = 3
    stack = _rand(p, rows, (K, 2), 4)
    consts = np.stack([np.asarray(jeng._scalar_mul_consts(v, p.scale, lvl,
                                                          mont=False))
                       for v in (0.5, -0.25j, 1.5 + 0.5j)])
    _same(tops.ct_linear_combo(p, tt, _t(stack), _t(consts)),
          jops.ct_linear_combo(jp, jt, jnp.asarray(stack),
                               jnp.asarray(consts)))
    pts = _rand(p, rows, (K,), 5)
    _same(tops.ct_linear_combo_dense(p, tt, _t(stack), _t(pts)),
          jops.ct_linear_combo_dense(jp, jt, jnp.asarray(stack),
                                     jnp.asarray(pts)))
    b_stack = _rand(p, rows, (K, 2), 6)
    _same(tops.ct_tensor_sum(p, tt, _t(stack), _t(b_stack)),
          jops.ct_tensor_sum(jp, jt, jnp.asarray(stack),
                             jnp.asarray(b_stack)))
    _same(tops.ct_rescale(p, tt, _t(a)),
          jops.ct_rescale(jp, jt, jnp.asarray(a)))
    perm = p.galois_perm(p.rot_galois_elt(3))
    _same(tops.ct_automorphism(p, tt, _t(a), torch.as_tensor(perm).long()),
          jops.ct_automorphism(jp, jt, jnp.asarray(a), jnp.asarray(perm)))


def test_walsh_sub_bytes_core(tiny_engine):
    jeng = tiny_engine["eng"]
    teng = Engine(get_params("tiny"), device="cpu")
    p = teng.params
    lvl = 3
    rows = tops._rows(p, lvl, False)
    a, b = _rand(p, rows, (16, 2), 7), _rand(p, rows, (16, 2), 8)
    w = _rand(p, rows, (8, 16, 16), 9)
    sh = ((w.astype(np.uint64) << np.uint64(32)) //
          np.asarray(p.q_primes[:lvl + 1], dtype=np.uint64)[:, None])
    consts = np.stack([w[..., 0], sh[..., 0].astype(np.uint32)], axis=-1)
    _same(tops.walsh_sub_bytes_core(p, teng.tabs, _t(a), _t(b), _t(consts)),
          jops.walsh_sub_bytes_core(jeng.params, jeng.tabs, jnp.asarray(a),
                                    jnp.asarray(b), jnp.asarray(consts)))


def test_keyswitch_paths(pair):
    """ks_decompose, keyswitch (relin key, full layout), hoisted_rotate
    (rotation key) and the fused mod-down; the exact mod-down oracle on
    tiny (its sequential per-prime NTTs are slow in the reference)."""
    E, teng, profile = pair
    jeng = E["eng"]
    p, jp, jt, tt = teng.params, jeng.params, jeng.tabs, teng.tabs
    rlk = _key(E["rlk"])
    g = p.rot_galois_elt(1)
    rot = _key(E["rot"].keys[g])
    perm = p.galois_perm(g)
    for lvl in ((p.top_level,) if profile == "tiny" else (7,)):
        rows = tops._rows(p, lvl, False)
        c = _rand(p, rows, (), 10 + lvl)
        d_t = tops.ks_decompose(p, tt, _t(c))
        d_j = jops.ks_decompose(jp, jt, jnp.asarray(c))
        _same(d_t, d_j)
        bt, at = tops.keyswitch(p, tt, _t(c), rlk.b, rlk.a)
        bj, aj = jops.keyswitch(jp, jt, jnp.asarray(c), E["rlk"].b,
                                E["rlk"].a)
        _same(bt, bj)
        _same(at, aj)
        data = _rand(p, rows, (2,), 20 + lvl)
        _same(tops.hoisted_rotate(p, tt, _t(data), d_t,
                                  torch.as_tensor(perm).long(), rot.b, rot.a),
              jops.hoisted_rotate(jp, jt, jnp.asarray(data), d_j,
                                  jnp.asarray(perm), E["rot"].keys[g].b,
                                  E["rot"].keys[g].a))
        x = _rand(p, tops._rows(p, lvl, True), (2,), 30 + lvl)
        _same(tops._mod_down_specials(p, tt, _t(x).long(), lvl).int(),
              jops._mod_down_specials(jp, jt, jnp.asarray(x), lvl))
        if profile == "tiny":
            _same(tops._mod_down_specials_exact(p, tt, _t(x[0]).long(),
                                                lvl).int(),
                  jops._mod_down_specials_exact(jp, jt, jnp.asarray(x[0]),
                                                lvl))


def test_capped_key_keyswitch(tiny_engine, monkeypatch):
    """A level-capped Galois key (SwitchKey.cap) in its stored layout."""
    jeng = tiny_engine["eng"]
    teng = Engine(get_params("tiny"), device="cpu")
    p = teng.params
    monkeypatch.setattr(jkeys, "_rng", np.random.default_rng(21))
    jk = jkeys.gen_galois_key(jeng.params, jeng.tabs, tiny_engine["sk"],
                              p.rot_galois_elt(2), lvl_cap=5)
    tk = _key(jk)
    assert tk.b.shape[1] == 5 + 1 + p.num_special
    c = _rand(p, tops._rows(p, 4, False), (), 22)
    bt, at = tops.keyswitch(p, teng.tabs, _t(c), tk.b, tk.a, tk.cap)
    bj, aj = jops.keyswitch(jeng.params, jeng.tabs, jnp.asarray(c), jk.b,
                            jk.a, jk.cap)
    _same(bt, bj)
    _same(at, aj)
