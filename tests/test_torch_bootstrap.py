"""The port's bootstrap (aesfhe_tpu_torch.bootstrap and the engine methods
it adds) against the reference (aesfhe_tpu), on the CPU.

Two chains, as the reference's own tests build them:
  (a) tests/test_bootstrap.py's boot chain: n=2^9, 34 levels, a 30-bit
      first prime, 4 specials, h=16 -- the single-prime tier;
  (b) tests/test_pipeline.py's prod-shaped chain: n=2^10, 54 levels, scale
      2^27, 8 specials, h=192, with hi_prec -- the flagship's arithmetic
      (paired-prime CoeffToSlot and EvalMod) on a small ring.

Default run: the host plans and constants array_equal to the reference's;
the pair rescale, ModRaise, the pair-drop products and the payload sums
torch.equal to the reference's (tiny and (b)), tracked scales with ==; the
port's pair-packed refresh on (a) within the reference's bounds.

`slow`: one bootstrap through both packages from the same ciphertext and
keys, equal bit for bit after every stage, on (a) and (b); the refresh on
(b); the port's 10-round flagship on boot_tiny (FIPS-197 C.1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesfhe_tpu import bootstrap as jbs
from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu.core import ops_impl as jops
from aesfhe_tpu.core.ciphertext import Ciphertext as JCiphertext
from aesfhe_tpu.core.engine import Engine as JEngine
from aesfhe_tpu.core.params import CKKSParams as JCKKSParams
from aesfhe_tpu.core.params import get_params as jget_params
from aesfhe_tpu_torch import bootstrap as tbs
from aesfhe_tpu_torch import interop, run_full_aes
from aesfhe_tpu_torch.context import EngineContext
from aesfhe_tpu_torch.core import engine as tengine
from aesfhe_tpu_torch.core import keys as tkeys
from aesfhe_tpu_torch.core import ops_impl as tops
from aesfhe_tpu_torch.core import rns
from aesfhe_tpu_torch.core.ciphertext import Ciphertext
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import CKKSParams
from aesfhe_tpu_torch.core.params import get_params

SEED = 3
CHAINS = dict(
    a=dict(n=1 << 9, max_level=34, scale_bits=27, first_prime_bits=30,
           num_special_primes=4, secret_hamming=16),
    b=dict(n=1 << 10, max_level=54, scale_bits=27, num_special_primes=8,
           secret_hamming=192))
HI_PREC = dict(a=False, b=True)
# one working level per chain, so the reference compiles one program set
LEVEL = dict(tiny=8, b=12)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """chain name -> (reference params, port params)."""
    out = {name: (JCKKSParams(**kw), CKKSParams(**kw))
           for name, kw in CHAINS.items()}
    out["tiny"] = (jget_params("tiny"), get_params("tiny"))
    return out


@pytest.fixture(scope="module")
def engines(params):
    """chain name -> (reference engine, port engine on the CPU, port relin
    key, the same key as the reference's)."""
    out = {}
    for name in ("tiny", "b"):
        jp, tp = params[name]
        teng = Engine(tp, device="cpu", rng=np.random.default_rng(SEED))
        rlk = teng.create_relinearization_key(teng.create_secret_key())
        jrlk = jkeys.SwitchKey(b=jnp.asarray(interop.to_numpy(rlk.b)),
                               a=jnp.asarray(interop.to_numpy(rlk.a)),
                               cap=None)
        out[name] = (JEngine(jp), teng, rlk, jrlk)
    return out


def _rand(p, rows, lead, seed):
    """uint32 residues [*lead, len(rows), N] under the rows' primes."""
    rng = np.random.default_rng(seed)
    qs = np.asarray(p.all_primes, dtype=np.int64)[np.asarray(rows)]
    x = rng.integers(0, 1 << 62, tuple(lead) + (len(rows), p.n))
    return (x % qs[:, None]).astype(np.uint32)


def _t(a):
    return interop.to_tensor(np.asarray(a), device="cpu")


def _same(got: torch.Tensor, want):
    assert torch.equal(got, _t(want))


def _same_ct(got: Ciphertext, want: JCiphertext):
    assert got.level == want.level
    assert got.scale == want.scale
    _same(got.data, want.data)


def _key(k):
    return interop.switch_key(np.asarray(k.b), np.asarray(k.a),
                              getattr(k, "cap", None), device="cpu")


# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", ["a", "b"])
def test_factored_plans_equal_reference(params, chain):
    jp, tp = params[chain]
    for jplan, tplan in zip(jbs.build_factored_plans(jp),
                            tbs.build_factored_plans(tp), strict=True):
        assert len(jplan) == len(tplan) > 0
        for jg, tg in zip(jplan, tplan, strict=True):
            assert (tg["g"], tg["B"]) == (jg["g"], jg["B"])
            assert tg["baby_steps"] == jg["baby_steps"]
            assert tg["giant_steps"] == jg["giant_steps"]
            assert len(tg["entries"]) == len(jg["entries"])
            for je, te in zip(jg["entries"], tg["entries"], strict=True):
                for k in ("delta", "beta", "gamma"):
                    assert te[k] == je[k]
                assert np.array_equal(te["u"], je["u"])


def test_host_constants_equal_reference(params):
    for gamma in range(-40, 41):
        assert tbs._pow2_hops(gamma) == jbs._pow2_hops(gamma)
        assert sum(tbs._pow2_hops(gamma)) == gamma
    for L in range(1, 21):
        for r in (3, 5):
            assert tbs._group_sizes(L, r) == jbs._group_sizes(L, r)
    for n in (4, 64, 512, 32768):
        assert tbs._bsgs_split(n) == jbs._bsgs_split(n)
    for name in ("a", "b", "tiny"):
        jp, tp = params[name]
        for small in (False, True):
            tK, tda, tdeg = tbs._flavor_config(tp, small)
            assert (tK, tda, tdeg) == jbs._flavor_config(jp, small)
            theta = (2 * np.pi * tK + np.pi / 2) / 2 ** tda

            def f(v):
                return np.cos(theta * v)
            assert np.array_equal(tbs._chebyshev_coeffs(f, tdeg),
                                  jbs._chebyshev_coeffs(f, tdeg))
            tkey = tbs.BootstrapKey(K=tK, double_angles=tda)
            jkey = jbs.BootstrapKey(small=small, K=tK, double_angles=tda)
            for delta in (tp.scale, tp.scale * 1.0371):
                assert tbs.eval_mod_scales(tkey, tp.q_primes[0], delta) == \
                    jbs.eval_mod_scales(jkey, jp.q_primes[0], delta)
    # the dense diagonals and the host apply (the factored plans' checks)
    jp, tp = params["a"]
    half = tp.slot_count
    for tf, jf in zip(tbs._cts_diag(tp, half) + tbs._stc_diag(tp, half),
                      jbs._cts_diag(jp, half) + jbs._stc_diag(jp, half)):
        for d in (0, 1, 37, half - 1):
            assert np.array_equal(tf(d), jf(d))
    stc_plan, _ = tbs.build_factored_plans(tp)
    mat = {e["delta"]: e["u"] for e in stc_plan[0]["entries"]}
    x = np.random.default_rng(1).standard_normal(half) + 0j
    assert np.array_equal(tbs._diag_apply_host(mat, x),
                          jbs._diag_apply_host(mat, x))


def test_interop_bootstrap_key(params, engines):
    """The reference key's scalar fields carried across; plans rebuilt."""
    jp, tp = params["b"]
    _, teng, rlk, _ = engines["b"]
    jkey = jbs.BootstrapKey(small=False, rot=None, K=12.5, cheb_deg=77,
                            double_angles=1, prescale=1.0, hi_prec=True,
                            hi_scale=2.0 ** 54 * 1.01)
    keys = {tp.rot_galois_elt(1): (interop.to_numpy(rlk.b),
                                   interop.to_numpy(rlk.a), None)}
    bk = interop.bootstrap_key(tp, keys, K=jkey.K, cheb_deg=jkey.cheb_deg,
                               double_angles=jkey.double_angles,
                               prescale=jkey.prescale, hi_prec=jkey.hi_prec,
                               hi_scale=jkey.hi_scale, device="cpu")
    for f in ("K", "cheb_deg", "double_angles", "prescale", "hi_prec",
              "hi_scale"):
        assert getattr(bk, f) == getattr(jkey, f)
    assert torch.equal(bk.rot.keys[tp.rot_galois_elt(1)].b, rlk.b)
    stc, cts = jbs.build_factored_plans(jp)
    assert [g["baby_steps"] for g in bk.cts_plan] == \
        [g["baby_steps"] for g in cts]
    assert len(bk.stc_plan) == len(stc)


# ---------------------------------------------------------------------------
# Device half: primitives and engine methods, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", ["tiny", "b"])
def test_rescale_pair_and_mod_raise(engines, chain):
    jeng, teng, _, _ = engines[chain]
    p, jp, jt, tt = teng.params, jeng.params, jeng.tabs, teng.tabs
    lvl = LEVEL[chain]
    a = _rand(p, tops._rows(p, lvl, False), (2,), lvl)
    _same(tops.ct_rescale_pair(p, tt, _t(a)),
          jops.ct_rescale_pair(jp, jt, jnp.asarray(a)))
    a0 = _rand(p, [0], (2,), 1)
    _same(tops.mod_raise_core(p, tt, _t(a0)),
          jops.mod_raise_core(jp, jt, jnp.asarray(a0)))


def test_rescale_pair_centred_boundary(engines):
    """Coefficients at and around the centred test's edges: v = Q/2 and
    Q/2 + 1 (Q = q_a q_b odd), and t = (q_b-1)/2 with v_a on both sides
    of (q_a+1)/2.  Both packages agree, and the port equals the exact
    rounding division (c - centred(c mod Q)) / Q."""
    jeng, teng, _, _ = engines["b"]
    p, tt = teng.params, teng.tabs
    lvl = LEVEL["b"]
    qa, qb = p.q_primes[lvl], p.q_primes[lvl - 1]
    Q, h = qa * qb, (qb - 1) // 2
    edge = [0, 1, Q // 2 - 1, Q // 2, Q // 2 + 1, Q - 1]
    edge += [va + qa * t for t in (h - 1, h, h + 1)
             for va in (0, (qa - 1) // 2, (qa + 1) // 2, qa - 1)]
    rng = np.random.default_rng(7)
    coeffs = [int(x) for x in rng.integers(-(1 << 62), 1 << 62, p.n)]
    for i, v in enumerate(edge):
        coeffs[2 * i] = v + 5 * Q
        coeffs[2 * i + 1] = v - 3 * Q
    primes = p.q_primes[:lvl + 1]
    res = torch.as_tensor([[c % q for c in coeffs] for q in primes],
                          dtype=torch.int64)
    a = tengine._encode_core(p, tt, res, lvl)[None]
    got = tops.ct_rescale_pair(p, tt, a)
    _same(got, jops.ct_rescale_pair(jeng.params, jeng.tabs,
                                    jnp.asarray(interop.to_numpy(a))))
    tr = tops._q_tr(p, tt, lvl - 2)
    plain = rns.from_mont(tops.intt_rows(got[0].long(), tr),
                          tr.q.reshape(-1, 1), tr.rinv.reshape(-1, 1))

    def centred(c):
        r = c % Q
        return r - Q if r >= (Q + 1) // 2 else r

    want = [[((c - centred(c)) // Q) % q for c in coeffs]
            for q in primes[:lvl - 1]]
    assert torch.equal(plain, torch.as_tensor(want, dtype=torch.int64))


@pytest.mark.parametrize("chain", ["tiny", "b"])
def test_engine_pair_products(engines, chain):
    """_rescale_pair, multiply_pair (relinearized on (b); on tiny the
    degree-2 product, whose pair drop runs on three components),
    multiply_renorm."""
    jeng, teng, rlk, jrlk = engines[chain]
    p = teng.params
    lvl = LEVEL[chain]
    rows = tops._rows(p, lvl, False)
    a, b = _rand(p, rows, (2,), 11), _rand(p, rows, (2,), 12)
    sa, sb = p.scale * 1.0137, p.scale * 0.9821
    ta, tb = Ciphertext(_t(a), sa), Ciphertext(_t(b), sb)
    ja, jb = JCiphertext(jnp.asarray(a), sa), JCiphertext(jnp.asarray(b), sb)
    _same_ct(teng._rescale_pair(ta), jeng._rescale_pair(ja))
    relin = chain == "b"
    _same_ct(teng.multiply_pair(ta, tb, rlk if relin else None),
             jeng.multiply_pair(ja, jb, jrlk if relin else None))
    for value, target in ((1.0 / 6.0, sa * 0.75), (0.3 - 1.1j, None),
                          (2.5j, p.scale * 3.1)):
        _same_ct(teng.multiply_renorm(ta, value, target_scale=target),
                 jeng.multiply_renorm(ja, value, target_scale=target))
    assert teng.counters["rescale"] == 5
    assert teng.counters["keyswitch"] == int(relin)


@pytest.mark.parametrize("chain", ["tiny", "b"])
def test_payload_sums(engines, chain):
    """Diagonals encoded at ~2^54: the digit payloads, their batched
    materialization, fused_pt_sum, fused_ptd_sum (rescales 1 and 2) and
    fused_payload_sum."""
    jeng, teng, _, _ = engines[chain]
    p = teng.params
    lvl = LEVEL[chain]
    K = 3
    rng = np.random.default_rng(13)
    enc_scale = 2.0 ** 54 * 1.0371
    vecs = [rng.standard_normal(p.slot_count) +
            1j * rng.standard_normal(p.slot_count) for _ in range(K)]
    tpay = [teng.encode_payload(v, enc_scale) for v in vecs]
    jpay = [jeng.encode_payload(v, enc_scale) for v in vecs]
    assert np.array_equal(np.stack(tpay), np.stack(jpay))
    assert int(np.stack(tpay)[:, 2].max()) > 0      # digits above 2^44 used
    tptd = teng.materialize_payloads(tpay, lvl)
    jptd = jeng.materialize_payloads(jpay, lvl)
    _same(tptd, jptd)
    _same(teng.payload_to_plaintext(tpay[1], lvl, enc_scale).data,
          jeng.payload_to_plaintext(jpay[1], lvl, enc_scale).data)
    data = _rand(p, tops._rows(p, lvl, False), (K, 2), 14)
    s = p.scale * 1.0021
    tcts = [Ciphertext(_t(d), s) for d in data]
    jcts = [JCiphertext(jnp.asarray(d), s) for d in data]
    for rescales in (1, 2):
        _same_ct(teng.fused_ptd_sum(tcts, tptd, enc_scale, rescales),
                 jeng.fused_ptd_sum(jcts, jptd, enc_scale, rescales))
    _same_ct(teng.fused_payload_sum(tcts, tpay, enc_scale, rescales=2),
             jeng.fused_payload_sum(jcts, jpay, enc_scale, rescales=2))
    tpts = [teng.payload_to_plaintext(x, lvl, enc_scale) for x in tpay]
    jpts = [jeng.payload_to_plaintext(x, lvl, enc_scale) for x in jpay]
    _same_ct(teng.fused_pt_sum(list(zip(tcts, tpts)), rescales=2),
             jeng.fused_pt_sum(list(zip(jcts, jpts)), rescales=2))


# ---------------------------------------------------------------------------
# The refresh through the port, and the bootstrap stage by stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", ["a", pytest.param("b",
                                                     marks=pytest.mark.slow)])
def test_port_pair_packed_refresh(params, chain):
    """Two real +-1 planes as p0 + i p1 through one bootstrap, unpacked by a
    conjugation: within the reference's bounds (tests/test_bootstrap.py,
    0.35 and every sign)."""
    _, tp = params[chain]
    ctx = EngineContext(params=tp, device="cpu", rotation_steps=(),
                        rng=np.random.default_rng(SEED), use_bootstrap=True)
    eng = ctx.engine
    bk = ctx.bootstrap_key
    assert bk.hi_prec is (tp.n >= 4096)
    if HI_PREC[chain] and not bk.hi_prec:
        bk = eng.create_bootstrap_key(ctx.secret_key, rot=bk.rot,
                                      hi_prec=True)
    sc = eng.slot_count
    rng = np.random.default_rng(9)
    p0 = 1.0 - 2.0 * rng.integers(0, 2, sc)
    p1 = 1.0 - 2.0 * rng.integers(0, 2, sc)
    packed = eng.add(eng._drop(eng.encrypt(p0, ctx.public_key), 0),
                     eng.multiply_i(eng._drop(eng.encrypt(p1, ctx.public_key),
                                              0)))
    z = eng.bootstrap(packed, ctx.relinearization_key, ctx.conjugation_key, bk)
    zc = eng.conjugate(z, ctx.conjugation_key)
    out0 = eng.linear_combination([z, zc], [0.5, 0.5])
    out1 = eng.linear_combination([z, zc], [-0.5j, 0.5j])
    assert out0.level > 3 and out1.level > 3
    assert eng.counters["bootstrap"] == 1
    assert bk.diag_misses == len(bk.diags) > 0 and bk.diag_hits == 0
    for out, plane in ((out0, p0), (out1, p1)):
        d = eng.decrypt(out, ctx.secret_key)
        assert np.max(np.abs(d - plane)) < 0.35
        assert np.array_equal(np.real(d) < 0, plane < 0)


def _record(monkeypatch, mod, log):
    """Log every ModRaise, CoeffToSlot/SlotToCoeff group, conjugation split
    and EvalMod output of module `mod`'s bootstrap as (stage, residues,
    level, scale)."""
    def entry(name, ct):
        log.append((name, np.asarray(interop.to_numpy(ct.data)
                                     if isinstance(ct.data, torch.Tensor)
                                     else ct.data), ct.level, ct.scale))

    def wrap(fn_name, label):
        fn = getattr(mod, fn_name)

        def inner(*args, **kwargs):
            out = fn(*args, **kwargs)
            name = label(args)
            for i, ct in enumerate(out if isinstance(out, tuple) else (out,)):
                entry(f"{name}{i}", ct)
            return out
        monkeypatch.setattr(mod, fn_name, inner)

    wrap("_mod_raise", lambda a: "mod_raise")
    wrap("_apply_group", lambda a: f"group {a[3]}")
    wrap("_boot_front", lambda a: "conj_split")
    wrap("_eval_mod", lambda a: "eval_mod")


@pytest.mark.slow
@pytest.mark.parametrize("chain", ["a", "b"])
def test_bootstrap_stages_match_reference(params, chain, monkeypatch):
    """The reference's seeded keys and a pair-packed ciphertext through
    both packages: after ModRaise, every CoeffToSlot group, the conjugation
    split, each EvalMod and every SlotToCoeff group the residues, level and
    scale are equal bit for bit."""
    jp, tp = params[chain]
    monkeypatch.setattr(jkeys, "_rng", np.random.default_rng(SEED))
    jeng = JEngine(jp, use_bootstrap=True)
    sk = jeng.create_secret_key()
    pk = jeng.create_public_key(sk)
    rlk = jeng.create_relinearization_key(sk)
    conj = jeng.create_conjugation_key(sk)
    jbk = jbs.create_bootstrap_key(jeng, sk, hi_prec=HI_PREC[chain])
    sc = jp.slot_count
    rng = np.random.default_rng(9)
    p0 = 1.0 - 2.0 * rng.integers(0, 2, sc)
    p1 = 1.0 - 2.0 * rng.integers(0, 2, sc)
    packed = jeng.add(jeng._drop(jeng.encrypt(p0, pk), 0),
                      jeng.multiply_i(jeng._drop(jeng.encrypt(p1, pk), 0)))

    teng = Engine(tp, device="cpu")
    tbk = interop.bootstrap_key(
        tp, {g: (np.asarray(k.b), np.asarray(k.a), k.cap)
             for g, k in jbk.rot.keys.items()},
        K=jbk.K, cheb_deg=jbk.cheb_deg, double_angles=jbk.double_angles,
        prescale=jbk.prescale, hi_prec=jbk.hi_prec, hi_scale=jbk.hi_scale,
        device="cpu")
    tin = interop.ciphertext(np.asarray(packed.data), packed.scale,
                             device="cpu")
    jlog, tlog = [], []
    _record(monkeypatch, jbs, jlog)
    _record(monkeypatch, tbs, tlog)
    jout = jbs.bootstrap(jeng, packed, rlk, conj, jbk)
    tout = tbs.bootstrap(teng, tin, _key(rlk), _key(conj), tbk)
    assert [e[0] for e in tlog] == [e[0] for e in jlog]
    for (name, tdata, tlvl, tscale), (_, jdata, jlvl, jscale) in zip(
            tlog, jlog):
        assert (tlvl, tscale) == (jlvl, jscale), name
        assert np.array_equal(tdata, jdata), name
    _same_ct(tout, jout)
    err = np.max(np.abs(jeng.decrypt(jout, sk) - (p0 + 1j * p1)))
    assert err < 0.35


@pytest.mark.slow
def test_flagship_boot_tiny_fips197():
    """The port's 10-round flagship (run_full_aes) on boot_tiny: 36
    bootstraps, every block equal to AES-128, block 0 FIPS-197 C.1."""
    aes, _ = run_full_aes.setup("boot_tiny", 0, device="cpu")
    state = run_full_aes.make_state(aes.eng.engine.slot_count, 1)
    res = run_full_aes.run_flagship(aes, state, 10)
    assert res["bootstraps"] == 36
    assert res["exact"] and res["fips_block0"]
