"""The key-switch legs' kernels (`aesfhe_tpu_torch/core/ks_legs.py`:
ks_modup, ks_moddown, sub_scale) on the CPU, where each wrapper runs its
plain version: exact (torch.equal) against the reference's ks_decompose,
its padded digit tables, its fused mod-down (random inputs and inputs at
float32 half-integers of the v_hat sum) and the epilogue's arithmetic; the
CPU model of the conversion kernels' digit arithmetic (u8 digit matrices,
int32 products, the 32-bit fold) against the plain versions; and the
wrappers' argument checks.  The kernels themselves run on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesfhe_tpu.core import ops_impl as jops
from aesfhe_tpu.core.engine import Engine as JEngine
from aesfhe_tpu.core.params import CKKSParams as JCKKSParams
from aesfhe_tpu.core.params import get_params as jget_params
from aesfhe_tpu.parallel.dist_keyswitch import _padded_digit_tables
from aesfhe_tpu_torch import bench, interop
from aesfhe_tpu_torch.core import ks_legs
from aesfhe_tpu_torch.core import ops_impl as tops
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import CKKSParams
from aesfhe_tpu_torch.core.params import get_params
from aesfhe_tpu_torch.parallel.mesh import digit_pad

# tests/test_torch_bootstrap.py's chain (b): prod_boot's shape (K = 8
# special primes, digits of 8 limbs) on N=2^10
CHAIN_B = dict(n=1 << 10, max_level=54, scale_bits=27, num_special_primes=8,
               secret_hamming=192)
# parameter sets past one k-step of the conversion kernels (more than 8
# primes in a digit or in the special set) and a chain with primes below
# 2^16 (30, 15, 14, 16, 16 bits; specials of 30), all on N=2^10
WIDE = {"k9": dict(num_special_primes=9), "k10": dict(num_special_primes=10),
        "k16": dict(num_special_primes=16),
        "alpha9": dict(num_special_primes=10, alpha=9),
        "k20": dict(max_level=20, num_special_primes=20)}
WIDE = {k: dict(dict(n=1 << 10, max_level=12, scale_bits=26), **v)
        for k, v in WIDE.items()}
WIDE["scale14"] = dict(n=1 << 10, max_level=4, scale_bits=14)
# one wide level each: (profile, level), K = 2, 3, 6, 8; then digits of 9,
# 10, 13 (one digit, K = 16) and 9 limbs (K = 10), and the small primes
MODUP_CASES = [("tiny", 8), ("test", 16), ("deep", 41), ("b", 54),
               ("k9", 12), ("k10", 12), ("k16", 12), ("alpha9", 12),
               ("scale14", 4)]
# the special-prime counts K = 2 (tiny), 3 (test), 4 (boot_tiny), 6 (deep),
# 8 (chain b), at a level each; then K = 9, 10, 16 and 10 (alpha 9), and
# the small primes
MODDOWN_CASES = [("tiny", 4), ("test", 10), ("boot_tiny", 30), ("deep", 20),
                 ("b", 16), ("k9", 12), ("k10", 7), ("k16", 12),
                 ("alpha9", 12), ("scale14", 4)]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference params, port params, port tables on the CPU)."""
    if name == "b" or name in WIDE:
        kw = CHAIN_B if name == "b" else WIDE[name]
        jp, tp = JCKKSParams(**kw), CKKSParams(**kw)
    else:
        jp, tp = jget_params(name), get_params(name)
    return jp, tp, Engine(tp, device="cpu").tabs


@functools.lru_cache(maxsize=None)
def _jtabs(name):
    """The reference's device tables of the profile."""
    return JEngine(_pair(name)[0]).tabs


def _residues(p, rows, lead, rng):
    qs = np.asarray(p.all_primes, dtype=np.int64)[np.asarray(rows)]
    x = rng.integers(0, 1 << 62, tuple(lead) + (len(rows), p.n))
    return x % qs[:, None]


def _t(a):
    return interop.to_tensor(np.asarray(a).astype(np.uint32), device="cpu")


@pytest.mark.parametrize("name,level", MODUP_CASES)
def test_ks_decompose_matches_reference(name, level):
    """The port's ks_decompose (INTT, ks_modup, NTT) equals the
    reference's on every digit at one wide level of each profile."""
    jp, tp, tabs = _pair(name)
    c = _residues(tp, tops._rows(tp, level, False), (),
                  np.random.default_rng(level))
    got = tops.ks_decompose(tp, tabs, _t(c))
    want = jops.ks_decompose(jp, _jtabs(name), jnp.asarray(c, jnp.uint32))
    assert got.shape[0] == len(tp.ks_tables(level)["groups"])
    assert torch.equal(got, interop.to_tensor(np.asarray(want), device="cpu"))


@pytest.mark.parametrize("name,level,D", [("b", 54, 2), ("b", 54, 4),
                                          ("b", 30, 4), ("deep", 41, 4),
                                          ("k9", 12, 4)])
def test_modup_digit_ranges_match_padded_tables(name, level, D):
    """ks_modup over each rank's digit range [r*pad/D, (r+1)*pad/D) equals
    the basis extension through the reference's padded digit tables
    (`parallel/dist_keyswitch.py:_padded_digit_tables`: inv_w = 0 past the
    active digits; at level 30 of chain b and level 41 of deep the last
    ranks hold padding only; k9's digits have 9 and 4 limbs); and the
    port's ks_decompose(j0, j1) is the full decomposition's rows, zero past
    the active digits."""
    _, tp, tabs = _pair(name)
    pad = digit_pad(tp.dnum, D)
    per = pad // D
    t = _padded_digit_tables(tp, level, pad)
    assert pad > t["dnum"]
    c = _residues(tp, tops._rows(tp, level, False), (),
                  np.random.default_rng(D))
    basis = t["basis"].astype(np.int64)[:, None]
    want = []
    for j in range(pad):
        acc = np.zeros((t["M"], tp.n), dtype=np.int64)
        for a in range(t["idx"].shape[1]):
            y = (c[t["idx"][j, a]] * int(t["inv_w"][j, a])
                 % int(t["q_limb"][j, a]))
            acc = (acc + y[None, :] * t["conv_w"][j, a].astype(np.int64)
                   [:, None] % basis) % basis
        want.append(acc)
    want = torch.as_tensor(np.stack(want)).to(torch.int32)
    tab = ks_legs.ModupTables(tp, level, "cpu")
    c_eval = tops.ntt_rows(_t(c), tops._q_tr(tp, tabs, level), to_mont=True,
                           out_dtype=torch.int32)
    full = tops.ks_decompose(tp, tabs, c_eval)
    live = full.shape[0]
    for r in range(D):
        j0, j1 = r * per, (r + 1) * per
        assert torch.equal(ks_legs.ks_modup(_t(c), tab, j0, j1), want[j0:j1])
        part = tops.ks_decompose(tp, tabs, c_eval, j0, j1)
        assert torch.equal(part[:max(0, live - j0)], full[j0:j1])
        assert not part[max(0, live - j0):].any()


def _half_integer_input(tp, tabs, level, rng):
    """[2, l+1+K, N] over (q | specials), the special limbs built so that
    every coefficient's sum_i y_i/p_i lies within a few 1e-8 of a
    half-integer (tests/test_torch_core.py's construction)."""
    K, lp1, n = tp.num_special, level + 1, tp.n
    ps = np.asarray(tp.special_primes, dtype=np.int64)
    y = rng.integers(0, 1 << 62, (2, K, n)) % ps[:, None]
    rest = (y[:, 1:] / ps[1:, None]).sum(1)
    y0 = np.round((np.ceil(rest - 0.5) + 0.5 - rest) * ps[0]).astype(np.int64)
    y[:, 0] = np.clip(y0 + rng.integers(-40, 41, (2, n)), 0, ps[0] - 1)
    inv_w = np.asarray(tp.md_tables(level)["inv_w"], dtype=np.int64)
    w = np.array([pow(int(a), -1, int(p)) for a, p in zip(inv_w, ps)])
    d = torch.as_tensor((y * w[:, None]) % ps[:, None])
    tr = tabs.rows(np.arange(tp.num_q, tp.num_q + K))
    spec = tops.ntt_rows(d, tr, to_mont=True)
    qs = np.asarray(tp.q_primes[:lp1], dtype=np.int64)
    xq = torch.as_tensor(rng.integers(0, 1 << 62, (2, lp1, n)) % qs[:, None])
    return torch.cat([xq, spec], dim=1).to(torch.int32)


@pytest.mark.parametrize("name,level", MODDOWN_CASES)
def test_mod_down_matches_reference(name, level):
    """_mod_down_specials (INTT, ks_moddown, NTT, sub_scale) equals the
    reference's compiled mod-down on two random components and two at
    float32 half-integers of the v_hat sum (one compiled program for
    both)."""
    jp, tp, tabs = _pair(name)
    rng = np.random.default_rng(level)
    ref = jax.jit(functools.partial(jops._mod_down_specials, jp,
                                    _jtabs(name)), static_argnums=1)
    for x in (_t(_residues(tp, tops._rows(tp, level, True), (2,), rng)),
              _half_integer_input(tp, tabs, level, rng)):
        want = interop.to_tensor(np.asarray(ref(
            jnp.asarray(interop.to_numpy(x)), level)), device="cpu")
        assert torch.equal(tops._mod_down_specials(tp, tabs, x, level), want)


@pytest.fixture(scope="module", params=["k16", "k20", "scale14"])
def keyed(request):
    """One seeded key family (secret, public, relinearization and the step-1
    rotation key) on each side, drawn in the same order from the same seed
    (the reference's module RNG is put back afterwards), at k16 (one digit
    of 13 limbs, K = 16), k20 (one digit of 21 limbs, K = 20: three chunks
    each way) and scale14 (primes below 2^16)."""
    from aesfhe_tpu.core import keys as jkeys
    name = request.param
    jp, tp, _ = _pair(name)
    jeng, teng = JEngine(jp), Engine(tp, device="cpu",
                                     rng=np.random.default_rng(5))
    saved, jkeys._rng = jkeys._rng, np.random.default_rng(5)
    try:
        jsk = jeng.create_secret_key()
        j = dict(pk=jeng.create_public_key(jsk),
                 rlk=jeng.create_relinearization_key(jsk),
                 rot=jeng.create_fixed_rotation_key(jsk, [1]))
    finally:
        jkeys._rng = saved
    tsk = teng.create_secret_key()
    t = dict(pk=teng.create_public_key(tsk),
             rlk=teng.create_relinearization_key(tsk),
             rot=teng.create_fixed_rotation_key(tsk, [1]))
    return name, jeng, teng, j, t


def test_relinearize_and_rotate_match_reference(keyed):
    """Engine.relinearize (a random degree-2 ciphertext at the top level)
    and Engine.rotate by one slot (an encryption, carried across) through
    both packages, from the same seeded keys: the same residues."""
    from aesfhe_tpu.core.ciphertext import Ciphertext as JCiphertext
    from aesfhe_tpu_torch.core.ciphertext import Ciphertext
    name, jeng, teng, j, t = keyed
    tp = teng.params
    assert torch.equal(t["rlk"].b, interop.to_tensor(np.asarray(j["rlk"].b),
                                                     device="cpu"))
    rng = np.random.default_rng(9)
    top = tp.top_level
    c3 = _residues(tp, tops._rows(tp, top, False), (3,), rng)
    got = teng.relinearize(Ciphertext(_t(c3), 2.0 ** 20), t["rlk"]).data
    want = jeng.relinearize(JCiphertext(jnp.asarray(c3, jnp.uint32),
                                        2.0 ** 20), j["rlk"]).data
    assert torch.equal(got, interop.to_tensor(np.asarray(want),
                                              device="cpu"))
    ct = teng.encrypt(rng.uniform(-1, 1, tp.slot_count), t["pk"])
    got = teng.rotate(ct, t["rot"], 1).data
    want = jeng.rotate(JCiphertext(jnp.asarray(interop.to_numpy(ct.data)),
                                   ct.scale), j["rot"], 1).data
    assert torch.equal(got, interop.to_tensor(np.asarray(want),
                                              device="cpu"))


def _scale_want(x, y, q, w):
    """(x - y) * w mod q row by row in Python integers."""
    x, y = x.numpy().astype(object), y.numpy().astype(object)
    q = np.asarray(q, dtype=object)[:, None]
    w = np.asarray(w, dtype=object)[:, None]
    return torch.as_tensor(((x - y) % q * w % q).astype(np.int64)
                           ).to(torch.int32)


@pytest.mark.parametrize("view", ["rows", "batch", "plain"])
def test_sub_scale_on_strided_views(view):
    """sub_scale reads x through its strides: the leading rows of a wider
    tensor (a mod-down's q rows of [2, M, N]), every other component of a
    batch, or a plain [R, N]; y is the NTT's contiguous output."""
    _, tp, _ = _pair("test")
    rng = np.random.default_rng(7)
    R = 9
    qs = [int(q) for q in tp.q_primes[:R]]
    ws = [int(v) for v in rng.integers(0, 1 << 62, R) % qs]
    tab = torch.as_tensor(ks_legs.scale_table(qs, ws))
    wide = _t(_residues(tp, tops._rows(tp, R + 3, False), (4,), rng))
    x = dict(rows=wide[:2, :R], batch=wide[::2, :R], plain=wide[0, :R])[view]
    assert x.is_contiguous() == (view == "plain")
    y = _t(_residues(tp, tops._rows(tp, R - 1, False), x.shape[:-2], rng))
    assert torch.equal(ks_legs.sub_scale(x, y, tab),
                       _scale_want(x, y, qs, ws))


@pytest.mark.parametrize("case", ["modup dtype", "modup shape",
                                  "modup device", "moddown dtype",
                                  "moddown shape", "moddown strides",
                                  "sub_scale dtype", "sub_scale shape",
                                  "sub_scale table", "sub_scale device",
                                  "sub_scale last axis", "table digit size",
                                  "fold even prime", "fold prime size"])
def test_wrappers_raise(case):
    """Anything the kernels do not take raises, on the CPU as on the card:
    a dtype other than int32, a shape that does not match the tables, a
    tensor on another device than the tables, a layout the kernels do not
    read, a digit too wide for the 64-bit accumulator, a prime the
    kernels' 32-bit fold does not take."""
    _, tp, _ = _pair("tiny")
    level, N = 4, tp.n
    up = ks_legs.ModupTables(tp, level, "cpu")
    down = ks_legs.ModdownTables(tp, level, "cpu")
    c = torch.zeros((level + 1, N), dtype=torch.int32)
    d = torch.zeros((2, tp.num_special, N), dtype=torch.int32)
    x = torch.zeros((2, level + 1, N), dtype=torch.int32)
    calls = {
        "modup dtype": (TypeError,
                        lambda: ks_legs.ks_modup(c.long(), up, 0, up.J)),
        "modup shape": (ValueError,
                        lambda: ks_legs.ks_modup(c[1:], up, 0, up.J)),
        "modup device": (ValueError, lambda: ks_legs.ks_modup(
            c.to("meta"), up, 0, up.J)),
        "moddown dtype": (TypeError,
                          lambda: ks_legs.ks_moddown(d.long(), down)),
        "moddown shape": (ValueError,
                          lambda: ks_legs.ks_moddown(d[:, 1:], down)),
        "moddown strides": (ValueError, lambda: ks_legs.ks_moddown(
            d.transpose(0, 1).contiguous().transpose(0, 1), down)),
        "sub_scale dtype": (TypeError,
                            lambda: ks_legs.sub_scale(x.long(), x, down.pinv)),
        "sub_scale shape": (ValueError,
                            lambda: ks_legs.sub_scale(x, x[:1], down.pinv)),
        "sub_scale table": (ValueError,
                            lambda: ks_legs.sub_scale(x[:, 1:], x[:, 1:],
                                                      down.pinv)),
        "sub_scale device": (ValueError, lambda: ks_legs.sub_scale(
            x.to("meta"), x.to("meta"), down.pinv)),
        "sub_scale last axis": (ValueError, lambda: ks_legs.sub_scale(
            x[..., ::2], x[..., ::2], down.pinv)),
        "table digit size": (ValueError,
                             lambda: ks_legs._check_sum("a digit",
                                                        [1 << 60] * 9)),
        "fold even prime": (ValueError, lambda: ks_legs.digit_tables(
            [[1]], [(1 << 20) + 2], [(1 << 20) + 7])),
        "fold prime size": (ValueError, lambda: ks_legs.digit_tables(
            [[1]], [(1 << 31) + 11], [(1 << 20) + 7])),
    }
    exc, call = calls[case]
    with pytest.raises(exc):
        call()


def test_modup_and_moddown_plain_match_python_integers():
    """The plain versions' lazy 64-bit sums at the widest tables any profile
    has (chain b's top level: digits of 8 limbs, 8 special primes, every
    prime near 2^30 in the worst case the check allows) against Python
    integers, and the float32 v_hat of a K = 8 input equal to its halving
    order."""
    _, tp, _ = _pair("b")
    level = 54
    rng = np.random.default_rng(11)
    up = ks_legs.ModupTables(tp, level, "cpu")
    c = _residues(tp, tops._rows(tp, level, False), (), rng)
    got = ks_legs.ks_modup(_t(c), up, 0, 2)
    basis = tp.ks_tables(level)["basis"].astype(object)[:, None]
    for j in range(2):
        g = tp.ks_tables(level)["groups"][j]
        acc = np.zeros((up.M, tp.n), dtype=object)
        for a, i in enumerate(g["limbs"]):
            y = c[i].astype(object) * int(g["inv_w"][a]) % tp.q_primes[i]
            acc += y[None, :] * g["conv_w"][a].astype(object)[:, None]
        assert torch.equal(got[j], torch.as_tensor(
            (acc % basis).astype(np.int64)).to(torch.int32))
    down = ks_legs.ModdownTables(tp, level, "cpu")
    ps = [int(p) for p in tp.special_primes]
    d = _residues(tp, range(tp.num_q, tp.L_tot), (), rng)
    out = ks_legs.ks_moddown(_t(d), down)
    mdt = tp.md_tables(level)
    y = [d[i].astype(object) * int(mdt["inv_w"][i]) % ps[i] for i in range(8)]
    yf = torch.as_tensor(np.stack([v.astype(np.int64) for v in y])
                         ).to(torch.float32)
    t = [yf[i] * down.inv_p[i] for i in range(8)]
    t = [t[i] + t[i + 4] for i in range(4)]
    t = [t[i] + t[i + 2] for i in range(2)]
    vhat = torch.round(t[0] + t[1]).long().numpy().astype(object)
    for m in (0, 17, level):
        qm = tp.q_primes[m]
        conv = sum(y[i] * int(mdt["conv_w"][i, m]) for i in range(8)) % qm
        want = (conv - vhat * int(mdt["pmod_w"][m])) % qm
        assert torch.equal(out[m], torch.as_tensor(want.astype(np.int64)
                                                   ).to(torch.int32))


def test_named_ranges_and_their_split():
    """The reference's 13 named scopes and the port's three ranges of the
    elementwise ops are the port's profiler ranges: a
    CPU trace of one tiny key-switch shows ckks.keyswitch around
    ckks.ks_decompose and ckks.ks_inner_moddown; profile_round's split
    counts each kernel under its innermost range (self) and under every
    range around it (total), the rest outside the ranges."""
    from types import SimpleNamespace as NS

    from aesfhe_tpu_torch import profile_round, trace
    assert len(trace.SCOPES) == 16
    for scope, fns in trace.SCOPES.items():
        for fn in fns:
            assert getattr(tops, fn).ckks_scope == scope
    _, tp, tabs = _pair("tiny")
    rng = np.random.default_rng(0)
    c = _t(_residues(tp, tops._rows(tp, 3, False), (), rng))
    kb, ka = (_t(_residues(tp, range(tp.L_tot), (tp.dnum,), rng))
              for _ in range(2))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tops.keyswitch(tp, tabs, c, kb, ka)
    parents = {e.name: e.cpu_parent.name if e.cpu_parent else None
               for e in prof.events() if e.name.startswith("ckks.")}
    assert parents == {"ckks.keyswitch": None,
                       "ckks.ks_decompose": "ckks.keyswitch",
                       "ckks.ks_inner_moddown": "ckks.keyswitch"}

    def ev(name, dev, start, end, id=0):
        return NS(name=name, device_type=dev, id=id,
                  time_range=NS(start=start, end=end))
    from torch.autograd import DeviceType
    CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
    trace = [ev("ckks.keyswitch", CPU, 0, 100), ev("cudaLaunchKernel", CPU,
                                                   1, 2, 7),
             ev("ckks.ks_decompose", CPU, 10, 50),
             ev("cuLaunchKernelEx", CPU, 20, 21, 8),
             ev("cudaLaunchKernel", CPU, 30, 31, 9),
             ev("cudaLaunchKernel", CPU, 60, 61, 10),
             ev("ckks.rescale", CPU, 200, 300),
             ev("cudaLaunchKernel", CPU, 250, 251, 11),
             ev("cudaLaunchKernel", CPU, 400, 401, 12),
             ev("ckks.keyswitch", CUDA, 5, 500, 0)]
    trace += [ev("k", CUDA, 1000 + i, 1000 + i + us, i)
              for i, us in ((7, 1), (8, 4), (9, 8), (10, 2), (11, 32),
                            (12, 16), (13, 37))]
    split = profile_round.scope_split(trace, 100e-6)
    assert split["ckks.keyswitch"] == dict(self_s=3e-6, total_s=15e-6)
    assert split["ckks.ks_decompose"] == dict(self_s=12e-6, total_s=12e-6)
    assert split["ckks.rescale"] == dict(self_s=32e-6, total_s=32e-6)
    assert split["(outside the ranges)"]["self_s"] == pytest.approx(53e-6)


# the kernels' main-path shapes: prod_boot's levels 54, 28 and 24 (K = 8,
# digits of 8 limbs) and bench's widest switch (level 15, K = 4); then two
# chunks (k16: one digit of 13 limbs, K = 16; k9: digits of 9 and 4 limbs,
# the second narrower than the widest, K = 9), three (k20: one digit of 21
# limbs, K = 20) and the primes below 2^16
MODEL_CASES = [("prod_boot", 54), ("prod_boot", 28), ("prod_boot", 24),
               ("bench", 15), ("k16", 12), ("k9", 12), ("k20", 20),
               ("scale14", 4)]


@functools.lru_cache(maxsize=None)
def _port_params(name):
    if name in WIDE:
        return CKKSParams(**WIDE[name])
    return bench.bench_params(16, 16) if name == "bench" else \
        get_params(name)


def _extreme(primes, inv_w, kind, rng, n):
    """Residues whose y = c inv_w mod q are random ("random"; also "half"),
    the largest residue with three 0xFF bytes everywhere ("0xFF"), or a
    per-word mix of that, q - 1 and 0 ("mix")."""
    if kind in ("random", "half"):
        q = np.asarray([int(v) for v in primes], dtype=np.int64)[:, None]
        return rng.integers(0, 1 << 62, (len(primes), n)) % q
    pick = np.full((len(primes), n), 2) if kind == "0xFF" else \
        rng.integers(0, 3, (len(primes), n))
    return ks_legs.byte_extremes(primes, inv_w, pick)


def _half_specials(p, level, rng, n):
    """Special rows [2, K, n] whose float32 sums sum_i y_i/p_i lie within a
    few 1e-8 of a half-integer (`_half_integer_input`'s construction)."""
    K, ps = p.num_special, np.asarray(p.special_primes, dtype=np.int64)
    y = rng.integers(0, 1 << 62, (2, K, n)) % ps[:, None]
    rest = (y[:, 1:] / ps[1:, None]).sum(1)
    y0 = np.round((np.ceil(rest - 0.5) + 0.5 - rest) * ps[0]).astype(np.int64)
    y[:, 0] = np.clip(y0 + rng.integers(-40, 41, (2, n)), 0, ps[0] - 1)
    inv_w = np.asarray(p.md_tables(level)["inv_w"], dtype=np.int64)
    w = np.array([pow(int(a), -1, int(q)) for a, q in zip(inv_w, ps)])
    return (y * w[:, None]) % ps[:, None]


@pytest.mark.parametrize("kind", ["random", "0xFF", "mix", "half"])
@pytest.mark.parametrize("name,level", MODEL_CASES)
def test_digit_model_equals_plain(name, level, kind):
    """The CPU model of the conversion kernels (the digit matrices A_e as
    the kernels read them, the bytes of y, the chunks' S_e summed as int32
    products, one 32-bit fold a word where the tables' fold group takes
    every chunk, a digit over its own chunks) is torch.equal to
    ks_modup_plain (every digit, and a mesh range [J - 1, J + 1) whose
    last digit is padding) and to ks_moddown_plain (one component and two)
    at N = 2^9, on random inputs, on inputs that maximise every byte and
    (mod-down) on rows at float32 half-integers of v_hat's sum; over the
    whole digit S_e < 2^31 and within the chunks' 32 * 255^2 each,
    L, H < 2^32 and the Montgomery step's x_hi below q (its result
    canonical after one addition), for 1, 2 and 3 chunks and for primes
    below 2^16."""
    p = _port_params(name)
    rng = np.random.default_rng(level)
    n = 1 << 9
    up = ks_legs.ModupTables(p, level, "cpu")
    inv = [0] * (level + 1)
    for g in p.ks_tables(level)["groups"]:
        for i, w in zip(g["limbs"], g["inv_w"]):
            inv[i] = w
    c = torch.as_tensor(_extreme(p.q_primes[:level + 1], inv, kind, rng,
                                 n)).to(torch.int32)
    peaks = {}
    for j0, j1 in ((0, up.J), (up.J - 1, up.J + 1)):
        got = ks_legs.ks_modup_model(c, up, j0, j1, peaks)
        assert torch.equal(got, ks_legs.ks_modup_plain(c, up, j0, j1))
    assert not got[1:].any()
    down = ks_legs.ModdownTables(p, level, "cpu")
    d = torch.as_tensor(_half_specials(p, level, rng, n) if kind == "half"
                        else np.stack([_extreme(
                            p.special_primes, p.md_tables(level)["inv_w"],
                            kind, rng, n) for _ in range(2)])
                        ).to(torch.int32)
    for x in (d, d[0]):
        assert torch.equal(ks_legs.ks_moddown_model(x, down, peaks),
                           ks_legs.ks_moddown_plain(x, down))
    assert up.kernel_tables()[2] == up.nch
    assert down.kernel_tables()[2] == down.nch
    nch = max(up.nch, down.nch)
    assert nch == {"k16": 2, "k9": 2, "k20": 3}.get(name, 1)
    assert peaks["S"] < min(nch * 32 * 255 ** 2, 1 << 31)
    assert max(peaks["L"], peaks["H"]) < 1 << 32
    assert peaks["xq"] < 0


def test_tables_on_the_cpu_take_any_digit():
    """On the CPU the tables hold only the plain versions' constants: no
    digit matrices and no fold constants, and a digit of 9 limbs or 16
    special primes is accepted; kernel_tables() (the CPU model's, and every
    table's on a card) builds them chunk by chunk, ceil(width / 8)
    chunks."""
    p = _port_params("k9")
    up = ks_legs.ModupTables(p, 12, "cpu")
    assert up.afrag is None and up.bfold is None
    assert up.dig.tolist() == [[0, 9], [9, 4]] and up.nch == 2
    assert up.conv.shape == (2, 2 * ks_legs.CHUNK, up.M)
    down = ks_legs.ModdownTables(_port_params("k16"), 12, "cpu")
    assert down.afrag is None and down.fold is None and down.nch == 2
    assert down.cuts == [8]
    MT = -(-up.M // 16)
    assert up.kernel_tables()[0].shape == (2, 2, MT, 4, 32, 4)
    assert down.kernel_tables()[0].shape == (2, 1, 4, 32, 4)
    assert up.group is None and up.kernel_tables()[2] == 2
    with pytest.raises(ValueError, match="at most 8"):
        ks_legs.digit_tables(np.ones((9, 3)), [7, 11, 13], [5] * 9)


def test_fold_group_splits_where_one_fold_overflows():
    """A constructed conversion of 20 chunks (160 limbs with inputs below
    2^31 - 1, every y_a byte-extreme, random conv_w into 24 primes near
    2^30): the sums of all 20 chunks' products would pass L < 2^32, so
    fold_group gives fewer chunks a fold; the CPU model, folding every
    `group` chunks and adding the canonical partials mod q, equals the
    conversion in Python integers, each fold canonical (x_hi < q); one
    chunk a fold is exact too; a table whose single chunk breaks the bound
    raises."""
    p = _port_params("k20")
    qs = [int(q) for q in p.q_primes[:20]] + \
        [int(v) for v in p.special_primes[:4]]
    A, M, n = 160, len(qs), 64
    rng = np.random.default_rng(4)
    conv = rng.integers(0, 1 << 62, (A, M)) % np.asarray(qs)
    pin = [(1 << 31) - 1] * A
    afrag, group = ks_legs.chunked_tables(conv, qs, pin)
    assert afrag.shape[0] == 20 and 1 < group < 20
    y = ks_legs.byte_extremes(pin, [1] * A, rng.integers(1, 3, (A, n)))
    want = (y.astype(object).T @ conv.astype(object)).T % \
        np.asarray(qs, dtype=object)[:, None]
    fold = torch.as_tensor(ks_legs.fold_table(qs))
    for g in (group, 1):
        peaks = {}
        got = ks_legs.convert_digits_model(
            torch.as_tensor(y)[None], torch.as_tensor(afrag), fold,
            group=g, peaks=peaks)[0]
        assert torch.equal(got, torch.as_tensor(want.astype(np.int64)))
        assert peaks["xq"] < 0 and max(peaks["L"], peaks["H"]) < 1 << 32
    with pytest.raises(ValueError, match="32-bit fold"):
        ks_legs.fold_group(np.full((1, 4, 16), 1 << 31), [(1 << 30) + 3])


def test_lazy_sums_reduce_by_the_primes_bound():
    """The plain versions' lazy int64 sums reduce where the bound from the
    actual primes would pass 2^63 - 1: every 8 products of 30-bit primes,
    every 2 of 31-bit ones, never for 24 products of 16-bit ones; the
    mod-down over 16 special primes (one reduction) against Python
    integers."""
    for bits, cuts in ((30, [8, 16]), (31, list(range(2, 24, 2))),
                       (16, [])):
        t = ((1 << bits) - 2) ** 2
        assert ks_legs.lazy_reductions("x", [t] * 24, (1 << bits) - 2) == \
            cuts
    with pytest.raises(ValueError):
        ks_legs.lazy_reductions("x", [1 << 63], 0)
    _, tp, _ = _pair("k16")
    level = 12
    down = ks_legs.ModdownTables(tp, level, "cpu")
    ps = [int(v) for v in tp.special_primes]
    d = _residues(tp, range(tp.num_q, tp.L_tot), (), np.random.default_rng(3))
    out = ks_legs.ks_moddown(_t(d), down)
    mdt = tp.md_tables(level)
    y = [d[i].astype(object) * int(mdt["inv_w"][i]) % ps[i] for i in range(16)]
    vhat = torch.round(ks_legs.vhat_frac(
        torch.as_tensor(np.stack([v.astype(np.int64) for v in y])
                        ).to(torch.float32), down.inv_p, 16)).long()
    vhat = vhat[0].numpy().astype(object)
    for m in (0, 5, level):
        qm = tp.q_primes[m]
        conv = sum(y[i] * int(mdt["conv_w"][i, m]) for i in range(16)) % qm
        want = (conv - vhat * int(mdt["pmod_w"][m])) % qm
        assert torch.equal(out[m], torch.as_tensor(want.astype(np.int64)
                                                   ).to(torch.int32))


def test_digit_tables_fragment_order():
    """digit_tables stores A_e[m, 4a + s] = byte_e(conv[a, m] 256^s 2^32
    mod q_m) (Python integers) in mma.sync m16n8k32's A-fragment order for
    .u8: lane l's register r holds row l/4 (+8 for r odd) and the bytes
    k = 4(l%4) .. 4(l%4)+3 (+16 for r >= 2), lowest k in the lowest byte;
    rows past M and limbs past A are zero."""
    p = _port_params("prod_boot")
    level = 28
    mdt = p.md_tables(level)
    qs = [int(q) for q in p.q_primes[:level + 1]]
    conv = np.asarray(mdt["conv_w"], dtype=np.int64)[:5]        # A = 5
    frag = ks_legs.digit_tables(conv, qs, p.special_primes[:5])
    MT = frag.shape[0]
    assert frag.shape == (-(-len(qs) // 16), 4, 32, 4)
    words = frag.astype(np.int64) & 0xFFFFFFFF
    for mt in range(MT):
        for e in range(4):
            for lane in range(32):
                for r in range(4):
                    row = 16 * mt + lane // 4 + 8 * (r % 2)
                    k0 = 4 * (lane % 4) + 16 * (r // 2)
                    want = 0
                    for i in range(4):
                        a, s_ = divmod(k0 + i, 4)
                        if row < len(qs) and a < conv.shape[0]:
                            v = int(conv[a, row]) * 256 ** s_ * (1 << 32) \
                                % qs[row]
                            want |= ((v >> 8 * e) & 255) << 8 * i
                    assert words[mt, e, lane, r] == want
