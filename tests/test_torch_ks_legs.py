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
# one wide level each: (profile, level), K = 2, 3, 6, 8
MODUP_CASES = [("tiny", 8), ("test", 16), ("deep", 41), ("b", 54)]
# the special-prime counts K = 2 (tiny), 3 (test), 4 (boot_tiny), 6 (deep),
# 8 (chain b), at a level each
MODDOWN_CASES = [("tiny", 4), ("test", 10), ("boot_tiny", 30), ("deep", 20),
                 ("b", 16)]


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
    if name == "b":
        jp, tp = JCKKSParams(**CHAIN_B), CKKSParams(**CHAIN_B)
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
                                          ("b", 30, 4), ("deep", 41, 4)])
def test_modup_digit_ranges_match_padded_tables(name, level, D):
    """ks_modup over each rank's digit range [r*pad/D, (r+1)*pad/D) equals
    the basis extension through the reference's padded digit tables
    (`parallel/dist_keyswitch.py:_padded_digit_tables`: inv_w = 0 past the
    active digits; at level 30 of chain b and level 41 of deep the last
    ranks hold padding only); and the port's ks_decompose(j0, j1) is the
    full decomposition's rows, zero past the active digits."""
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
    """The reference's 13 named scopes are the port's profiler ranges: a
    CPU trace of one tiny key-switch shows ckks.keyswitch around
    ckks.ks_decompose and ckks.ks_inner_moddown; profile_round's split
    counts each kernel under its innermost range (self) and under every
    range around it (total), the rest outside the ranges."""
    from types import SimpleNamespace as NS

    from aesfhe_tpu_torch import profile_round
    from aesfhe_tpu_torch.core import scopes
    assert len(scopes.SCOPES) == 13
    for fn, scope in scopes.SCOPES.items():
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
# digits of 8 limbs) and bench's widest switch (level 15, K = 4)
MODEL_CASES = [("prod_boot", 54), ("prod_boot", 28), ("prod_boot", 24),
               ("bench", 15)]


@functools.lru_cache(maxsize=None)
def _port_params(name):
    return bench.bench_params(16, 16) if name == "bench" else \
        get_params(name)


def _extreme(primes, inv_w, kind, rng, n):
    """Residues whose y = c inv_w mod q are random ("random"), the largest
    residue with three 0xFF bytes everywhere ("0xFF"), or a per-word mix
    of that, q - 1 and 0 ("mix")."""
    if kind == "random":
        q = np.asarray([int(v) for v in primes], dtype=np.int64)[:, None]
        return rng.integers(0, 1 << 62, (len(primes), n)) % q
    pick = np.full((len(primes), n), 2) if kind == "0xFF" else \
        rng.integers(0, 3, (len(primes), n))
    return ks_legs.byte_extremes(primes, inv_w, pick)


@pytest.mark.parametrize("kind", ["random", "0xFF", "mix"])
@pytest.mark.parametrize("name,level", MODEL_CASES)
def test_digit_model_equals_plain(name, level, kind):
    """The CPU model of the conversion kernels (the digit matrices A_e as
    the kernels read them, the bytes of y, S_e as int32 products, the
    32-bit fold) is torch.equal to ks_modup_plain (every digit, and a mesh
    range [J - 1, J + 1) whose last digit is padding) and to
    ks_moddown_plain (one component and two) at N = 2^9, on random inputs
    and on inputs that maximise every byte; S_e < 2^21 and L, H < 2^30."""
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
    d = torch.as_tensor(np.stack([_extreme(
        p.special_primes, p.md_tables(level)["inv_w"], kind, rng, n)
        for _ in range(2)])).to(torch.int32)
    for x in (d, d[0]):
        assert torch.equal(ks_legs.ks_moddown_model(x, down, peaks),
                           ks_legs.ks_moddown_plain(x, down))
    assert peaks["S"] < 1 << 21
    assert max(peaks["L"], peaks["H"]) < 1 << 30


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
