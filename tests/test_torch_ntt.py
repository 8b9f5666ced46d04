"""The NTT wrappers (`aesfhe_tpu_torch.core.ntt.ntt_fwd`/`ntt_inv`) and the
CUDA kernels' pass schedule, on the CPU, against the reference.

- the wrappers on CPU tensors and `ops_impl.ntt_rows`/`intt_rows` (a
  non-contiguous Q.P row set, a leading batch axis) are torch.equal to
  `aesfhe_tpu.core.ntt.ntt_fwd`/`ntt_inv` on the tiny and test profiles,
  also on int64 inputs outside [0, q) (the kernels reduce on load, as the
  plain version's floor mod does);
- `kernel_model`, a torch transcription of `csrc/ntt.cu` (its pass split,
  block tiling, strided and contiguous index maps, twiddle index per
  stage, 32-bit Shoup arithmetic and the inverse's N^-1 folded into its
  last stage) over the tables `ntt.kernel_tables` uploads, equals the
  reference's host NTT for N = 2^4 ... 2^13 on two limbs, with the kernels'
  own tile and one-pass sizes and with small ones that split every N;
- the wrappers' argument checks, and no module but core/ntt.py calls the
  plain versions.
"""
import functools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesfhe_tpu.core import ntt as jntt
from aesfhe_tpu.core.params import get_params as jparams
from aesfhe_tpu_torch.core import ntt as tntt
from aesfhe_tpu_torch.core import ops_impl, rns
from aesfhe_tpu_torch.core.params import get_params as tparams

MASK = 0xFFFFFFFF
PKG = pathlib.Path(__file__).resolve().parent.parent / "aesfhe_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    # the xdist workers share the host's cores with the reference's tests
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jref(x, rows, p, inverse=False):
    """The reference's NTT over table rows `rows` of profile p (uint32)."""
    t = p.tables
    r = np.asarray(rows)
    if inverse:
        return np.asarray(jntt.ntt_inv(
            jnp.asarray(x), jnp.asarray(t.wi[r]), jnp.asarray(t.wi_sh[r]),
            jnp.asarray(t.q[r]), jnp.asarray(t.ninv[r]),
            jnp.asarray(t.ninv_sh[r])))
    return np.asarray(jntt.ntt_fwd(jnp.asarray(x), jnp.asarray(t.w[r]),
                                   jnp.asarray(t.w_sh[r]),
                                   jnp.asarray(t.q[r])))


def _inputs(rng, shape, q, spread: bool):
    """Canonical residues, or (spread) int64 values around and outside
    [0, q): negative, above q, above 2^31, inside the plain version's
    domain (no int64 product overflows)."""
    qc = q.reshape(-1, 1)
    if not spread:
        return rng.integers(0, 1 << 62, shape) % qc
    return rng.integers(-(1 << 31), 1 << 31, shape)


@pytest.mark.parametrize("profile", ["tiny", "test"])
def test_wrappers_match_reference(profile):
    """ntt_fwd/ntt_inv on CPU tensors over every prime (a leading batch
    axis), and ops_impl.ntt_rows/intt_rows over a non-contiguous Q.P row
    set, torch.equal to the reference; inputs outside [0, q) give the
    reference's transform of x mod q; ntt_inv(ntt_fwd(x)) = x mod q."""
    p, jp = tparams(profile), jparams(profile)
    t = p.tables
    rng = np.random.default_rng(21)
    q_all = np.asarray(p.all_primes, dtype=np.int64)
    full = tntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "cpu").rows(
        range(p.L_tot))
    for spread in (False, True):
        x = _inputs(rng, (2, p.L_tot, p.n), q_all, spread)
        xr = (x % q_all.reshape(-1, 1)).astype(np.uint32)
        fwd = tntt.ntt_fwd(torch.as_tensor(x), full)
        want = _jref(xr, range(p.L_tot), jp)
        assert np.array_equal(fwd.numpy(), want.astype(np.int64))
        inv = tntt.ntt_inv(torch.as_tensor(x), full)
        want = _jref(xr, range(p.L_tot), jp, inverse=True)
        assert np.array_equal(inv.numpy(), want.astype(np.int64))
        back = tntt.ntt_inv(fwd, full)
        assert np.array_equal(back.numpy(), xr.astype(np.int64))
    # the key-switch's basis below the top: q_0..q_level | specials
    level = 2
    rows = ops_impl._rows(p, level, True)
    assert np.any(np.diff(rows) != 1)
    tr = ops_impl.DeviceTables(p, "cpu").rows(rows)
    d = _inputs(rng, (3, len(rows), p.n), q_all[rows], False)
    got = ops_impl.ntt_rows(torch.as_tensor(d), tr)
    want = _jref(d.astype(np.uint32), rows, jp)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    got_inv = ops_impl.intt_rows(got, tr)
    assert np.array_equal(got_inv.numpy(), d)
    # a strided view (a slice of limbs, as the rescales pass) reads alike
    view = torch.as_tensor(d)[:, 1:3]
    assert not view.is_contiguous()
    part = ops_impl.ntt_rows(view, ops_impl.DeviceTables(p, "cpu").rows(
        rows[1:3]))
    assert torch.equal(part, got[:, 1:3])


# ---------------------------------------------------------------------------
# The kernels' pass schedule, transcribed from csrc/ntt.cu
# ---------------------------------------------------------------------------

def _shoup(a, w, wsh, q):
    r = (a * w - ((a * wsh) >> 32) * q) & MASK
    return torch.where(r >= q, r - q, r)


def _add(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def _sub(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)


def _model_pass(x, fwd, strided, logn, logp, tile_log, tw, tsh, rowc):
    """One launch of ntt_pass<fwd, strided> over rows x [R, N] (canonical):
    every block of the grid, its loads, its stages, its stores.  tw, tsh
    [R, N] and rowc [R, 5] are each row's table rows."""
    groups_log = logn - logp
    logc = min(groups_log, tile_log - logp)
    P, C = 1 << logp, 1 << logc
    E = P << logc
    col_shift = logn - logp
    q = rowc[:, 0:1]
    out = torch.full_like(x, -1)
    e = torch.arange(E)
    bf = torch.arange(E // 2)
    s_lo = 0 if strided else logn - logp
    for blk in range(1 << (groups_log - logc)):
        g0 = blk << logc
        idx = (g0 + (e & (C - 1)) + ((e >> logc) << col_shift) if strided
               else (g0 << logp) + e)
        buf = x[:, idx].clone()
        for j in range(logp):
            s = s_lo + j if fwd else s_lo + logp - 1 - j
            logt = logp - 1 - (s - s_lo)
            tl = 1 << logt
            if strided:
                gl, i = bf & (C - 1), bf >> logc
            else:
                gl, i = bf >> (logp - 1), bf & ((P >> 1) - 1)
            ku = ((i >> logt) << (logt + 1)) | (i & (tl - 1))
            kv = ku + tl
            idx_u = (g0 + gl + (ku << col_shift) if strided
                     else ((g0 + gl) << logp) + ku)
            pu = ku * C + gl if strided else gl * P + ku
            pv = kv * C + gl if strided else gl * P + kv
            assert torch.equal(torch.sort(torch.cat([pu, pv])).values, e)
            ti = (1 << s) + (idx_u >> (logn - s))
            u, v = buf[:, pu], buf[:, pv]
            if fwd:
                wv = _shoup(v, tw[:, ti], tsh[:, ti], q)
                a, b = _add(u, wv, q), _sub(u, wv, q)
            elif s == 0:
                a = _shoup(_add(u, v, q), rowc[:, 1:2], rowc[:, 2:3], q)
                b = _shoup(_sub(u, v, q), rowc[:, 3:4], rowc[:, 4:5], q)
            else:
                a = _add(u, v, q)
                b = _shoup(_sub(u, v, q), tw[:, ti], tsh[:, ti], q)
            buf[:, pu], buf[:, pv] = a, b
        out[:, idx] = buf
    assert bool((out >= 0).all()), "a pass left elements unwritten"
    return out


def kernel_model(x, k: dict, fwd: bool, one_pass_log=12, tile_log=12):
    """ntt_fwd_launch / ntt_inv_launch on x int64 [R, N] (any int64, one
    table row per data row) with the host tables k of ntt.kernel_tables."""
    logn = x.shape[-1].bit_length() - 1
    pick = "w" if fwd else "wi"
    tw = torch.as_tensor(k[pick].astype(np.int64))
    tsh = torch.as_tensor(k[pick + "_sh"].astype(np.int64))
    rowc = torch.as_tensor(k["rowc"].astype(np.int64))
    y = x % rowc[:, 0:1]                      # load_residue: floor mod
    if logn <= one_pass_log:
        plan = [(False, logn)]
    else:
        lc = logn // 2
        plan = ([(True, logn - lc), (False, lc)] if fwd
                else [(False, lc), (True, logn - lc)])
    for strided, logp in plan:
        y = _model_pass(y, fwd, strided, logn, logp, tile_log, tw, tsh, rowc)
    return y


@functools.lru_cache(maxsize=None)
def _limbs(logn: int):
    """Two primes of the ring 2^logn, their kernel tables, an input with
    values outside [0, q), and the reference's host NTT of it per limb."""
    n = 1 << logn
    primes = tuple(rns.find_ntt_primes(30, 2 * n, 2))
    t = tntt.NTTTables(n, primes)
    k = tntt.kernel_tables(t.w, t.wi, t.ninv, t.q)
    rng = np.random.default_rng(logn)
    x = rng.integers(-(1 << 33), 1 << 33, (2, n))
    want = np.stack([np.asarray(jntt.ntt_fwd_host(x[i], q, t.psi[i]),
                                dtype=np.int64)
                     for i, q in enumerate(primes)])
    return primes, k, x, want


@pytest.mark.parametrize("sizes", [(12, 12), (3, 7)],
                         ids=["kernel-sizes", "split-every-n"])
def test_pass_schedule_matches_reference(sizes):
    """The kernels' pass schedule equals the reference's host NTT (forward)
    and inverts it (inverse, N^-1 folded into the last stage) for
    N = 2^4 ... 2^13 on two limbs; (one-pass limit, tile) = the kernels'
    (2^12, 4096: N = 2^13 takes two passes of two blocks a row) and small
    ones (2^3, 128: every N two passes, from N = 2^8 several blocks a
    row).  The folded constants in the tables' rowc: q, N^-1 and
    wi[1] * N^-1, each with its Shoup companion floor(c * 2^32 / q)."""
    one_pass, tile = sizes
    primes, k, _, _ = _limbs(6)
    for i, q in enumerate(primes):
        q_, ninv, ninv_sh, wi1n, wi1n_sh = (int(v) for v in k["rowc"][i])
        assert q_ == q and ninv * 64 % q == 1
        assert wi1n == int(k["wi"][i, 1]) * ninv % q
        assert ninv_sh == (ninv << 32) // q and wi1n_sh == (wi1n << 32) // q
    for logn in range(4, 14):
        primes, k, x, want = _limbs(logn)
        q = np.asarray(primes, dtype=np.int64).reshape(-1, 1)
        got = kernel_model(torch.as_tensor(x), k, True, one_pass, tile)
        assert np.array_equal(got.numpy(), want), logn
        back = kernel_model(torch.as_tensor(want), k, False, one_pass, tile)
        assert np.array_equal(back.numpy(), x % q), logn


# ---------------------------------------------------------------------------
# The wrappers' checks
# ---------------------------------------------------------------------------

def test_wrapper_checks():
    """A bad dtype, a non-power-of-two N, a shape the tables do not have
    and an unknown device raise; an empty batch returns empty.  No module
    of the port but core/ntt.py names ntt_fwd_plain or ntt_inv_plain:
    every NTT goes through the wrappers, so on the card through the
    kernels."""
    p = tparams("tiny")
    t = p.tables
    rows = tntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "cpu").rows(range(3))
    x = torch.zeros((3, p.n), dtype=torch.int64)
    for fn in (tntt.ntt_fwd, tntt.ntt_inv):
        with pytest.raises(TypeError, match="int64"):
            fn(x.int(), rows)
        with pytest.raises(ValueError, match="power of two"):
            fn(torch.zeros((3, 12), dtype=torch.int64), rows)
        with pytest.raises(ValueError, match="tables"):
            fn(torch.zeros((4, p.n), dtype=torch.int64), rows)
        with pytest.raises(ValueError, match="unsupported device"):
            meta = tntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "meta")
            fn(x.to("meta"), meta.rows(range(3)))
        assert fn(x[:0].reshape(0, 3, p.n), rows).shape == (0, 3, p.n)
    with pytest.raises(ValueError, match="power of two"):
        tntt.DeviceNTT(t.w[:, :12], t.wi[:, :12], t.ninv, t.q, "cpu")
    callers = sorted(str(f.relative_to(PKG)) for f in PKG.rglob("*.py")
                     if f.name != "ntt.py" or f.parent.name != "core"
                     if "ntt_fwd_plain" in f.read_text()
                     or "ntt_inv_plain" in f.read_text())
    assert callers == []
