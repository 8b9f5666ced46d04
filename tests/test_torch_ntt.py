"""The NTT wrappers (`aesfhe_tpu_torch.core.ntt.ntt_fwd`/`ntt_inv`) and the
CUDA kernels' pass schedule, on the CPU, against the reference.

- the wrappers on CPU tensors and `ops_impl.ntt_rows`/`intt_rows` (a
  non-contiguous Q.P row set, a leading batch axis) are torch.equal to
  `aesfhe_tpu.core.ntt.ntt_fwd`/`ntt_inv` on the tiny and test profiles,
  also on int64 inputs outside [0, q) (the kernels reduce on load, as the
  plain version's floor mod does), and at N=2^18 on bench.py's profile;
- `kernel_model`, a torch transcription of `csrc/ntt.cu` (its pass split,
  block tiling, strided and contiguous index maps, twiddle index per
  stage, 32-bit Shoup arithmetic and the inverse's N^-1 folded into its
  last stage) over the tables `ntt.kernel_tables` uploads, equals the
  reference's host NTT for N = 2^4 ... 2^13 on two limbs, with the kernels'
  own tile and one-pass sizes and with small ones that split every N; the
  cluster path (2^16, 2^17 on 8 blocks, 2^18 on 16) and the two-pass path
  (2^19, 2^20, 2^21) at the kernels' own sizes equal the plain version,
  their shared-memory accesses free of bank conflicts;
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
from aesfhe_tpu.core import rns as jrns
from aesfhe_tpu.core.params import CKKSParams as JCKKSParams
from aesfhe_tpu.core.params import get_params as jparams
from aesfhe_tpu_torch.core import ntt as tntt
from aesfhe_tpu_torch.core import ops_impl, rns
from aesfhe_tpu_torch.core.params import CKKSParams
from aesfhe_tpu_torch.core.params import get_params as tparams

MASK = 0xFFFFFFFF
PKG = pathlib.Path(__file__).resolve().parent.parent / "aesfhe_tpu_torch"
# bench.py's profile at AESFHE_BENCH_LOGN=18 (the two-pass path's ring)
BENCH18 = dict(n=1 << 18, max_level=16, scale_bits=28, num_special_primes=4)


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


def _large_ring_case():
    """bench's profile at N=2^18: two rows of a key-switch basis across
    its gap (q_5 and the first special prime), a batch of 2, canonical and
    spread inputs, through ntt_fwd/ntt_inv and ntt_rows/intt_rows."""
    p, jp = CKKSParams(**BENCH18), JCKKSParams(**BENCH18)
    level = 5
    rows = ops_impl._rows(p, level, True)[level:level + 2]
    assert rows[1] - rows[0] > 1
    tr = ops_impl.DeviceTables(p, "cpu").rows(rows)
    q = np.asarray(p.all_primes, dtype=np.int64)[rows]
    rng = np.random.default_rng(18)
    for spread in (False, True):
        x = _inputs(rng, (2, 2, p.n), q, spread)
        xr = (x % q.reshape(-1, 1)).astype(np.uint32)
        xt = torch.as_tensor(x)
        want = _jref(xr, rows, jp).astype(np.int64)
        fwd = tntt.ntt_fwd(xt, tr.ntt)
        assert np.array_equal(fwd.numpy(), want)
        assert torch.equal(ops_impl.ntt_rows(xt, tr), fwd)
        want = _jref(xr, rows, jp, inverse=True).astype(np.int64)
        inv = tntt.ntt_inv(xt, tr.ntt)
        assert np.array_equal(inv.numpy(), want)
        assert torch.equal(ops_impl.intt_rows(xt, tr), inv)
        assert np.array_equal(ops_impl.intt_rows(fwd, tr).numpy(), xr)


@pytest.mark.parametrize("profile", ["tiny", "test", "bench18"])
def test_wrappers_match_reference(profile):
    """ntt_fwd/ntt_inv on CPU tensors over every prime (a leading batch
    axis), and ops_impl.ntt_rows/intt_rows over a non-contiguous Q.P row
    set, torch.equal to the reference; inputs outside [0, q) give the
    reference's transform of x mod q; ntt_inv(ntt_fwd(x)) = x mod q.
    bench18: the large ring (N=2^18, bench.py's AESFHE_BENCH_LOGN=18
    profile) on two rows across the key-switch basis' gap."""
    if profile == "bench18":
        return _large_ring_case()
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
# The kernels' schedule, transcribed from csrc/ntt.cu
# ---------------------------------------------------------------------------

# csrc/ntt.cu's sizes: kClusterMinLog, kClusterLog, kRunLog, kTileLog; the
# 16-block cluster's kCluster16Log, kC16Log (runs of 2^(kC16Log + 5)); the
# two-pass path's kTwoPassMinLog, kColMaxLog, kRunMinLog, kRunsTileLog
KERNEL = dict(cluster_min_log=16, cluster_log=3, run_log=8, tile_log=11,
              cluster16_log=18, c16_log=4,
              two_pass_min_log=19, col_max_log=10, run_min_log=10,
              runs_tile_log=13)
# small ones: every N from 2^4 through the cluster path (2 blocks, runs of
# 2^(logN/2)), the one-block path with one row a block
SMALL = dict(cluster_min_log=4, cluster_log=1, run_log=None, tile_log=3)


def _shoup(a, w, wsh, q):
    r = (a * w - ((a * wsh) >> 32) * q) & MASK
    return torch.where(r >= q, r - q, r)


def _add(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def _sub(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)


def _pad(p):
    return p + (p >> 5)


def _log2(x):
    """floor(log2(x)) of a positive int64 tensor, elementwise."""
    out = torch.zeros_like(x)
    for b in range(1, 63):
        out += (x >> b) > 0
    return out


def _radix(v, r, s0, gb, q, tw, f, fwd):
    """radix<kR, kFwd>: v [G, 2^r] runs stages s0 .. s0+r-1; tw(ti) ->
    (w, wsh) [G]; f the fold constants (4 of [G])."""
    R = 1 << r
    v = [v[:, j] for j in range(R)]
    for k in range(r):
        i = k if fwd else r - 1 - k
        half = R >> (i + 1)
        for tg in range(1 << i):
            j0 = tg * (R >> i)
            if not fwd and s0 + i == 0:
                for jj in range(j0, j0 + half):
                    u, x = v[jj], v[jj + half]
                    v[jj] = _shoup(_add(u, x, q), f[0], f[1], q)
                    v[jj + half] = _shoup(_sub(u, x, q), f[2], f[3], q)
                continue
            w, wsh = tw((1 << (s0 + i)) + (gb << i) + tg)
            for jj in range(j0, j0 + half):
                u, x = v[jj], v[jj + half]
                if fwd:
                    t = _shoup(x, w, wsh, q)
                    v[jj], v[jj + half] = _add(u, t, q), _sub(u, t, q)
                else:
                    v[jj] = _add(u, x, q)
                    v[jj + half] = _shoup(_sub(u, x, q), w, wsh, q)
    return torch.stack(v, 1)


def _groups(nbits, pb0, r):
    """pass(): each group's base position; lanes on the low position bits
    when pb0 >= 5, else on the bits from pb0 + r up."""
    g = torch.arange(1 << (nbits - r))
    top, nh = pb0 + r, nbits - pb0 - r
    if pb0 >= 5:
        return ((g >> pb0) << top) | (g & ((1 << pb0) - 1))
    return ((g & ((1 << nh) - 1)) << top) | (g >> nh)


def _banks_distinct(addr):
    """Every warp's 32 lanes (consecutive groups) on 32 distinct banks."""
    b = (addr % 32).reshape(-1, 32)
    return bool((torch.sort(b, 1).values == torch.arange(32)).all())


def _pass(nbits, pb0, r, s0, boff, load, store, q, tw, f, fwd, banks,
          seen, held=False):
    """One pass: load(pos [G, R]) -> values, radix, store(pos, values);
    the positions of all groups cover the buffer once; banks: each smem
    access is checked for conflicts (load/store return the physical
    addresses they touched, or None for global memory).  held (pass_held):
    the stores are returned as a function, to run after a barrier."""
    # at the kernel's sizes no pass straddles bit 5 (SmemBuf's stride)
    assert not banks or pb0 >= 5 or pb0 + r <= 5
    base = _groups(nbits, pb0, r)
    pos = base[:, None] + (torch.arange(1 << r) << pb0)[None]
    assert torch.equal(torch.sort(pos.reshape(-1)).values,
                       torch.arange(1 << nbits))
    gb = ((base >> (pb0 + r)) & ((1 << s0) - 1)) + boff
    v, addr = load(pos)
    if banks and addr is not None:
        assert all(_banks_distinct(addr[:, j]) for j in range(1 << r))
    v = _radix(v, r, s0, gb, q(base), lambda ti: tw(base, ti), f(base), fwd)
    seen.append((pb0, r, s0))

    def put():
        addr = store(pos, v)
        if banks and addr is not None:
            assert all(_banks_distinct(addr[:, j]) for j in range(1 << r))
    if held:
        return put
    put()


def _smem(buf):
    def load(pos):
        a = _pad(pos)
        return buf[a], a

    def store(pos, v):
        a = _pad(pos)
        buf[a] = v
        return a
    return load, store


def _chunks_top3(bits):
    """The cluster path's passes over `bits` point bits: 3 at a time from
    the top, the rest last (kLs = 8: 3+3+2, 9: 3+3+3; runs: 3+3+2)."""
    out, hi = [], bits
    while hi > 0:
        r = min(3, hi)
        out.append((hi - r, r))
        hi -= r
    return out


def block_chunks(logn):
    """csrc/ntt.cu block_chunks: [5, logN) in balanced chunks of at most 3
    bits from the top, then [2, 5) and [0, 2), cut to logN."""
    out = []
    if logn > 5:
        wid = logn - 5
        cnt = (wid + 2) // 3
        hi = logn
        for i in range(cnt):
            sz = wid // cnt + (1 if i < wid % cnt else 0)
            out.append((hi - sz, sz))
            hi -= sz
    if logn > 2:
        out.append((2, min(logn, 5) - 2))
    out.append((0, min(logn, 2)))
    return out


def _model_block(y0, tab, fwd, logn, tile_log, banks, seen):
    """ntt_block over rows y0 [R, N] (canonical, to_mont applied)."""
    R, n = y0.shape
    logt = max(logn, tile_log)
    per = 1 << (logt - logn)
    out = torch.full_like(y0, -1)
    chunks = block_chunks(logn)
    for blk in range(-(-R // per)):
        fr0 = blk * per
        buf = torch.full((_pad((1 << logt) - 1) + 1,), -1, dtype=torch.int64)
        e = torch.arange(1 << logt)
        fr = fr0 + (e >> logn)
        ok = fr < R
        buf[_pad(e)] = 0
        buf[_pad(e[ok])] = y0[fr[ok], e[ok] & (n - 1)]

        def trow(base):
            return torch.clamp(fr0 + (base >> logn), max=R - 1)

        load, store = _smem(buf)
        for pb0, r in (chunks if fwd else chunks[::-1]):
            _pass(logt, pb0, r, logn - pb0 - r, 0, load, store,
                  lambda b: tab["q"][trow(b)],
                  lambda b, ti: (tab["w"][trow(b), ti],
                                 tab["wsh"][trow(b), ti]),
                  lambda b: [c[trow(b)] for c in tab["fold"]], fwd, banks,
                  seen)
        out[fr[ok], e[ok] & (n - 1)] = buf[_pad(e[ok])]
    return out


def _model_cluster(y0, tab, fwd, logn, cl_log, lc, banks, seen,
                   one_buf=False):
    """ntt_cluster (ntt_cluster16) over rows y0 [R, N]: one cluster of
    2^cl_log blocks a row; block `rank` holds the columns from rank*C
    (column layout k*C + cl) and the runs from h0 = rank*H (run layout
    hl*2^lc + c).  At the kernels' 32 columns a block (C = 32) the run
    passes are c bits [5, lc) (the exchange: one bit a block), [2, 5),
    [0, 2).  Every block runs the first half, then (a cluster barrier)
    the exchange; one_buf (ntt_cluster16): both layouts share one buffer a
    block, so the exchange's stores wait until every block has loaded
    (pass_held), then the rest of the second half; its exchange's run
    stages read their twiddles from the block's staged copy (ExTw)."""
    R, n = y0.shape
    K, col_log, ls = 1 << cl_log, lc - cl_log, logn - lc
    C, nb, hlog = 1 << col_log, logn - lc + lc - cl_log, ls - cl_log
    words = _pad((1 << nb) - 1) + 1
    out = torch.full_like(y0, -1)
    kernel_form = col_log == 5
    col_chunks = _chunks_top3(ls)
    run_chunks = ([(5, cl_log), (2, 3), (0, 2)] if kernel_form
                  else _chunks_top3(lc))
    for row in range(R):
        cols = [torch.full((words,), -1, dtype=torch.int64) for _ in range(K)]
        runs = cols if one_buf else [
            torch.full((words,), -1, dtype=torch.int64) for _ in range(K)]
        q = tab["q"][row]
        f = [c[row] for c in tab["fold"]]

        def small_tw(base, ti):        # the staged first-half twiddles
            assert int(ti.max()) < 1 << ls
            return tab["w"][row, ti], tab["wsh"][row, ti]

        def big_tw(base, ti):
            return tab["w"][row, ti], tab["wsh"][row, ti]

        def ex_tw(rank):               # ExTw: the exchange's stages, staged
            h0 = rank << hlog
            e = torch.arange(((1 << cl_log) - 1) << hlog)
            i = _log2((e >> hlog) + 1)
            idx = (1 << (ls + i)) + (h0 << i) + e - (((1 << i) - 1) << hlog)
            sw, ssh = tab["w"][row, idx], tab["wsh"][row, idx]

            def tw(base, ti):
                i = _log2(ti) - ls
                assert int(i.min()) >= 0 and int(i.max()) < cl_log
                at = (((1 << i) - 1) << 5) + ti - (1 << (ls + i)) - (h0 << i)
                assert int(at.min()) >= 0 and int(at.max()) < e.numel()
                return sw[at], ssh[at]
            return tw

        def col_gidx(pos, rank):       # ColIn / ColOut
            return ((pos >> col_log) << lc) | ((rank << col_log)
                                               + (pos & (C - 1)))

        def glob_in(gidx):
            return lambda pos: (y0[row, gidx(pos)], None)

        def glob_out(gidx):
            def store(pos, v):
                out[row, gidx(pos)] = v
            return store

        def from_cols(rank):           # FromCols<kLs>
            h0 = rank << hlog

            def load(pos):
                blk = (pos >> col_log) & (K - 1)
                a = _pad(((h0 + (pos >> lc)) << col_log) | (pos & (C - 1)))
                # the kernel's form: block j, one offset
                if kernel_form:
                    assert torch.equal(blk, torch.arange(K).expand_as(blk))
                    assert torch.equal(a, a[:, :1].expand_as(a))
                v = torch.stack([c[a] for c in cols])
                return torch.gather(v, 0, blk[None]).squeeze(0), a
            return load

        def from_runs(rank):           # FromRuns<kLs>
            def load(pos):
                k = pos >> col_log
                a = _pad(((k & ((1 << hlog) - 1)) << lc) | (rank << col_log)
                         | (pos & (C - 1)))
                # the kernel's form: one block, a stride
                if kernel_form:
                    blk = k >> hlog
                    assert torch.equal(blk, blk[:, :1].expand_as(blk))
                    step = torch.arange(a.shape[1]) * _pad(1 << lc)
                    assert torch.equal(a, a[:, :1] + step)
                v = torch.stack([b[a] for b in runs])
                return torch.gather(v, 0, (k >> hlog)[None]).squeeze(0), a
            return load

        def run_phase(rank, first_load, passes, held=False):
            h0 = rank << hlog
            load, store = _smem(runs[rank])
            order = run_chunks if fwd else run_chunks[::-1]
            put = None
            for i in passes:
                cb0, r = order[i]
                s0 = ls + lc - cb0 - r
                last = i == len(order) - 1
                exchange = one_buf and cb0 == 5
                put = _pass(nb, cb0, r, s0, h0 << (s0 - ls),
                            first_load if i == 0 else load,
                            glob_out(lambda p: p + (h0 << lc))
                            if fwd and last else store,
                            lambda b: q, ex_tw(rank) if exchange else big_tw,
                            lambda b: f, fwd, banks, seen, held)
            return put

        def col_phase(rank, first_load, passes, held=False):
            load, store = _smem(cols[rank])
            order = col_chunks if fwd else col_chunks[::-1]
            put = None
            for i in passes:
                kb0, r = order[i]
                last = i == len(order) - 1
                put = _pass(nb, col_log + kb0, r, ls - kb0 - r, 0,
                            first_load if i == 0 else load,
                            glob_out(lambda p: col_gidx(p, rank))
                            if not fwd and last else store,
                            lambda b: q, small_tw, lambda b: f, fwd, banks,
                            seen, held)
            return put

        first, second = (col_phase, run_phase) if fwd else (run_phase,
                                                           col_phase)
        n1, n2 = ((len(col_chunks), len(run_chunks)) if fwd
                  else (len(run_chunks), len(col_chunks)))
        for rank in range(K):          # up to the first cluster barrier
            first(rank, glob_in(lambda p: col_gidx(p, rank)) if fwd else
                  glob_in(lambda p: p + ((rank << hlog) << lc)), range(n1))
        # the exchange: every block's loads, then (one buffer: after the
        # second cluster barrier) every block's stores
        puts = [second(rank, from_cols(rank) if fwd else from_runs(rank),
                       range(1), one_buf) for rank in range(K)]
        for put in puts:
            if put is not None:
                put()
        for rank in range(K):
            second(rank, None, range(1, n2))
    return out


def _pass_blocks(nbits, pb0, r, s0, boffs, load, store, q, tw, f, fwd,
                 banks, seen):
    """_pass on K blocks at once (the two-pass kernels' grid): each block
    has the same groups, block k's group index bits offset by boffs[k];
    load(pos [G, R]) -> (values [K, G, R], smem addresses or None),
    store(pos, values) -> addresses or None; tw(ti [K*G]) -> (w, wsh)."""
    assert not banks or pb0 >= 5 or pb0 + r <= 5
    base = _groups(nbits, pb0, r)
    pos = base[:, None] + (torch.arange(1 << r) << pb0)[None]
    assert torch.equal(torch.sort(pos.reshape(-1)).values,
                       torch.arange(1 << nbits))
    gb = ((base >> (pb0 + r)) & ((1 << s0) - 1))[None] + boffs[:, None]
    v, addr = load(pos)
    if banks and addr is not None:
        assert all(_banks_distinct(addr[:, j]) for j in range(1 << r))
    K, G, R = v.shape
    v = _radix(v.reshape(K * G, R), r, s0, gb.reshape(-1), q, tw, f, fwd)
    addr = store(pos, v.reshape(K, G, R))
    if banks and addr is not None:
        assert all(_banks_distinct(addr[:, j]) for j in range(1 << r))
    seen.append((pb0, r, s0))


def two_pass_split(logn, sizes=KERNEL):
    """csrc/ntt.cu runs_log: (a, b), runs of 2^b, columns of 2^a."""
    b = max(sizes["run_min_log"], logn - sizes["col_max_log"])
    return logn - b, b


def _model_two_pass(y0, tab, fwd, logn, sizes, banks, seen):
    """ntt_cols and ntt_runs (ntt_fwd: cols then runs, ntt_inv: runs then
    cols) over rows y0 [R, N], the residues in between in `mid`.  ntt_cols:
    2^(b-5) blocks a row, block k the columns from 32 k (column layout k'
    * 32 + cl, row index (k' << b) | (32 k + cl)), the passes of
    block_chunks' [5, a + 5), the twiddles below 2^a (staged); ntt_runs:
    2^(a-h) blocks a row of 2^h runs of 2^b (2^(h+b) = max(2^b,
    2^runs_tile_log) positions), block k's runs from h0 = k 2^h, the passes
    of block_chunks(b), group bits offset by h0 << (b - pb0 - r), the
    twiddles from 2^a up."""
    R, n = y0.shape
    la, lb = two_pass_split(logn, sizes)
    nbc = la + 5
    nbr = max(lb, sizes["runs_tile_log"])
    hlog = nbr - lb
    col_chunks, run_chunks = block_chunks(nbc)[:-2], block_chunks(lb)
    mid = torch.full_like(y0, -1)
    out = torch.full_like(y0, -1)

    def blocks(src, dst, row, nbits, gidx, chunks, s_top, s_base, h0, tw):
        K = h0.numel()
        words = _pad((1 << nbits) - 1) + 1
        buf = torch.full((K, words), -1, dtype=torch.int64)

        def smem_load(pos):
            a = _pad(pos)
            return buf[:, a], a

        def smem_store(pos, v):
            a = _pad(pos)
            buf[:, a] = v
            return a

        def glob_load(pos):
            return src[row, gidx(pos)], None

        def glob_store(pos, v):
            dst[row, gidx(pos)] = v

        order = chunks if fwd else chunks[::-1]
        for i, (pb0, r) in enumerate(order):
            s0 = s_top - pb0 - r
            _pass_blocks(nbits, pb0, r, s0, h0 << (s0 - s_base),
                         glob_load if i == 0 else smem_load,
                         glob_store if i == len(order) - 1 else smem_store,
                         tab["q"][row], lambda ti: tw(row, ti),
                         [c[row] for c in tab["fold"]], fwd, banks, seen)

    def small_tw(row, ti):              # staged: the first a stages' only
        assert int(ti.max()) < 1 << la
        return tab["w"][row, ti], tab["wsh"][row, ti]

    def big_tw(row, ti):                # through L2: the last b stages'
        assert int(ti.min()) >= 1 << la
        return tab["w"][row, ti], tab["wsh"][row, ti]

    def cols(src, dst):
        c0 = torch.arange(1 << (lb - 5))[:, None, None] << 5
        for row in range(R):
            blocks(src, dst, row, nbc,
                   lambda pos: ((pos >> 5) << lb)[None] | (c0 + (pos & 31)),
                   col_chunks, nbc, 0, torch.zeros_like(c0.reshape(-1)),
                   small_tw)

    def runs(src, dst):
        h0 = torch.arange(1 << (la - hlog)) << hlog
        for row in range(R):
            blocks(src, dst, row, nbr,
                   lambda pos: (h0[:, None, None] << lb) + pos[None],
                   run_chunks, logn, la, h0, big_tw)

    if fwd:
        cols(y0, mid)
        runs(mid, out)
    else:
        runs(y0, mid)
        cols(mid, out)
    return out


def kernel_model(x, k: dict, fwd: bool, mont: bool = False, sizes=KERNEL,
                 banks: bool = False, seen: list | None = None):
    """ntt_fwd_launch / ntt_inv_launch on x int64 [R, N] (any int64, one
    table row per data row) with the host tables k of ntt.kernel_tables:
    the load's floor mod and to_mont factor, then the two-pass path (N >=
    2^two_pass_min_log), the 16-block cluster (N = 2^cluster16_log), the
    cluster path (N >= 2^cluster_min_log) or the one-block path.  banks:
    assert that every
    shared-memory access of a warp hits 32 distinct banks."""
    logn = x.shape[-1].bit_length() - 1
    pick = "w" if fwd else "wi"
    rc = torch.as_tensor(k["rowc"].astype(np.int64))
    tab = dict(w=torch.as_tensor(k[pick].astype(np.int64)),
               wsh=torch.as_tensor(k[pick + "_sh"].astype(np.int64)),
               q=rc[:, 0], fold=[rc[:, c] for c in
                                 (range(7, 11) if mont else range(1, 5))])
    q = rc[:, 0:1]
    y = x % q                                   # load_residue: floor mod
    if fwd and mont:
        y = _shoup(y, rc[:, 5:6], rc[:, 6:7], q)
    seen = [] if seen is None else seen
    if logn >= sizes.get("two_pass_min_log", logn + 1):
        return _model_two_pass(y, tab, fwd, logn, sizes, banks, seen)
    if logn == sizes.get("cluster16_log"):
        c16 = sizes["c16_log"]
        return _model_cluster(y, tab, fwd, logn, c16, c16 + 5, banks, seen,
                              one_buf=True)
    if logn >= sizes["cluster_min_log"]:
        lc = sizes["run_log"] or logn // 2
        return _model_cluster(y, tab, fwd, logn, sizes["cluster_log"], lc,
                              banks, seen)
    return _model_block(y, tab, fwd, logn, sizes["tile_log"], banks, seen)


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


@pytest.mark.parametrize("sizes", [KERNEL, SMALL],
                         ids=["kernel-sizes", "split-every-n"])
def test_pass_schedule_matches_reference(sizes):
    """The kernels' schedule equals the reference's host NTT (forward) and
    inverts it (inverse, N^-1 folded into the last stage) for N = 2^4 ...
    2^13 on two limbs, with the kernels' sizes (the one-block path, up to
    2^7 rows a block, its shared-memory accesses free of bank conflicts)
    and with small ones (every N through the cluster path: 2 blocks, the
    column passes, the exchange through the other block's shared memory,
    the run passes).  The folded factors: with to_mont the forward equals
    the reference's transform of x * 2^32 mod q, and the inverse with
    from_mont returns x * 2^-32 mod q.  The constants in the tables' rowc:
    q, N^-1, wi[1]*N^-1, R, N^-1*R^-1, wi[1]*N^-1*R^-1, each with its
    Shoup companion floor(c * 2^32 / q)."""
    primes, k, _, _ = _limbs(6)
    for i, q in enumerate(primes):
        c = [int(v) for v in k["rowc"][i]]
        assert len(c) == 11 and c[0] == q and c[1] * 64 % q == 1
        assert c[3] == int(k["wi"][i, 1]) * c[1] % q
        assert c[5] == (1 << 32) % q
        assert c[7] == c[1] * pow(1 << 32, -1, q) % q
        assert c[9] == c[3] * pow(1 << 32, -1, q) % q
        assert all(c[j + 1] == (c[j] << 32) // q for j in (1, 3, 5, 7, 9))
    for logn in range(4, 14):
        primes, k, x, want = _limbs(logn)
        q = np.asarray(primes, dtype=np.int64).reshape(-1, 1)
        rm = np.asarray([(1 << 32) % int(v) for v in q.ravel()]).reshape(-1, 1)
        banks = sizes is KERNEL
        got = kernel_model(torch.as_tensor(x), k, True, sizes=sizes,
                           banks=banks)
        assert np.array_equal(got.numpy(), want), logn
        back = kernel_model(torch.as_tensor(want), k, False, sizes=sizes,
                            banks=banks)
        assert np.array_equal(back.numpy(), x % q), logn
        # the folded factors: NTT(x R) with to_mont, x R^-1 with from_mont
        got = kernel_model(torch.as_tensor(x % q * rm % q), k, True,
                           sizes=sizes)
        assert np.array_equal(kernel_model(torch.as_tensor(x), k, True, True,
                                           sizes=sizes).numpy(),
                              got.numpy()), logn
        back = kernel_model(got, k, False, True, sizes=sizes)
        assert np.array_equal(back.numpy(), x % q), logn


@pytest.mark.parametrize("logn", [16, 17, 18])
def test_cluster_schedule_at_kernel_sizes(logn):
    """The cluster paths at the kernels' own sizes on one row, 32 columns a
    block: 2^16 and 2^17 on 8 blocks, runs of 256 (run passes of 3+3+2 c
    bits; column passes of 3+3+2 k bits at 2^16, 3+3+3 at 2^17), 2^18 on
    16 blocks (ntt_cluster16), runs and columns of 512 (run passes 4+3+2,
    the first one the exchange, column passes 3+3+3).  Every pass's groups
    cover its buffer, each shared-memory access of a warp (local and
    through the exchange) hits 32 distinct banks, the first half's twiddle
    indices stay below 2^(logN-lc) (staged), and the result equals the
    plain version's, both ways, with and without the folded factors."""
    n = 1 << logn
    primes = tuple(rns.find_ntt_primes(30, 2 * n, 1))
    t = tntt.NTTTables(n, primes)
    k = tntt.kernel_tables(t.w, t.wi, t.ninv, t.q)
    rng = np.random.default_rng(logn)
    x = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (1, n)))
    tabs = tntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "cpu").rows([0])
    cl = 4 if logn == 18 else 3
    K, kls = 1 << cl, logn - cl - 5
    modes = ((True, False), (True, True), (False, True))
    if logn == 18:
        modes += ((False, False),)
    for fwd, mont in modes:
        seen = []
        got = kernel_model(x, k, fwd, mont, banks=True, seen=seen)
        want = (tntt.ntt_fwd(x, tabs, to_mont=mont) if fwd
                else tntt.ntt_inv(x, tabs, from_mont=mont))
        assert torch.equal(got, want), (fwd, mont)
        # per block: 3 column passes, 3 run passes; the second half's
        # first pass (the exchange) on every block, then the rest
        assert len(seen) == 2 * 3 * K
        cols = [(5 + kls - 3, 3, 0), (5 + kls - 6, 3, 3), (5, kls - 6, 6)]
        runs = [(5, cl, kls), (2, 3, kls + cl), (0, 2, kls + cl + 3)]
        first, second = (cols, runs) if fwd else (runs[::-1], cols[::-1])
        assert seen[:3] == first                                # rank 0
        assert seen[3 * K:4 * K] == [second[0]] * K
        assert seen[4 * K:4 * K + 2] == second[1:]              # rank 0


@pytest.mark.parametrize("logn", [19, 20, 21])
def test_two_pass_schedule_at_kernel_sizes(logn):
    """The two-pass path (N >= 2^19) at the kernels' own sizes on one row:
    2^19 splits 9 + 10 (column passes of 3+3+3 k bits), 2^20 10 + 10
    (3+3+2+2), 2^21 10 + 11 (runs of 2^11, 4 a block); run passes of
    block_chunks(b).  Every pass's groups cover its buffer, each
    shared-memory access of a warp hits 32 distinct banks, the column
    pass's twiddle indices stay below 2^a (staged) and the run pass's from
    2^a up, and the result equals the plain version's, both ways, with and
    without the folded factors."""
    n = 1 << logn
    primes = tuple(rns.find_ntt_primes(30, 2 * n, 1))
    t = tntt.NTTTables(n, primes)
    k = tntt.kernel_tables(t.w, t.wi, t.ninv, t.q)
    rng = np.random.default_rng(logn)
    x = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (1, n)))
    tabs = tntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "cpu").rows([0])
    la, lb = two_pass_split(logn)
    assert (la, lb) == {19: (9, 10), 20: (10, 10), 21: (10, 11)}[logn]
    cols = [(pb0, r, la + 5 - pb0 - r) for pb0, r in block_chunks(la + 5)[:-2]]
    runs = [(pb0, r, logn - pb0 - r) for pb0, r in block_chunks(lb)]
    assert [r for _, r, _ in cols] == {9: [3, 3, 3], 10: [3, 3, 2, 2]}[la]
    for fwd in (True, False):
        for mont in (False, True):
            seen = []
            got = kernel_model(x, k, fwd, mont, banks=True, seen=seen)
            want = (tntt.ntt_fwd(x, tabs, to_mont=mont) if fwd
                    else tntt.ntt_inv(x, tabs, from_mont=mont))
            assert torch.equal(got, want), (fwd, mont)
            # one row: the column launch's passes, then the run launch's
            first, second = (cols, runs) if fwd else (runs[::-1], cols[::-1])
            assert seen == first + second


def test_floor_mod_in_32_bit_arithmetic():
    """csrc/ntt.cu load_residue_r, the kernels' floor mod of int64 inputs
    from N = 2^18 up: x = hi * 2^32 + lo, x mod q = (hi mod q) * R + lo mod
    q with R = 2^32 mod q (a Shoup product with R's companion from rowc),
    hi mod q a truncated remainder lifted to [0, q): equal to the floor
    mod over the whole int64 range (both ends, -1, q, -q, random) for
    primes of 17 to 30 bits."""
    for bits in (17, 24, 30):
        q = rns.find_ntt_primes(bits, 1 << 19, 1)[0]
        k = tntt.kernel_tables(np.ones((1, 2), dtype=np.uint32),
                               np.ones((1, 2), dtype=np.uint32), [1], [q])
        r, rsh = (int(k["rowc"][0, c]) for c in (5, 6))
        assert r == (1 << 32) % q
        x = torch.as_tensor(np.concatenate([
            np.random.default_rng(bits).integers(-(1 << 63), (1 << 63) - 1,
                                                 20000),
            [-(1 << 63), (1 << 63) - 1, -1, 0, 1, q - 1, q, -q, 1 << 32,
             -(1 << 32), (1 << 31) - 1, -(1 << 31)]]).astype(np.int64))
        hm = torch.fmod(x >> 32, q)
        hm = torch.where(hm < 0, hm + q, hm)
        got = _add(_shoup(hm, r, rsh, q), (x & MASK) % q, q)
        assert torch.equal(got, x.remainder(q)), bits


# ---------------------------------------------------------------------------
# The wrappers' checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["tiny", "test"])
def test_fused_forms_match_reference(profile):
    """The wrappers' fused forms on CPU tensors against the reference, over
    a non-contiguous Q.P row set with a batch axis: int32 and int64 in,
    int32 and int64 out; ntt_fwd(x, to_mont=True) equals the reference's
    ntt_fwd of its rns.to_mont(x), and ntt_inv(y, from_mont=True) the
    reference's rns.from_mont of its ntt_inv(y); int64 inputs outside
    [0, q) give the transform of x mod q; the round trip returns x."""
    p, jp = tparams(profile), jparams(profile)
    t = jp.tables
    level = 2
    rows = ops_impl._rows(p, level, True)
    tr = ops_impl.DeviceTables(p, "cpu").rows(rows)
    q = np.asarray(p.all_primes, dtype=np.int64)[rows]
    rng = np.random.default_rng(8)
    x = _inputs(rng, (2, len(rows), p.n), q, False)
    xs = _inputs(rng, (2, len(rows), p.n), q, True)
    qj = jnp.asarray(t.q[rows]).reshape(-1, 1)
    qinv = jnp.asarray(jp.qinv_arr[rows]).reshape(-1, 1)
    r2 = jnp.asarray(jp.r2_arr[rows]).reshape(-1, 1)
    xm = np.asarray(jrns.to_mont(jnp.asarray(x.astype(np.uint32)), qj,
                                 qinv, r2))
    want_f = _jref(xm, rows, jp).astype(np.int64)
    want_i = np.asarray(jrns.from_mont(
        jnp.asarray(_jref(x.astype(np.uint32), rows, jp, inverse=True)),
        qj, qinv)).astype(np.int64)
    for in_dt in (torch.int32, torch.int64):
        xt = torch.as_tensor(x).to(in_dt)
        for out_dt in (torch.int32, torch.int64):
            got = ops_impl.ntt_rows(xt, tr, to_mont=True, out_dtype=out_dt)
            assert got.dtype == out_dt
            assert np.array_equal(got.long().numpy(), want_f)
            inv = ops_impl.intt_rows(xt, tr, from_mont=True, out_dtype=out_dt)
            assert inv.dtype == out_dt
            assert np.array_equal(inv.long().numpy(), want_i)
            plain = tntt.ntt_fwd(xt, tr.ntt, out_dtype=out_dt)
            assert np.array_equal(plain.long().numpy(),
                                  _jref(x.astype(np.uint32), rows, jp))
    # int64 outside [0, q): the transforms of x mod q, fused alike
    xr = xs % q.reshape(-1, 1)
    got = ops_impl.ntt_rows(torch.as_tensor(xs), tr, to_mont=True,
                            out_dtype=torch.int32)
    assert torch.equal(got, ops_impl.ntt_rows(
        torch.as_tensor(xr).int(), tr, to_mont=True, out_dtype=torch.int32))
    got = ops_impl.intt_rows(torch.as_tensor(xs), tr, from_mont=True)
    assert torch.equal(got, ops_impl.intt_rows(torch.as_tensor(xr), tr,
                                               from_mont=True))
    back = ops_impl.intt_rows(ops_impl.ntt_rows(
        torch.as_tensor(x).int(), tr, to_mont=True, out_dtype=torch.int32),
        tr, from_mont=True, out_dtype=torch.int32)
    assert np.array_equal(back.numpy(), x)


def test_wrapper_checks():
    """A dtype other than int32 or int64 (float32, int16; also as
    out_dtype), a non-power-of-two N, a shape the tables do not have and
    an unknown device raise; int32 is taken; an empty batch returns empty.
    No module of the port but core/ntt.py names ntt_fwd_plain or
    ntt_inv_plain: every NTT goes through the wrappers, so on the card
    through the kernels."""
    p = tparams("tiny")
    t = p.tables
    rows = tntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "cpu").rows(range(3))
    x = torch.zeros((3, p.n), dtype=torch.int64)
    for fn in (tntt.ntt_fwd, tntt.ntt_inv):
        for bad in (torch.float32, torch.int16):
            with pytest.raises(TypeError, match="int32 or int64"):
                fn(x.to(bad), rows)
            with pytest.raises(TypeError, match="out_dtype"):
                fn(x, rows, False, bad)
        assert torch.equal(fn(x.int(), rows), fn(x, rows))
        assert fn(x, rows, False, torch.int32).dtype == torch.int32
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


def test_ntt_variants_apply():
    """Every variant of `python3 -m aesfhe_tpu_torch.ntt_variants` (the
    designs tried and dropped, timed beside the kernels on the card)
    still applies to csrc/ntt.cu: each of its edits matches exactly once."""
    from aesfhe_tpu_torch import kernels, ntt_variants
    base = kernels.SOURCES["ntt"].read_text()
    for name in ntt_variants.VARIANTS:
        assert ntt_variants.variant_source(name) != base, name
