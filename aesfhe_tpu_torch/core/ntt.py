"""Negacyclic NTT over RNS limbs: the CUDA kernels' wrappers and their
plain torch versions.

Counterpart of `aesfhe_tpu/core/ntt.py` and of the `ops_impl.ntt_rows` /
`intt_rows` contract, which the reference meets on its accelerator with the
MXU 4-step NTT (`aesfhe_tpu/core/mxu_ntt.py:ntt_fwd_mxu`/`ntt_inv_mxu`):
Cooley-Tukey with the psi-twist merged into the twiddles, natural
coefficient order in, bit-reversed evaluation order out; the inverse uses
Gentleman-Sande butterflies on bit-reversed input.  Output slot i holds the
evaluation at psi^(2*bitrev(i)+1), the order `params.galois_perm` indexes.

Twiddles are plain constants, so a twiddle product (x*w mod q) keeps the
Montgomery form of the data.

`ntt_fwd`/`ntt_inv` take the data and an `NTTRows` (a row selection of one
`DeviceNTT`, the tables of a prime set on one device).  The contract:
- input int32 (canonical residues, read as they are) or int64 (any value,
  reduced mod q: the transform of x mod q);
- output int32 or int64 (`out_dtype`), canonical residues;
- `ntt_fwd(x, t, to_mont=True)` is `ntt_fwd(rns.to_mont(x))` (x * 2^32 mod
  q on load) and `ntt_inv(x, t, from_mont=True)` is
  `rns.from_mont(ntt_inv(x))` (2^-32 folded into the last stage's N^-1
  constants), residue for residue.
On a CPU tensor they compute the plain version (`ntt_fwd_plain`/
`ntt_inv_plain`, the same arguments step by step); on a CUDA tensor they
launch the kernels of `aesfhe_tpu_torch/csrc/ntt.cu` (design note there) or
raise: one launch a call up to N = 2^18 (at `CLUSTER16_LOGN` = 18 on a
cluster of 16 blocks), two from 2^19 (`TWO_PASS_MIN_LOGN`: the two-pass
path, the residues in between in an int32 scratch of its own) up to
2^`MAX_LOGN`; a larger ring raises.  A launch the card refuses (a cluster
it cannot place) raises with its CUDA error; nothing takes another path.
`launches_fwd`/`launches_inv` count the launches, `launches_cluster16` and
`launches_two_pass` those of the 2^18 kernel and of the two-pass path
among them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from . import rns

launches_fwd = 0
launches_inv = 0
launches_cluster16 = 0
launches_two_pass = 0
MAX_LOGN = 25            # the kernels' largest ring (csrc/ntt.cu kMaxLog)
CLUSTER16_LOGN = 18      # one launch on 16 blocks a row (kCluster16Log)
TWO_PASS_MIN_LOGN = 19   # from here two launches a transform (kTwoPassMinLog)
DTYPES = (torch.int32, torch.int64)
R32 = 1 << 32            # the Montgomery radix R


def bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


class NTTTables:
    """Per-prime twiddle tables (host numpy), indexed [L, N]: w[l, rev(j)] =
    psi_l^j (the Harvey/SEAL layout), wi likewise for psi_l^-1, ninv = N^-1.
    The Shoup companions are kept for parity with the reference's tables."""

    def __init__(self, n: int, primes: tuple[int, ...]):
        self.n = n
        self.primes = primes
        self.logn = n.bit_length() - 1
        L = len(primes)
        self.psi = []
        w = np.zeros((L, n), dtype=np.uint32)
        w_sh = np.zeros((L, n), dtype=np.uint32)
        wi = np.zeros((L, n), dtype=np.uint32)
        wi_sh = np.zeros((L, n), dtype=np.uint32)
        ninv = np.zeros((L,), dtype=np.uint32)
        ninv_sh = np.zeros((L,), dtype=np.uint32)
        rev = bit_reverse_perm(n)

        def pow_table(base: int, q: int) -> np.ndarray:
            """[1, base, ..., base^(n-1)] mod q by uint64 doubling."""
            out = np.ones(1, dtype=np.uint64)
            qq = np.uint64(q)
            while out.size < n:
                step = np.uint64(pow(base, out.size, q))
                out = np.concatenate([out, (out * step) % qq])
            return out[:n]

        for li, q in enumerate(primes):
            psi = rns.find_primitive_2n_root(q, 2 * n)
            self.psi.append(psi)
            w[li, rev] = pow_table(psi, q).astype(np.uint32)
            wi[li, rev] = pow_table(pow(psi, -1, q), q).astype(np.uint32)
            qq = np.uint64(q)
            w_sh[li] = ((w[li].astype(np.uint64) << np.uint64(32)) // qq
                        ).astype(np.uint32)
            wi_sh[li] = ((wi[li].astype(np.uint64) << np.uint64(32)) // qq
                         ).astype(np.uint32)
            ni = pow(n, -1, q)
            ninv[li] = ni
            ninv_sh[li] = rns.shoup_precompute(ni, q)
        self.w = w
        self.w_sh = w_sh
        self.wi = wi
        self.wi_sh = wi_sh
        self.ninv = ninv
        self.ninv_sh = ninv_sh
        self.q = np.asarray(primes, dtype=np.uint32)


def ntt_fwd_plain(x: torch.Tensor, w: torch.Tensor, q: torch.Tensor,
                  r: torch.Tensor | None = None,
                  out_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Forward negacyclic NTT, the kernel's plain version.

    x: int32 or int64 [..., L, N] (natural coefficient order); w: int64
    [L, N]; q: int64 [L]; r: int64 [L], R mod q, multiplied in on load
    (to_mont), or None.  Returns out_dtype [..., L, N] in bit-reversed eval
    order.  Each stage writes u + w*v and u - w*v + q into one buffer and
    reduces it with a single remainder (every value stays below 3q)."""
    shape = x.shape
    n, L = shape[-1], shape[-2]
    qc = q.reshape(L, 1, 1)
    x = x.long()
    if r is not None:
        x = x.remainder(q.reshape(L, 1)) * r.reshape(L, 1) % q.reshape(L, 1)
    m = 1
    while m < n:
        t = n // (2 * m)
        xr = x.reshape(shape[:-1] + (m, 2, t))
        u, v = xr[..., 0, :], xr[..., 1, :]
        wv = v * w[:, m:2 * m].reshape(L, m, 1)
        wv.remainder_(qc)
        out = torch.empty_like(xr)
        torch.add(u, wv, out=out[..., 0, :])
        torch.sub(u, wv, out=out[..., 1, :])
        out[..., 1, :].add_(qc)
        out.remainder_(qc.unsqueeze(-1))
        x = out.reshape(shape)
        m *= 2
    return x.to(out_dtype)


def ntt_inv_plain(x: torch.Tensor, wi: torch.Tensor, q: torch.Tensor,
                  ninv: torch.Tensor, rinv: torch.Tensor | None = None,
                  out_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Inverse negacyclic NTT, the kernel's plain version: bit-reversed
    eval order -> natural order, times N^-1 and, given rinv [L] (2^-32 mod
    q), times rinv (from_mont).  Each stage writes u + v and (u - v + q) *
    w, then one remainder."""
    shape = x.shape
    n, L = shape[-1], shape[-2]
    qc = q.reshape(L, 1, 1)
    x = x.long()
    t = 1
    m = n // 2
    while m >= 1:
        xr = x.reshape(shape[:-1] + (m, 2, t))
        u, v = xr[..., 0, :], xr[..., 1, :]
        out = torch.empty_like(xr)
        torch.add(u, v, out=out[..., 0, :])
        hi = out[..., 1, :]
        torch.sub(u, v, out=hi)
        hi.add_(qc)
        hi.mul_(wi[:, m:2 * m].reshape(L, m, 1))
        out.remainder_(qc.unsqueeze(-1))
        x = out.reshape(shape)
        t *= 2
        m //= 2
    x = rns.shoup_mul(x, ninv.reshape(L, 1), q.reshape(L, 1))
    if rinv is not None:
        x = rns.from_mont(x, q.reshape(L, 1), rinv.reshape(L, 1))
    return x.to(out_dtype)


def shoup_table(w: np.ndarray, q: np.ndarray) -> np.ndarray:
    """floor(w * 2^32 / q) per entry, uint32, for w < q [L, ...], q [L]."""
    w = np.asarray(w, dtype=np.uint64)
    qq = np.asarray(q, dtype=np.uint64).reshape((-1,) + (1,) * (w.ndim - 1))
    return ((w << np.uint64(32)) // qq).astype(np.uint32)


def mont_factors(q) -> tuple[np.ndarray, np.ndarray]:
    """(R mod q, R^-1 mod q) per prime, uint64, R = 2^32."""
    qs = [int(v) for v in np.asarray(q).reshape(-1)]
    return (np.asarray([R32 % v for v in qs], dtype=np.uint64),
            np.asarray([pow(R32, -1, v) for v in qs], dtype=np.uint64))


def kernel_tables(w, wi, ninv, q) -> dict:
    """The kernels' host tables (uint32): w, w_sh, wi, wi_sh [L, N] and the
    per-row constants rowc [L, 11] = (q, ninv, its companion, wi[1]*ninv
    mod q, its companion, R mod q, its companion, ninv*R^-1 mod q, its
    companion, wi[1]*ninv*R^-1 mod q, its companion): the inverse's last
    stage multiplies u+v by ninv and u-v by wi[1]*ninv (times R^-1 with
    from_mont); the forward multiplies its input by R with to_mont."""
    qh = np.asarray(q, dtype=np.uint64)
    ninv = np.asarray(ninv, dtype=np.uint64)
    wi1n = np.asarray(wi, dtype=np.uint64)[:, 1] * ninv % qh
    r, rinv = mont_factors(qh)
    consts = [ninv, wi1n, r, ninv * rinv % qh, wi1n * rinv % qh]
    rowc = np.stack([qh] + [a for c in consts
                            for a in (c, shoup_table(c, qh))],
                    axis=1).astype(np.uint32)
    return dict(w=np.asarray(w, dtype=np.uint32), w_sh=shoup_table(w, qh),
                wi=np.asarray(wi, dtype=np.uint32), wi_sh=shoup_table(wi, qh),
                rowc=rowc)


def _bits32(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host values -> int32 tensor with the same bits on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32)).to(device)


class DeviceNTT:
    """The NTT tables of one prime set on one device, uploaded once: the
    plain version's int64 w, wi [Lt, N], q, ninv, r (R mod q), rinv (R^-1
    mod q) [Lt]; on a CUDA device also the kernels' 32-bit tables (uint32
    bits in int32 tensors): w, w_sh, wi, wi_sh [Lt, N] and the per-row
    constants [Lt, 11] (`kernel_tables`: the folded N^-1 and Montgomery
    factors).  `rows(sel)` returns the cached `NTTRows` of a row
    selection."""

    def __init__(self, w, wi, ninv, q, device):
        self.device = torch.device(device)
        w = np.asarray(w, dtype=np.uint32)
        wi = np.asarray(wi, dtype=np.uint32)
        ninv = np.asarray(ninv, dtype=np.uint64)
        qh = np.asarray(q, dtype=np.uint64)
        self.n = w.shape[-1]
        if self.n < 2 or self.n & (self.n - 1):
            raise ValueError(f"NTT tables of N={self.n}: not a power of two")

        def dev64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        self.w, self.wi = dev64(w), dev64(wi)
        self.q, self.ninv = dev64(qh), dev64(ninv)
        self.r, self.rinv = (dev64(a) for a in mont_factors(qh))
        self._rows: dict[tuple, NTTRows] = {}
        if self.device.type == "cuda":
            k = kernel_tables(w, wi, ninv, qh)
            self.k_w, self.k_wsh, self.k_wi, self.k_wish, self.k_rowc = (
                _bits32(k[name], self.device)
                for name in ("w", "w_sh", "wi", "wi_sh", "rowc"))

    def rows(self, rows) -> "NTTRows":
        key = tuple(int(r) for r in rows)
        tr = self._rows.get(key)
        if tr is None:
            tr = NTTRows(self, key)
            self._rows[key] = tr
        return tr


class NTTRows:
    """A row selection of a DeviceNTT: the table row of each data row, on
    the device as an int32 vector for the kernels, and the plain version's
    q, ninv, r, rinv and (on demand) w, wi rows: a view when the rows are
    one contiguous run, else gathered per call."""

    def __init__(self, tabs: DeviceNTT, rows: tuple[int, ...]):
        self.tabs = tabs
        self.L = len(rows)
        idx = torch.as_tensor(rows, dtype=torch.int64, device=tabs.device)
        self.rows_dev = idx.to(torch.int32)
        self.q = tabs.q[idx]
        self.ninv = tabs.ninv[idx]
        self.r = tabs.r[idx]
        self.rinv = tabs.rinv[idx]
        runs = []
        for r in rows:
            if runs and runs[-1][1] == r:
                runs[-1][1] = r + 1
            else:
                runs.append([r, r + 1])
        self._runs = runs

    def _take(self, full):
        if len(self._runs) == 1:
            a, b = self._runs[0]
            return full[a:b]
        return torch.cat([full[a:b] for a, b in self._runs])

    def w(self):
        return self._take(self.tabs.w)

    def wi(self):
        return self._take(self.tabs.wi)


def _check(name: str, x: torch.Tensor, t: NTTRows, out_dtype):
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: x must be int32 or int64, got {x.dtype}")
    if out_dtype not in DTYPES:
        raise TypeError(f"{name}: out_dtype must be int32 or int64, got "
                        f"{out_dtype}")
    if x.dim() < 2:
        raise ValueError(f"{name}: x must be [..., L, N], got "
                         f"{tuple(x.shape)}")
    L, n = x.shape[-2], x.shape[-1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: N={n} is not a power of two >= 2")
    if n != t.tabs.n or L != t.L:
        raise ValueError(f"{name}: x has [L, N] = [{L}, {n}], the tables "
                         f"[{t.L}, {t.tabs.n}]")
    td = t.tabs.device
    if x.device.type != td.type or (td.index is not None
                                    and x.device.index != td.index):
        raise ValueError(f"{name}: x on {x.device}, tables on {td}")


def ntt_fwd(x: torch.Tensor, t: NTTRows, to_mont: bool = False,
            out_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Forward NTT of x int32 or int64 [..., L, N] (natural order) over the
    rows of t -> out_dtype [..., L, N] canonical residues in bit-reversed
    eval order; to_mont multiplies x by R = 2^32 mod q first."""
    _check("ntt_fwd", x, t, out_dtype)
    if x.device.type == "cpu":
        return ntt_fwd_plain(x, t.w(), t.q, t.r if to_mont else None,
                             out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_fwd: unsupported device {x.device}")
    y = _launch("ntt_fwd_launch", x, t, t.tabs.k_w, t.tabs.k_wsh, to_mont,
                out_dtype)
    global launches_fwd
    launches_fwd += _count(x)
    return y


def ntt_inv(x: torch.Tensor, t: NTTRows, from_mont: bool = False,
            out_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Inverse NTT of x int32 or int64 [..., L, N] (bit-reversed eval
    order) over the rows of t -> out_dtype [..., L, N] canonical residues
    in natural order; from_mont multiplies the result by R^-1 mod q."""
    _check("ntt_inv", x, t, out_dtype)
    if x.device.type == "cpu":
        return ntt_inv_plain(x, t.wi(), t.q, t.ninv,
                             t.rinv if from_mont else None, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_inv: unsupported device {x.device}")
    y = _launch("ntt_inv_launch", x, t, t.tabs.k_wi, t.tabs.k_wish,
                from_mont, out_dtype)
    global launches_inv
    launches_inv += _count(x)
    return y


def launches_per_transform(n: int) -> int:
    """Kernel launches of one ntt_fwd/ntt_inv call on a ring of n."""
    return 2 if n.bit_length() - 1 >= TWO_PASS_MIN_LOGN else 1


def _count(x) -> int:
    """A transform's launches, the 2^18 kernel's also counted in
    launches_cluster16 and the two-pass path's in launches_two_pass."""
    global launches_cluster16, launches_two_pass
    n = x.shape[-1]
    k = launches_per_transform(n)
    if k == 2:
        launches_two_pass += k
    elif n == 1 << CLUSTER16_LOGN:
        launches_cluster16 += k
    return k


def _launch(fn_name: str, x, t: NTTRows, w, wsh, mont: bool,
            out_dtype) -> torch.Tensor:
    """One transform on the current stream (one launch, two from 2^19): x
    is read through its batch and row strides (copied only when its last
    axis is strided), with 16-byte loads where its address and strides
    allow; the two-pass path takes an int32 scratch from the allocator for
    the residues between its launches; no host synchronisation, so it runs
    inside a CUDA graph capture."""
    L, n = x.shape[-2], x.shape[-1]
    logn = n.bit_length() - 1
    if logn > MAX_LOGN:
        raise ValueError(f"NTT kernel: N=2^{logn} above the kernels' largest "
                         f"ring 2^{MAX_LOGN} (csrc/ntt.cu kMaxLog)")
    xb = x.reshape(-1, L, n)
    if xb.stride(-1) != 1:
        xb = xb.contiguous()
    B = xb.shape[0]
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    vec = (xb.data_ptr() % 16 == 0 and xb.stride(0) % 4 == 0
           and xb.stride(1) % 4 == 0)
    scratch = None
    if logn >= TWO_PASS_MIN_LOGN:
        scratch = torch.empty(y.shape, dtype=torch.int32, device=x.device)
    fn = getattr(_library(), fn_name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(xb.data_ptr(), xb.stride(0), xb.stride(1), xb.element_size(),
             y.data_ptr(), y.element_size(),
             None if scratch is None else scratch.data_ptr(), w.data_ptr(),
             wsh.data_ptr(), t.tabs.k_rowc.data_ptr(), t.rows_dev.data_ptr(),
             B, L, logn, int(mont), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    return y


def _library():
    """The kernels' library: built and loaded at first use, when every
    kernel is also allowed its dynamic shared memory (ntt_setup)."""
    lib = kernels.load("ntt")
    if lib.ntt_fwd_launch.argtypes is None:
        for fn in (lib.ntt_fwd_launch, lib.ntt_inv_launch):
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.ntt_occupancy.argtypes = [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
        lib.ntt_occupancy.restype = ctypes.c_int
        lib.ntt_setup.restype = ctypes.c_int
        err = lib.ntt_setup()
        if err != 0:
            lib.ntt_fwd_launch.argtypes = None
            raise RuntimeError(f"ntt_setup failed: CUDA error {err}")
    return lib


def occupancy(logn: int) -> dict:
    """The launch a ring of 2^logn takes on the current card: blocks per
    SM, clusters resident at once (0 off the cluster paths: 8 blocks each
    at 2^16 and 2^17, 16 at 2^18), dynamic shared memory bytes and threads
    a block; from 2^19 those of the two-pass path's column pass, and under
    "runs" its run pass's, with the split (a, b): the column pass runs the
    first a stages."""
    out = (ctypes.c_int * 8)()
    err = _library().ntt_occupancy(logn, out)
    if err != 0:
        raise RuntimeError(f"ntt_occupancy failed: CUDA error {err}")
    occ = dict(blocks_per_sm=out[0], clusters=out[1], smem_bytes=out[2],
               threads=out[3])
    if logn >= TWO_PASS_MIN_LOGN:
        occ.update(split=(out[6], out[7]), runs=dict(
            blocks_per_sm=out[4], smem_bytes=out[5], threads=out[3]))
    return occ


def bytes_moved(B: int, L: int, n: int, in_bytes: int = 8,
                out_bytes: int = 8) -> int:
    """Least bytes a transform must move: each input word read once, each
    output word written once (4 bytes int32, 8 int64).  The two-pass path
    (N >= 2^19) moves each row through device memory twice by design: at
    least twice these bytes int32 in and out; up to 2^18 a row crosses it
    once."""
    return (in_bytes + out_bytes) * B * L * n


def int_mults(B: int, L: int, n: int, inverse: bool = False,
              to_mont: bool = False) -> int:
    """32-bit integer multiplies of the kernels' arithmetic: three per
    Shoup product, one product per butterfly (N/2 * logN a row), the
    inverse's folded last stage one more per butterfly, and to_mont one
    per input element."""
    logn = n.bit_length() - 1
    per_row = 3 * (n // 2) * (logn + (1 if inverse else 0))
    if to_mont and not inverse:
        per_row += 3 * n
    return B * L * per_row
