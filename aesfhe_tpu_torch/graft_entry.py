"""Entry points: one compute step as a callable, and a multi-rank dry run.
Counterpart of `__graft_entry__.py`.

entry() -> (fn, example_args): the innermost compute of the AES-FHE
pipeline, homomorphic AES SubBytes on a nibble-pair state (the 2D zeta16
S-box LUT pair over shared power bases) at N = 2^10; fn takes and returns
the two ciphertexts' residue tensors.

dryrun_multichip(n): one batched AddRoundKey + SubBytes step on a
(data, limb) mesh of n ranks at N = 2^8, each rank a spawned process: the
batch of nibble-pair states splits over "data" (parallel.batch), every
key-switch shards its digits over "limb" (MeshEngine), and every output
ciphertext must equal the single-device Engine's bit for bit; lane 0
decrypts to the AES S-box.  With n even the mesh is (2, n/2), else (1, n).
Then the distributed NTT over a 1-D mesh of the n ranks, fwd and inv
against the port's NTT.  Ranks run on the card (NCCL with a card per
rank, else gloo with the ranks sharing the card) unless device="cpu".
"""
from __future__ import annotations

import numpy as np
import torch

from .context import EngineContext
from .core.ciphertext import Ciphertext
from .core.engine import resolve_device
from .core.params import CKKSParams
from .ops.mixcolumns_service import AESFHETransformer
from .ops.xor_service import COEFF_DIR, CoefficientCache, EngineWrapper
from .ops.xor_service import XORService
from .ops.zeta import ZetaEncoder, split_nibbles

ENTRY_PARAMS = dict(n=1 << 10, max_level=14, scale_bits=26,
                    num_special_primes=2)
DRYRUN_PARAMS = dict(n=1 << 8, max_level=15, scale_bits=26,
                     num_special_primes=2)


def _build(params: CKKSParams, device, seed: int, mesh=None):
    """Context (relin and conj keys: the step rotates nothing), XOR
    service and transformer."""
    ctx = EngineContext(params=params, device=device, mesh=mesh,
                        rotation_steps=(), rng=np.random.default_rng(seed))
    wrap = EngineWrapper(ctx=ctx)
    xor_svc = XORService(wrap)
    return ctx, xor_svc, AESFHETransformer(wrap, xor_svc)


def _sbox_luts():
    return (CoefficientCache(COEFF_DIR / "sbox_hi2d_coeffs.json").load_coeffs(),
            CoefficientCache(COEFF_DIR / "sbox_lo2d_coeffs.json").load_coeffs())


def entry(device="cuda"):
    """(sub_bytes_step, (hi_data, lo_data)): SubBytes on a nibble pair."""
    params = CKKSParams(**ENTRY_PARAMS)
    ctx, xor_svc, tf = _build(params, resolve_device(device), 0)
    hi2d, lo2d = _sbox_luts()
    scale = params.scale

    def sub_bytes_step(hi_data, lo_data):
        bh = xor_svc._build_power_basis(Ciphertext(hi_data, scale))
        bl = xor_svc._build_power_basis(Ciphertext(lo_data, scale))
        return (tf._bilinear(bh, bl, hi2d).data,
                tf._bilinear(bh, bl, lo2d).data)

    state = np.random.default_rng(1).integers(0, 256, params.slot_count,
                                              dtype=np.uint8)
    s_hi, s_lo = split_nibbles(state)
    ct_hi = ctx.encrypt(ZetaEncoder.to_zeta(s_hi, 16))
    ct_lo = ctx.encrypt(ZetaEncoder.to_zeta(s_lo, 16))
    return sub_bytes_step, (ct_hi.data, ct_lo.data)


def _round_step(xor_svc, tf, luts, key_nibbles, ct_hi, ct_lo):
    """AddRoundKey (plaintext key) + SubBytes on one nibble-pair state."""
    hi = xor_svc._xor_with_plain_nibbles(ct_hi, key_nibbles[0])
    lo = xor_svc._xor_with_plain_nibbles(ct_lo, key_nibbles[1])
    bh = xor_svc._build_power_basis(hi)
    bl = xor_svc._build_power_basis(lo)
    return tf._bilinear(bh, bl, luts[0]), tf._bilinear(bh, bl, luts[1])


def _dryrun_rank(rank, world, device_type):
    from .aes_tables import AES_SBOX
    from .core import ntt
    from .parallel.batch import sharded_circuit
    from .parallel.dist_ntt import DistNTT
    from .parallel.mesh import axis_rank, make_mesh, mesh_device
    from .parallel.multihost import fetch_global, sharded_global

    torch.set_num_threads(1)
    data_ax = 2 if world % 2 == 0 else 1
    limb_ax = world // data_ax
    mesh = make_mesh(data_ax, limb_ax, device_type)
    dev = mesh_device(mesh)
    params = CKKSParams(**DRYRUN_PARAMS)
    ctx, xor_svc, tf = _build(params, dev, 0)
    mctx = ctx.on_mesh(mesh)
    mwrap = EngineWrapper(ctx=mctx)
    mxor = XORService(mwrap)
    mtf = AESFHETransformer(mwrap, mxor)
    luts = _sbox_luts()
    sc = params.slot_count
    key = np.tile(np.arange(16, dtype=np.uint8), sc // 16)
    knib = split_nibbles(key)
    B = max(2, data_ax * 2)
    states = np.random.default_rng(2).integers(0, 256, (B, sc),
                                               dtype=np.uint8)
    pairs = [[ctx.encrypt(ZetaEncoder.to_zeta(h, 16)) for h in
              split_nibbles(s)] for s in states]
    scale = pairs[0][0].scale
    stack = torch.stack([torch.stack([p[0].data, p[1].data])
                         for p in pairs])                 # [B, 2, k, L, N]

    def step(ct):                        # ct.data [2 (hi, lo), k, L, N]
        hi, lo = _round_step(mxor, mtf, luts, knib,
                             Ciphertext(ct.data[0], ct.scale),
                             Ciphertext(ct.data[1], ct.scale))
        if hi.scale != lo.scale or hi.level != lo.level:
            raise AssertionError("hi and lo left the step unaligned")
        return Ciphertext(torch.stack([hi.data, lo.data]), hi.scale)

    out, out_scale = sharded_circuit(step, scale, mesh)(stack)
    # each rank holds its own batch block to one device; together the
    # ranks cover every lane
    per = B // data_ax
    mine = range(axis_rank(mesh, "data") * per,
                 (axis_rank(mesh, "data") + 1) * per)
    for b in mine:
        want = _round_step(xor_svc, tf, luts, knib, *pairs[b])
        for i in range(2):
            if not torch.equal(out[b, i], want[i].data) or \
                    out_scale != want[i].scale:
                raise AssertionError(f"lane {b} {'hi' if i == 0 else 'lo'}:"
                                     f" the mesh differs from one device")
    hi = ctx.decrypt(Ciphertext(out[0, 0], out_scale))
    lo = ctx.decrypt(Ciphertext(out[0, 1], out_scale))
    got = (ZetaEncoder.from_zeta(hi, 16) << 4) | ZetaEncoder.from_zeta(lo, 16)
    if not np.array_equal(got, AES_SBOX[states[0] ^ key]):
        raise AssertionError("multichip round step decodes wrong")

    # the distributed NTT over a 1-D mesh of every rank
    ntt_ok = None
    A = 1 << ((params.n.bit_length() - 1) // 2)
    if A % world == 0:
        mesh1 = make_mesh(1, world, device_type)
        d = DistNTT(params, mesh1)
        L = params.num_q
        rng = np.random.default_rng(11)
        x = np.stack([rng.integers(0, int(q), params.n)
                      for q in params.q_primes[:L]])
        want = ntt.ntt_fwd(torch.as_tensor(x, device=dev),
                           ctx.engine.tabs.ntt.rows(range(L)))
        y = d.fwd(sharded_global(mesh1, x.reshape(L, A, A).astype(np.int32),
                                 2))
        got = fetch_global(y, mesh1, 1).reshape(L, params.n)
        back = fetch_global(d.inv(y), mesh1, 2).reshape(L, params.n)
        ntt_ok = (np.array_equal(got, want.cpu().numpy())
                  and np.array_equal(back, x))
        if not ntt_ok:
            raise AssertionError("distributed NTT differs from one device")
    return dict(mesh=(data_ax, limb_ax), batch=B, n=params.n,
                keyswitches=int(mctx.engine.counters["keyswitch"]),
                collectives=mctx.engine.dks.comm.mode, ntt_exact=ntt_ok)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The batched step on n ranks (see the module docstring); returns rank
    0's summary and raises on any mismatch."""
    from .parallel.launch import spawn
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        backend = "nccl"
    out = spawn(_dryrun_rank, n_devices, dev.type, backend=backend)[0]
    print(f"dryrun_multichip({n_devices}): OK (mesh data={out['mesh'][0]} x "
          f"limb={out['mesh'][1]}, batch={out['batch']}, n={out['n']}, "
          f"{out['keyswitches']} key-switches on the mesh, "
          f"{out['collectives']}; distributed NTT exact: {out['ntt_exact']})")
    return out


if __name__ == "__main__":
    import sys
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
