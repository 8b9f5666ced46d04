"""State carried across between the reference package and the port.

The reference keeps residues as uint32 arrays; the port as int32 tensors
with the same bits.  These functions take and return numpy arrays (a caller
holding JAX arrays passes `np.asarray(x)`), so this module imports no JAX.
Like the engine, they place tensors on the card unless the caller passes
device="cpu".
"""
from __future__ import annotations

import numpy as np
import torch

from .bootstrap import BootstrapKey, _bsgs_split, build_factored_plans
from .core.ciphertext import Ciphertext
from .core.engine import resolve_device
from .core.keys import GaloisKeySet, PublicKey, SecretKey, SwitchKey


def to_tensor(arr, device="cuda") -> torch.Tensor:
    """uint32 residue array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(arr)
    if a.dtype != np.uint32:
        raise TypeError(f"expected uint32 residues, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(
        resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 residue tensor -> uint32 array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32 residues, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def ciphertext(data, scale: float, device="cuda") -> Ciphertext:
    return Ciphertext(to_tensor(data, device), float(scale))


def ciphertext_arrays(ct: Ciphertext) -> tuple[np.ndarray, float]:
    return to_numpy(ct.data), float(ct.scale)


def secret_key(s_eval, s_coeff, device="cuda") -> SecretKey:
    return SecretKey(to_tensor(s_eval, device),
                     np.asarray(s_coeff, dtype=np.int8))


def public_key(b, a, device="cuda") -> PublicKey:
    return PublicKey(to_tensor(b, device), to_tensor(a, device))


def switch_key(b, a, cap: int | None = None, device="cuda") -> SwitchKey:
    return SwitchKey(to_tensor(b, device), to_tensor(a, device),
                     None if cap is None else int(cap))


def galois_keys(keys: dict, device="cuda") -> GaloisKeySet:
    """{galois element: (b, a, cap)} -> GaloisKeySet."""
    return GaloisKeySet(keys={int(g): switch_key(b, a, cap, device)
                              for g, (b, a, cap) in keys.items()})


def bootstrap_key(params, keys: dict, *, K: float, cheb_deg: int,
                  double_angles: int, prescale: float, hi_prec: bool,
                  hi_scale: float, small: bool = False,
                  factored: bool = True, device="cuda") -> BootstrapKey:
    """A bootstrap key from the reference's Galois keys ({galois element:
    (b, a, cap)}) and scalar fields; the factored plans or the dense BSGS
    split are rebuilt from `params`."""
    rot = galois_keys(keys, device)
    common = dict(small=bool(small), rot=rot, K=float(K),
                  cheb_deg=int(cheb_deg), double_angles=int(double_angles),
                  prescale=float(prescale), hi_prec=bool(hi_prec),
                  hi_scale=float(hi_scale), factored=bool(factored))
    if not factored:
        baby, giant = _bsgs_split(params.slot_count)
        return BootstrapKey(baby=baby, giant=giant, **common)
    stc_plan, cts_plan = build_factored_plans(params)
    return BootstrapKey(stc_plan=stc_plan, cts_plan=cts_plan, **common)


def switch_key_arrays(key: SwitchKey) -> tuple[np.ndarray, np.ndarray,
                                               int | None]:
    return to_numpy(key.b), to_numpy(key.a), key.cap
