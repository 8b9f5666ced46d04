"""Keys and ciphertexts on disk, in the reference's `.npz` formats.
Counterpart of `aesfhe_tpu/utils/serialization.py` (its file formats and
`params_fingerprint`): residues are stored as uint32 arrays with the bits
the port keeps in int32 tensors, so a file either package writes loads in
the other.  Loading places tensors on the card unless the caller passes
device="cpu".

    ciphertext  data (uint32 [degree+1, level+1, N]), scale, kind
    keys        secret_s_eval, secret_s_coeff, public_{b,a}, relin_{b,a},
                conj_{b,a}, rot_<g>_{b,a} per Galois element g, and _meta:
                JSON bytes {"galois_elts": [...], "caps": {"<g>": cap}}
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any

import numpy as np

from ..core.ciphertext import Ciphertext
from ..core.keys import GaloisKeySet, PublicKey, SecretKey, SwitchKey
from ..interop import to_numpy, to_tensor


def save_ciphertext(path: Path, ct: Ciphertext):
    np.savez_compressed(path, data=to_numpy(ct.data), scale=ct.scale,
                        kind="ciphertext")


def load_ciphertext(path: Path, device="cuda") -> Ciphertext:
    z = np.load(path)
    return Ciphertext(to_tensor(z["data"], device), float(z["scale"]))


def save_keys(path: Path, *, secret: SecretKey | None = None,
              public: PublicKey | None = None,
              relin: SwitchKey | None = None,
              conj: SwitchKey | None = None,
              rotation: GaloisKeySet | None = None):
    """Any subset of the key family into one .npz."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {"galois_elts": []}
    if secret is not None:
        arrays["secret_s_eval"] = to_numpy(secret.s_eval)
        arrays["secret_s_coeff"] = np.asarray(secret.s_coeff)
    for name, key in (("public", public), ("relin", relin), ("conj", conj)):
        if key is not None:
            arrays[f"{name}_b"] = to_numpy(key.b)
            arrays[f"{name}_a"] = to_numpy(key.a)
    if rotation is not None:
        meta["caps"] = {}
        for g, k in rotation.keys.items():
            arrays[f"rot_{g}_b"] = to_numpy(k.b)
            arrays[f"rot_{g}_a"] = to_numpy(k.a)
            meta["galois_elts"].append(g)
            if k.cap is not None:
                meta["caps"][str(g)] = int(k.cap)
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_keys(path: Path, device="cuda") -> dict:
    """{"secret", "public", "relin", "conj", "rotation"}: whichever the file
    holds."""
    z = np.load(path)
    meta = json.loads(bytes(z["_meta"]).decode()) if "_meta" in z else {}
    out: dict[str, Any] = {}
    if "secret_s_eval" in z:
        out["secret"] = SecretKey(to_tensor(z["secret_s_eval"], device),
                                  np.asarray(z["secret_s_coeff"],
                                             dtype=np.int8))
    if "public_b" in z:
        out["public"] = PublicKey(to_tensor(z["public_b"], device),
                                  to_tensor(z["public_a"], device))
    for name in ("relin", "conj"):
        if f"{name}_b" in z:
            out[name] = SwitchKey(to_tensor(z[f"{name}_b"], device),
                                  to_tensor(z[f"{name}_a"], device))
    elts = meta.get("galois_elts", [])
    if elts:
        caps = meta.get("caps", {})
        out["rotation"] = GaloisKeySet(keys={
            g: SwitchKey(to_tensor(z[f"rot_{g}_b"], device),
                         to_tensor(z[f"rot_{g}_a"], device),
                         cap=caps.get(str(g))) for g in elts})
    return out


def params_fingerprint(params) -> str:
    """Stable fingerprint of everything keygen depends on: the ring, the
    full prime basis, and the digit-group structure."""
    h = hashlib.sha256()
    h.update(repr((params.n, params.max_level, params.scale_bits,
                   params.secret_hamming, params.alpha,
                   params.all_primes)).encode())
    return h.hexdigest()[:16]
