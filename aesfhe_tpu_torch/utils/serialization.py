"""Keys and ciphertexts on disk, in the reference's `.npz` formats, and the
on-disk key cache.  Counterpart of `aesfhe_tpu/utils/serialization.py`:
residues are stored as uint32 arrays with the bits the port keeps in int32
tensors, so a file either package writes loads in the other (the cache's
files too: same names, same fingerprints).  Loading places tensors on the
card unless the caller passes device="cpu".

    ciphertext  data (uint32 [degree+1, level+1, N]), scale, kind
    keys        secret_s_eval, secret_s_coeff, public_{b,a}, relin_{b,a},
                conj_{b,a}, rot_<g>_{b,a} per Galois element g, and _meta:
                JSON bytes {"galois_elts": [...], "caps": {"<g>": cap}}
"""
from __future__ import annotations

import hashlib
import json
import os
import secrets
import zipfile
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


def _cache_cap_mb() -> float:
    return float(os.environ.get("AESFHE_KEY_CACHE_MAX_MB", "1024"))


def _save_atomic(path: Path, **keys):
    """save_keys through a temp name no other writer uses (pid and a random
    suffix), then one atomic rename: concurrent writers of the same entry
    each replace it whole, and a reader never sees half a file."""
    tmp = path.with_name(f"{path.stem}.{os.getpid()}."
                         f"{secrets.token_hex(6)}.tmp.npz")
    try:
        save_keys(tmp, **keys)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def cached_key_family(engine, cache_dir, rotation_steps=None) -> dict:
    """The (secret, public, relin, conj, rotation) key family of `engine`
    from `cache_dir`, generated from the engine's generator and saved on
    first use.  Counterpart of the reference's function of that name: the
    same file name (`keys_<params_fingerprint>.npz`, the fingerprint bound
    to the sorted explicit rotation steps when given), the same draw order
    (secret, rotations, public, relin, conj), the same size cap (families
    whose switch keys exceed AESFHE_KEY_CACHE_MAX_MB, default 1024, are
    generated but not saved), so files cross between the packages.  Unlike
    the reference it writes through a temp name of its own
    (`_save_atomic`), so concurrent writers do not race.

    `rotation_steps`: None -> the power-of-two ladder; a sequence -> only
    those steps (possibly none)."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    fp = params_fingerprint(engine.params)
    if rotation_steps is not None:
        fp = hashlib.sha256((fp + repr(sorted(set(
            int(s) for s in rotation_steps)))).encode()).hexdigest()[:16]
    path = cache_dir / f"keys_{fp}.npz"
    if path.exists():
        try:
            k = load_keys(path, device=engine.device)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            path.unlink(missing_ok=True)
        else:
            need = {"secret", "public", "relin", "conj"}
            # a ladder caller needs the rotation keys in the file
            if rotation_steps is None:
                need |= {"rotation"}
            if need <= set(k):
                k.setdefault("rotation", GaloisKeySet(keys={}))
                return k
    sk = engine.create_secret_key()
    if rotation_steps is None:
        rot = engine.create_rotation_key(sk)
    elif rotation_steps:
        rot = engine.create_fixed_rotation_key(sk, list(rotation_steps))
    else:
        rot = GaloisKeySet(keys={})
    out = dict(secret=sk, public=engine.create_public_key(sk),
               relin=engine.create_relinearization_key(sk),
               conj=engine.create_conjugation_key(sk), rotation=rot)
    p = engine.params
    switch_mb = (2 + len(rot.keys)) * 2 * p.dnum * p.L_tot * p.n * 4 / 2**20
    if switch_mb <= _cache_cap_mb():
        _save_atomic(path, **out)
    return out


def cached_bootstrap_key(engine, sk, cache_dir, *, small: bool = False,
                         factored: bool | None = None,
                         hi_prec: bool | None = None):
    """create_bootstrap_key with its Galois key set cached on disk, under
    the reference's name (`bootrot_<hash>.npz`: the params fingerprint, the
    flavor knobs and the secret key's coefficients), size-capped like
    cached_key_family."""
    from .. import bootstrap as bs
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256((params_fingerprint(engine.params) +
                        f"|boot|{small}|{factored}|{hi_prec}").encode())
    h.update(np.ascontiguousarray(sk.s_coeff).tobytes())
    path = cache_dir / f"bootrot_{h.hexdigest()[:16]}.npz"
    rot = None
    if path.exists():
        try:
            rot = load_keys(path, device=engine.device).get("rotation")
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            path.unlink(missing_ok=True)
    had_cache = rot is not None
    bk = bs.create_bootstrap_key(engine, sk, small=small, factored=factored,
                                 rot=rot, hi_prec=hi_prec)
    if not had_cache and bk.rot is not None and bk.rot.keys:
        mb = sum(k.b.numel() + k.a.numel()
                 for k in bk.rot.keys.values()) * 4 / 2 ** 20
        if mb <= _cache_cap_mb():
            _save_atomic(path, rotation=bk.rot)
    return bk
