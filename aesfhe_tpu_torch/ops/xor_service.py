"""Homomorphic XOR and AddRoundKey in the zeta domain, and the engine
facade every service calls.  Counterpart of `aesfhe_tpu/ops/xor_service.py`.

Domain conventions: a byte b is zeta256^b; a nibble v is zeta16^v.  A LUT
is a polynomial in the power basis of its input (coeffs/generate.py); a 2D
LUT sum_ij c_ij x^i y^j runs as one fused linear combination per row and one
inner product with a single relinearization (`bilinear_lut`).  Nibble
extraction returns zeta16-domain nibbles; the recombine lifts the low nibble
back to zeta256 through the lo_lift LUT.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from ..coeffs import generate as coeffgen
from ..context import EngineContext
from ..core import keys as keys_mod
from ..core.ciphertext import Ciphertext
from ..core.engine import Engine
from .zeta import ZetaEncoder, split_nibbles

COEFF_DIR = coeffgen.COEFF_DIR


class XORConfig:
    """Engine configuration: ring profile (or explicit params), device, the
    rotation keys generated up front (None -> power-of-two ladder; a
    sequence, possibly empty -> only those steps), whether to generate the
    bootstrap key, whether EngineWrapper.bootstrap replays the fused
    bootstrap (`fused_boot`; the reference's AESFHE_FUSED_BOOT, off by
    default as there), the device mesh the engine's key-switches shard over
    (`mesh`, `mesh_axis`: see EngineContext), and the coefficient files of
    the XOR service.  A fused bootstrap is a CUDA graph, which cannot
    capture the mesh's collectives: with a mesh, `fused_boot` raises."""

    def __init__(self, profile: str | None = None, params=None,
                 rotation_steps=None, device="cuda",
                 use_bootstrap: bool = False, fused_boot: bool = False,
                 mesh=None, mesh_axis: str = "limb",
                 coeffs_path: Path = COEFF_DIR / "xor_mono_coeffs.json",
                 nibble_hi_path: Path = COEFF_DIR / "nibble_hi16_coeffs.json",
                 nibble_lo_path: Path = COEFF_DIR / "nibble_test.json",
                 mul_coeffs_path: Path = COEFF_DIR / "xor_256x256_coeffs.json",
                 lo_lift_path: Path = COEFF_DIR / "lo_lift_coeffs.json"):
        self.coeffs_path = Path(coeffs_path)
        self.nibble_hi_path = Path(nibble_hi_path)
        self.nibble_lo_path = Path(nibble_lo_path)
        self.mul_coeffs_path = Path(mul_coeffs_path)
        self.lo_lift_path = Path(lo_lift_path)
        self.profile = profile
        self.params = params
        self.rotation_steps = rotation_steps
        self.device = device
        self.use_bootstrap = use_bootstrap
        self.fused_boot = fused_boot
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        _check_fused_on_mesh(fused_boot, mesh)


def _check_fused_on_mesh(fused_boot: bool, mesh):
    if fused_boot and mesh is not None:
        raise ValueError("fused_boot=True on a device mesh: the fused "
                         "bootstrap is a CUDA graph, which cannot capture "
                         "the mesh's collectives; use the eager bootstrap "
                         "(fused_boot=False)")


class EngineWrapper:
    """Ergonomic op facade over an EngineContext's engine and keys."""

    def __init__(self, config: XORConfig | None = None, *,
                 ctx: EngineContext | None = None,
                 rng: np.random.Generator | None = None):
        config = config or XORConfig()
        if ctx is None:
            ctx = EngineContext(params=config.params, profile=config.profile,
                                device=config.device, rng=rng,
                                rotation_steps=config.rotation_steps,
                                use_bootstrap=config.use_bootstrap,
                                mesh=config.mesh, mesh_axis=config.mesh_axis)
        _check_fused_on_mesh(config.fused_boot,
                             getattr(ctx.engine, "mesh", None))
        self.ctx = ctx
        self.engine: Engine = ctx.engine
        self.public_key = ctx.public_key
        self.secret_key = ctx.secret_key
        self.relin_key = ctx.relinearization_key
        self.conj_key = ctx.conjugation_key
        self.rot_key = ctx.rotation_key
        self.boot_key = ctx.bootstrap_key
        self.fused_boot = config.fused_boot
        # FusedBootstrap instances by input-scale bucket (see _bootstrap_fused)
        self.fused_instances: dict = {}

    def encrypt(self, data, device: bool = False):
        return self.engine.encrypt(np.asarray(data), self.public_key,
                                   device=device)

    def decrypt(self, ct, device: bool = False) -> np.ndarray:
        return self.engine.decrypt(ct, self.secret_key, device=device)

    def encode(self, vec):
        return self.engine.encode(np.asarray(vec))

    def multiply(self, a, b, relin_key=None):
        if isinstance(a, Ciphertext) and isinstance(b, Ciphertext):
            return self.engine.multiply(a, b, relin_key or self.relin_key)
        return self.engine.multiply(a, b)

    def add(self, a, b):
        return self.engine.add(a, b)

    def add_plain(self, ct, val):
        return self.engine.add_plain(ct, val)

    def make_power_basis(self, ct, degree: int):
        return self.engine.make_power_basis(ct, degree, self.relin_key)

    def conjugate(self, ct):
        return self.engine.conjugate(ct, self.conj_key)

    def multiply_plain(self, ct, val):
        return self.engine.multiply_plain(ct, val)

    def rotate(self, ct, steps: int):
        return self.engine.rotate(ct, self.rot_key, steps)

    def bootstrap(self, ct):
        """Refresh `ct` with the context's bootstrap key: a replay of the
        fused bootstrap when the config asks for it, else the eager path."""
        if self.fused_boot:
            return self._bootstrap_fused(ct)
        return self.engine.bootstrap(ct, self.relin_key, self.conj_key,
                                     self.boot_key)

    def _bootstrap_fused(self, ct):
        """Drop to level 0 first (ModRaise reads only the bottom prime), so
        one FusedBootstrap serves every input level; one instance per input
        scale, bucketed at 1e-4 in log2.  A new instance bootstraps its first
        input eagerly while it captures (FusedBootstrap.warm_out), so that
        input is not bootstrapped twice."""
        from ..bootstrap import FusedBootstrap
        ct = self.engine._drop(ct, 0)
        key = round(float(np.log2(ct.scale)) * 1e4)
        inst = self.fused_instances.get(key)
        if inst is None:
            inst = FusedBootstrap(self.engine, self.relin_key, self.conj_key,
                                  self.boot_key, ct)
            self.fused_instances[key] = inst
            if inst.warm_out is not None:
                out, inst.warm_out = inst.warm_out, None
                return out
        return inst(ct)

    def relinearize(self, ct, relin_key=None):
        # degree-2 only; a degree-1 input comes back unchanged
        try:
            return self.engine.relinearize(ct, relin_key or self.relin_key)
        except RuntimeError as e:
            if "should have 3 polynomials" in str(e):
                return ct
            raise

    def ensure_rotation_steps(self, steps):
        """Generate direct full-level Galois keys for any `steps` missing
        from the rotation key set (hoisted rotations need direct keys).  A
        present level-capped key is regenerated."""
        params = self.engine.params
        sc = params.slot_count

        def _insufficient(g: int) -> bool:
            k = self.rot_key.keys.get(g)
            return k is None or k.cap is not None

        missing = [s % sc for s in steps
                   if s % sc and _insufficient(params.rot_galois_elt(s % sc))]
        if missing:
            fixed = keys_mod.gen_rotation_keys(params, self.engine.tabs,
                                               self.secret_key,
                                               self.engine.rng,
                                               sorted(set(missing)))
            self.rot_key.keys.update(
                {g: self.engine.adopt_key(k) for g, k in fixed.keys.items()})

    def linear_combination(self, cts, coeffs, constant=0.0,
                           target_scale=None):
        return self.engine.linear_combination(cts, coeffs, constant,
                                              target_scale=target_scale)

    def inner_product(self, lhs, rhs):
        return self.engine.inner_product(lhs, rhs, self.relin_key)


class CoefficientCache:
    """JSON -> complex coefficient dict: 1D [i, re, im] entries keyed by i,
    2D [i, j, re, im] entries keyed by (i, j)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._coeffs = None

    def load_coeffs(self) -> Dict[Any, complex]:
        if self._coeffs is None:
            data = json.loads(self.path.read_text(encoding="utf-8"))
            coeffs: Dict[Any, complex] = {}
            for entry in data["entries"]:
                if len(entry) == 3:
                    i, re, im = entry
                    coeffs[int(i)] = re + 1j * im
                elif len(entry) == 4:
                    i, j, re, im = entry
                    coeffs[(int(i), int(j))] = re + 1j * im
                else:
                    raise ValueError(f"Unrecognized entry format: {entry}")
            self._coeffs = coeffs
        return self._coeffs


class FullXORCache(CoefficientCache):
    """The 256x256 XOR coefficients (2D entries only)."""

    def load_coeffs(self) -> Dict[Tuple[int, int], complex]:
        coeffs = super().load_coeffs()
        if not all(isinstance(k, tuple) for k in coeffs):
            raise ValueError(f"{self.path} holds 1D entries")
        return coeffs


def _dense_1d(path: Path, n: int) -> np.ndarray:
    c = coeffgen.load_1d_coeffs(path)
    if len(c) != n:
        raise ValueError(f"{path}: {len(c)} coefficients, expected {n}")
    return c


# ---------------------------------------------------------------------------
# LUT evaluation shared by XORService, SBoxService, GFService and
# AESFHETransformer.
# ---------------------------------------------------------------------------

def build_power_basis_256(eng: EngineWrapper,
                          ct: Ciphertext) -> Dict[int, Ciphertext]:
    """t^1..t^255 in the zeta256 domain: a binary-depth ladder to t^128 plus
    conjugations for the upper half, t^(256-k) = conj(t^k)."""
    pos = eng.make_power_basis(ct, 128)
    basis = {k: pos[k - 1] for k in range(1, 129)}
    for k in range(129, 256):
        basis[k] = eng.conjugate(pos[256 - k - 1])
    return basis


def eval_lut_1d(eng: EngineWrapper, basis: Dict[int, Ciphertext],
                coeffs: np.ndarray) -> Ciphertext:
    """sum_k coeffs[k] * t^k over a prebuilt power basis, as ONE fused
    linear combination (the constant term rides it symbolically)."""
    ks = [k for k in range(1, len(coeffs)) if abs(coeffs[k]) > 1e-12]
    return eng.linear_combination([basis[k] for k in ks],
                                  [coeffs[k] for k in ks],
                                  constant=coeffs[0])


def bilinear_lut(eng: EngineWrapper, bx: Dict[int, Ciphertext],
                 by: Dict[int, Ciphertext], coeffs) -> Ciphertext:
    """res = sum_ij c_ij x^i y^j from prebuilt power bases.

    Row-major fusion: each row i (in sorted order) collapses to one fused
    linear combination over by (columns in sorted order), then all rows
    reduce in a single inner product with one relinearization; the pure-x,
    pure-y and constant terms ride separate fused combinations.  The order
    of the sums is part of the result: the reference sums alike, residue
    for residue."""
    rows: Dict[int, Dict[int, complex]] = {}
    const = 0.0
    lin_b: Dict[int, complex] = {}
    lin_a: Dict[int, complex] = {}
    for (i, j), c in coeffs.items():
        if i == 0 and j == 0:
            const += c
        elif i == 0:
            lin_b[j] = lin_b.get(j, 0) + c
        elif j == 0:
            lin_a[i] = lin_a.get(i, 0) + c
        else:
            rows.setdefault(i, {})[j] = c
    lhs, rhs = [], []
    for i, row in sorted(rows.items()):
        js = sorted(row)
        lhs.append(bx[i])
        rhs.append(eng.linear_combination([by[j] for j in js],
                                          [row[j] for j in js]))
    res = eng.inner_product(lhs, rhs)
    if lin_a:
        ks = sorted(lin_a)
        res = eng.add(res, eng.linear_combination(
            [bx[k] for k in ks], [lin_a[k] for k in ks]))
    if lin_b:
        ks = sorted(lin_b)
        res = eng.add(res, eng.linear_combination(
            [by[k] for k in ks], [lin_b[k] for k in ks]))
    if const:
        res = eng.add_plain(res, const)
    return res


class XORService:
    """4-bit and 8-bit homomorphic XOR, nibble extraction and recombine,
    the root-of-unity cleanse, and AddRoundKey with a plaintext key."""

    BOOT_LEVEL = 8   # an XOR input below this level is bootstrapped first

    def __init__(self, engine_wrapper: EngineWrapper,
                 coeff_cache: CoefficientCache | None = None,
                 nibble_hi_cache: CoefficientCache | None = None,
                 nibble_lo_cache: CoefficientCache | None = None,
                 full_xor_cache: FullXORCache | None = None,
                 lo_lift_cache: CoefficientCache | None = None):
        self.eng_wrap = engine_wrapper
        self.coeff_cache = coeff_cache or CoefficientCache(
            COEFF_DIR / "xor_mono_coeffs.json")
        self.nibble_hi_cache = nibble_hi_cache or CoefficientCache(
            COEFF_DIR / "nibble_hi16_coeffs.json")
        self.nibble_lo_cache = nibble_lo_cache or CoefficientCache(
            COEFF_DIR / "nibble_test.json")
        self.full_xor_cache = full_xor_cache or FullXORCache(
            COEFF_DIR / "xor_256x256_coeffs.json")
        self.lo_lift_cache = lo_lift_cache or CoefficientCache(
            COEFF_DIR / "lo_lift_coeffs.json")
        # key pattern -> encoded ARK weight plaintexts (LRU); 32 patterns
        # cover an AES-128 key schedule (11 round keys x hi/lo) with room
        self._ark_pt_cache: Dict[bytes, Any] = {}

    _ARK_CACHE_CAP = 32

    @property
    def eng(self) -> EngineWrapper:
        return self.eng_wrap

    # ------------------------------------------------------------------
    def _maybe_bootstrap(self, ct: Ciphertext, need: int) -> Ciphertext:
        if ct.level < need and self.eng_wrap.boot_key is not None:
            return self.eng_wrap.bootstrap(ct)
        return ct

    def _build_power_basis(self, ct: Ciphertext) -> Dict[int, Ciphertext]:
        """t^1..t^15 in the zeta16 domain: a degree-8 ladder plus
        conjugations for the upper half, t^(16-k) = conj(t^k).  Index 0 is
        absent: constant terms ride linear_combination symbolically."""
        eng = self.eng_wrap
        pos = eng.make_power_basis(ct, 8)
        basis = {i + 1: c for i, c in enumerate(pos)}
        for k in range(1, 8):
            basis[16 - k] = eng.conjugate(pos[k - 1])
        return basis

    def _build_power_basis_256(self, ct: Ciphertext) -> Dict[int, Ciphertext]:
        return build_power_basis_256(self.eng_wrap, ct)

    # ------------------------------------------------------------------
    def _lut2d_cipher(self, enc_a, enc_b, basis_builder, coeffs):
        return bilinear_lut(self.eng_wrap, basis_builder(enc_a),
                            basis_builder(enc_b), coeffs)

    def xor_cipher(self, enc_a: Ciphertext, enc_b: Ciphertext) -> Ciphertext:
        """4-bit XOR of two zeta16-domain ciphertexts."""
        enc_a = self._maybe_bootstrap(enc_a, self.BOOT_LEVEL)
        enc_b = self._maybe_bootstrap(enc_b, self.BOOT_LEVEL)
        return self._lut2d_cipher(enc_a, enc_b, self._build_power_basis,
                                  self.coeff_cache.load_coeffs())

    def xor_cipher_full(self, enc_a: Ciphertext,
                        enc_b: Ciphertext) -> Ciphertext:
        """8-bit XOR of two zeta256-domain ciphertexts (the 16384-term
        256x256 LUT)."""
        return self._lut2d_cipher(enc_a, enc_b, self._build_power_basis_256,
                                  self.full_xor_cache.load_coeffs())

    # ------------------------------------------------------------------
    def xor(self, a_int: np.ndarray, b_int: np.ndarray) -> np.ndarray:
        """End-to-end 4-bit XOR: encrypt, xor_cipher, decrypt."""
        eng = self.eng_wrap
        enc_a = eng.encrypt(ZetaEncoder.to_zeta(np.asarray(a_int), 16))
        enc_b = eng.encrypt(ZetaEncoder.to_zeta(np.asarray(b_int), 16))
        res = self.xor_cipher(enc_a, enc_b)
        return ZetaEncoder.from_zeta(eng.decrypt(res), 16)[:np.size(a_int)]

    def xor256(self, a_int: np.ndarray, b_int: np.ndarray) -> np.ndarray:
        eng = self.eng_wrap
        enc_a = eng.encrypt(ZetaEncoder.to_zeta(np.asarray(a_int), 256))
        enc_b = eng.encrypt(ZetaEncoder.to_zeta(np.asarray(b_int), 256))
        res = self.xor_cipher_full(enc_a, enc_b)
        return ZetaEncoder.from_zeta(eng.decrypt(res), 256)[:np.size(a_int)]

    # ------------------------------------------------------------------
    def extract_nibbles(self, enc_vec: Ciphertext,
                        _shared_basis: Dict[int, Ciphertext] | None = None
                        ) -> Tuple[Ciphertext, Ciphertext]:
        """zeta256-domain byte ciphertext -> (zeta16^hi, zeta16^lo).

        lo = enc^16 exactly (domain reduction); hi = the 256-point LUT with
        zeta16-range output, one fused linear combination over the shared
        power basis."""
        eng = self.eng_wrap
        basis = _shared_basis or self._build_power_basis_256(enc_vec)
        hi_coeffs = _dense_1d(self.nibble_hi_cache.path, 256)
        ks = [k for k in range(1, 256) if abs(hi_coeffs[k]) > 1e-12]
        enc_hi = eng.linear_combination([basis[k] for k in ks],
                                        [hi_coeffs[k] for k in ks],
                                        constant=hi_coeffs[0])
        return enc_hi, basis[16]

    def cleanse(self, ct: Ciphertext, modulus: int = 16) -> Ciphertext:
        """Noise cleanse on roots of unity: z -> ((m+1)z - z^(m+1))/m.

        For z = zeta*(1+e) the first-order error cancels, so accumulated
        CKKS noise is squashed to O(m*e^2).  Cost: 5 multiplies (z^2, z^4,
        z^8, z^16, z^17) and one fused combination, which lands the output
        on exactly Delta: the squaring chain drifts the tracked scale
        (s -> s^2/q per level), and repeated cleanses would compound it."""
        if modulus != 16:
            raise ValueError("cleanse is tuned for the nibble domain (m=16)")
        eng = self.eng_wrap
        z2 = eng.multiply(ct, ct)
        z4 = eng.multiply(z2, z2)
        z8 = eng.multiply(z4, z4)
        z16 = eng.multiply(z8, z8)
        z17 = eng.multiply(z16, ct)
        m = float(modulus)
        return eng.linear_combination(
            [ct, z17], [(m + 1) / m, -1.0 / m],
            target_scale=eng.engine.params.scale)

    def lift_lo(self, lo16_ct: Ciphertext) -> Ciphertext:
        """zeta16^l -> zeta256^l through the 16-point lo_lift LUT."""
        eng = self.eng_wrap
        coeffs = _dense_1d(self.lo_lift_cache.path, 16)
        basis = self._build_power_basis(lo16_ct)
        ks = [k for k in range(1, 16) if abs(coeffs[k]) > 1e-12]
        return eng.linear_combination([basis[k] for k in ks],
                                      [coeffs[k] for k in ks],
                                      constant=coeffs[0])

    def recombine_nibbles16(self, hi16_ct: Ciphertext,
                            lo16_ct: Ciphertext) -> Ciphertext:
        """byte = hi*16 + lo for zeta16-domain nibbles: zeta16^hi already is
        zeta256^(16 hi); lift lo and multiply."""
        return self.eng_wrap.multiply(hi16_ct, self.lift_lo(lo16_ct))

    # ------------------------------------------------------------------
    def _xor_with_plain_nibbles(self, enc16: Ciphertext,
                                key_nibbles: np.ndarray) -> Ciphertext:
        """XOR a zeta16-domain ciphertext with plaintext per-slot nibbles.

        With the key in the clear the 2D XOR LUT collapses to a 1D LUT with
        slot-dependent coefficients w_i(slot) = sum_j c_ij zeta16^(j*k_slot):
        8 plaintext multiplies in one fused sum, no ct*ct multiply.  The
        weight vectors are dense plaintexts, encoded on the host through the
        exact f64 path and cached per key pattern."""
        eng = self.eng_wrap
        sc = eng.engine.slot_count
        kn = np.asarray(key_nibbles, dtype=np.uint8).ravel()
        reps = -(-sc // kn.size)
        k = np.ascontiguousarray(np.tile(kn, reps)[:sc])
        ck = k.tobytes()
        cached = self._ark_pt_cache.pop(ck, None)
        if cached is None:
            coeffs = self.coeff_cache.load_coeffs()
            zeta = np.exp(-2j * np.pi / 16)
            rows: Dict[int, np.ndarray] = {}
            const = np.zeros(sc, dtype=np.complex128)
            for (i, j), c in coeffs.items():
                w = c * zeta ** ((j * k.astype(np.int64)) % 16)
                if i == 0:
                    const += w
                else:
                    rows[i] = rows.get(i, 0) + w
            pts = [(i, eng.encode(w)) for i, w in sorted(rows.items())]
            cached = (pts, const if np.max(np.abs(const)) > 1e-12 else None)
        self._ark_pt_cache[ck] = cached          # (re)insert: LRU recency
        while len(self._ark_pt_cache) > self._ARK_CACHE_CAP:
            self._ark_pt_cache.pop(next(iter(self._ark_pt_cache)))
        pts, const = cached
        basis = self._build_power_basis(enc16)
        acc = eng.linear_combination([basis[i] for i, _ in pts],
                                     [pt for _, pt in pts])
        if const is not None:
            acc = eng.add(acc, const)
        return acc

    def add_round_key(self, enc_state: Ciphertext,
                      round_key: np.ndarray) -> Ciphertext:
        """AddRoundKey on a zeta256-domain state with a plaintext round key:
        shared 255-power basis -> nibble extraction -> two 4-bit XORs
        against the key nibbles -> recombine to zeta256."""
        basis = self._build_power_basis_256(enc_state)
        s_hi, s_lo = self.extract_nibbles(enc_state, _shared_basis=basis)
        k_hi, k_lo = split_nibbles(np.asarray(round_key, dtype=np.uint8))
        x_hi = self._xor_with_plain_nibbles(s_hi, k_hi)
        x_lo = self._xor_with_plain_nibbles(s_lo, k_lo)
        return self.recombine_nibbles16(x_hi, x_lo)

    def add_round_key_full(self, enc_state: Ciphertext,
                           round_key: np.ndarray) -> Ciphertext:
        """Byte-domain AddRoundKey through the full 256x256 XOR LUT against
        an encrypted key."""
        zrk = ZetaEncoder.to_zeta(np.asarray(round_key), 256)
        return self.xor_cipher_full(enc_state, self.eng_wrap.encrypt(zrk))
