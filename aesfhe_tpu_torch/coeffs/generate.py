"""LUT coefficient generators: zeta-domain polynomial interpolation, numpy
only.  Counterpart of `aesfhe_tpu/coeffs/generate.py`; the JSON files
beside this module are its output (`python -m aesfhe_tpu_torch gen-coeffs`)
and equal the reference's checked-in files entry for entry.

A LUT f on Z_n becomes the polynomial sum_k c_k t^k with c = ifft(zeta_n^f),
so that evaluating it at t = zeta_n^x gives zeta_n^f(x).  Artifacts:
  - 1D LUTs via IFFT, optionally conjugate-symmetrised and saved as a half
    spectrum (the nibble files);
  - 2D LUTs via IFFT2, saved sparse (XOR, and the nibble-pair S-box and
    GF(2^8) multipliers the zeta pipeline evaluates);
  - lo_lift: the 16-point LUT zeta16^l -> zeta256^l that recombines a
    (hi, lo) nibble pair into a byte.

JSON schemas: 1D {n, tol, entries: [[i, re, im]]}, 2D {shape, tol,
entries: [[i, j, re, im]]}.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..aes_tables import AES_SBOX, gmul

COEFF_DIR = Path(__file__).resolve().parent


def gf_table(mult: int) -> np.ndarray:
    return np.array([gmul(x, mult) for x in range(256)], dtype=np.uint8)


# ---------------------------------------------------------------------------

def compute_1d_lut_coeffs(output_func, n: int = 256,
                          use_symmetry: bool = False) -> np.ndarray:
    """coeffs = ifft(zeta_n^f(x)); optional conjugate-symmetry averaging."""
    zeta = np.exp(-2j * np.pi / n)
    lut = np.array([zeta ** int(output_func(x)) for x in range(n)],
                   dtype=np.complex128)
    coeffs = np.fft.ifft(lut)
    if use_symmetry:
        coeffs = apply_conjugate_symmetry_1d(coeffs)
    return coeffs


def apply_conjugate_symmetry_1d(coeffs: np.ndarray) -> np.ndarray:
    n = coeffs.shape[0]
    res = coeffs.copy()
    for k in range(1, n // 2):
        avg = (res[k] + np.conj(res[n - k])) / 2
        res[k] = avg
        res[n - k] = np.conj(avg)
    if n % 2 == 0:
        res[n // 2] = res[n // 2].real + 0j
    return res


def compute_2d_lut_coeffs(output_func, n: int = 16) -> np.ndarray:
    zeta = np.exp(-2j * np.pi / n)
    f = np.array([[int(output_func(a, b)) for b in range(n)]
                  for a in range(n)])
    return np.fft.ifft2(zeta ** f)


def lo_lift_coeffs() -> np.ndarray:
    """16-point interpolation of zeta16^l -> zeta256^l."""
    lut = np.exp(-2j * np.pi * np.arange(16) / 256)
    return np.fft.ifft(lut)


# ---------------------------------------------------------------------------

def save_1d_coeffs(coeffs: np.ndarray, path: Path, tol: float = 1e-12,
                   half: bool = False, note: str | None = None):
    n = coeffs.shape[0]
    upper = n // 2 + 1 if half else n
    entries = [[int(k), float(coeffs[k].real), float(coeffs[k].imag)]
               for k in range(upper) if abs(coeffs[k]) > tol]
    data = {"n": n, "tol": tol, "entries": entries}
    if note:
        data["note"] = note
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2))


def save_2d_coeffs(coeffs: np.ndarray, path: Path, tol: float = 1e-12):
    n, m = coeffs.shape
    entries = [[int(i), int(j), float(coeffs[i, j].real),
                float(coeffs[i, j].imag)]
               for i in range(n) for j in range(m)
               if abs(coeffs[i, j]) > tol]
    data = {"shape": [n, m], "tol": tol, "entries": entries}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2))


def load_1d_coeffs(path: Path, mirror_half: bool = True) -> np.ndarray:
    """Dense complex coefficient vector from a 1D JSON; if the file stores
    only the half spectrum (nibble saves), mirror via conjugate symmetry."""
    data = json.loads(Path(path).read_text())
    n = data.get("n") or len(data["entries"])
    coeffs = np.zeros(n, dtype=np.complex128)
    present = np.zeros(n, dtype=bool)
    for i, re, im in data["entries"]:
        coeffs[int(i)] = re + 1j * im
        present[int(i)] = True
    if mirror_half and not present[n // 2 + 1:].any():
        for k in range(1, n // 2):
            if present[k] and not present[n - k]:
                coeffs[n - k] = np.conj(coeffs[k])
    return coeffs


def load_2d_coeffs(path: Path) -> dict[tuple[int, int], complex]:
    data = json.loads(Path(path).read_text())
    return {(int(i), int(j)): complex(re, im)
            for i, j, re, im in data["entries"]}


# ---------------------------------------------------------------------------

def generate_all(out_dir: Path | None = None) -> dict[str, Path]:
    """Write every coefficient artifact into `out_dir` (default: beside
    this module); returns {file name: path}."""
    out = Path(out_dir) if out_dir else COEFF_DIR
    gf2 = gf_table(2)
    gf3 = gf_table(3)
    paths = {}

    def p1(name, coeffs, **kw):
        path = out / name
        save_1d_coeffs(coeffs, path, **kw)
        paths[name] = path

    def p2(name, coeffs):
        path = out / name
        save_2d_coeffs(coeffs, path)
        paths[name] = path

    # XOR LUTs
    p2("xor_mono_coeffs.json", compute_2d_lut_coeffs(lambda i, j: i ^ j, 16))
    p2("xor_256x256_coeffs.json",
       compute_2d_lut_coeffs(lambda i, j: i ^ j, 256))
    # nibble extraction (zeta256-exponent convention)
    p1("nibble_hi_coeffs.json",
       compute_1d_lut_coeffs(lambda x: x // 16, 256, use_symmetry=True),
       half=True)
    p1("nibble_lo_coeffs.json",
       compute_1d_lut_coeffs(lambda x: x % 16, 256, use_symmetry=True),
       half=True)
    p1("nibble_test.json", compute_1d_lut_coeffs(lambda x: x % 16, 16))
    # hi-nibble extraction with zeta16-domain output: f(x) = (x>>4)*16, so
    # the output zeta256^(16*hi) is zeta16^hi
    p1("nibble_hi16_coeffs.json",
       compute_1d_lut_coeffs(lambda x: (x >> 4) * 16, 256),
       note="256->16 hi-nibble LUT with zeta16-domain output (TPU build)")
    # S-box 8->4 split
    p1("sbox_hi_coeffs.json",
       compute_1d_lut_coeffs(lambda x: (AES_SBOX[x] >> 4) * 16, 256),
       note="8-to-4 S-Box LUT coefficients via IFFT")
    p1("sbox_lo_coeffs.json",
       compute_1d_lut_coeffs(lambda x: AES_SBOX[x] & 0xF, 256),
       note="8-to-4 S-Box LUT coefficients via IFFT")
    # GF x2 / x3
    p1("gf2_8to8_coeffs.json", compute_1d_lut_coeffs(lambda x: gf2[x], 256))
    p1("gf3_8to8_coeffs.json", compute_1d_lut_coeffs(lambda x: gf3[x], 256))
    p1("gf2_hi_coeffs.json",
       compute_1d_lut_coeffs(lambda x: (gf2[x] >> 4) * 16, 256))
    p1("gf2_lo_coeffs.json", compute_1d_lut_coeffs(lambda x: gf2[x] & 0xF, 256))
    p1("gf3_hi_coeffs.json",
       compute_1d_lut_coeffs(lambda x: (gf3[x] >> 4) * 16, 256))
    p1("gf3_lo_coeffs.json", compute_1d_lut_coeffs(lambda x: gf3[x] & 0xF, 256))
    # inverse-MixColumns multipliers x9/x11/x13/x14
    for m in (9, 11, 13, 14):
        gfm = gf_table(m)
        p1(f"gf{m}_hi_coeffs.json",
           compute_1d_lut_coeffs(lambda x: (gfm[x] >> 4) * 16, 256))
        p1(f"gf{m}_lo_coeffs.json",
           compute_1d_lut_coeffs(lambda x: gfm[x] & 0xF, 256))
    # nibble-domain (4->4) GF LUTs
    p1("gf2_nibble_coeffs.json",
       compute_1d_lut_coeffs(lambda x: gf2[x] & 0xF, 16))
    p1("gf3_nibble_coeffs.json",
       compute_1d_lut_coeffs(lambda x: gf3[x] & 0xF, 16))
    # zeta16 -> zeta256 lift for the nibble recombine
    p1("lo_lift_coeffs.json", lo_lift_coeffs(),
       note="zeta16^l -> zeta256^l lift LUT (TPU build)")
    # 2D nibble-pair GF multipliers (hi', lo') = f(hi, lo) in the zeta16
    # domain: MixColumns runs on nibble pairs, where XOR is a 16x16 LUT
    for m in (2, 3, 9, 11, 13, 14):
        gfm = gf_table(m)

        def hi2d(h, l, t=gfm):
            return t[(h << 4) | l] >> 4

        def lo2d(h, l, t=gfm):
            return t[(h << 4) | l] & 0xF

        p2(f"gf{m}_hi2d_coeffs.json", compute_2d_lut_coeffs(hi2d, 16))
        p2(f"gf{m}_lo2d_coeffs.json", compute_2d_lut_coeffs(lo2d, 16))
    # 2D nibble-pair S-box and inverse: SubBytes at LUT degree 15, not 255
    inv_sbox = np.zeros(256, dtype=np.uint8)
    inv_sbox[AES_SBOX] = np.arange(256, dtype=np.uint8)
    for name, tbl in (("sbox", AES_SBOX), ("inv_sbox", inv_sbox)):
        p2(f"{name}_hi2d_coeffs.json", compute_2d_lut_coeffs(
            lambda h, l, t=tbl: t[(h << 4) | l] >> 4, 16))
        p2(f"{name}_lo2d_coeffs.json", compute_2d_lut_coeffs(
            lambda h, l, t=tbl: t[(h << 4) | l] & 0xF, 16))
    return paths
