"""Plain AES-128 (FIPS-197) in NumPy, over many blocks at once.

The benchmark's reference: it imports nothing of the program and derives
the round keys itself.  A block is 16 bytes in FIPS-197's order (byte i is
row i % 4, column i // 4); a batch is a uint8 array [blocks, 16] or its
flat form [blocks * 16].

    encrypt(pt, key, rounds)           AddRoundKey(rk0), then rounds 1..rounds
                                       (round 10 without MixColumns); a run
                                       that stops before round 10 ends with
                                       AddRoundKey(rk_rounds)
    round_state(pt, key, r)            the state a bit-sliced run holds after
                                       round r of 10: encrypt(pt, key, r)
                                       without its last AddRoundKey (round 10:
                                       with it, as the cipher ends)
    decrypt(ct, key, rounds)           the inverse of encrypt(., key, rounds)
"""
from __future__ import annotations

import numpy as np


def _xtime(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.uint16)
    return (((a << 1) ^ np.where(a & 0x80, 0x1B, 0)) & 0xFF).astype(np.uint8)


def _gmul_table(m: int) -> np.ndarray:
    """GF(2^8) product by m of every byte, modulo x^8 + x^4 + x^3 + x + 1."""
    x = np.arange(256, dtype=np.uint8)
    out = np.zeros(256, dtype=np.uint8)
    p = x.copy()
    while m:
        if m & 1:
            out ^= p
        p = _xtime(p)
        m >>= 1
    return out


def _sbox() -> np.ndarray:
    """FIPS-197 5.1.1: the multiplicative inverse in GF(2^8), then the
    affine map b ^ rot(b, 1..4) ^ 0x63."""
    inv = np.zeros(256, dtype=np.uint8)
    for a in range(1, 256):
        row = _MUL[a]
        inv[a] = int(np.nonzero(row == 1)[0][0])
    b = inv.astype(np.uint16)
    s = b.copy()
    for k in range(1, 5):
        s ^= ((b << k) | (b >> (8 - k))) & 0xFF
    return (s ^ 0x63).astype(np.uint8)


_MUL = np.stack([_gmul_table(m) for m in range(256)])      # [m, x] = m * x
SBOX = _sbox()
INV_SBOX = np.argsort(SBOX).astype(np.uint8)
_M2, _M3, _M9, _M11, _M13, _M14 = (_MUL[m] for m in (2, 3, 9, 11, 13, 14))

# byte i = (row i % 4, column i // 4); ShiftRows moves row r left by r
_IDX = np.arange(16)
_SHIFT = (_IDX % 4) + 4 * (((_IDX // 4) + (_IDX % 4)) % 4)
_INV_SHIFT = np.argsort(_SHIFT)


def expand_key(key) -> np.ndarray:
    """FIPS-197 5.2: the 11 round keys of a 16-byte key, [11, 16] uint8."""
    k = _blocks(key)
    if k.shape != (1, 16):
        raise ValueError(f"an AES-128 key has 16 bytes, got {k.size}")
    k = k[0]
    w = [k[4 * i:4 * i + 4].copy() for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = w[i - 1].copy()
        if i % 4 == 0:
            t = SBOX[np.roll(t, -1)]
            t[0] ^= rcon
            rcon = int(_M2[rcon])
        w.append(w[i - 4] ^ t)
    return np.stack([np.concatenate(w[4 * r:4 * r + 4]) for r in range(11)])


def _blocks(x) -> np.ndarray:
    a = (np.frombuffer(x, dtype=np.uint8) if isinstance(x, (bytes, bytearray))
         else np.asarray(x, dtype=np.uint8))
    if a.size % 16:
        raise ValueError(f"{a.size} bytes are not whole 16-byte blocks")
    return a.reshape(-1, 16)


def mix_columns(s: np.ndarray) -> np.ndarray:
    c = s.reshape(-1, 4, 4)                      # [block, column, row]
    a0, a1, a2, a3 = (c[..., r] for r in range(4))
    out = np.stack([_M2[a0] ^ _M3[a1] ^ a2 ^ a3,
                    a0 ^ _M2[a1] ^ _M3[a2] ^ a3,
                    a0 ^ a1 ^ _M2[a2] ^ _M3[a3],
                    _M3[a0] ^ a1 ^ a2 ^ _M2[a3]], axis=-1)
    return out.reshape(-1, 16)


def inv_mix_columns(s: np.ndarray) -> np.ndarray:
    c = s.reshape(-1, 4, 4)
    a0, a1, a2, a3 = (c[..., r] for r in range(4))
    out = np.stack([_M14[a0] ^ _M11[a1] ^ _M13[a2] ^ _M9[a3],
                    _M9[a0] ^ _M14[a1] ^ _M11[a2] ^ _M13[a3],
                    _M13[a0] ^ _M9[a1] ^ _M14[a2] ^ _M11[a3],
                    _M11[a0] ^ _M13[a1] ^ _M9[a2] ^ _M14[a3]], axis=-1)
    return out.reshape(-1, 16)


def _check_rounds(rounds: int):
    if not 0 <= rounds <= 10:
        raise ValueError(f"AES-128 has 10 rounds, asked for {rounds}")


def round_state(pt, key, r: int) -> np.ndarray:
    """[blocks, 16]: ARK(rk0), rounds 1..r, without round r's AddRoundKey
    unless r is 10."""
    _check_rounds(r)
    rk = expand_key(key)
    s = _blocks(pt) ^ rk[0]
    for i in range(1, r + 1):
        if i > 1:
            s = s ^ rk[i - 1]
        s = SBOX[s][:, _SHIFT]
        if i != 10:
            s = mix_columns(s)
    return s ^ rk[10] if r == 10 else s


def encrypt(pt, key, rounds: int = 10) -> np.ndarray:
    """[blocks, 16]: AES-128 stopped after `rounds` rounds."""
    s = round_state(pt, key, rounds)
    return s if rounds in (0, 10) else s ^ expand_key(key)[rounds]


def decrypt(ct, key, rounds: int = 10) -> np.ndarray:
    """[blocks, 16]: the inverse of encrypt(., key, rounds)."""
    _check_rounds(rounds)
    rk = expand_key(key)
    s = _blocks(ct).copy()
    for r in range(rounds, 0, -1):
        s = s ^ rk[r]
        if r != 10:
            s = inv_mix_columns(s)
        s = INV_SBOX[s[:, _INV_SHIFT]]
    return s ^ rk[0]
