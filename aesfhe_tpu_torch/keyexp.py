"""AES-128 key schedule (host, plaintext).  Counterpart of
`aesfhe_tpu/keyexp.py`."""
from __future__ import annotations

import numpy as np

from .aes_tables import AES_SBOX, gmul

RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                dtype=np.uint8)


def expand_key_128(key: bytes | np.ndarray) -> np.ndarray:
    """16-byte key -> [11, 16] round keys (round 0 = the key itself), each
    flat in column-major byte order: byte i is word i // 4, byte i % 4."""
    key = (np.frombuffer(bytes(key), dtype=np.uint8)
           if isinstance(key, (bytes, bytearray))
           else np.asarray(key, dtype=np.uint8))
    if key.size != 16:
        raise ValueError("AES-128 key must be 16 bytes")
    words = [key[4 * i:4 * i + 4].copy() for i in range(4)]
    for i in range(4, 44):
        temp = words[i - 1].copy()
        if i % 4 == 0:
            temp = np.roll(temp, -1)               # RotWord
            temp = AES_SBOX[temp]                  # SubWord
            temp[0] ^= RCON[i // 4 - 1]
        words.append(words[i - 4] ^ temp)
    out = np.zeros((11, 16), dtype=np.uint8)
    for r in range(11):
        out[r] = np.concatenate(words[4 * r:4 * r + 4])
    return out


def inv_mix_columns(state16: np.ndarray) -> np.ndarray:
    """InvMixColumns (FIPS-197 5.3.3) of one 16-byte state, column by
    column (byte i is row i % 4, column i // 4)."""
    from .ops.bitplane import INV_MIX    # the services' module, with torch
    s = np.asarray(state16, dtype=np.uint8).reshape(4, 4)   # [column, row]
    out = np.zeros_like(s)
    for c in range(4):
        for r in range(4):
            v = 0
            for j in range(4):
                v ^= gmul(int(s[c, j]), INV_MIX[r][j])
            out[c, r] = v
    return out.reshape(16)


def equivalent_inverse_keys(round_keys: np.ndarray) -> np.ndarray:
    """FIPS-197 5.3.5: the equivalent inverse cipher's round keys, [11, 16]:
    dw[r] = InvMixColumns(w[r]) for rounds 1-9, dw[0] = w[0] and
    dw[10] = w[10].  InvMixColumns is linear over GF(2), so
    InvMixColumns(x) ^ dw[r] = InvMixColumns(x ^ w[r]): the inverse round
    can run InvMixColumns before its AddRoundKey."""
    rk = np.asarray(round_keys, dtype=np.uint8)
    dw = rk.copy()
    for r in range(1, 10):
        dw[r] = inv_mix_columns(rk[r])
    return dw
