"""AES-128 key schedule (host, plaintext).  Counterpart of
`aesfhe_tpu/keyexp.py`."""
from __future__ import annotations

import numpy as np

from .aes_tables import AES_SBOX

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
