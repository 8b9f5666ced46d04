"""AES state layout, PKCS#7 padding and block chunking, numpy only.
Counterpart of `aesfhe_tpu/utils/aes_utils.py`.
"""
from __future__ import annotations

import numpy as np


def bytes_to_state(block: bytes) -> np.ndarray:
    """16-byte block -> 4x4 AES state, column-major (block[0] -> state[0,0],
    block[1] -> state[1,0], ...)."""
    if len(block) != 16:
        raise ValueError("Block length must be 16 bytes")
    return np.frombuffer(block, dtype=np.uint8).reshape((4, 4), order="F")


def state_to_bytes(state: np.ndarray) -> bytes:
    if state.shape != (4, 4):
        raise ValueError("State must be a 4x4 array")
    return state.reshape(16, order="F").astype(np.uint8).tobytes()


def chunk_bytes(data: bytes, block_size: int = 16) -> list[bytes]:
    return [data[i:i + block_size] for i in range(0, len(data), block_size)]


def pkcs7_pad(block: bytes, block_size: int = 16) -> bytes:
    # pad_len is always in [1, block_size]: a full-length input gets a whole
    # padding block, per RFC 5652
    pad_len = block_size - (len(block) % block_size)
    return block + bytes([pad_len] * pad_len)


def pkcs7_unpad(data: bytes) -> bytes:
    if not data:
        return data
    pad_len = data[-1]
    if pad_len < 1 or pad_len > len(data):
        raise ValueError(f"corrupt PKCS#7 padding: length byte {pad_len}")
    if data[-pad_len:] != bytes([pad_len] * pad_len):
        raise ValueError("corrupt PKCS#7 padding: non-uniform pad bytes")
    return data[:-pad_len]
