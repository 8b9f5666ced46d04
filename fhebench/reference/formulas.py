"""Frozen copies of the program's byte arithmetic and the card's peaks.

`ntt_bytes` is `aesfhe_tpu_torch/core/ntt.py:bytes_moved` and
`ks_inner_bytes` is `aesfhe_tpu_torch/core/ks_inner.py:bytes_moved` as of
the benchmark's first version: the least bytes a call must move, each input
word read once and each output word written once.  A roofline share is
those bytes over the kernels' device time times the card's bandwidth.
"""
from __future__ import annotations

# bytes per second of device memory, by the name torch.cuda.get_device_name
# gives (NVIDIA's data sheet, SXM part, at its 700 W limit)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def ntt_launches(n: int) -> int:
    """Kernel launches of one forward or inverse transform of a ring of n:
    one up to 2^18, two (a column pass, then a run pass) from 2^19."""
    return 2 if n.bit_length() - 1 >= 19 else 1


def ntt_bytes(batch: int, rows: int, n: int, in_bytes: int,
              out_bytes: int) -> int:
    """A transform of [batch, rows, n] words: each read once (4 bytes int32,
    8 int64), each written once."""
    return (in_bytes + out_bytes) * batch * rows * n


def ks_inner_bytes(digits: int, rows: int, n: int) -> int:
    """The key-switch inner product of [digits, rows, n] int32 digits with
    both key halves into [2, rows, n]: 3 * digits + 2 rows of n words."""
    return (3 * digits * rows + 2 * rows) * n * 4
