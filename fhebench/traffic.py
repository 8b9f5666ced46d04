"""The one traffic generator: it reads a mix, `fhebench/traffic/<mix>.json`,
and yields its requests and their inputs.

A mix is one closed-loop client: each request starts when the previous one
has completed.  A request is one whole cipher: it takes one batch through
`rounds_per_cipher` AES rounds; the next request takes the next of
`batches` distinct batches, in a cycle.  `direction` is `encrypt` (the
batch holds plaintexts) or `decrypt` (the batch holds their ciphertexts
after `rounds_per_cipher` rounds).  Set-up runs one request on a batch of
its own, so that the window meets every code path of the cell warm.
`refresh` says whether the pipeline is given its bootstrap refresh.

Batches are drawn from the seed: every block is uniform random bytes,
except that block 0 is FIPS-197 C.1's plaintext where the configuration
asks for it.  Batch -1 is the warm-up's.
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np

from .reference import aes

FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
KEYS = {"loop", "clients", "direction", "rounds_per_cipher", "batches",
        "refresh", "why"}


def load(path: Path) -> dict:
    """A mix, checked: a closed loop of one client over ciphers of 1 to 10
    rounds."""
    mix = json.loads(Path(path).read_text())
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"{path}: unknown keys {sorted(unknown)}")
    if mix["loop"] != "closed" or mix["clients"] != 1:
        raise ValueError(f"{path}: only a closed loop of one client runs")
    if mix["direction"] not in ("encrypt", "decrypt"):
        raise ValueError(f"{path}: direction is encrypt or decrypt")
    if not 1 <= mix["rounds_per_cipher"] <= 10:
        raise ValueError(f"{path}: a cipher has 1 to 10 rounds")
    if mix["batches"] < 2:
        raise ValueError(f"{path}: two batches at least, so that no "
                         "cipher repeats its predecessor's input")
    return mix


def requests(mix: dict):
    """The endless sequence of one client's requests: the batch each
    cipher takes."""
    for cipher in itertools.count():
        yield cipher % mix["batches"]


def plaintexts(seed: int, batch: int, blocks: int,
               fips_block0: bool) -> np.ndarray:
    """[blocks * 16] uint8: batch `batch` of the run with this seed."""
    rng = np.random.default_rng([seed % 2 ** 63, batch + 1])
    pt = rng.integers(0, 256, blocks * 16, dtype=np.uint8)
    if fips_block0:
        pt[:16] = np.frombuffer(FIPS_PT, dtype=np.uint8)
    return pt


def program_input(mix: dict, pt: np.ndarray, key: bytes) -> np.ndarray:
    """What the program is handed for a batch: the plaintexts, or for the
    inverse direction their ciphertexts after the cipher's rounds."""
    if mix["direction"] == "encrypt":
        return pt
    return aes.encrypt(pt, key, mix["rounds_per_cipher"]).reshape(-1)
