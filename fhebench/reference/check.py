"""The comparison that decides `correct`.

Each answer is the bytes the program's output decrypts to, for one batch
after its whole cipher.  The plain AES of `aes.py` works out what each
answer must be from the plaintexts the benchmark drew; an answer is right
when every byte equals it.  AES-128 fixes every bit, so
the comparison is exact: the limits are 0.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import aes

LIMITS = {"wrong_bytes": 0, "unchecked_answers": 0}


@dataclass
class Answer:
    batch: int
    got: np.ndarray | None      # the decrypted bytes; None if none came


def expected(pt: np.ndarray, key: bytes, direction: str,
             rounds: int) -> np.ndarray:
    """[blocks * 16]: what a batch of plaintexts `pt` reads after a cipher
    of `rounds` rounds in `direction`."""
    if direction == "decrypt":
        return np.asarray(pt, dtype=np.uint8).reshape(-1)
    return aes.encrypt(pt, key, rounds).reshape(-1)


def judge(answers: list[Answer], plaintexts: dict, key: bytes,
          direction: str, rounds: int) -> dict:
    """{"wrong_bytes", "unchecked_answers", "failed"}: bytes that differ
    from the reference over every answer, answers that never came, and the
    requests behind a wrong or missing answer (one an answer)."""
    wrong = unchecked = failed = 0
    for a in answers:
        if a.got is None:
            unchecked += 1
            failed += 1
            continue
        want = expected(plaintexts[a.batch], key, direction, rounds)
        got = np.asarray(a.got, dtype=np.uint8).reshape(-1)
        bad = (int(np.count_nonzero(got != want)) if got.shape == want.shape
               else want.size)
        wrong += bad
        failed += 1 if bad else 0
    return dict(wrong_bytes=wrong, unchecked_answers=unchecked, failed=failed)


def passes(verdict: dict) -> bool:
    return all(verdict[k] <= v for k, v in LIMITS.items())


def control(answers: list[Answer], plaintexts: dict, key: bytes,
            direction: str, rounds: int, seed: int) -> list[Answer]:
    """The control: the reference in the program's place, with the
    guarantee the configuration states broken as an evaluation below its
    precision breaks it: in each answer one bit of one byte, drawn from the
    seed, decodes the wrong way."""
    rng = np.random.default_rng([seed % 2 ** 63, 7])
    out = []
    for a in answers:
        want = expected(plaintexts[a.batch], key, direction, rounds).copy()
        want[rng.integers(want.size)] ^= np.uint8(1 << int(rng.integers(8)))
        out.append(Answer(a.batch, want))
    return out
