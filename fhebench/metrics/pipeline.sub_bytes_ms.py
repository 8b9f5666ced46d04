"""Milliseconds a round in the bit-sliced round's SubBytes stage
(InvSubBytes in the inverse cipher): the engine's `aes.sub_bytes_ns`
counter over the window (timing events at the stage's edges, added while
the profiler records) over the rounds completed.  Left out where the
program keeps no such counter."""

KEY = "aes.sub_bytes_ns"


def read(run):
    if not run.rounds or not run.counters.get(KEY):
        return None
    return run.counters[KEY] / run.rounds / 1e6
