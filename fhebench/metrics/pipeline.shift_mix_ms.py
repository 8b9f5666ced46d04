"""Milliseconds a round in the bit-sliced round's ShiftRows+MixColumns
stage and its cleanse (InvShiftRows, InvMixColumns with the folded
AddRoundKey and the cleanse in the inverse cipher): the engine's
`aes.shift_mix_ns` counter over the window (timing events at the stage's
edges, added while the profiler records) over the rounds completed.  Left
out where the program keeps no such counter."""

KEY = "aes.shift_mix_ns"


def read(run):
    if not run.rounds or not run.counters.get(KEY):
        return None
    return run.counters[KEY] / run.rounds / 1e6
