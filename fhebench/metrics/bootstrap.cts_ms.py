"""Milliseconds a bootstrap in its CoeffToSlot phase (ModRaise through the conjugation split): the engine's
`boot.cts_ns` counter over the window (each graph replay times its
phases with the graph's own event nodes, the eager bootstrap with events
at its phase boundaries, while the profiler records) over its `bootstrap`
counter.  Left out where the program keeps no such counter."""

KEY = "boot.cts_ns"


def read(run):
    boots = run.counters.get("bootstrap", 0)
    if not boots or KEY not in run.counters:
        return None
    return run.counters[KEY] / boots / 1e6
