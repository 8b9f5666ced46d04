"""100 x the traced window's idle time in gaps that begin while the
innermost open range is one of the pipeline's own spans (`ckks.aes.*`: a
round and its stages), over the window: the card waiting on the
pipeline's and the round services' Python.  Left out where the trace
holds no such span (a program without them)."""
from fhebench.tracing import gaps_of, innermost

PREFIX = "ckks.aes."


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or \
            not any(n.startswith(PREFIX) for _, _, n in t.annotations):
        return None
    gaps = gaps_of(t.busy_intervals, t.window)
    labels = innermost(t.annotations, [s for s, _ in gaps])
    idle = sum(e - s for (s, e), name in zip(gaps, labels)
               if name is not None and name.startswith(PREFIX))
    return 100.0 * idle / (t.window[1] - t.window[0])
