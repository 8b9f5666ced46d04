"""100 x the traced window's idle time in gaps that begin while the
innermost open range is a CKKS primitive's (a `ckks.` name outside the
pipeline's `ckks.aes.*` and the bootstrap's `ckks.boot*`), over the
window: the card waiting on the engine's and the primitives' Python."""
from fhebench.tracing import gaps_of, innermost


def _primitive(name) -> bool:
    return name is not None and name.startswith("ckks.") and \
        not name.startswith(("ckks.aes.", "ckks.boot"))


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    gaps = gaps_of(t.busy_intervals, t.window)
    labels = innermost(t.annotations, [s for s, _ in gaps])
    idle = sum(e - s for (s, e), name in zip(gaps, labels)
               if _primitive(name))
    return 100.0 * idle / (t.window[1] - t.window[0])
