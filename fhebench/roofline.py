"""A kernel family's share of the card's memory roofline, for the metric
readers under `metrics/`."""
from __future__ import annotations

from .reference.formulas import HBM_BYTES_PER_S


def share(run, metric: str, names, pattern: str):
    """100 x bytes / (device seconds x bandwidth) over the window, or None
    with a note where the tally, the launch counters and the trace do not
    agree on the launches, or the card's bandwidth is not in the table."""
    if run.trace is None:
        return None
    tallied = sum(run.tally.get(n, (0, 0))[0] for n in names)
    counted = sum(run.launches.get(n, 0) for n in names)
    nbytes = sum(run.tally.get(n, (0, 0))[1] for n in names)
    traced = run.trace.matching(pattern)
    bw = HBM_BYTES_PER_S.get(run.device_name)
    why = None
    if tallied != counted:
        why = f"{tallied} tallied launches, {counted} counted"
    elif len(traced) != tallied:
        why = f"{len(traced)} kernels in the trace, {tallied} launches"
    elif bw is None:
        why = f"no bandwidth for {run.device_name!r}"
    elif not tallied:
        return None
    if why:
        run.notes.append(f"{metric} left out: {why}")
        return None
    seconds = sum(e - s for _, s, e in traced) / 1e9
    return 100.0 * nbytes / (seconds * bw)
