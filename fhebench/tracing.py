"""What a traced run reads: the profiler's device trace of the window, and
launch tallies taken by wrapping the program's kernel entries.

The trace is read straight from the profiler's raw events (no event tree is
built: a window holds a million kernels).  Device operations are the CUDA
events that are not annotations; the window is the `fhebench.window` range
the harness opens around it, on the trace's own clock.

A tally wraps a module attribute of the program (a kernel's Python entry,
which callers reach through the module) and adds each call's launches and
bytes, as a metric reader's `TALLIES` declare them.  A call made while a
CUDA graph is being captured is added to that graph's own tally instead,
and every replay of the graph adds the graph's tally once.
"""
from __future__ import annotations

import functools
import heapq
import importlib
import re
from dataclasses import dataclass, field

import torch

WINDOW = "fhebench.window"
RANGES = ("fhebench.", "ckks.")


@dataclass
class Tally:
    """`module.attr` is wrapped; `account(args, kwargs) -> (launches,
    bytes)` counts one call; `counter` names its launches in
    `aesfhe_tpu_torch.kernels.launch_counts()`."""
    module: str
    attr: str
    counter: str
    account: object


@dataclass
class Tallies:
    totals: dict = field(default_factory=dict)     # counter -> [launches, bytes]
    capturing: list | None = None
    graphs: dict = field(default_factory=dict)     # id(graph owner) -> list

    def add(self, counter: str, launches: int, nbytes: int):
        if self.capturing is not None and \
                torch.cuda.is_current_stream_capturing():
            self.capturing.append((counter, launches, nbytes))
            return
        t = self.totals.setdefault(counter, [0, 0])
        t[0] += launches
        t[1] += nbytes

    def replay(self, owner):
        for c, n, b in self.graphs.get(id(owner), ()):
            t = self.totals.setdefault(c, [0, 0])
            t[0] += n
            t[1] += b

    def reset(self):
        self.totals = {}


def install(tallies: list[Tally], graph_owner=None) -> Tallies:
    """Wrap each tallied entry (once per module attribute) and, where the
    program captures graphs, the owner class's `_capture` and `__call__`
    (a call of an owner with a graph is a replay)."""
    state = Tallies()
    seen = set()
    for t in tallies:
        if (t.module, t.attr) in seen:
            continue
        seen.add((t.module, t.attr))
        mod = importlib.import_module(t.module)
        orig = getattr(mod, t.attr)

        def wrapped(*args, _orig=orig, _t=t, **kwargs):
            out = _orig(*args, **kwargs)
            state.add(_t.counter, *_t.account(args, kwargs))
            return out

        setattr(mod, t.attr, wrapped)
    if graph_owner is not None:
        capture, call = graph_owner._capture, graph_owner.__call__

        def _capture(self, *args, **kwargs):
            state.capturing = []
            try:
                return capture(self, *args, **kwargs)
            finally:
                state.graphs[id(self)] = state.capturing
                state.capturing = None

        def __call__(self, *args, **kwargs):
            replay = self.graph is not None
            out = call(self, *args, **kwargs)
            if replay:
                state.replay(self)
            return out

        graph_owner._capture = _capture
        graph_owner.__call__ = __call__
    return state


class Profiler:
    """torch's profiler (host and CUDA activity) around the window, read
    through its raw events."""

    def __init__(self, cuda: bool = True):
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState)
        from torch._C._profiler import _ExperimentalConfig
        args = (ProfilerState.KINETO, False, False, False, False, False,
                _ExperimentalConfig())
        try:
            self.config = ProfilerConfig(*args, "")
        except TypeError:
            self.config = ProfilerConfig(*args)
        self.cuda = cuda
        self.activities = {ProfilerActivity.CPU}
        if cuda:
            self.activities.add(ProfilerActivity.CUDA)
        self.events = None

    def start(self):
        from torch.autograd import _enable_profiler, _prepare_profiler
        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities)

    def stop(self):
        from torch.autograd import _disable_profiler
        if self.cuda:
            torch.cuda.synchronize()
        self.events = _disable_profiler().events()


@dataclass
class Trace:
    """The window's device operations [(name, start_ns, end_ns)], clipped
    to the window, and the host's ranges [(start_ns, end_ns, name)]."""
    window: tuple
    ops: list
    annotations: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @functools.cached_property
    def busy_intervals(self) -> list:
        return union(sorted((s, e) for _, s, e in self.ops))

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals) / 1e9

    def matching(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [(n, s, e) for n, s, e in self.ops if rx.search(n)]

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[short(n), v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time of the window by what the host was in when each gap
        began (the innermost `fhebench.*` or `ckks.*` range open there),
        the k largest sums."""
        gaps = gaps_of(self.busy_intervals, self.window)
        labels = innermost(self.annotations, [s for s, _ in gaps])
        by = {}
        for (s, e), label in zip(gaps, labels):
            by[label or "-"] = by.get(label or "-", 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[short(n), v / 1e9] for n, v in top]


def short(name: str, n: int = 150) -> str:
    """A kernel's name without the namespaces that every torch kernel
    repeats, cut to n characters."""
    for ns in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(ns, "")
    return name if len(name) <= n else name[:n - 3] + "..."


def read_trace(events) -> Trace:
    """The Trace of the window that the WINDOW annotation spans.  Ranges
    are told from operations by their names (the harness's `fhebench.*`,
    the program's `ckks.*`): torch's raw events do not carry their kind in
    every version."""
    window = None
    ops, annotations = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        ranged = name.startswith(RANGES)
        if e.device_type() == cuda:
            if not ranged:
                ops.append((name, start, end))
        elif ranged:
            if name == WINDOW:
                window = (start, end)
            annotations.append((start, end, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window
    ops = [(n, max(s, w0), min(t, w1)) for n, s, t in ops if t > w0 and s < w1]
    return Trace(window, ops, annotations)


def union(intervals: list) -> list:
    """Sorted intervals [(start, end)] merged where they touch or overlap."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps_of(busy: list, window: tuple) -> list:
    """The idle intervals of a window around merged busy intervals."""
    out, t = [], window[0]
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def innermost(spans: list, points: list) -> list:
    """For each of the sorted points, the name of the latest-starting span
    [(start, end, name)] open there (None where none is)."""
    spans = sorted(spans)
    out, heap, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            s, e, n = spans[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out
