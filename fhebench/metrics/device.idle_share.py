"""100 x (1 - the union of the device operations' intervals over the
traced window), from the profiler's trace of the window itself."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
