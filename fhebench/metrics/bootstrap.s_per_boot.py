"""Seconds inside the refresh callable over the bootstraps of the window
(the engine's `bootstrap` counter, graph replays included): every one of
them, not a median."""


def read(run):
    boots = run.counters.get("bootstrap", 0)
    if not boots:
        return None
    if len(run.refresh_s) != boots:
        run.notes.append(f"bootstrap.s_per_boot: {len(run.refresh_s)} "
                         f"refresh calls for {boots} bootstraps")
    return sum(run.refresh_s) / boots
