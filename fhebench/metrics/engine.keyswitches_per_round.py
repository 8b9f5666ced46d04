"""The engine's `keyswitch` counter over the window (graph replays add
their deltas), per AES round completed."""


def read(run):
    if not run.rounds:
        return None
    return run.counters["keyswitch"] / run.rounds
