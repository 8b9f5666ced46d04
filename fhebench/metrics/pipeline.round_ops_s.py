"""Seconds per AES round outside the refresh: the window less the time
inside the refresh callable (the card synchronised at its boundaries),
over the rounds completed.  The round services (`ops/`) and the pipeline's
own work, the refresh's pack, unpack and cleanse included."""


def read(run):
    if not run.rounds:
        return None
    return (run.seconds - sum(run.refresh_s)) / run.rounds
