"""Failure detection and elastic recovery for distributed runs.
Counterpart of `aesfhe_tpu/parallel/failure.py` (which imports no JAX; the
port keeps its own copy).

The dominant failure of a multi-process run is a hung collective: a peer
died and every other rank blocks in its all-reduce or all-to-all for good.
Three pieces make such a run restartable:

  Heartbeat   per-process liveness files + staleness detection: each worker
              touches heartbeat_dir/proc<i> on a daemon thread; any process
              (or an external orchestrator) calls `stale()` to learn which
              peers have stopped beating.
  Watchdog    per-step deadline: arms a timer around each collective step;
              if the step's wall-clock time exceeds the deadline the process
              is declared wedged and `on_timeout` fires (default: log and
              abort the process with a distinctive exit code so the launcher
              restarts it -- a collective blocked in NCCL or gloo cannot be
              interrupted from Python, so aborting the process IS the
              recovery).
  run_elastic step-level retry loop: runs `step(attempt)` with the
              watchdog armed, restarting up to `max_restarts` times on
              failure.  Ciphertext state is replayable, so combined with
              the bit-sliced pipeline's per-round checkpoints
              (AESFHE128Bitsliced.encrypt_rounds(checkpoint_dir=)) and the
              on-disk key cache (EngineContext(key_cache=)) a restart
              resumes at the last completed round with the same keys.

Exit code 87 marks a watchdog abort (distinguishable from crashes for the
launcher's restart policy).
"""
from __future__ import annotations

import os
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

WATCHDOG_EXIT_CODE = 87


class Heartbeat:
    """File-based liveness: worker side beats, observer side detects."""

    def __init__(self, heartbeat_dir: str | Path, process_id: int,
                 interval_s: float = 2.0):
        self.dir = Path(heartbeat_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.process_id = process_id
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def path(self) -> Path:
        return self.dir / f"proc{self.process_id}"

    def beat_once(self) -> None:
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(repr(time.time()))
        os.replace(tmp, self.path)

    def start(self) -> "Heartbeat":
        self.beat_once()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"heartbeat-{self.process_id}")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.beat_once()
            except OSError:
                pass                      # a full/unmounted disk must not
                                          # kill the worker itself

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)

    def stale(self, max_age_s: float,
              expect: Iterable[int] | None = None) -> list[int]:
        """Process ids whose heartbeat is older than `max_age_s` (or missing
        entirely, for ids in `expect`)."""
        now = time.time()
        seen: dict[int, float] = {}
        for p in self.dir.glob("proc*"):
            try:
                seen[int(p.name[4:])] = float(p.read_text())
            except (ValueError, OSError):
                continue
        out = [pid for pid, ts in seen.items() if now - ts > max_age_s]
        if expect is not None:
            out += [pid for pid in expect if pid not in seen]
        return sorted(set(out))


class Watchdog:
    """Deadline monitor for steps that can wedge (hung collectives).

    Python cannot interrupt a blocked collective, so the only reliable
    recovery is killing the process and letting the launcher restart it
    from the last checkpoint; `on_timeout` defaults to exactly that."""

    def __init__(self, timeout_s: float,
                 on_timeout: Callable[[str], None] | None = None):
        self.timeout_s = timeout_s
        self.fired: str | None = None
        self._on_timeout = on_timeout or self._abort
        self._timer: threading.Timer | None = None

    @staticmethod
    def _abort(step_name: str):
        print(f"watchdog: step {step_name!r} exceeded deadline; aborting "
              f"process (exit {WATCHDOG_EXIT_CODE})", flush=True)
        os._exit(WATCHDOG_EXIT_CODE)

    def _fire(self, name: str):
        self.fired = name
        self._on_timeout(name)

    def step(self, name: str):
        """Context manager arming the deadline around one step."""
        wd = self

        class _Step:
            def __enter__(self):
                wd._timer = threading.Timer(wd.timeout_s, wd._fire, (name,))
                wd._timer.daemon = True
                wd._timer.start()
                return wd

            def __exit__(self, *exc):
                if wd._timer is not None:
                    wd._timer.cancel()
                    wd._timer = None
                return False

        return _Step()


def run_elastic(step: Callable[[int], object], *, max_restarts: int = 2,
                step_timeout_s: float | None = None,
                on_timeout: Callable[[str], None] | None = None,
                step_name: str = "step"):
    """Run `step(attempt)` until it returns, restarting on exceptions up to
    `max_restarts` times (ciphertext evaluation is replayable; pair with the
    pipeline's checkpoint_dir so a restart resumes at the last completed
    round instead of round 1).  With `step_timeout_s`, each attempt is also
    watchdog-armed."""
    last: BaseException | None = None
    for attempt in range(max_restarts + 1):
        try:
            if step_timeout_s is None:
                return step(attempt)
            wd = Watchdog(step_timeout_s, on_timeout=on_timeout)
            with wd.step(f"{step_name}#{attempt}"):
                out = step(attempt)
            if wd.fired is not None:
                raise TimeoutError(f"watchdog fired on {wd.fired}")
            return out
        except BaseException as e:          # noqa: BLE001 -- retry policy
            last = e
            if attempt == max_restarts:
                break
            print(f"run_elastic: attempt {attempt} failed "
                  f"({type(e).__name__}: {e}); restarting", flush=True)
    raise RuntimeError(
        f"run_elastic: {step_name} failed after {max_restarts + 1} "
        f"attempts") from last
