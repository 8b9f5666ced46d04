"""Test scheduling for `pytest -n N --dist loadfile` (pytest-xdist).

xdist queues whole files by their number of tests, largest first, and tops
a worker up with another file while its last two tests run.  The suite's
longest file, `tests/test_pipeline.py` (five tests, most of the suite's
wall on one worker), then starts late and may end with another file
queued behind it.  The scheduler below starts that file first and gives
its worker nothing else; every other file keeps xdist's order.

xdist is imported inside the hook, so a run without it (the card's
JAX-free `--noconftest` runs, plain `pytest`) never imports it.
"""
import pytest

# the files that go first, each on a worker of its own
FIRST = ("tests/test_pipeline.py",)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongFilesFirst(LoadFileScheduling):
        def _assign_work_unit(self, node):
            for scope in reversed(FIRST):
                if scope in self.workqueue:
                    self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

        def _reschedule(self, node):
            held = self.assigned_work.get(node, {})
            if any(scope in FIRST and not all(held[scope].values())
                   for scope in held):
                return
            super()._reschedule(node)

    return LongFilesFirst(config, log)
