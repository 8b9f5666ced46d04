"""Test scheduling for `pytest -n N --dist loadfile` (pytest-xdist).

xdist queues whole files by their number of tests, largest first, and tops
a worker up with another file while its last two tests run.  The suite's
longest file, `tests/test_pipeline.py` (five tests, ~1150 s on one
worker), then starts late, or sets the wall alone.  The scheduler below
splits each file of FIRST into units by the module fixture its tests take
(one fixture, one unit: each fixture is still built once, on one worker),
starts those units first, and gives each unit's worker one other unit
only, the smallest queued, until the unit is done: an xdist worker runs a
test once it knows the next one (or is told to stop), so a unit alone on
its worker would keep its last test until the whole run had ended.  Every
other file keeps xdist's order.

xdist is imported inside the hook, so a run without it (the card's
JAX-free `--noconftest` runs, plain `pytest`) never imports it.

The reference's on-disk key cache (`aesfhe_tpu.utils.serialization`,
which `tests/conftest.py`'s engine fixtures load or fill) writes every key
family through one temporary name, so two workers that build the same
family on a cold cache race and one fixture fails (FileNotFoundError;
ROADMAP queue 3).  An autouse fixture of the whole run wraps the two
cache functions in each process with an exclusive file lock per family:
the second worker waits for the first one's keys and loads them.
"""
import ast
import fcntl
import functools
import hashlib
import tempfile
from pathlib import Path

import pytest

# the files that go first, split by module fixture, each unit on a worker
# of its own
FIRST = ("tests/test_pipeline.py",)


def fixture_units(path: str) -> dict:
    """{test name: unit}: the unit of each test function in the file is
    the first module-scoped fixture among its arguments (`path::fixture`),
    else the file; units in the order of their fixtures in the file."""
    tree = ast.parse((Path(__file__).parent / path).read_text())
    funcs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]

    def module_fixture(fn):
        for d in fn.decorator_list:
            if isinstance(d, ast.Call) and "fixture" in ast.unparse(d.func):
                return any(k.arg == "scope" and ast.literal_eval(k.value) ==
                           "module" for k in d.keywords)
        return False
    fixtures = [f.name for f in funcs if module_fixture(f)]
    units = {}
    for fn in funcs:
        if fn.name.startswith("test_"):
            args = [a.arg for a in fn.args.args]
            used = [f for f in fixtures if f in args]
            units[fn.name] = f"{path}::{used[0]}" if used else path
    return units


def _one_writer(fn, dir_arg: int):
    """fn(engine, ..., cache_dir, ...) under an exclusive lock on a file in
    the temporary directory (the cache directory holds only the cache's
    own files) named for the family: the cache directory, fn, the engine's
    ring and primes, the keyword arguments and any positional ones after
    cache_dir."""
    @functools.wraps(fn)
    def locked(*args, **kwargs):
        cache_dir = args[dir_arg] if len(args) > dir_arg else \
            kwargs.get("cache_dir")
        if not cache_dir:
            return fn(*args, **kwargs)
        p = args[0].params
        family = repr((str(Path(cache_dir).resolve()), fn.__name__, p.n,
                       tuple(int(q) for q in p.all_primes),
                       args[dir_arg + 1:], sorted(kwargs.items())))
        name = hashlib.sha256(family.encode()).hexdigest()[:16]
        locks = Path(tempfile.gettempdir()) / "aesfhe_key_cache_locks"
        locks.mkdir(exist_ok=True)
        with open(locks / name, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            return fn(*args, **kwargs)
    return locked


@pytest.fixture(scope="session", autouse=True)
def _key_cache_one_writer():
    """Before any test's fixtures: the reference's key cache functions under
    `_one_writer` in this process (nothing without the reference)."""
    try:
        from aesfhe_tpu.utils import serialization
    except ImportError:
        yield
        return
    saved = serialization.cached_key_family, serialization.cached_bootstrap_key
    serialization.cached_key_family = _one_writer(saved[0], 1)
    serialization.cached_bootstrap_key = _one_writer(saved[1], 2)
    yield
    serialization.cached_key_family, serialization.cached_bootstrap_key = saved


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling
    units = {path: fixture_units(path) for path in FIRST}

    def first(scope: str) -> bool:
        return scope.split("::", 1)[0] in units

    class LongFilesFirst(LoadFileScheduling):
        def _split_scope(self, nodeid: str) -> str:
            path = nodeid.split("::", 1)[0]
            if path in units:
                name = nodeid.split("::", 1)[1].split("[", 1)[0]
                return units[path].get(name, path)
            return super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            for scope in [s for s in reversed(self.workqueue) if first(s)]:
                self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

        def _reschedule(self, node):
            held = self.assigned_work.get(node, {})
            if not any(first(scope) and not all(held[scope].values())
                       for scope in held):
                super()._reschedule(node)
                return
            rest = [s for s in self.workqueue if not first(s)]
            if len(held) == 1 and rest and not node.shutting_down:
                scope = rest[-1]              # the queue runs largest first
                unit = self.workqueue.pop(scope)
                held[scope] = unit
                ids = self.registered_collections[node]
                node.send_runtest_some([ids.index(t) for t, done in
                                        unit.items() if not done])

    return LongFilesFirst(config, log)
