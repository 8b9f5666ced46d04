"""The repo-root conftest's scheduler for `pytest -n N --dist loadfile`:
tests/test_pipeline.py splits into one unit per module fixture, those
units start first, each on a worker of its own that takes nothing else
until its unit is done, and every other file stays whole in xdist's
order.  Driven here with stand-in workers, no subprocess."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent
PIPE = "tests/test_pipeline.py"


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  ROOT / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Node:
    """A worker as the scheduler sees it: the test indices sent to it."""

    def __init__(self, name):
        self.gateway = SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def test_pipeline_units_are_its_module_fixtures():
    """Each test of tests/test_pipeline.py belongs to the unit of the module
    fixture it takes: the deep cipher's two tests, the bootstrapped
    cipher's two (three rounds, FIPS-197) and the prod-shaped zeta test."""
    units = _root_conftest().fixture_units(PIPE)
    by_unit = {}
    for test, unit in units.items():
        by_unit.setdefault(unit, []).append(test)
    assert by_unit == {
        f"{PIPE}::cipher": ["test_one_full_round",
                            "test_pack_blocks_roundtrip"],
        f"{PIPE}::boot_cipher": ["test_three_rounds_with_bootstrap",
                                 "test_full_aes128_fips197"],
        f"{PIPE}::prod_shaped_cipher": ["test_zeta_three_rounds_prod_shaped"]}


def test_pipeline_units_start_first_on_workers_of_their_own():
    """Six workers: the three units of tests/test_pipeline.py go to three
    workers, and each of those gets one more unit, the smallest file
    queued (a worker runs a test once it knows the next one, so a unit's
    last test would otherwise wait for the end of the run), and nothing
    else until its unit is done; the other files, each whole, go to the
    other workers; a unit's worker takes more work once its unit is done,
    and every test is sent once."""
    pytest.importorskip("xdist")
    mod = _root_conftest()
    config = SimpleNamespace(
        getvalue=lambda k: {"dist": "loadfile", "tx": ["6*popen"]}[k],
        option=SimpleNamespace(loadscopereorder=True))
    sched = mod.pytest_xdist_make_scheduler(config, None)
    pipe = [f"{PIPE}::{t}" for t in mod.fixture_units(PIPE)]
    sizes = dict(zip("abcdefghij", (9, 8, 7, 6, 5, 4, 3, 3, 2, 1)))
    others = [f"tests/test_{f}.py::test_{i}" for f, n in sizes.items()
              for i in range(n)]
    collection = others[:10] + pipe + others[10:]
    nodes = [_Node(f"gw{i}") for i in range(6)]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()

    def files(node):
        return {sched._split_scope(collection[i]) for i in node.sent}
    units = set(mod.fixture_units(PIPE).values())
    holders = [n for n in nodes if files(n) & units]
    assert len(holders) == 3
    extra = [files(n) - units for n in holders]
    assert all(len(files(n) & units) == 1 and len(e) == 1
               for n, e in zip(holders, extra))
    assert sorted(f for e in extra for f in e) == [
        "tests/test_h.py", "tests/test_i.py", "tests/test_j.py"]
    assert all(not files(n) & units for n in nodes if n not in holders)
    assert all(not f.startswith(PIPE) for f in
               {sched._split_scope(t) for t in others})
    # the deep cipher's unit ends: its worker takes the next file
    first = next(n for n in holders if f"{PIPE}::cipher" in files(n))
    for i in [i for i in first.sent if collection[i].startswith(PIPE)]:
        sched.mark_test_complete(first, i)
    assert len(files(first)) == 3
    sent = sorted(i for n in nodes for i in n.sent)
    assert len(sent) == len(set(sent))
