"""`BENCHMARK.json` keeps to the benchmark's contract: its keys, the
characters of its names and units, its lengths and bounds, and every name
it gives leads to a file of the harness."""
import json
import re

import pytest

from fhebench.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir()


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entries_have_just_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for part, want in keys.items():
        for e in BENCH[part]:
            extra = {"workloads"} if part in ("end_to_end",
                                              "per_layer") else set()
            assert want <= set(e) <= want | extra, e["name"]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["source"] == "host_clock"
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in BENCH["end_to_end"])


def _reported(metrics, cell):
    return [m for m in metrics if cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_enough_and_its_files_exist(w):
    e2e = {m["name"] for m in _reported(BENCH["end_to_end"], w["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = _reported(BENCH["per_layer"], w["name"])
    assert layer and all(m["moves"] in e2e for m in layer)
    assert (ROOT / "fhebench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in _reported(BENCH["end_to_end"] + BENCH["per_layer"], w["name"]):
        assert (ROOT / "fhebench" / "metrics" / f"{m['name']}.py").exists()


def test_configs_are_used_and_their_files_match():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert line(cfg["source"])
        assert (ROOT / "fhebench" / "pipelines" /
                f"{cfg['pipeline']}.py").exists()


def test_metric_workloads_name_cells_and_layers_are_one_line():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["per_layer"]:
        assert line(m["layer"])


def test_four_chip_cells_stay_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
