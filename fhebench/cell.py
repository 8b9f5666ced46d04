"""Finds a cell's parts by the names `BENCHMARK.json` gives them, so that a
configuration, a traffic mix or a metric is added as files and entries
alone:

    configs[].file                   the configuration (sizes, pipeline,
                                     refresh, batch, source, assumed)
    fhebench/pipelines/<pipeline>.py the system under test behind one
                                     `System` class, named by the
                                     configuration's `pipeline`
    fhebench/traffic/<traffic>.json  the mix `traffic.py` generates
    fhebench/metrics/<metric>.py     one reader per metric, `read(run)`
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

from . import traffic

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    pipeline: object        # the module under fhebench/pipelines/
    end_to_end: list        # [(metric entry, reader module)]
    per_layer: list


def load_module(path: Path, name: str):
    """A module from its file; a file named after a metric may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "fhebench._loaded." + re.sub(r"\W", "_", name), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _readers(metrics: list, cell: str, base: Path) -> list:
    out = []
    for m in metrics:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out.append((m, load_module(base / "metrics" / f"{m['name']}.py",
                                   m["name"])))
    return out


def load(name: str, root: Path) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, its files read from
    `root`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    if config.get("name") != entry["name"]:
        raise ValueError(f"{entry['file']} names {config.get('name')!r}, "
                         f"not {entry['name']!r}")
    base = root / HERE.name
    mix = traffic.load(base / "traffic" / f"{w['traffic']}.json")
    pipeline = load_module(base / "pipelines" / f"{config['pipeline']}.py",
                           "pipeline_" + config["pipeline"])
    return Cell(name, w["chips"], config, mix, pipeline,
                _readers(bench["end_to_end"], name, base),
                _readers(bench["per_layer"], name, base))
