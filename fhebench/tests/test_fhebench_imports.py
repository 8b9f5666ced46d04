"""Nothing under fhebench/ imports JAX or the JAX package, and nothing
under fhebench/reference/ imports the program: by the whole top-level name
of each module, since the program's name begins with the JAX package's."""
import ast
import json
import subprocess
import sys

import pytest

from fhebench.run import FORBIDDEN, ROOT

HARNESS = ROOT / "fhebench"
FILES = sorted(HARNESS.rglob("*.py"))


def imported(path) -> set:
    """Top-level names of every module a file imports."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    HARNESS)))
def test_no_jax_anywhere(path):
    assert not imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HARNESS / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    mods = imported(path)
    assert "aesfhe_tpu_torch" not in mods and not mods & set(FORBIDDEN)


def test_loading_every_cell_loads_no_jax():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    code = ("import json, sys\n"
            "from fhebench import cell, run, tracing, traffic\n"
            f"for name in {cells!r}:\n"
            "    cell.load(name, run.ROOT)\n"
            "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
