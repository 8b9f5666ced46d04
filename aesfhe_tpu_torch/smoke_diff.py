"""Compare two `chip_smoke.py` logs: an earlier tree's and this one's.

    python3 -m aesfhe_tpu_torch.smoke_diff EARLIER_LOG LOG

For every kernel whose ptxas line the earlier log prints (`ptxas ...:`
lines; the anonymous namespace's hash and the source's name stripped from
the symbol), whether this log prints the same line; for every path whose
launches the earlier log prints (`<path>: kernel launches {...},
instances {...}`, or `chunked {...}` in older logs), whether this log's
counts are the same (an instance the earlier tree lacks must count 0
there).  Prints the kernels and paths that differ, then one summary line.
Needs no card.
"""
from __future__ import annotations

import ast
import re
import sys
from pathlib import Path

_NS = re.compile(r"(_ZN\d+)?_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
_LAUNCH = re.compile(r"^(.+): kernel launches (\{.*?\})"
                     r"(?:, (?:instances|chunked) (\{.*?\}))?")


def ptxas_lines(text: str) -> dict:
    """{symbol without its namespace hash: [what ptxas said, ...]}."""
    out: dict = {}
    for line in text.splitlines():
        if not line.startswith("ptxas ") or ": " not in line:
            continue
        head, said = line.split(": ", 1)
        sym = _NS.sub("_GLOBAL__N_", head.split()[-1])
        out.setdefault(sym, []).append(said.strip())
    return out


def launch_lines(text: str) -> dict:
    """{path: (kernel launches, instances)}, the last line of each path."""
    out = {}
    for line in text.splitlines():
        m = _LAUNCH.match(line)
        if m:
            out[m.group(1)] = (ast.literal_eval(m.group(2)),
                               ast.literal_eval(m.group(3) or "{}"))
    return out


def compare(earlier: str, now: str) -> dict:
    """The kernels and paths of `earlier` that `now` does not repeat."""
    old_p, new_p = ptxas_lines(earlier), ptxas_lines(now)
    ptxas = {k: (v, new_p.get(k)) for k, v in old_p.items()
             if new_p.get(k) != v}
    old_l, new_l = launch_lines(earlier), launch_lines(now)
    paths = {}
    for path, (counts, inst) in old_l.items():
        got = new_l.get(path)
        if got is None or got[0] != counts or any(
                got[1].get(k, 0) != inst.get(k, 0)
                for k in set(inst) | set(got[1])):
            paths[path] = ((counts, inst), got)
    return dict(kernels=len(old_p), ptxas=ptxas, paths_total=len(old_l),
                paths=paths)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    d = compare(Path(args[0]).read_text(), Path(args[1]).read_text())
    for sym, (old, new) in d["ptxas"].items():
        print(f"ptxas differs: {sym}: {old} -> {new}")
    for path, (old, new) in d["paths"].items():
        print(f"launches differ: {path}: {old} -> {new}")
    print(f"{d['kernels'] - len(d['ptxas'])} of the earlier log's "
          f"{d['kernels']} kernels with the same ptxas lines; "
          f"{d['paths_total'] - len(d['paths'])} of its {d['paths_total']} "
          f"paths with the same launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
