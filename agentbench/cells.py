"""Everything a run needs, found by the names in ``BENCHMARK.json``:
the cell, its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and the
metrics it reports."""
from __future__ import annotations

import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    """``BENCHMARK.json``, with each parked cell (``parked/<cell>.json``)
    that it does not name.  A parked cell keeps every file it runs from and
    runs by its name, but no check runs it: its file holds the entries that
    put it back into ``BENCHMARK.json`` (its configuration, its cell, and
    the per-layer metrics with ``workloads`` that it reads, whose lists it
    joins where ``BENCHMARK.json`` has the metric already)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in sorted((HERE / "parked").glob("*.json")):
        park(bench, json.loads(path.read_text()))
    return bench


def park(bench: dict, parked: dict) -> None:
    named = {w["name"] for w in bench["workloads"]}
    new = [w for w in parked["workloads"] if w["name"] not in named]
    if not new:
        return
    bench["workloads"] += new
    have = {c["name"] for c in bench["configs"]}
    bench["configs"] += [c for c in parked["configs"] if c["name"] not in have]
    metrics = {e["name"]: e for e in bench["end_to_end"] + bench["per_layer"]}
    for entry in parked["per_layer"]:
        if entry["name"] not in metrics:
            bench["per_layer"].append(entry)
        elif "workloads" in metrics[entry["name"]]:
            metrics[entry["name"]]["workloads"] += [w["name"] for w in new]


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def _file(folder: str, name: str) -> dict:
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} entry {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _file("configs", name)


def limits(cell_name: str) -> dict:
    return _file("limits", cell_name)


def metric_names(bench: dict, cell_name: str, trace: bool) -> List[str]:
    """The cell's end-to-end metrics (an untraced run) or its per-layer
    ones (a traced run): every entry without ``workloads``, and those that
    list the cell."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [e["name"] for e in entries
            if "workloads" not in e or cell_name in e["workloads"]]
