"""Re-derive ``op_stats`` of every dry-run cell from its saved op trace
(no model is built and no step is run), the counterpart of
``repro.launch.reanalyze``: used after the counting rules of
``analysis/op_stats.py`` change.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.reanalyze --collectives CELL [--out DIR]

DIR is the dry-run's (``experiments/dryrun_torch/`` by default).  The
memory readings come from the run and stay as they were.  With
``--collectives`` nothing is rewritten: the cell's collectives are
printed one line per c10d op and output shape (``collective_breakdown``),
which tells the query columns' gather (``_allgather_base_`` and, in a
train step, its ``_reduce_scatter_base_`` gradient) from the all-reduces.
"""
from __future__ import annotations

import argparse
import gzip
import json
from pathlib import Path

from repro_torch.analysis.op_stats import analyze, op_work
from repro_torch.launch.dryrun import RESULTS_DIR, collectives


def reanalyze_cell(json_path: Path, trace_path: Path) -> dict:
    """The record at ``json_path`` with ``op_stats`` and ``collectives``
    derived from the trace at ``trace_path``."""
    rec = json.loads(json_path.read_text())
    stats = analyze(json.loads(gzip.decompress(trace_path.read_bytes())))
    rec["op_stats"] = stats
    rec["collectives"] = collectives(stats)
    return rec


def collective_breakdown(trace) -> list:
    """Each c10d op of a trace by its output's shape (a list's first
    tensor's): {"op", "out", "dtype", "count", "bytes" (over every call),
    "share" of the trace's collective bytes}, largest first."""
    rows = {}
    for rec in trace:
        w = op_work(rec)
        if "collective" not in w:
            continue
        out = rec["out"][0]
        while isinstance(out, list):  # a list of tensors: its first one's
            out = out[0]
        key = (rec["op"].split(".")[1], tuple(out["t"]), out["d"])
        row = rows.setdefault(key, {"op": key[0], "out": list(key[1]),
                                    "dtype": key[2], "count": 0, "bytes": 0})
        row["count"] += rec["count"]
        row["bytes"] += rec["count"] * w["bytes"]
    total = sum(r["bytes"] for r in rows.values()) or 1
    return sorted(({**r, "share": r["bytes"] / total} for r in rows.values()),
                  key=lambda r: -r["bytes"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    ap.add_argument("--collectives", metavar="CELL", default=None,
                    help="print CELL's collectives by op and shape")
    args = ap.parse_args(argv)
    if args.collectives:
        gz = args.out / "trace" / f"{args.collectives}.json.gz"
        for row in collective_breakdown(json.loads(gzip.decompress(gz.read_bytes()))):
            print(json.dumps(row))
        return 0
    n = 0
    for gz in sorted((args.out / "trace").glob("*.json.gz")):
        cell = gz.name[:-len(".json.gz")]
        jpath = args.out / f"{cell}.json"
        if not jpath.exists():
            continue
        jpath.write_text(json.dumps(reanalyze_cell(jpath, gz), indent=2))
        n += 1
        print(f"reanalyzed {cell}", flush=True)
    print(f"done: {n} cells")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
