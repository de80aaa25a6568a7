"""Re-derive ``op_stats`` of every dry-run cell from its saved op trace
(no model is built and no step is run), the counterpart of
``repro.launch.reanalyze``: used after the counting rules of
``analysis/op_stats.py`` change.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze [--out DIR]

DIR is the dry-run's (``experiments/dryrun_torch/`` by default).  The
memory readings come from the run and stay as they were.
"""
from __future__ import annotations

import argparse
import gzip
import json
from pathlib import Path

from repro_torch.analysis.op_stats import analyze
from repro_torch.launch.dryrun import RESULTS_DIR, collectives


def reanalyze_cell(json_path: Path, trace_path: Path) -> dict:
    """The record at ``json_path`` with ``op_stats`` and ``collectives``
    derived from the trace at ``trace_path``."""
    rec = json.loads(json_path.read_text())
    stats = analyze(json.loads(gzip.decompress(trace_path.read_bytes())))
    rec["op_stats"] = stats
    rec["collectives"] = collectives(stats)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    args = ap.parse_args(argv)
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
