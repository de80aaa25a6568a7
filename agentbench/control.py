"""The readings that the limit of ``correct`` is set from, on the card.

    python3 -m agentbench.control --workload <cell> --seeds 1,2,3,... \\
        --seconds 15 [--out readings.jsonl]

In one process, for each seed: a run of the cell as the benchmark makes it
(a shorter window at the cell's own load and sizes), with the program's
readings (the widest and the mean logit gap, the share of tokens off the
reference's first choice) and the control's: the reference in fp8 in
the program's place, over the same prompts and served tokens
(``correct.py``), and per call of the sample its tokens and the sum and
the widest of its gaps on either side, so that a smaller sample's
readings (a first part of the same sample) come from the same run.  One
JSON line per seed.  The limit lies above the program's largest reading
and below the control's smallest.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from agentbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            res = harness.run_cell(args.workload, seed, args.seconds, False, t, control=True)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "correct": res["correct"], "failed": res["failed"],
                               "readings": res["control"],
                               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
