"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m agentbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error give the same checks.  The run
exits with a code other than 0, and prints no result, where there is no
CUDA card or fewer than the cell asks for, where the program cannot be
imported, and where a module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()  # the set-up's clock starts before any import

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# whole top-level names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from agentbench import cells, harness

    bench = cells.benchmark()
    cell = cells.cell(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              T_START, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"loaded in this run: {found}; the port's benchmark loads none of "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
