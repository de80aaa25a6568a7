"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: ``repro_torch`` is not ``repro``), and the references load nothing
of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN = r'''
import json, sys
sys.path[:0] = ["src", "."]
from agentbench.tests import tiny
res = tiny.run("{cell}", 5)
from agentbench import run
print(json.dumps({{"correct": res["correct"], "found": run.forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
'''


def top_level(cmd: str) -> dict:
    out = subprocess.run([sys.executable, "-c", cmd], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    for cell in ("olmoe-1b-7b.mapreduce", "rwkv6-7b.agent"):
        got = top_level(RUN.format(cell=cell))
        assert got["correct"]
        assert got["found"] == [] and not FORBIDDEN & set(got["top"])
        assert "repro_torch" in got["top"]


def test_the_references_load_nothing_of_the_program():
    got = top_level("import json, sys; sys.path[:0] = ['src', '.']\n"
                    "import agentbench.reference.olmoe, agentbench.reference.rwkv6, "
                    "agentbench.correct, agentbench.weights\n"
                    "print(json.dumps({'top': sorted({m.split('.')[0] for m in sys.modules})}))")
    assert not (FORBIDDEN | {"repro_torch"}) & set(got["top"])


def test_the_yardstick_names_no_program_module():
    """The references, counts, weights and the comparison import neither
    the program nor JAX, in any statement."""
    files = [*(ROOT / "agentbench/reference").glob("*.py"),
             *(ROOT / "agentbench/counts").glob("*.py"),
             ROOT / "agentbench/weights.py", ROOT / "agentbench/correct.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {"repro_torch"}, (path, name)
