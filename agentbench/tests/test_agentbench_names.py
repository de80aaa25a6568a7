"""Every cell, configuration, mix, limit and metric is found by its name,
and a new one is added as new files and entries only."""
import copy
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from agentbench import cells
from agentbench.metrics import reader
from agentbench.traffic import load_mix, program_of

ROOT = Path(__file__).resolve().parents[2]


def test_every_name_has_its_file():
    bench = cells.benchmark()
    for entry in bench["configs"]:
        config = cells.config(entry["name"])
        assert (ROOT / entry["file"]).is_file() and config["name"] == entry["name"]
        assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"]
    for cell in bench["workloads"]:
        program_of(load_mix(cell["traffic"]))
        assert cells.limits(cell["name"])["numbers"]
        for trace in (False, True):
            names = cells.metric_names(bench, cell["name"], trace)
            assert names and all(callable(reader(n)) for n in names)
        assert "setup_s" in cells.metric_names(bench, cell["name"], False)
    for metric in bench["end_to_end"] + bench["per_layer"]:
        reader(metric["name"])


def test_a_parked_cell_runs_by_name_and_no_check_runs_it():
    """A parked cell is not in ``BENCHMARK.json``; ``cells.benchmark()``
    finds it by name, and its entries put back a second time change
    nothing."""
    raw = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = cells.benchmark()
    paths = sorted((ROOT / "agentbench/parked").glob("*.json"))
    assert paths
    for path in paths:
        parked = json.loads(path.read_text())
        for w in parked["workloads"]:
            assert w["name"] not in {x["name"] for x in raw["workloads"]}
            assert cells.cell(w["name"], bench) == w
            assert cells.metric_names(bench, w["name"], True)
        again = copy.deepcopy(bench)
        cells.park(again, parked)
        assert again == bench


ADD = r'''
import json, sys
sys.path[:0] = ["src", "."]
from agentbench import cells
from agentbench.metrics import reader
from agentbench.traffic import Workflows, load_mix
bench = cells.benchmark()
cell = cells.cell("olmoe-1b-7b.short", bench)
cells.config(cell["config"]); cells.limits(cell["name"])
wf = Workflows(load_mix(cell["traffic"]), 1, 100)
assert wf.start() is not None
names = cells.metric_names(bench, "olmoe-1b-7b.short", True)
assert "prompt_share" in names, names
print(json.dumps({"value": reader("prompt_share")({"window": {"tokens": 3}})}))
'''


def digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_mix_and_metric_are_new_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "agentbench", tmp_path / "agentbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "src").symlink_to(ROOT / "src")
    before = digest(tmp_path / "agentbench")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # new files: a mix, a limit and a metric's reader
    mix = json.loads((tmp_path / "agentbench/traffic/mapreduce_16docs.json").read_text())
    mix["clients"] = 2
    (tmp_path / "agentbench/traffic/mapreduce_2docs.json").write_text(json.dumps(mix))
    (tmp_path / "agentbench/limits/olmoe-1b-7b.short.json").write_text(
        (tmp_path / "agentbench/limits/olmoe-1b-7b.mapreduce.json").read_text())
    (tmp_path / "agentbench/metrics/prompt_share.py").write_text(
        "def read(record):\n    return 100.0 * record['window']['tokens'] / 6\n")
    # new entries
    bench["workloads"].append({"name": "olmoe-1b-7b.short", "config": "olmoe-1b-7b",
                               "traffic": "mapreduce_2docs", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "prompt_share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "tokens_per_s", "workloads": ["olmoe-1b-7b.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", ADD], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"value": 50.0}
    after = digest(tmp_path / "agentbench")
    assert all(after[name] == h for name, h in before.items())
