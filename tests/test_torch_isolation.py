"""The port stands alone: no module of ``src/repro_torch`` nor its root
scripts ``chip_smoke.py``, ``kernel_ab.py``, ``wkv6_split_probe.py``,
``shard_probe.py`` and ``flash_bwd_probe.py`` nor its example ``examples/train_model_torch.py`` nor the sharded tests'
rank worker ``tests/torch_sharded_worker.py`` nor the sharded checkpoint's
tests ``tests/test_torch_checkpoint_sharded.py`` imports JAX or anything of
the JAX package, and its entry points run on the card unless the caller
names the CPU."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DenseLM
from repro_torch.models.vision import VisionLM
from repro_torch.serving.engine import ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "kernel_ab.py", REPO / "wkv6_split_probe.py",
     REPO / "shard_probe.py", REPO / "flash_bwd_probe.py",
     REPO / "examples" / "train_model_torch.py",
     REPO / "tests" / "torch_sharded_worker.py",
     REPO / "tests" / "test_torch_checkpoint_sharded.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax_or_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_finds_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "transformer.py", "layers.py", "ops.py",
            "chip_smoke.py", "bridge.py", "hw.py", "scheduler.py",
            "profiler.py", "tile_plan.py", "hymba.py", "vision.py",
            "encdec.py", "optimizer.py", "train_loop.py", "train.py",
            "data.py", "checkpoint.py", "compression.py",
            "fault_tolerance.py", "registry.py", "sharding.py", "mesh.py",
            "train_model_torch.py", "op_stats.py", "dryrun.py",
            "reanalyze.py", "admission.py", "telemetry.py", "drift.py",
            "forecast.py", "replan.py", "accuracy.py", "metrics.py",
            "spans.py", "torch_sharded_worker.py", "shard_probe.py",
            "flash_bwd_probe.py", "test_torch_checkpoint_sharded.py"} <= names


def test_scanner_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.models import layers\n"
                 "from repro_torch.models import layers as L\n")
    assert set(_imported_roots(f)) == {"jax", "repro", "repro_torch"}


def test_training_entry_points_default_to_the_card():
    """``launch.train.main`` runs on the card unless ``--device cpu`` is
    given, and ``make_train_step`` trains a model where it lies: its state
    and batches follow the model's device, which a ``DenseLM`` built with
    no device names as ``cuda``."""
    import inspect

    from repro_torch.launch.train import main as train_main
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_loop import make_train_step

    assert inspect.signature(DenseLM).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--steps", "1", "--ckpt-dir", "unused", "--resume"])
    cfg = reduced_config(get_config("qwen2.5-3b"))
    model = DenseLM(cfg, device="cpu")
    step = make_train_step(model)
    state = init_state(dict(model.named_parameters()))
    state, metrics = step(state, {"tokens": [[1, 2, 3, 4]], "labels": [[2, 3, 4, 5]]})
    assert metrics["loss"].device.type == "cpu" and int(metrics["step"]) == 1


def test_entry_points_without_a_device_raise_here():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    cfg = reduced_config(get_config("llama-3.2-1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    ServingEngine(model, device="cpu")  # the explicit CPU is taken
    for arch, cls in (("llama-3.2-vision-11b", VisionLM),
                      ("seamless-m4t-large-v2", EncDecLM)):
        cfg = reduced_config(get_config(arch))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
        cls(cfg, device="cpu")
