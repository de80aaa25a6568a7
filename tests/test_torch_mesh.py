"""``launch/mesh.py`` and ``shard_model`` at the production shapes, under
torch's fake process group: one process plays rank 0 of 256 (or 512)
ranks, and a model on the meta device gives every weight's local shard
without memory.  Also the (1, 1) mesh of one CPU process, and the
refusals: no card, no process group, a world of another size."""
import math

import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.fault_tolerance import MeshPlan
from repro_torch.launch import mesh as meshes
from repro_torch.models.transformer import DenseLM
from repro_torch.training.optimizer import init_state
from torch_threads import one_thread  # noqa: F401  (autouse)


@pytest.fixture
def fake_world():
    """A fake default process group of ``world`` ranks, this one rank 0."""
    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(fake_world, multi_pod):
    shape = meshes.MULTI_POD_SHAPE if multi_pod else meshes.PRODUCTION_SHAPE
    fake_world(math.prod(shape))
    mesh = meshes.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.shape) == shape == ((2, 32, 8) if multi_pod else (32, 8))
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                   else ("data", "model"))
    # the model axis is one 8-GPU NVLink host
    assert mesh.size(mesh.mesh_dim_names.index("model")) == 8


def test_mesh_from_plan(fake_world):
    fake_world(64)
    mesh = meshes.mesh_from_plan(MeshPlan(data_ways=8, model_ways=8,
                                          dropped_workers=(), restart_from_checkpoint=True),
                                 device_type="cpu")
    assert tuple(mesh.shape) == (8, 8) and mesh.mesh_dim_names == ("data", "model")


@pytest.mark.parametrize("arch", ["llama-3.1-8b", "qwen2.5-3b"])
def test_meta_shards_at_the_production_mesh(fake_world, arch):
    """Every weight of a meta ``DenseLM`` sharded at (32, 8): its local
    shard is ``local_shape`` of its fitted spec (llama-3.1-8b's w_gate
    (4096, 14336) gives (4096, 1792); qwen2.5-3b's two KV heads stay whole
    over 8 ways), and its moments are 1/32 of that where ZeRO-1 gives
    them a ``data`` dim."""
    fake_world(256)
    mesh = meshes.make_production_mesh(device_type="cpu")
    cfg = get_config(arch)
    model = DenseLM(cfg, device="meta")
    specs = sharding.fit_param_specs(model, mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    moments = sharding.zero_opt_specs(specs, shapes, 32).m
    sharding.shard_model(model, mesh)
    state = init_state(dict(model.named_parameters()))
    for name, p in model.named_parameters():
        assert p.device.type == "meta"
        assert tuple(p.to_local().shape) == sharding.local_shape(shapes[name], specs[name], mesh)
        m = state.m[name].to_local()
        assert m.dtype == torch.float32
        assert tuple(m.shape) == sharding.local_shape(shapes[name], moments[name], mesh)
    if arch == "llama-3.1-8b":
        assert tuple(model.layers[0].mlp["w_gate"].to_local().shape) == (4096, 1792)
    else:
        assert tuple(model.layers[0].attn["wk"].to_local().shape) == (2048, 256)
        assert tuple(state.m["layers.0.attn.wk"].to_local().shape) == (64, 256)


def test_single_device_mesh_on_the_cpu():
    if dist.is_initialized():
        pytest.skip("a process group is running in this process")
    try:
        mesh = meshes.single_device_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_meshes_refuse_what_is_missing(fake_world):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        meshes.single_device_mesh()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no default process group"):
        meshes.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    fake_world(8)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        meshes.make_production_mesh()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        meshes.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="unsupported device type"):
        meshes.make_mesh((8,), ("data",), device_type="meta")
