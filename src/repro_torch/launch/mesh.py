"""Device meshes, the counterpart of ``repro.launch.mesh`` over torch's
``DeviceMesh``.

Importing this module touches no device and no process group; meshes are
built only inside the functions.  Every mesh but ``single_device_mesh``'s
needs a default process group whose world is the mesh's size, which the
launcher starts (``torch.distributed.init_process_group`` with its
address, world size and rank).  A mesh of the card runs over NCCL; a CPU
mesh (gloo, or the fake process group of a shape-only test) is built
only where the caller asks for ``device_type="cpu"``.  Nothing falls back
from one to the other: a missing card or NCCL raises.

The production shapes put the ``model`` (tensor-parallel) axis inside one
8-GPU NVLink host, the port's ``ClusterSpec(chips_per_host=8,
hb_domain_size=8)`` (``hw.H100_HOST_8``): (32, 8) over ``("data",
"model")`` is 256 GPUs, and two such pods, (2, 32, 8) over ``("pod",
"data", "model")``, are 512.  The reference's (16, 16) TPU mesh does not
carry over: its 16-way ``model`` axis rides the TPU's inter-chip links,
and on H100 hosts it would span two NVLink domains, so every layer's two
tensor-parallel all-reduces would cross the slower network between
hosts.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.sharding import AXES, DATA, MODEL, POD

PRODUCTION_SHAPE = (32, 8)
MULTI_POD_SHAPE = (2, 32, 8)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, whose world must be the mesh's size: the cards over NCCL
    (``device_type="cuda"``) or the CPU (``"cpu"``)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device_type='cpu' explicitly for a CPU mesh")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: a mesh of the cards "
                               "needs it")
    elif device_type != "cpu":
        raise ValueError(f"unsupported device type {device_type!r}: use "
                         "'cuda' or 'cpu'")
    if not dist.is_initialized():
        raise RuntimeError("no default process group: start one with "
                           "torch.distributed.init_process_group first")
    if device_type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"a mesh of the cards needs the NCCL backend, "
                           f"not {dist.get_backend()!r}")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """One pod, (32, 8) over (data, model): 256 GPUs in 32 hosts of 8; or
    two, (2, 32, 8) over (pod, data, model): 512."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, (POD, DATA, MODEL), device_type)
    return make_mesh(PRODUCTION_SHAPE, AXES, device_type)


def single_device_mesh(device_type: str = "cuda"):
    """(1, 1) over (data, model) for one process on one card (or the
    CPU).  Starts a process group of one rank over an in-process store
    where none is running: NCCL for the card, gloo for the CPU."""
    if not dist.is_initialized():
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device_type='cpu' explicitly for a CPU mesh")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh((1, 1), AXES, device_type)


def mesh_from_plan(plan, device_type: str = "cuda"):
    """The (data, model) mesh of a ``fault_tolerance.MeshPlan``: the
    launcher's rebuild after an elasticity event."""
    return make_mesh((plan.data_ways, plan.model_ways), AXES, device_type)
