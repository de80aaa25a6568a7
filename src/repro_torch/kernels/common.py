"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``src/repro_torch/csrc/<name>.cu`` file with a plain C
interface.  At first use it is compiled with ``nvcc`` for ``sm_90a`` into
a shared library under ``build/`` at the repository root and loaded with
``ctypes``.  The library's file name carries a hash of the source and the
flags, so a stale build is never loaded.  ``build`` compiles several
kernels at once, one ``nvcc`` process per source.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code.  ``launch_counts`` holds one integer
per kernel, which its wrapper bumps where it launches the kernel and
nowhere else, so a run can show that it went through the kernel.

On the meta device (the dry-run, ``launch/dryrun.py``) a wrapper launches
nothing: it applies the card's operand checks, under ``card_checks``,
which turns a refusal into ``Refused``, returns empty outputs of the
kernel's shapes, and reports the call to the active op counters
(``count_meta_call``; ``analysis/op_stats.py`` keeps them).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
REPO_ROOT = PACKAGE_DIR.parents[1]
BUILD_DIR = REPO_ROOT / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("flash_attention", "decode_attention", "wkv6_scan", "wkv6_chunk",
           "flash_attention_bwd", "wkv6_bwd")

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}


# the op counters a meta-device call reports to: each takes (kernel name,
# the call's shape as a dict)
meta_counters: List[Callable[[str, dict], None]] = []


class Refused(RuntimeError):
    """A kernel's operand checks refused a call on the meta device: the
    card would refuse the same call."""


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def count_meta_call(name: str, **shape) -> None:
    """A meta-device call of kernel ``name`` at ``shape``, reported to every
    active op counter.  ``launch_counts`` stays as it is: nothing was
    launched."""
    for counter in meta_counters:
        counter(name, shape)


@contextlib.contextmanager
def card_checks(t: torch.Tensor):
    """Runs the card's operand checks of a call on ``t``'s device: on the
    meta device a refusal is raised as ``Refused``; on the card it is
    raised as it is."""
    try:
        yield
    except (RuntimeError, ValueError) as exc:
        if t.device.type == "meta":
            raise Refused(str(exc)) from exc
        raise


def refuse_grad(wrapper: str, *tensors: torch.Tensor) -> None:
    """Raise where a wrapper whose kernel has no backward is called on the
    card for a result that needs a gradient: the launch would write its
    output through ctypes, and autograd would pass no gradient back."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{wrapper}: an input requires grad, and its "
                           "kernel has no backward; call it under "
                           "torch.no_grad()")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile the named kernels that are not built yet, all at once.

    Returns the build report of each name compiled by this call.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    reports = {}
    for name, (proc, tmp, out, t0) in started.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{text}")
        os.replace(tmp, out)
        reports[name] = {"seconds": seconds, "ptxas": text}
    return reports


def load_function(name: str, symbol: str, argtypes: Sequence):
    """The C entry ``symbol`` of kernel library ``name``, built on first use.

    Every pointer and the stream must be ``ctypes.c_void_p`` in
    ``argtypes``; ctypes would otherwise pass them as 32-bit ints.
    """
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    if code != 0:
        msg = getattr(_libs[name], f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype) -> None:
    """What the kernels require of a tensor they read or write: the given
    device and dtype, a contiguous last dim, and 16-byte alignment of the
    base and of every row, for 16-byte vector loads."""
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous")
    per_16b = 16 // t.element_size()
    strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    if t.data_ptr() % 16 or any(s % per_16b for s in strides):
        raise ValueError(f"{name}: rows must be 16-byte aligned")
