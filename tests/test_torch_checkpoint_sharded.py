"""Checkpoints of a sharded training state (``training/checkpoint.py``).

Four gloo ranks on the CPU (``tests/torch_sharded_worker.py``, spawned once
for the module) train reduced qwen2.5-3b and reduced hymba-1.5b (whose
Mamba ``w_in`` is sharded as its (d, 2, h) paired halves) at mesh (2, 2)
with ZeRO-1 moments, f32 weights from a torch seed, and save a checkpoint
after CKPT_AT steps; this process trains the same model unsharded and
saves one too, before the ranks start.  Then:

* the sharded run's file is an unsharded run's: one writer, one
  ``shard_0.npz``, the same keys and shapes, and values held to the
  unsharded file's as ``tests/test_torch_sharding.py`` holds a sharded
  run to an unsharded one (they differ only by the order of the sharded
  sums): moments within TOL, 1e-4 of each one's scale, and each weight's
  update in RMS within 1% of the unsharded update's, over the elements
  whose first moment is zero or above NOISE of its largest (AdamW's first
  steps move an element whose gradient is rounding by about lr either
  way);
* a sharded model from another seed restores it and continues bit-equal
  to the uninterrupted sharded run, on every rank;
* a sharded model restores the unsharded file, and an unsharded model the
  sharded file, each holding the file's values exactly after the restore
  and continuing within TOL of the run that wrote it.

It imports no JAX: the runs are the port's own.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.registry import get_config, reduced_config

import torch_sharded_worker as worker
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCHS = {"qwen": "qwen2.5-3b", "hymba": "hymba-1.5b"}
MESH = (2, 2)
WORLD = 4
# as tests/test_torch_sharding.py holds a sharded run to an unsharded one
TOL, NOISE = 1e-4, 1e-5
SEED = 3


def _case(name, base):
    cfg = reduced_config(get_config(ARCHS[name]))
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, size=(4, 12))
    return {"key": name, "cfg": cfg, "seed": SEED,
            "batch": {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)},
            "ckpt": {"save": str(base / name / "sharded"),
                     "restore": str(base / name / "plain")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (the unsharded run, each rank's sharded run, the unsharded
    restore of the sharded file, the case)}."""
    base = tmp_path_factory.mktemp("ckpt_sharded")
    cases = [_case(name, base) for name in ARCHS]
    # the unsharded runs first: their files are the ranks' to restore
    plain = {c["key"]: worker.checkpoint_case(
        dict(c, ckpt={"save": c["ckpt"]["restore"]})) for c in cases}
    got, _ = worker.run_ranks([dict(c, mesh=MESH) for c in cases],
                              str(base / "store"), WORLD)
    crossed = {c["key"]: worker.checkpoint_case(
        dict(c, ckpt={"restore": c["ckpt"]["save"]}))["crossed"] for c in cases}
    return {c["key"]: (plain[c["key"]], [r[c["key"]] for r in got],
                       crossed[c["key"]], c) for c in cases}


def _close(ours, ref, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= TOL * scale, f"{what}: error {err} over scale {scale}"


def _state_close(ours, ref, start):
    """A state (``param/``, ``m/``, ``v/`` keys and ``step``) held to
    ``ref``: moments within TOL, each weight's update from ``start`` by
    the update rule above, the step exactly."""
    assert ours.keys() == ref.keys()
    for key, a in ref.items():
        kind, _, name = key.partition("/")
        if kind in ("m", "v"):
            _close(ours[key], a, key)
        elif kind == "param":
            m = np.abs(ref[f"m/{name}"])
            held = (m == 0) | (m > NOISE * m.max())
            moved = np.sqrt(np.square(a - start[name])[held].mean())
            err = np.sqrt(np.square(ours[key] - a)[held].mean())
            assert moved > 0 and err <= 1e-2 * moved, (key, err, moved)
        else:
            assert np.array_equal(ours[key], a), key


def _file(path):
    """(manifest, {key: array}, file names) of a checkpoint's step."""
    d = path / f"step_{worker.CKPT_AT:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "shard_0.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return manifest, arrays, sorted(f.name for f in d.iterdir())


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_checkpoint_is_an_unsharded_one(runs, name, tmp_path):
    """One writer and one shard, the unsharded file's keys, shapes and
    dtypes, and its values within TOL; hymba's ``w_in`` and its moments at
    (d, 2h)."""
    *_, case = runs[name]
    m_s, a_s, files = _file(Path(case["ckpt"]["save"]))
    m_p, a_p, _ = _file(Path(case["ckpt"]["restore"]))
    assert files == ["manifest.json", "shard_0.npz"]
    assert m_s["writers"] == 1 and m_s["step"] == worker.CKPT_AT
    assert m_s["leaves"] == m_p["leaves"] and m_s["num_leaves"] == len(a_s)
    assert a_s.keys() == a_p.keys()
    for key, a in a_p.items():
        assert a_s[key].shape == a.shape == tuple(m_s["leaves"][key]["shape"]), key
    _state_close(a_s, a_p, worker.start_weights(case))
    if name == "hymba":
        w_in = [k for k in a_s if k.endswith("mamba.w_in")]
        assert w_in and all(a_s[k].ndim == 2 for k in w_in)


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_resume_is_bit_equal(runs, name):
    """A sharded model from another seed, restored from the sharded file,
    takes the remaining steps exactly as the uninterrupted sharded run."""
    _, ranks, _, _ = runs[name]
    for rank in ranks:
        run, resumed = rank["run"], rank["resumed"]
        assert resumed["losses"] == run["losses"][worker.CKPT_AT:]
        assert resumed["final"].keys() == run["final"].keys()
        for key, a in run["final"].items():
            assert np.array_equal(resumed["final"][key], a), key


@pytest.mark.parametrize("name", ARCHS)
def test_unsharded_checkpoint_restores_into_a_sharded_model(runs, name):
    """Every rank's restored state gathers to the unsharded file exactly,
    and its remaining steps follow the unsharded run within TOL."""
    plain, ranks, _, case = runs[name]
    _, arrays, _ = _file(Path(case["ckpt"]["restore"]))
    for rank in ranks:
        crossed = rank["crossed"]
        for key, a in arrays.items():
            assert np.array_equal(crossed["restored"][key].astype(a.dtype), a), key
        _close(crossed["losses"], plain["run"]["losses"][worker.CKPT_AT:], "losses")
        _state_close(crossed["final"], plain["run"]["final"], worker.start_weights(case))


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_checkpoint_restores_into_an_unsharded_model(runs, name):
    """An unsharded model restores the sharded file exactly, and its
    remaining steps follow the sharded run within TOL."""
    _, ranks, crossed, case = runs[name]
    _, arrays, _ = _file(Path(case["ckpt"]["save"]))
    for key, a in arrays.items():
        assert np.array_equal(crossed["restored"][key].astype(a.dtype), a), key
    run = ranks[0]["run"]
    _close(crossed["losses"], run["losses"][worker.CKPT_AT:], "losses")
    _state_close(crossed["final"], run["final"], worker.start_weights(case))
