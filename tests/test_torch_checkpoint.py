"""The port's checkpoints (``repro_torch.training.checkpoint``) and the
launcher's ``--ckpt-dir``/``--resume``: a saved and restored model and
AdamW state are bit-equal, a resumed run equals an uninterrupted one bit
for bit, a write cut before the manifest's rename leaves the last
checkpoint readable, and the reference's ``latest_step`` and
``prune_old`` read the port's directories as the port does.  Reduced
qwen2.5-3b in bf16 on the CPU, weights drawn from torch seeds."""
import json
import os

import numpy as np
import pytest
import torch

from repro.training import checkpoint as ref_ckpt
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticCorpus
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.train_loop import make_train_step

CFG = reduced_config(get_config("qwen2.5-3b"))
OPT = AdamWConfig(lr=1e-3, warmup_steps=2)


@pytest.fixture(autouse=True)
def one_thread():
    """Torch's intra-op pool cut to one thread: these small models' steps
    issue thousands of tiny operations, and while the suite's other
    workers hold every core each one's hand-off to the pool costs more
    than its work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _model(seed):
    model = build_model(CFG, device="cpu", dtype=torch.bfloat16)
    model.init_params(torch.Generator().manual_seed(seed))
    return model


def _random_state(model, seed):
    """An AdamW state with nonzero f32 moments and a nonzero step."""
    g = torch.Generator().manual_seed(seed)
    state = init_state(dict(model.named_parameters()))
    for t in list(state.m.values()) + list(state.v.values()):
        t.copy_(torch.rand(t.shape, generator=g))
    return state._replace(step=torch.tensor(7, dtype=torch.int32))


def _assert_same(model_a, state_a, model_b, state_b):
    pa, pb = dict(model_a.named_parameters()), dict(model_b.named_parameters())
    assert pa.keys() == pb.keys() == state_a.m.keys() == state_b.m.keys()
    for n in pa:
        assert pa[n].dtype == pb[n].dtype
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(state_a.m[n], state_b.m[n]), f"m.{n}"
        assert torch.equal(state_a.v[n], state_b.v[n]), f"v.{n}"
    assert state_b.step.dtype == torch.int32
    assert torch.equal(state_a.step, state_b.step)


def test_checkpoint_roundtrip_and_latest(tmp_path):
    """The reference's round trip (save, latest, restore by step, prune),
    bit-equal with bf16 weights and f32 moments, into a model and state
    drawn from other seeds."""
    d = str(tmp_path)
    model, state = _model(0), _random_state(_model(0), 1)
    assert ckpt.latest_step(d) is None
    ckpt.save_checkpoint(d, 10, model, state, extra={"arch": CFG.name})
    later = _model(5)
    ckpt.save_checkpoint(d, 20, later, init_state(dict(later.named_parameters())))
    assert ckpt.latest_step(d) == 20
    other = _model(3)
    fresh = _random_state(other, 4)
    m_before = dict(fresh.m)
    params_before = dict(other.named_parameters())
    restored, step, extra = ckpt.restore_checkpoint(d, other, fresh, step=10)
    assert step == 10 and extra["arch"] == CFG.name
    _assert_same(model, state, other, restored)
    # in place: the same parameter and moment objects
    assert all(p is params_before[n] for n, p in other.named_parameters())
    assert all(restored.m[n] is t for n, t in m_before.items())
    manifest = json.loads((tmp_path / "step_00000010" / "manifest.json").read_text())
    assert manifest["leaves"]["param/embed"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["m/embed"]["dtype"] == "float32"
    assert manifest["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    ckpt.prune_old(d, keep=1)
    assert ckpt.latest_step(d) == 20
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, other, restored, step=10)


def test_restore_refuses_a_checkpoint_of_another_model(tmp_path):
    d = str(tmp_path)
    model = _model(0)
    ckpt.save_checkpoint(d, 1, model, init_state(dict(model.named_parameters())))
    deeper = build_model(reduced_config(get_config("qwen2.5-3b"), layers=3),
                         device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore_checkpoint(d, deeper, init_state(dict(deeper.named_parameters())))
    wider = build_model(reduced_config(get_config("llama-3.2-1b")),
                        device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(d, wider, init_state(dict(wider.named_parameters())))


def _steps(model, state, start, n, losses):
    step_fn = make_train_step(model, OPT)
    data = SyntheticCorpus(DataConfig(CFG.vocab_size, 16, 4))
    for s in range(start, start + n):
        state, metrics = step_fn(state, data.batch_at(s))
        losses.append(metrics["loss"])
    return state


def test_training_resumes_identically(tmp_path):
    """4 steps == 2 steps, a save, a restore into a model drawn from
    another seed, and 2 more steps: every weight, moment, step and loss
    bit-equal."""
    a = _model(0)
    la = []
    sa = _steps(a, init_state(dict(a.named_parameters())), 0, 4, la)

    b = _model(0)
    lb = []
    sb = _steps(b, init_state(dict(b.named_parameters())), 0, 2, lb)
    ckpt.save_checkpoint(str(tmp_path), 2, b, sb)
    c = _model(1)
    sc, step, _ = ckpt.restore_checkpoint(str(tmp_path), c,
                                          init_state(dict(c.named_parameters())))
    assert step == 2
    _assert_same(b, sb, c, sc)
    sc = _steps(c, sc, 2, 2, lb)
    _assert_same(a, sa, c, sc)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_interrupted_write_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    """A write cut before the manifest's rename (the commit point) leaves
    ``latest_step`` at the previous step, which stays readable; stray
    ``.tmp`` files do not count as a checkpoint."""
    d = str(tmp_path)
    model = _model(0)
    state = _random_state(model, 1)
    ckpt.save_checkpoint(d, 10, model, state)
    real_replace = os.replace

    def crash_at_commit(src, dst):
        if str(dst).endswith("manifest.json"):
            raise OSError("killed before the commit point")
        real_replace(src, dst)

    monkeypatch.setattr(ckpt.os, "replace", crash_at_commit)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(d, 20, _model(2), _random_state(_model(2), 3))
    monkeypatch.undo()
    cut = tmp_path / "step_00000020"
    assert (cut / "shard_0.npz").exists() and (cut / "manifest.json.tmp").exists()
    assert not (cut / "manifest.json").exists()
    (tmp_path / "step_00000030").mkdir()
    (tmp_path / "step_00000030" / "manifest.json.tmp").write_text("{}")
    (tmp_path / "step_00000040.tmp").write_text("")
    assert ckpt.latest_step(d) == ref_ckpt.latest_step(d) == 10
    other = _model(5)
    restored, step, _ = ckpt.restore_checkpoint(
        d, other, init_state(dict(other.named_parameters())))
    assert step == 10
    _assert_same(model, state, other, restored)


def test_reference_reads_the_port_directories(tmp_path):
    """The reference's ``latest_step`` and ``prune_old`` agree with the
    port's on directories the port wrote."""
    model = _model(0)
    state = init_state(dict(model.named_parameters()))
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for step in (3, 1, 12, 7, 5):
        for d in (port_dir, ref_dir):
            ckpt.save_checkpoint(str(d), step, model, state)
    assert ckpt.latest_step(str(port_dir)) == ref_ckpt.latest_step(str(ref_dir)) == 12
    ckpt.prune_old(str(port_dir), keep=3)
    ref_ckpt.prune_old(str(ref_dir), keep=3)
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in ref_dir.iterdir())
    assert names == ["step_00000005", "step_00000007", "step_00000012"]
    assert ckpt.latest_step(str(port_dir)) == ref_ckpt.latest_step(str(port_dir)) == 12


def test_launcher_resume_continues_the_run(tmp_path, capsys):
    """``--ckpt-dir --ckpt-every 2`` for 4 steps, then ``--resume --steps
    2``: the same losses as steps 4-5 of an uninterrupted 6-step run."""
    args = ["--device", "cpu", "--batch", "4", "--seq", "16"]
    whole = train_main(args + ["--steps", "6"])
    d = str(tmp_path)
    train_main(args + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002",
                                                          "step_00000004"]
    capsys.readouterr()
    resumed = train_main(args + ["--steps", "2", "--ckpt-dir", d, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step 4: loss=" in out
    assert resumed == whole[4:]
    assert np.isfinite(resumed).all()


def test_launcher_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--seq", "8", "--steps", "1"]
    losses = train_main(args + ["--ckpt-dir", str(tmp_path), "--resume"])
    assert "no checkpoint found; starting fresh" in capsys.readouterr().out
    assert losses == train_main(args)
