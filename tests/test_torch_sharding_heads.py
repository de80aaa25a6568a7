"""Sharded execution where a rank's block of query columns cuts a head or
straddles KV groups (``sharding.attention_share``): the reference's
``fit_spec`` splits ``wq``'s columns evenly, and the port runs, per rank,
every whole head its block touches, its q gathered over ``model`` before
RoPE, each run of heads over one KV head padded to the longest, and keeps
its own columns of the output for ``wo``'s rows.

Two configs, built by ``dataclasses.replace`` on both sides from the
reduced ones, with f32 weights bridged from
``ModelBundle.init(jax.random.key(0))``:

* ``dense``: qwen2-7b's layout cut down, 14 query heads over 2 KV heads
  (G = 7, D = 8), biases; at (1, 4) a rank owns 3.5 heads, as qwen2-7b's
  28 over 8 ways;
* ``hymba``: 15 query heads over 3 KV heads (G = 5, D = 8, h = 120 Mamba
  channels); at (1, 4) rank 1 runs heads 3-4 over KV 0 and 5-7 over KV 1,
  padded to 2 x 3, and its Mamba ``w_in`` is split per half.

Four gloo ranks on the CPU (``tests/torch_sharded_worker.py``, spawned
once for the module) run each at meshes (2, 2) and (1, 4), held to the
unsharded port with ``test_torch_sharding.py``'s tolerances; the
unsharded port's prefill logits are held to the reference's.  A
slice-only backward of the q gather (each rank keeps its own columns'
gradient, with no other rank's part) must fail the gradient check, and
the padded call must equal one call per run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.distributed import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro.models.layers import param_shapes, param_specs as jax_param_specs
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.models import build_model
from repro_torch.models.layers import (call_heads, causal_flash_attention,
                                       decode_attention, own_columns)

import torch_sharded_worker as worker
from test_torch_sharding import (NOISE, SERVE_TOL, TOL, WORLD, _close, _jax_mesh,
                                 _tree_leaves)
from torch_threads import one_thread  # noqa: F401  (autouse)

CONFIGS = {"dense": ("qwen2-7b", dict(num_heads=14, num_kv_heads=2, head_dim=8)),
           "hymba": ("hymba-1.5b", dict(num_heads=15, num_kv_heads=3, head_dim=8))}
MESHES = ((2, 2), (1, 4))
SHARDED = [(mesh, name) for name in CONFIGS for mesh in MESHES]
IDS = [f"{m[0]}x{m[1]}-{name}" for m, name in SHARDED]
# the slice-only backward, where every rank's block cuts a head
MUTATED = [f"1x4-{name}-slice" for name in CONFIGS]


def _configs(name):
    arch, change = CONFIGS[name]
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **change)
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)), **change)
    assert cfg.to_dict() == jcfg.to_dict()
    return cfg, jcfg


@pytest.fixture(scope="module")
def configs():
    """{name: (the case without key and mesh, the reference's bundle and
    f32 params)}."""
    out = {}
    rng = np.random.default_rng(3)
    for name in CONFIGS:
        cfg, jcfg = _configs(name)
        bundle = jax_build_model(jcfg)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              bundle.init(jax.random.key(0)))
        tokens = rng.integers(0, cfg.vocab_size, size=(4, 12))
        case = {"cfg": cfg, "params": jax.tree.map(np.asarray, params),
                "batch": {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)},
                "prompts": rng.integers(0, cfg.vocab_size, size=(2, 9)),
                "decode": rng.integers(0, cfg.vocab_size, size=(4, 2)),
                "requests": [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                             for n in (5, 9, 12, 7)]}
        out[name] = (case, bundle, params)
    return out


@pytest.fixture(scope="module")
def runs(configs, tmp_path_factory):
    """Every case on its mesh (each rank's results), the mutated cases,
    and each config unsharded (run here while the ranks run)."""
    cases = [dict(configs[name][0], key=key, mesh=mesh)
             for (mesh, name), key in zip(SHARDED, IDS)]
    cases += [dict(configs[key.split("-")[1]][0], key=key, mesh=(1, 4),
                   slice_backward=True) for key in MUTATED]
    store = str(tmp_path_factory.mktemp("sharding_heads") / "store")
    got, plain = worker.run_ranks(
        cases, store, WORLD,
        meanwhile=lambda: {name: worker.run_case(case)
                           for name, (case, _, _) in configs.items()})
    return {case["key"]: ([r[case["key"]] for r in got], plain[case["key"].split("-")[1]],
                          case) for case in cases}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2-7b"])
def test_per_gpu_weight_bytes_are_the_reference_placements(arch):
    """At full size on an 8-GPU host and on (32, 8), the bytes of a GPU's
    weights (``per_gpu_bytes``, in bf16, hymba's ``a_log`` in f32) are
    those of the reference's placements under its ``fit_spec``, but for
    the KV projections, which the port keeps whole where the KV heads do
    not divide into the ways (5 and 4 over 8): hymba's query, output and
    Mamba weights, ``w_in`` split per half, hold the reference's share."""
    cfg = get_config(arch)
    bundle = jax_build_model(jax_get_config(arch))
    specs = dict(_tree_leaves(jax_param_specs(bundle.defs)))
    shapes = dict(_tree_leaves(param_shapes(bundle.defs)))
    model = build_model(cfg, device="meta")
    for sizes in ({"data": 1, "model": 8}, {"data": 32, "model": 8}):
        ref = sum(int(np.prod(sharding.local_shape(
            shapes[k].shape, tuple(jax_sharding.fit_spec(specs[k], shapes[k].shape,
                                                          _jax_mesh(sizes))), sizes)))
                  * shapes[k].dtype.itemsize for k in specs)
        whole = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                    if sharding.holds_kv_heads(n))
        ours = sharding.per_gpu_bytes(model, sizes)["weights"]
        assert cfg.num_kv_heads % 8 and ours - ref == whole * 7 // 8, (sizes, ours, ref)


def test_the_cases_cut_heads_and_straddle_kv_groups():
    """At (1, 4) every rank of both configs gathers q (its block cuts a
    head); hymba's rank 1 runs two KV heads in runs of 2 and 3, padded to
    3.  At (2, 2) the dense config's heads split whole (7 a rank, one KV
    head each: today's path), hymba's 7.5 do not."""
    dense, _ = _configs("dense")
    hymba, _ = _configs("hymba")
    for cfg in (dense, hymba):
        for rank in range(4):
            runs, _, _, cut = sharding._touched_heads(4, rank, cfg.num_heads,
                                                     cfg.num_kv_heads, cfg.head_dim)
            assert cut
    runs, (k0, k1), cols, _ = sharding._touched_heads(4, 1, 15, 3, 8)
    assert runs == ((3, 2), (5, 3)) and (k0, k1) == (0, 2) and cols == slice(6, 36)
    assert not sharding._touched_heads(2, 0, 14, 2, 8)[3]
    assert sharding._touched_heads(2, 0, 15, 3, 8)[3]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unsharded_logits_match_reference(configs, runs, name):
    """The chain's anchor: the unsharded port's prefill logits equal the
    reference's on the same weights and prompts."""
    case, bundle, params = configs[name]
    ref, _ = jax.jit(bundle.prefill)(params, {"tokens": jnp.asarray(case["prompts"])})
    plain = runs[f"1x4-{name}"][1]
    _close(plain["serve_logits"][0], np.asarray(ref).reshape(
        plain["serve_logits"][0].shape), 1e-4, f"{name} logits against the reference")


@pytest.mark.parametrize("key", IDS)
def test_sharded_loss_and_gradients_match_unsharded(runs, key):
    ranks, plain, _ = runs[key]
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        _close(r["loss"], plain["loss"], TOL, "loss")
        assert r["grads"].keys() == plain["grads"].keys()
        for name, g in plain["grads"].items():
            assert np.abs(g).max() > 0, name
            _close(r["grads"][name], g, TOL, name)


@pytest.mark.parametrize("key", MUTATED)
def test_a_slice_only_gather_backward_fails_the_gradients(runs, key):
    """With the gather's gradient sliced and not reduce-scattered, a
    rank's query columns miss the other ranks' part of each cut head's
    gradient: the loss is the same, the query projection's gradient is
    not (nor, through it, the input's)."""
    ranks, plain, _ = runs[key]
    for r in ranks:
        _close(r["loss"], plain["loss"], TOL, "loss")
        worst = max(float(np.abs(r["grads"][n] - g).max() / np.abs(g).max())
                    for n, g in plain["grads"].items() if n.endswith("attn.wq"))
        assert worst > 100 * TOL, worst


@pytest.mark.parametrize("key", IDS)
def test_sharded_train_steps_match_unsharded(runs, key):
    """Three ZeRO-1 steps: losses and moments within TOL of their scale,
    each weight's update in RMS within 1% of the unsharded update's over
    the elements whose first moment is zero or above NOISE of its largest
    (as ``test_torch_sharding.py``), and each rank's weight and moment
    shards of the fitted sizes (hymba's ``w_in`` as many elements as the
    reference's column split gives)."""
    ranks, plain, case = runs[key]
    start = worker.start_weights(case)
    data, ways = case["mesh"]
    sizes = {"data": data, "model": ways}
    model = build_model(case["cfg"], device="meta")
    specs = sharding.fit_param_specs(model, sizes)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    moments = sharding.zero_opt_specs(specs, shapes, data).m
    for r in ranks:
        _close(r["losses"], plain["losses"], TOL, "losses")
        for part in ("m", "v"):
            for name, t in plain[part].items():
                _close(r[part][name], t, TOL, f"{part}/{name}")
        for name, w in plain["weights"].items():
            m = np.abs(plain["m"][name])
            held = (m == 0) | (m > NOISE * m.max())
            moved = np.sqrt(np.square(w - start[name])[held].mean())
            err = np.sqrt(np.square(r["weights"][name] - w)[held].mean())
            assert moved > 0 and err <= 1e-2 * moved, (name, err, moved)
        for name, (weight, moment) in r["numel"].items():
            assert weight == np.prod(sharding.local_shape(shapes[name], specs[name], sizes))
            assert moment * (data if "data" in moments[name] else 1) == weight, name


def _call_kv_heads(cfg, ways, rank):
    if cfg.num_kv_heads % ways == 0:
        return cfg.num_kv_heads // ways
    runs, (k0, k1), _, _ = sharding._touched_heads(ways, rank, cfg.num_heads,
                                                  cfg.num_kv_heads, cfg.head_dim)
    return k1 - k0


@pytest.mark.parametrize("key", IDS)
def test_sharded_prefill_and_decode_match_unsharded(runs, key):
    """Prefill logits within SERVE_TOL of their scale and decode steps'
    within TOL (the bf16 cache may round an entry the other way); each
    rank's cache holds the KV heads of its call, or under the "seq" layout
    (the dense config at (1, 4), whose 2 KV heads do not divide into 4
    ways; hymba, whose window takes it at every sharded mesh) every KV
    head over its block of the positions and of the ring's indices, and,
    in hymba, its h / W Mamba channels; only plain tensors reach the
    kernel wrappers."""
    ranks, plain, case = runs[key]
    cfg, (_, ways) = case["cfg"], case["mesh"]
    seq = sharding.kv_layout(cfg, {"model": ways}) == "seq"
    for rank, r in enumerate(ranks):
        _close(r["serve_logits"][0], plain["serve_logits"][0], SERVE_TOL, "prefill")
        _close(r["serve_logits"][1:], plain["serve_logits"][1:], TOL, "decode")
        assert r["kernel_input_types"] == ["Tensor"]
        heads = _call_kv_heads(cfg, ways, rank)
        for name, shape in plain["cache_shapes"].items():
            want = list(shape)
            if name in ("conv", "ssm"):
                want[2] = shape[2] // ways
            elif seq:
                want[3] = shape[3] // ways if shape[3] % ways == 0 else shape[3]
            else:
                want[2] = heads
            assert r["cache_shapes"][name] == tuple(want), (rank, name)


@pytest.mark.parametrize("key", IDS)
def test_sharded_engine_tokens_equal_unsharded(runs, key):
    ranks, plain, case = runs[key]
    assert len(plain["tokens"]) == len(case["requests"])
    for r in ranks:
        assert r["tokens"] == plain["tokens"]


def _run_calls(share, q_cols, k, v, kind, D):
    """The rank's attention output columns by the padded call, and by one
    call per run over its KV head, each kept to the run's own heads."""
    q = call_heads(q_cols, share, D)
    if kind == "flash":
        padded = causal_flash_attention(q, k, v)
    else:
        padded = decode_attention(q[:, 0], k, v, torch.tensor([5, 9]))
    whole = call_heads(q_cols, share._replace(runs=(), gather=None), D)
    per_run = []
    for j, (first, n) in enumerate(share.runs):
        if kind == "flash":
            per_run.append(causal_flash_attention(whole[..., first:first + n, :],
                                                  k[..., j:j + 1, :], v[..., j:j + 1, :]))
        else:
            per_run.append(decode_attention(whole[:, 0, first:first + n],
                                            k[:, j:j + 1], v[:, j:j + 1],
                                            torch.tensor([5, 9])))
    per_run = torch.cat(per_run, dim=-2).reshape(*per_run[0].shape[:-2], -1)
    if share.cols is not None:
        per_run = per_run[..., share.cols]
    return own_columns(padded, share), per_run


@pytest.mark.parametrize("kind", ["flash", "decode"])
@pytest.mark.parametrize("rank", range(4))
def test_padded_call_equals_one_call_per_run(rank, kind):
    """hymba's layout at (1, 4): the padded call's outputs, cut to each
    run's heads and the rank's columns, equal separate calls per KV head
    on the same q, exactly (the padding only adds heads)."""
    cfg, _ = _configs("hymba")
    D = cfg.head_dim
    runs, (k0, k1), cols, _ = sharding._touched_heads(4, rank, cfg.num_heads,
                                                     cfg.num_kv_heads, D)
    group = max(n for _, n in runs)
    share = sharding.HeadShare(k1 - k0, slice(k0 * D, k1 * D), True, group, None,
                               runs, cols)
    gen = torch.Generator().manual_seed(rank)
    S = 12 if kind == "flash" else 1
    q_all = torch.randn(2, S, cfg.num_heads * D, generator=gen)
    if kind == "flash":
        k, v = (torch.randn(2, S, k1 - k0, D, generator=gen) for _ in range(2))
    else:
        k, v = (torch.randn(2, k1 - k0, 16, D, generator=gen) for _ in range(2))
    padded, per_run = _run_calls(share, q_all, k, v, kind, D)
    torch.testing.assert_close(padded, per_run, rtol=0, atol=0)
