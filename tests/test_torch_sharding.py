"""The port's sharding (``distributed/sharding.py``) against the reference's
and against the unsharded port.

* Specs: every config's placement table equals the reference's
  ``param_specs`` leaf by leaf (the reference's stacked leaves carry a
  leading ``None`` per layer-stack dim, which the port's per-layer names
  drop), and ``adapt_spec``, ``fit_spec`` and ``zero_opt_specs`` agree with
  the reference's at six meshes.  The reference's functions read only
  ``mesh.axis_names`` and ``mesh.shape``, so a stand-in feeds them without
  256 JAX devices.  The one divergence: where ``num_kv_heads`` does not
  divide into the model ways, the port keeps the KV projections whole on
  every rank (a head is never split), where the reference's ``fit_spec``
  splits them.
* Sharded execution: four gloo ranks on the CPU, spawned once for the
  module (``tests/torch_sharded_worker.py``, which imports no JAX), run a
  dense ``DenseLM`` with f32 weights bridged from
  ``ModelBundle.init(jax.random.key(0))`` at meshes (2, 2) and (1, 4),
  with one KV head (fewer than the model ways) and with KV heads that
  divide into them.  Each is held to the unsharded port on the same
  weights: the loss and every gradient, and three train steps' losses and
  moments, within 1e-4 of each one's scale (the ranks sum partial
  products in another order; a different batch on each data rank), each
  weight's update over the three steps in RMS within 1% of the unsharded
  update's (leaving out the few elements whose gradient is rounding), prefill and decode logits within 1e-5 of their scale, the
  engine's tokens exactly.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.distributed import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro.models.layers import param_shapes, param_specs as jax_param_specs
from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.models import build_model
from repro_torch.models.hymba import layer_groups
from repro_torch.models.transformer import DenseLM

import torch_sharded_worker as worker
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
SERVE_TOL = 1e-5
NOISE = 1e-5
WORLD = 4
MESHES = [(1, 1), (2, 2), (1, 4), (32, 8), (2, 16, 8), (2, 32, 8)]
DENSE = sorted(name for name, cfg in REGISTRY.items() if cfg.family == "dense")


def _mesh_axes(shape):
    names = ("pod", "data", "model")[-len(shape):]
    return dict(zip(names, shape))


def _jax_mesh(sizes):
    """What the reference's spec functions read of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


def _norm(spec):
    """A spec as a tuple of tuples of axis names, one per dim."""
    return tuple(() if e is None else tuple(e) if isinstance(e, (tuple, list))
                 else (e,) for e in spec)


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _tree_leaves(sub, path + (key,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, sub in enumerate(tree):
            yield from _tree_leaves(sub, path + (i,))
    else:
        yield path, tree


def _reference_path(model, name):
    """The reference's tree path of the port's weight ``name``, through the
    bridge's names: a layer's index leaves the path (hymba's layer i goes
    to its group of ``layer_groups``)."""
    parts = name.split(".")
    if model.cfg.family == "hybrid" and parts[0] == "layers":
        first = 0
        for g, (_, count) in enumerate(layer_groups(model.cfg)):
            if first <= int(parts[1]) < first + count:
                return ("groups", g, *parts[2:])
            first += count
    return tuple(p for p in parts if not p.isdigit())


# ---------------------------------------------------------------------------
# (a) specs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_placement_table_matches_reference(arch):
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    ref = dict(_tree_leaves(jax_param_specs(
        jax_build_model(jax_reduced_config(jax_get_config(arch))).defs)))
    ours = sharding.param_specs(model)
    assert len(ours) == len(dict(model.named_parameters()))
    used = set()
    for name, p in model.named_parameters():
        path = _reference_path(model, name)
        spec = tuple(ref[path])
        lead, rest = spec[:len(spec) - p.ndim], spec[len(spec) - p.ndim:]
        assert all(e is None for e in lead), (name, spec)
        assert _norm(ours[name]) == _norm(rest), (name, ours[name], spec)
        used.add(path)
    assert used == set(ref)


def _reference_specs_and_shapes():
    """Every (spec, shape) of every config's weights at full size, from the
    reference's defs (no array is made), and the batch spec at a batch of
    1 and of 256."""
    out = []
    for arch in sorted(JAX_REGISTRY):
        bundle = jax_build_model(jax_get_config(arch))
        specs = dict(_tree_leaves(jax_param_specs(bundle.defs)))
        shapes = dict(_tree_leaves(param_shapes(bundle.defs)))
        out += [(specs[k], tuple(shapes[k].shape)) for k in sorted(specs, key=str)]
    out += [(P(("pod", "data")), (1, 4096)), (P(("pod", "data")), (256, 4096)),
            (P(("pod", "data"), None, "model"), (512, 8, 24)), (None, (4, 4))]
    return out


@pytest.fixture(scope="module")
def spec_cases():
    return _reference_specs_and_shapes()


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_spec_rules_match_reference(spec_cases, shape):
    sizes = _mesh_axes(shape)
    mesh = _jax_mesh(sizes)
    for spec, dims in spec_cases:
        ours = None if spec is None else tuple(spec)
        assert _norm(sharding.adapt_spec(ours, sizes)) == _norm(
            jax_sharding.adapt_spec(spec, mesh)), (spec, shape)
        if spec is not None:
            assert _norm(sharding.fit_spec(ours, dims, sizes)) == _norm(
                jax_sharding.fit_spec(spec, dims, mesh)), (spec, dims, shape)
    ways = sizes.get("data", 1)
    specs = {str(i): s for i, (s, _) in enumerate(spec_cases) if s is not None}
    dims = {str(i): d for i, (_, d) in enumerate(spec_cases)}
    ref = jax_sharding.zero_opt_specs(
        specs, {k: jax.ShapeDtypeStruct(dims[k], jnp.float32) for k in specs}, ways)
    ours = sharding.zero_opt_specs({k: tuple(s) for k, s in specs.items()}, dims, ways)
    assert ours.m == ours.v
    for k in specs:
        assert _norm(ours.m[k]) == _norm(ref.m[k]), (specs[k], dims[k], ways)


def test_zero_opt_specs_structure():
    """The reference's ``test_zero_opt_specs_structure`` on the port."""
    model = build_model(reduced_config(get_config("qwen2.5-3b")), device="cpu",
                        dtype=torch.float32)
    specs = sharding.param_specs(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    z = sharding.zero_opt_specs(specs, shapes, data_ways=4)
    assert z.m.keys() == specs.keys()
    assert any("data" in s for s in z.m.values() if s is not None)


@pytest.mark.parametrize("arch", DENSE)
def test_fitted_specs_split_no_kv_head(arch):
    """At model ways 1, 2, 4 and 8 on an 8-GPU host, the port's fitted
    specs equal the reference's ``fit_spec`` of its specs, except the KV
    projections where ``num_kv_heads`` does not divide into the ways:
    those stay whole."""
    cfg = get_config(arch)
    model = DenseLM(cfg, device="meta")
    ref = dict(_tree_leaves(jax_param_specs(jax_build_model(jax_get_config(arch)).defs)))
    for ways in (1, 2, 4, 8):
        sizes = {"data": 8 // ways, "model": ways}
        ours = sharding.fit_param_specs(model, sizes)
        for name, p in model.named_parameters():
            spec = tuple(ref[_reference_path(model, name)])[-p.ndim:] if p.ndim else ()
            theirs = jax_sharding.fit_spec(P(*spec), tuple(p.shape), _jax_mesh(sizes))
            exception = (name.endswith(sharding.KV_PROJECTIONS)
                         and cfg.num_kv_heads % ways != 0)
            if exception:
                assert _norm(ours[name]) == ((),) * p.ndim, (name, ways)
                assert _norm(theirs) != _norm(ours[name]), (name, ways)
            else:
                assert _norm(ours[name]) == _norm(theirs), (name, ways)


def test_shard_model_refuses_what_it_cannot_run():
    # hymba's attention and Mamba heads split at every way count that
    # divides its 1600 query columns and channels (25 heads of 64: 3.125 a
    # rank at 8 ways), and qwen2-7b's 28 heads at 8 ways (3.5 a rank)
    hymba = get_config("hymba-1.5b")
    for ways in (1, 2, 4, 8):
        sharding.check_shardable(hymba, {"data": 8 // ways, "model": ways})
        sharding.check_shardable(hymba, {"pod": 2, "data": 16, "model": ways})
    sharding.check_shardable(get_config("qwen2-7b"), {"data": 1, "model": 8})
    # uneven blocks of query columns are refused
    with pytest.raises(ValueError, match="even blocks"):
        sharding.check_shardable(hymba, {"data": 1, "model": 3})
    # every other family runs at one 8-GPU host and at two pods of them:
    # self-attention wherever its query columns split, the cross layers
    # and rwkv's WKV heads where their heads split whole 8 ways
    admitted = [name for name, cfg in REGISTRY.items()
                if cfg.family in ("moe", "encoder", "ssm", "vlm", "audio")]
    assert {REGISTRY[n].family for n in admitted} == {"moe", "encoder", "ssm",
                                                       "vlm", "audio"}
    for name in admitted:
        cfg = get_config(name)
        for sizes in ({"data": 1, "model": 8}, {"pod": 2, "data": 16, "model": 8}):
            if cfg.num_heads % 8 == 0 or cfg.family in sharding.SPLIT_HEAD_FAMILIES:
                sharding.check_shardable(cfg, sizes)
            else:
                with pytest.raises(ValueError, match="a head is never split"):
                    sharding.check_shardable(cfg, sizes)
    # the cross layers' rule still refuses 12 heads over 8 ways (the VLM's
    # and the enc-dec's; rwkv6's WKV heads alike), which the encoders'
    # self-attention runs
    for name, kv in (("llama-3.2-vision-11b", 4), ("seamless-m4t-large-v2", 12),
                     ("rwkv6-7b", 12)):
        cfg = dataclasses.replace(get_config(name), num_heads=12, num_kv_heads=kv,
                                  head_dim=64)
        with pytest.raises(ValueError, match="a head is never split"):
            sharding.check_shardable(cfg, {"data": 1, "model": 8})
    assert get_config("e5-base-v2").num_heads == 12
    sharding.check_shardable(get_config("e5-base-v2"), {"data": 1, "model": 8})
    with pytest.raises(ValueError, match="takes"):
        sharding.check_shardable(get_config("qwen2.5-3b"),
                                 {"expert": 2, "data": 16, "model": 8})
    # the pod axis joins data parallelism
    sharding.check_shardable(get_config("qwen2.5-3b"),
                             {"pod": 2, "data": 16, "model": 8})
    sharding.check_shardable(get_config("glm4-9b"), {"data": 1, "model": 8})


@pytest.mark.parametrize("arch", DENSE)
def test_per_gpu_bytes_fall_with_the_model_ways(arch):
    """Weights split over ``model`` (all but the norms and replicated KV
    projections), moments over ``data`` as well: on an 8-GPU host every
    way count holds at least 1/8 of the f32 moments and little more."""
    model = DenseLM(get_config(arch), device="meta")
    total = sum(p.numel() for p in model.parameters())
    seen = []
    for ways in (1, 2, 4, 8):
        b = sharding.per_gpu_bytes(model, {"data": 8 // ways, "model": ways})
        seen.append(b["weights"])
        assert total <= b["moments"] <= 1.15 * total
    assert seen[0] == 2 * total
    assert all(a > b for a, b in zip(seen, seen[1:]))


# ---------------------------------------------------------------------------
# (c) sharded execution on four gloo ranks
# ---------------------------------------------------------------------------


def _case_config(arch, kv):
    """The port's and the reference's reduced ``arch``; ``kv`` heads of 8
    query heads where given (head_dim 8 keeps d_model 64)."""
    cfg, jcfg = reduced_config(get_config(arch)), jax_reduced_config(jax_get_config(arch))
    if kv is not None:
        change = dict(num_heads=8, num_kv_heads=kv, head_dim=8)
        cfg, jcfg = dataclasses.replace(cfg, **change), dataclasses.replace(jcfg, **change)
    return cfg, jcfg


# qwen2.5-3b reduced: 4 query heads over 1 KV head, biases, a tied
# embedding; llama-3.1-8b with 8 query heads over 4 KV heads, an lm_head
CONFIGS = {"kv1": ("qwen2.5-3b", None), "kv4": ("llama-3.1-8b", 4)}
SHARDED = [(mesh, kv) for mesh in ((2, 2), (1, 4)) for kv in CONFIGS]
IDS = [f"{m[0]}x{m[1]}-{kv}" for m, kv in SHARDED]


def _cases():
    rng = np.random.default_rng(0)
    cases, params = [], {}
    for mesh, kv in SHARDED:
        cfg, jcfg = _case_config(*CONFIGS[kv])
        if kv not in params:
            params[kv] = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                      jax_build_model(jcfg).init(jax.random.key(0)))
        tokens = rng.integers(0, cfg.vocab_size, size=(4, 12))
        cases.append({
            "key": f"{mesh[0]}x{mesh[1]}-{kv}", "mesh": mesh, "cfg": cfg,
            "params": params[kv],
            "batch": {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)},
            "prompts": rng.integers(0, cfg.vocab_size, size=(2, 9)),
            "decode": rng.integers(0, cfg.vocab_size, size=(4, 2)),
            "requests": [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                         for n in (5, 9, 12, 7)]})
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its mesh (each rank's results) and unsharded (run
    here while the ranks run)."""
    cases = _cases()
    store = str(tmp_path_factory.mktemp("sharding") / "store")
    got, plain = worker.run_ranks(
        cases, store, WORLD,
        meanwhile=lambda: {case["key"]: worker.run_case(case) for case in cases})
    return {case["key"]: ([r[case["key"]] for r in got], plain[case["key"]], case)
            for case in cases}


def _close(ours, ref, tol, what):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= tol * scale, f"{what}: error {err} over scale {scale}"


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


@pytest.mark.parametrize("key", IDS)
def test_sharded_train_steps_match_unsharded(runs, key):
    """Losses and moments after STEPS steps within TOL of their scale, and
    each weight's update in RMS within 1% of the unsharded update's, as
    ``test_torch_training.py`` holds the port's train step to the
    reference's, over the elements whose first moment is zero or above
    NOISE of its largest.  AdamW's first steps move an element by about lr
    times the sign of its gradient, and some gradients are zero up to
    rounding (a key bias shifts every score of a query by one constant,
    so where RoPE leaves a component unrotated its gradient is rounding):
    such an element moves either way on either side."""
    ranks, plain, case = runs[key]
    start = worker.start_weights(case)
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


@pytest.mark.parametrize("key", IDS)
def test_zero1_moments_are_a_data_share_of_the_weight_shard(runs, key):
    """Each rank's weight shard is its fitted spec's share of the weight
    (the KV projections of a model with one KV head stay whole over
    ``model``), and its moment shard 1/data of that where ZeRO-1 gives the
    moment a ``data`` dim, all of it where no dim divides."""
    ranks, plain, case = runs[key]
    data, ways = case["mesh"]
    sizes = {"data": data, "model": ways}
    model = DenseLM(case["cfg"], device="meta")
    specs = sharding.fit_param_specs(model, sizes)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    moments = sharding.zero_opt_specs(specs, shapes, data).m
    zeroed = 0
    for r in ranks:
        for name, (weight, moment) in r["numel"].items():
            assert weight == np.prod(sharding.local_shape(shapes[name], specs[name], sizes))
            zero = "data" in moments[name]
            zeroed += zero
            assert moment * (data if zero else 1) == weight, name
    assert zeroed


@pytest.mark.parametrize("key", IDS)
def test_sharded_prefill_and_decode_match_unsharded(runs, key):
    ranks, plain, case = runs[key]
    cfg, (_, ways) = case["cfg"], case["mesh"]
    for r in ranks:
        _close(r["serve_logits"], plain["serve_logits"], SERVE_TOL, "logits")
        if sharding.kv_layout(cfg, {"model": ways}) == "seq":
            # every KV head over the rank's block of the positions
            want = list(plain["cache_shapes"]["k"])
            want[3] //= ways
            assert r["cache_shapes"]["k"] == tuple(want)
        else:
            kv = cfg.num_kv_heads // ways if cfg.num_kv_heads % ways == 0 else 1
            assert r["cache_heads"] == kv
        assert r["kernel_input_types"] == ["Tensor"]


@pytest.mark.parametrize("key", IDS)
def test_sharded_engine_tokens_equal_unsharded(runs, key):
    ranks, plain, case = runs[key]
    assert len(plain["tokens"]) == len(case["requests"])
    for r in ranks:
        assert r["tokens"] == plain["tokens"]
