"""Sharded execution of the families beyond the dense decoders: an MoE
decoder (olmoe-1b-7b), rwkv6-7b, the VLM (llama-3.2-vision-11b, one
group), the enc-dec (seamless-m4t-large-v2) and an encoder (e5-base-v2),
each held to the unsharded port on the same weights and, unsharded, to
the reference.

Four gloo ranks on the CPU, spawned once for the module
(``tests/torch_sharded_worker.py``, which imports no JAX), run each
family's ``reduced_config`` with f32 weights bridged from
``ModelBundle.init(jax.random.key(0))`` (the VLM's gates set to seeded
nonzero values, as ``test_torch_training_families.py`` sets them) at
meshes (2, 2) and (1, 4).  The reduced VLM has one KV head, fewer than the
model ways, so its self and cross KV projections stay whole on every
rank; the others' KV heads divide.  Held as ``test_torch_sharding.py``
holds the dense decoders, with its tolerances: the loss and every
gradient, the whole weights' too (rwkv6's lerp and lora factor, the
router, the VLM's gates), three train steps' losses, weights and ZeRO-1
moments, prefill and decode logits (an encoder's pooled embedding), and
the served tokens exactly: the engine's for olmoe and rwkv6, ``generate``'s
for the VLM and the enc-dec.  olmoe's routing is held choice by choice: a
kept expert choice may differ from the unsharded run's only where the
unsharded router logits of its token leave a gap under NOISE of their
scale between two of the top K + 1 experts.  Each family's unsharded loss
is held to the reference's ``bundle.loss_fn`` on the same batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.models import build_model

import torch_sharded_worker as worker
from test_torch_sharding import NOISE, SERVE_TOL, TOL, WORLD, _close
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCHS = {"moe": "olmoe-1b-7b", "rwkv": "rwkv6-7b", "vlm": "llama-3.2-vision-11b",
         "encdec": "seamless-m4t-large-v2", "encoder": "e5-base-v2"}
MESHES = ((2, 2), (1, 4))
SHARDED = [(mesh, fam) for fam in ARCHS for mesh in MESHES]
IDS = [f"{m[0]}x{m[1]}-{fam}" for m, fam in SHARDED]
SERVED = [key for key in IDS if not key.endswith("encoder")]
# the reference's synthetic stub inputs, one seed per family
STUB_SEED = 11


def _configs(fam):
    arch = ARCHS[fam]
    cfg, jcfg = reduced_config(get_config(arch)), jax_reduced_config(jax_get_config(arch))
    assert cfg.to_dict() == jcfg.to_dict()
    return cfg, jcfg


def _gates(params, groups):
    """The VLM's params with every gate and gate_mlp set to a seeded
    nonzero value, |g| in [0.4, 1.2], either sign."""
    rng = np.random.default_rng(7)
    mag = rng.uniform(0.4, 1.2, size=(2, groups)).astype(np.float32)
    values = mag * rng.choice(np.array([-1.0, 1.0], np.float32), size=(2, groups))
    cross = dict(params["cross_layers"], gate=jnp.asarray(values[0]),
                 gate_mlp=jnp.asarray(values[1]))
    return dict(params, cross_layers=cross)


def _stub(cfg, rows, rng):
    """The family's image or audio input for ``rows`` rows, f32."""
    if cfg.family == "vlm":
        return {"image_embeds": rng.standard_normal(
            (rows, cfg.num_image_tokens, cfg.vision_d_model), dtype=np.float32)}
    if cfg.family == "audio":
        return {"audio_frames": rng.standard_normal(
            (rows, cfg.num_audio_frames, cfg.d_model), dtype=np.float32)}
    return {}


def _family_cases():
    """{family: (the case without key and mesh, the reference's bundle and
    f32 params)}."""
    out = {}
    for fam in ARCHS:
        cfg, jcfg = _configs(fam)
        bundle = jax_build_model(jcfg)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              bundle.init(jax.random.key(0)))
        if cfg.family == "vlm":
            params = _gates(params, cfg.num_layers // cfg.cross_attn_every)
        rng = np.random.default_rng(STUB_SEED)
        tokens = rng.integers(0, cfg.vocab_size, size=(4, 12))
        case = {"cfg": cfg, "params": jax.tree.map(np.asarray, params),
                "batch": {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
                          **_stub(cfg, 4, rng)},
                "prompts": rng.integers(0, cfg.vocab_size, size=(2, 9)),
                "prompt_inputs": _stub(cfg, 2, rng),
                "decode": rng.integers(0, cfg.vocab_size, size=(4, 2)),
                "requests": [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                             for n in (5, 9, 12, 7)]}
        out[fam] = (case, bundle, params)
    return out


@pytest.fixture(scope="module")
def families():
    return _family_cases()


@pytest.fixture(scope="module")
def runs(families, tmp_path_factory):
    """Every case on its mesh (each rank's results), and each family
    unsharded (run here while the ranks run)."""
    cases = [dict(families[fam][0], key=key, mesh=mesh)
             for (mesh, fam), key in zip(SHARDED, IDS)]
    store = str(tmp_path_factory.mktemp("sharding_families") / "store")
    got, plain = worker.run_ranks(
        cases, store, WORLD,
        meanwhile=lambda: {fam: worker.run_case(case) for fam, (case, _, _)
                           in families.items()})
    return {case["key"]: ([r[case["key"]] for r in got], plain[key.split("-")[-1]], case)
            for case, key in zip(cases, IDS)}


@pytest.mark.parametrize("fam", list(ARCHS))
def test_unsharded_loss_matches_reference(families, runs, fam):
    """The chain's anchor: the port's unsharded loss of each family equals
    the reference's ``loss_fn`` on the same weights and batch."""
    case, bundle, params = families[fam]
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    ref = float(jax.jit(bundle.loss_fn)(params, batch))
    plain = runs[f"2x2-{fam}"][1]
    _close(plain["loss"], ref, TOL, f"{fam} loss against the reference")


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
    """Losses and ZeRO-1 moments after the train steps within TOL of their
    scale, and each weight's update in RMS within 1% of the unsharded
    update's over the elements whose first moment is zero or above NOISE
    of its largest (as ``test_torch_sharding.py`` holds them); every
    rank's moment shard is 1/data of its weight shard where ZeRO-1 gives
    the moment a ``data`` dim."""
    ranks, plain, case = runs[key]
    start = worker.start_weights(case)
    data, ways = case["mesh"]
    model = build_model(case["cfg"], device="meta")
    specs = sharding.fit_param_specs(model, {"data": data, "model": ways})
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
            sizes = {"data": data, "model": ways}
            assert weight == np.prod(sharding.local_shape(shapes[name], specs[name], sizes))
            assert moment * (data if "data" in moments[name] else 1) == weight, name


def _local_heads(cfg, ways):
    """(KV heads, WKV heads) a rank holds: the KV heads split where they
    divide into the ways, else the one its query heads map to."""
    kv = cfg.num_kv_heads // ways if cfg.num_kv_heads % ways == 0 else 1
    return kv, cfg.num_heads // ways


@pytest.mark.parametrize("key", IDS)
def test_sharded_prefill_and_decode_match_unsharded(runs, key):
    """Prefill logits (an encoder's pooled embedding) within SERVE_TOL of
    their scale, and the decode steps' within TOL: the KV cache is bf16
    whatever the weights' dtype, and an entry whose f32 value differs in
    its last bits between the runs (the ranks sum partial products in
    another order) may round to the neighbouring bf16 value, 2^-8 of it
    (olmoe's second layer's keys do: 2.4e-5 of the logits' scale at its
    first step).  The caches hold each rank's heads (the token-shift
    states the whole width); only plain tensors reach the kernel
    wrappers."""
    ranks, plain, case = runs[key]
    cfg, (_, ways) = case["cfg"], case["mesh"]
    kv, wkv = _local_heads(cfg, ways)
    for r in ranks:
        if cfg.family == "encoder":
            _close(r["serve_logits"], plain["serve_logits"], SERVE_TOL, "pooled")
        else:
            _close(r["serve_logits"][0], plain["serve_logits"][0], SERVE_TOL, "prefill")
            _close(r["serve_logits"][1:], plain["serve_logits"][1:], TOL, "decode")
        assert r["kernel_input_types"] == ["Tensor"]
        if cfg.family == "encoder":
            continue
        for name, shape in plain["cache_shapes"].items():
            heads = {"wkv": wkv, "tm_x": None, "cm_x": None}.get(name, kv)
            want = shape if heads is None else shape[:2] + (heads,) + shape[3:]
            assert r["cache_shapes"][name] == want, name


@pytest.mark.parametrize("key", SERVED)
def test_sharded_served_tokens_equal_unsharded(runs, key):
    """The engine's tokens (olmoe, rwkv6) or ``generate``'s (the VLM, the
    enc-dec), exactly."""
    ranks, plain, case = runs[key]
    rows = (len(case["prompts"]) if case["cfg"].family in ("vlm", "audio")
            else len(case["requests"]))
    assert len(plain["tokens"]) == rows
    for r in ranks:
        assert r["tokens"] == plain["tokens"]


@pytest.mark.parametrize("key", [k for k in IDS if k.endswith("moe")])
def test_sharded_moe_keeps_the_unsharded_expert_choices(runs, key, capsys):
    """Every router call of the prefill and decode steps: each token's
    chosen experts (in order) and kept choices equal the unsharded run's,
    except at a token whose unsharded f32 router logits have a gap under
    NOISE of their scale between two neighbours of the top K + 1, where
    rounding may swap them.  Such tokens are counted and printed."""
    ranks, plain, case = runs[key]
    K = case["cfg"].experts_per_token
    for rank, r in enumerate(ranks):
        assert len(r["routes"]) == len(plain["routes"]) > 0
        near_ties = 0
        for ours, ref in zip(r["routes"], plain["routes"]):
            differ = ((ours["experts"] != ref["experts"])
                      | (ours["kept"] != ref["kept"])).any(axis=-1)
            top = -np.sort(-ref["logits"], axis=-1)[..., :K + 1]
            gap = (top[..., :-1] - top[..., 1:]).min(axis=-1)
            tied = gap < NOISE * np.abs(ref["logits"]).max()
            assert not (differ & ~tied).any(), (rank, np.argwhere(differ & ~tied))
            near_ties += int(differ.sum())
        with capsys.disabled():
            print(f"\n{key} rank {rank}: {near_ties} choices differ at near ties")
