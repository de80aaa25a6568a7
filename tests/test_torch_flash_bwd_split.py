"""The flash backward's dK/dV schedule and its split-and-merge arithmetic.

On the card the backward's dK/dV kernel runs units planned by
``plan_bwd_units``: each 64-key tile's walk over its (query head, query
tile) iterations is cut into units of at most ``cap`` iterations, launched
heaviest first; a split tile's units write f32 partials that a merge sums
in unit order.  Here the planner is held to that contract (every
iteration once, no unit over the cap, balance, order, no tensor read), at
the train shape and at ``chip_smoke.FLASH_BWD_CASES``, and
``flash_attention_bwd_split_ref``, which repeats the kernel's split and
merge in f32, is held against the plain backward and against ``jax.vjp``
of the reference's ``causal_flash_attention`` and
``bidirectional_attention`` at 1e-5 of each gradient's scale (its largest
magnitude).  The CUDA kernels are held against the plain version by the
``gpu``-marked tests of ``test_torch_flash_bwd.py`` and by
``chip_smoke.py``.
"""
import functools
import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_bwd_split_ref,
    flash_attention_fwd_lse_ref)
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (its top level imports the standard library only)

TOL = 1e-5
H100_SMS = 132  # the card the planner is sized for
# the longest unit over the balanced share of the card's consumer
# warpgroups that the planner promises
BALANCE_RATIO = 1.25
TRAIN = (2, 2048, 2048, 16, 2, 128, 0, True)  # (B, Sq, Sk, H, KV, D, window, causal)


def _case(c):
    """A chip_smoke.FLASH_BWD_CASES entry as (B, Sq, Sk, H, KV, D, window,
    causal)."""
    B, S, H, KV, D, window, _dtype, *rest = c
    Sk, causal = rest if rest else (S, True)
    return B, S, Sk, H, KV, D, window, causal


# the bf16 cases: the f32 kernels walk whole tiles and take no plan
CARD_CASES = [TRAIN] + [_case(c) for c in chip_smoke.FLASH_BWD_CASES
                        if c[6] == "bfloat16"]
CARD_IDS = [f"{'causal' if c[7] else 'full'}-w{c[6]}-B{c[0]}-S{c[1]}x{c[2]}-H{c[3]}-KV{c[4]}"
            for c in CARD_CASES]
# small shapes that split at caps of 1 and 7: G of 2, 4 and 8, ragged
# lengths, windows, non-causal at Sq != Sk
SMALL_CASES = [
    (1, 200, 200, 8, 2, 32, 0, True),
    (2, 150, 150, 4, 1, 64, 50, True),
    (1, 130, 200, 8, 1, 32, 0, False),
    (1, 600, 600, 4, 2, 16, 300, True),
]
SMALL_IDS = [f"{'causal' if c[7] else 'full'}-w{c[6]}-S{c[1]}x{c[2]}-G{c[3] // c[4]}-D{c[5]}"
             for c in SMALL_CASES]
CAPS = [1, 7, "tile"]


def _plan(case, cap=0):
    """The case's plan as the wrapper makes it: the head dim's dK/dV
    workers an SM (``bwd_slots_per_sm``)."""
    B, Sq, Sk, H, KV, D, window, causal = case
    slots = flash_ops.bwd_slots_per_sm(D)
    if cap == "tile":  # a whole tile's walk: nothing splits
        cap = max(flash_ops.plan_bwd_units(B, KV, H // KV, Sq, Sk, window, causal,
                                           H100_SMS, slots=slots).work)
    return flash_ops.plan_bwd_units(B, KV, H // KV, Sq, Sk, window, causal,
                                    H100_SMS, cap, slots)


def _pairs(case):
    """Every (key tile, query head, query tile) pair whose 64 x 64 block
    holds a kept (query, key) pair, from the mask itself."""
    B, Sq, Sk, H, KV, D, window, causal = case
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    kept = np.ones((Sq, Sk), bool)
    if causal:
        kept = (j <= i) & ((window <= 0) | (j > i - window))
    out = set()
    for qi in range(-(-Sq // 64)):
        for t in range(-(-Sk // 64)):
            if kept[qi * 64:(qi + 1) * 64, t * 64:(t + 1) * 64].any():
                out.update((t, g, qi) for g in range(H // KV))
    return out


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SMALL_CASES + CARD_CASES, ids=SMALL_IDS + CARD_IDS)
@pytest.mark.parametrize("cap", [0, 1, 7])
def test_plan_covers_every_iteration_once(case, cap):
    """The units of one (batch, KV head), expanded into their (key tile,
    query head, query tile) iterations, are exactly the blocks the mask
    keeps, each once; no unit exceeds the cap; a split tile's units write
    consecutive slots in chunk order and every slot is written once."""
    plan = _plan(case, cap)
    seen = []
    for t, it0, it1, slot in plan.units:
        assert 0 < it1 - it0 <= plan.cap
        qt0, nq = plan.walks[t]
        seen += [(t, it // nq, qt0 + it % nq) for it in range(it0, it1)]
    assert len(seen) == len(set(seen))
    assert set(seen) == _pairs(case)
    slots = sorted(u[3] for u in plan.units if u[3] >= 0)
    assert slots == list(range(plan.partials))
    for t, slot0, count in plan.merges:
        mine = sorted((u[1], u[3]) for u in plan.units if u[0] == t)
        assert [s for _, s in mine] == list(range(slot0, slot0 + count))
    split = {m[0] for m in plan.merges}
    assert all((u[3] >= 0) == (u[0] in split) for u in plan.units)


@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
def test_plan_balances_the_card(case):
    """At the card's shapes the longest unit is within BALANCE_RATIO of the
    balanced share of its dK/dV workers (2 x 132, or 132 at D = 256), and
    the units run heaviest first."""
    B, Sq, Sk, H, KV, D, window, causal = case
    plan = _plan(case)
    sizes = [it1 - it0 for _, it0, it1, _ in plan.units]
    workers = flash_ops.bwd_slots_per_sm(D) * H100_SMS
    share = B * KV * sum(plan.work) / workers
    assert max(sizes) <= BALANCE_RATIO * share
    assert sizes == sorted(sizes, reverse=True)
    assert plan.cap == max(1, -(-B * KV * sum(plan.work) // workers))


def test_plan_at_the_train_shape():
    """qwen2.5-3b's microbatch (B=2, S=2048, H=16, KV=2, D=128, causal):
    cap 64, 80 units per (batch, KV head), 320 in all, of which 208 full;
    72 partial slots each, 288 partial tiles, ~19 MB of f32 scratch."""
    B, Sq, Sk, H, KV, D, window, causal = TRAIN
    plan = _plan(TRAIN)
    assert plan.cap == 64 and len(plan.units) == 80
    assert sum(1 for u in plan.units if u[2] - u[1] == 64) * B * KV == 208
    assert plan.partials == 72 and len(plan.merges) == 24
    part = B * KV * plan.partials * 2 * 64 * D * 4
    assert part == 288 * 64 * 128 * 2 * 4
    assert flash_ops.bwd_work_bytes(plan, B, H, KV, Sq, D) == \
        -(-(8 * B * H * Sq + 16 * (80 + 24)) // 256) * 256 + part
    # the longest walk (tile 0: 8 heads x 32 query tiles) is cut in four
    assert [u[1:3] for u in plan.units if u[0] == 0] == [(0, 64), (64, 128),
                                                         (128, 192), (192, 256)]


def test_plan_at_head_dim_256_counts_the_blocks_an_sm_holds():
    """At D = 256 the persistent wgmma kernel's block is one worker: its
    slot (K and V, or Q and dO, of 64 rows: 64 KB; two stages of the
    streamed pair with their lse and D rows: 2 x 64.5 KB; two 64 x 64 f32
    exchange tiles for the two consumer warpgroups: 32 KB; ten mbarriers),
    rounded to 1 KB, and 1 KB of alignment slack take the whole 227 KB,
    and a block of two slots would hold no stage, so the plan is balanced
    over one worker an SM (two at the other head dims).  At gemma-7b's
    microbatch (B=2, S=2048, H = KV = 16, causal) the 32 (batch, KV head)
    pairs walk 528 iterations each over 132 workers: cap 128 (64 at two a
    SM), above every tile's walk (G = 1, at most 32 query tiles), so each
    tile is one unit and nothing splits."""
    tile, rows = 64 * 256 * 2, 2 * 64 * 4
    slot = -(-(2 * tile + 2 * (2 * tile + rows) + 2 * 64 * 64 * 4 + 8 * 10) // 1024) * 1024
    assert flash_ops.bwd_tc_smem_bytes(256) == slot + 1024 == 232448
    assert flash_ops.bwd_tc_smem_bytes(256) <= flash_ops.SM_SMEM_BYTES < 2 * slot + 1024
    assert flash_ops.bwd_tc_stages(256, 1) == 2 and flash_ops.bwd_tc_stages(256, 2) < 2
    assert flash_ops.bwd_slots_per_sm(256) == 1
    assert [flash_ops.bwd_slots_per_sm(D) for D in (32, 64, 128)] == [2, 2, 2]
    # the two-worker blocks of D = 64 and 128 keep their layouts
    assert [flash_ops.bwd_tc_stages(D, 2) for D in (64, 128)] == [4, 2]
    assert [flash_ops.bwd_tc_smem_bytes(D) for D in (64, 128)] == [203776, 201728]
    case = (2, 2048, 2048, 16, 16, 256, 0, True)
    plan = _plan(case)
    assert sum(plan.work) == 32 * 33 // 2
    assert plan.cap == -(-2 * 16 * sum(plan.work) // H100_SMS) == 128
    assert plan == flash_ops.plan_bwd_units(2, 16, 1, 2048, 2048, 0, True, H100_SMS,
                                            slots=1)
    assert plan != flash_ops.plan_bwd_units(2, 16, 1, 2048, 2048, 0, True, H100_SMS)
    # every key tile's walk (at most 32 query tiles, G = 1) fits the cap
    assert plan.partials == 0 and len(plan.units) == 32


@pytest.mark.parametrize(
    "case", [c for c in CARD_CASES if c[5] == 256],
    ids=[i for c, i in zip(CARD_CASES, CARD_IDS) if c[5] == 256])
def test_plan_at_head_dim_256_is_the_one_worker_plan(case):
    """Every D = 256 case of ``chip_smoke.FLASH_BWD_CASES`` (gemma-7b's
    microbatch, a ragged S, grouped heads under a window, non-causal
    cross-attention) is planned as the one-worker block runs it:
    ``plan_bwd_units(..., slots=1)``, the cap the balanced share of 132
    workers."""
    B, Sq, Sk, H, KV, D, window, causal = case
    plan = _plan(case)
    one = flash_ops.plan_bwd_units(B, KV, H // KV, Sq, Sk, window, causal, H100_SMS,
                                   slots=1)
    assert plan == one
    assert plan.cap == max(1, -(-B * KV * sum(plan.work) // H100_SMS))


def test_plan_without_splits_needs_no_partials():
    """Where the share exceeds every tile's walk (the encoders' and the
    cross-attention's shapes), every tile is one unit and writes bf16
    itself: no partials, no merges."""
    for case in [c for c in CARD_CASES if not c[7]]:
        plan = _plan(case)
        assert plan.partials == 0 and plan.merges == ()
        assert len(plan.units) == len(plan.walks)


def test_plan_reads_no_tensor(monkeypatch):
    """The plan depends on host integers only: no tensor is read back (a
    device read would sync the host with the card every layer)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the planner read a tensor")

    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    flash_ops.plan_bwd_units.cache_clear()
    plan = flash_ops.plan_bwd_units(2, 2, 8, 2048, 2048, 0, True, H100_SMS)
    assert (plan.cap, len(plan.units)) == (64, 80)


# ---------------------------------------------------------------------------
# the split-and-merge arithmetic
# ---------------------------------------------------------------------------


def _inputs(seed, B, Sq, Sk, H, KV, D):
    """q, k, v and the output's cotangent, (B, S, heads, D) f32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D))]


def _split(case, cap, arrays):
    """(dq, dk, dv) of ``flash_attention_bwd_split_ref`` in (B, S, heads,
    D) numpy, and those of ``flash_attention_bwd_ref``."""
    *_, window, causal = case
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2) for a in arrays)
    out, lse = flash_attention_fwd_lse_ref(q, k, v, window=window, causal=causal)
    split = flash_attention_bwd_split_ref(q, k, v, out, do, lse, _plan(case, cap),
                                          window=window, causal=causal)
    plain = flash_attention_bwd_ref(q, k, v, out, do, lse, window=window,
                                    causal=causal)
    return ([g.transpose(1, 2).numpy() for g in split],
            [g.transpose(1, 2).numpy() for g in plain])


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(ours, np.float32) - ref).max())
    assert err <= tol * scale, f"error {err} over scale {scale}"


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", SMALL_CASES, ids=SMALL_IDS)
def test_split_ref_matches_plain_backward(case, cap):
    plan = _plan(case, cap)
    if cap != "tile":  # the small caps do split a tile
        assert plan.merges
    split, plain = _split(case, cap, _inputs(0, *case[:6]))
    for ours, ref in zip(split, plain):
        _close(ours, ref)


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """(inputs, dq/dk/dv of jax.vjp of the reference's attention), one
    trace per shape."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    layers = importlib.import_module("repro.models.layers")
    B, Sq, Sk, H, KV, D, window, causal = case
    arrays = _inputs(1, B, Sq, Sk, H, KV, D)
    if causal:
        def attn(q, k, v):
            return layers.causal_flash_attention(q, k, v, window=window, q_chunk=16)
    else:
        attn = layers.bidirectional_attention
    @jax.jit
    def grads(q, k, v, do):
        return jax.vjp(attn, q, k, v)[1](do)

    return arrays, [np.asarray(g) for g in grads(*(jnp.asarray(a) for a in arrays))]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", SMALL_CASES[:3], ids=SMALL_IDS[:3])
def test_split_ref_matches_jax_vjp(case, cap):
    arrays, ref = _jax_grads(case)
    split, _ = _split(case, cap, arrays)
    for name, ours, theirs in zip(("dq", "dk", "dv"), split, ref):
        assert ours.shape == theirs.shape, name
        _close(ours, theirs)


def test_split_ref_keeps_dtypes():
    case = SMALL_CASES[0]
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2).bfloat16()
                   for a in _inputs(2, *case[:6]))
    out, lse = flash_attention_fwd_lse_ref(q, k, v)
    grads = flash_attention_bwd_split_ref(q, k, v, out, do, lse, _plan(case, 7))
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
               for g in grads)


# ---------------------------------------------------------------------------
# the wrapper's ctypes signature against the C entry point
# ---------------------------------------------------------------------------


def test_bwd_argtypes_match_the_c_entry_point():
    """ctypes passes what ``_BWD_ARGTYPES`` says whatever the C side
    expects, so a mismatch would only show on the card: check it here."""
    src = (common.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    body = re.search(r"int flash_attention_bwd\((.*?)\)\s*{", src, re.S).group(1)
    params = [p.strip() for p in body.split(",")]
    assert len(params) == len(flash_ops._BWD_ARGTYPES)
    ctypes = flash_ops.ctypes
    for param, argtype in zip(params, flash_ops._BWD_ARGTYPES):
        ctype = param.rsplit(" ", 1)[0].replace("const ", "")
        expected = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
                    "long long": ctypes.c_longlong}[ctype]
        assert argtype is expected, param
