"""A run with the timed path broken underneath reads ``correct`` false:
for each fault a served cell can have, in each cell, at tiny sizes on the
CPU (the harness's look for a card skipped), and at the cells' sizes on
the card.  One card holds a cell, so no exchange between cards can be
left out."""
import pytest
import torch

from agentbench.tests import tiny

CELLS = ["olmoe-1b-7b.mapreduce", "rwkv6-7b.agent"]


def wrap(model, step):
    """Put ``step(decode_step, cache, tokens, pos)`` in place of the model's
    decode step, which serves every token after a call's first."""
    inner = model.decode_step
    model.decode_step = lambda cache, tokens, pos: step(inner, cache, tokens, pos)


def state_unchanged(model, engine):
    """A step that returns its state unchanged: it decodes on a copy of
    the cache and hands the old one back."""
    def step(inner, cache, tokens, pos):
        if isinstance(cache, dict):
            copy = {k: v.clone() for k, v in cache.items()}
        else:
            copy = type(cache)(cache[0].clone(), cache[1].clone(), cache.seq)
        logits, _ = inner(copy, tokens, pos)
        return logits, cache
    wrap(model, step)


def half_batch(model, engine):
    """Half of the batch left out: every other row, alternating from step
    to step, takes the mean of the other rows' logits, so that every call
    loses about half of its steps wherever it sits in the batch."""
    steps = [0]

    def step(inner, cache, tokens, pos):
        logits, cache = inner(cache, tokens, pos)
        B = logits.shape[0]
        if B > 1:
            out = torch.arange(B, device=logits.device) % 2 == steps[0] % 2
            logits = logits.clone()
            logits[out] = logits[~out].mean(0, keepdim=True)
        steps[0] += 1
        return logits, cache
    wrap(model, step)


def slot_half(model, engine):
    """Half of the batch left out where it sits: the rows of the second
    half of the slots take the mean of the first half's logits.  Only
    calls that sat in those slots go wrong, so it is planted at the cells'
    sizes, where the sample holds calls of every part of the batch; a tiny
    cell's few clients may never reach the second half."""
    def step(inner, cache, tokens, pos):
        logits, cache = inner(cache, tokens, pos)
        B = logits.shape[0]
        if B > 1:
            logits = logits.clone()
            logits[B // 2:] = logits[:B // 2].mean(0, keepdim=True)
        return logits, cache
    wrap(model, step)


def token_altered(model, engine):
    """A token altered where it is produced: the decode step's best token
    moves to the next id."""
    def step(inner, cache, tokens, pos):
        logits, cache = inner(cache, tokens, pos)
        best = logits.argmax(-1)
        return torch.nn.functional.one_hot((best + 1) % logits.shape[-1],
                                           logits.shape[-1]).float(), cache
    wrap(model, step)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = tiny.run(cell, 21)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


FAULTS = [state_unchanged, half_batch, token_altered]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_not_correct(cell, fault):
    res = tiny.run(cell, 21, patch=fault)
    assert not res["correct"], res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels and the cell's sizes")


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS + [slot_half])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_not_correct_at_the_cells_size(card, cell, fault):
    import time

    from agentbench import harness

    res = harness.run_cell(cell, 3000000555, 15.0, False, time.perf_counter(), patch=fault)
    assert not res["correct"], res["checks"]
