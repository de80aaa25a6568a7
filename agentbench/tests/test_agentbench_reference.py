"""The plain references compute what the program computes: at small
sizes on the CPU in f32, the program's prefill and decode steps (its
kernels' plain versions) against the reference's one pass over the same
tokens, on the same weights."""
import copy
import dataclasses

import pytest
import torch

from agentbench import cells, correct
from agentbench.weights import load_into, make

SMALL = {
    "olmoe-1b-7b": {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
                    "head_dim": 16, "d_ff": 32, "vocab_size": 300, "num_experts": 8,
                    "experts_per_token": 2},
    "rwkv6-7b": {"num_layers": 2, "d_model": 128, "num_heads": 2, "num_kv_heads": 2,
                 "head_dim": 64, "d_ff": 256, "vocab_size": 300},
}


def program_logits(config, weights, prompt, served):
    """The program's logits for each served token: its prefill's, then a
    decode step per token, in a two-row batch whose other row is idle."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.zoo import build_model

    model = build_model(ArchConfig(**config["model"]), device="cpu", dtype=torch.float32)
    load_into(model, weights)
    logits, cache = model.prefill(torch.as_tensor(prompt)[None])
    out = [logits[0]]
    state = model.init_cache(2, 256)
    if isinstance(state, dict):
        for name, leaf in state.items():
            leaf[:, 1] = cache[name][:, 0]
    else:
        for big, small in zip(state, cache):
            big[:, 1, :, :small.shape[3]] = small[:, 0]
    for i, tok in enumerate(served[:-1]):
        pos = len(prompt) + i
        step, _ = model.decode_step(state, torch.tensor([0, tok]), torch.tensor([-1, pos]))
        out.append(step[1])
    return torch.stack(out)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "rwkv6-7b"])
def test_reference_matches_the_program_in_f32(name):
    torch.manual_seed(0)
    config = copy.deepcopy(cells.config(name))
    config["model"].update(SMALL[name])
    ref = correct.reference(config)
    leaves = [dataclasses.replace(leaf, dtype=torch.float32)
              for leaf in ref.leaves(config["model"])]
    weights = make(leaves, 11, "cpu")
    # a prompt long enough that the MoE capacity drops choices
    prompt = torch.randint(0, 300, (150,)).tolist()
    served = torch.randint(0, 300, (12,)).tolist()
    got = program_logits(config, {k: v.clone() for k, v in weights.items()}, prompt, served)
    (want,) = ref.logits(weights, config["model"], [(torch.tensor(prompt + served[:-1]),
                                                    len(prompt))], "f32")
    assert got.shape == want.shape == (len(served), 300)
    err = (got - want).abs().amax(-1) / want.abs().max()
    # the prefill's logits (the capacity's drops included) within f32
    # rounding; a decode step reads the program's KV cache, which is bf16
    # whatever the weights' dtype: within bf16's rounding of k and v
    # (2^-8), where rwkv6's state is f32 and keeps f32's
    assert err[0] < 2e-5, err
    assert err[1:].max() < (2e-5 if name == "rwkv6-7b" else 4e-3), err


def test_the_capacity_rule_drops_in_the_prefill_only():
    from agentbench.reference.olmoe import kept_choices

    experts = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]])
    # expert 0 takes its first two choices, in token-major order
    assert kept_choices(experts, 4, 2).tolist() == [[True, True], [True, True],
                                                   [False, True], [True, False]]


def test_fp8_control_rounds_both_operands():
    from agentbench.reference.common import dot

    x = torch.randn(8, 64, dtype=torch.float64).float()
    w = torch.randn(64, 32).float()
    exact, low = dot(x, w, "f32"), dot(x, w, "fp8")
    rel = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < rel < 0.2
