"""The frozen traffic programs: deterministic per seed, the sizes their
mixes state, and an agent's prompts that extend its transcript."""
import numpy as np
import pytest

from agentbench.traffic import Send, Tool, Workflows, load_mix


def drive(gen, reply):
    """Run one workflow to its end, answering each call with
    ``reply(send)``; returns the sends and tool waits in order."""
    seen, value = [], None
    while True:
        try:
            item = gen.send(value)
        except StopIteration:
            return seen
        seen.append(item)
        value = None if isinstance(item, Tool) else [reply(s) for s in item]


def served(send: Send):
    return list(range(send.max_new_tokens))


def sends(mix, seed, n, vocab=1000):
    wf = Workflows(mix, seed, vocab)
    return [drive(wf.start(), served) for _ in range(n)]


@pytest.mark.parametrize("name", ["mapreduce_16docs", "react_32sessions"])
def test_same_seed_same_calls_and_sizes_every_seed(name):
    mix = load_mix(name)
    a, b, c = sends(mix, 7, 20), sends(mix, 7, 20), sends(mix, 8, 20)
    flat = lambda runs: [x for run in runs for x in run]  # noqa: E731
    for x, y, z in zip(flat(a), flat(b), flat(c)):
        assert type(x) is type(y) is type(z)
        if isinstance(x, Tool):
            assert x == y == z
            continue
        for p, q, r in zip(x, y, z):
            assert np.array_equal(p.prompt, q.prompt) and p.max_new_tokens == q.max_new_tokens
            # another seed: the same sizes, other token ids
            assert len(r.prompt) == len(p.prompt) and r.max_new_tokens == p.max_new_tokens
    assert any(not np.array_equal(p.prompt, r.prompt)
               for x, z in zip(flat(a), flat(c)) if not isinstance(x, Tool)
               for p, r in zip(x, z))


def test_map_reduce_sizes():
    mix = load_mix("mapreduce_16docs")
    p = mix["params"]
    for run in sends(mix, 1, 200):
        tools, groups = run[0], run[1:]
        assert isinstance(tools, Tool) and tools.seconds == p["dispatch_s"]
        maps = groups[0]
        assert p["min_chunks"] <= len(maps) <= p["max_chunks"]
        assert all(len(s.prompt) >= p["chunk_tokens"] for s in maps)
        assert all(s.max_new_tokens >= p["map_out"]["base"] for s in maps)
        width = len(maps)
        for level in groups[1:]:
            assert len(level) == -(-width // p["reduce_fanout"])
            for s in level:
                k = (len(s.prompt) - p["reduce_extra"]) // p["partial_tokens"]
                assert 1 <= k <= p["reduce_fanout"]
                assert len(s.prompt) == k * p["partial_tokens"] + p["reduce_extra"]
            width = len(level)
        root = groups[-1]
        assert len(root) == 1 and root[0].max_new_tokens >= p["root_out"]["base"]
    # a lognormal(8.3, 0.6) document is ~4k tokens: 6 chunks at the median
    chunks = sorted(len(run[1]) for run in sends(mix, 1, 200))
    assert 4 <= chunks[len(chunks) // 2] <= 8


def test_react_sizes():
    mix = load_mix("react_32sessions")
    p = mix["params"]
    for run in sends(mix, 2, 200):
        agent = [g[0] for g in run if not isinstance(g, Tool)]
        tools = [t for t in run if isinstance(t, Tool)]
        assert len(agent[0].prompt) >= p["context_tokens"]["base"]
        assert 1 <= len(tools) <= p["max_steps"]
        assert all(t.seconds >= p["tool_s"]["base"] for t in tools)
        assert agent[-1].max_new_tokens >= p["answer_out"]["base"]


def test_agent_prompt_extends_previous_prompt_and_its_output():
    mix = load_mix("react_32sessions")
    p = mix["params"]
    wf = Workflows(mix, 3, 1000)
    for _ in range(30):
        gen, value, prev, prev_out, pending_obs = wf.start(), None, None, None, []
        while True:
            try:
                item = gen.send(value)
            except StopIteration:
                break
            if isinstance(item, Tool):
                value = None
                continue
            (send,) = item
            out = [int(x) for x in np.random.default_rng(len(send.prompt)).integers(0, 1000, send.max_new_tokens)]
            is_summary = prev is not None and not np.array_equal(
                send.prompt[:len(prev) + len(prev_out)], np.concatenate([prev, prev_out]))
            if is_summary:
                # a summariser call: its prompt is the observation alone
                assert len(send.prompt) > p["summarize_over"]
                pending_obs = out
            else:
                if prev is not None:
                    head = np.concatenate([prev, prev_out])
                    assert np.array_equal(send.prompt[:len(head)], head)
                    rest = send.prompt[len(head):]
                    if pending_obs:
                        assert list(rest) == pending_obs
                    else:
                        assert p["observation_tokens"]["base"] <= len(rest) <= p["summarize_over"]
                prev, prev_out, pending_obs = send.prompt, np.asarray(out), []
            value = [out]
