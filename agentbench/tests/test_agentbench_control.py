"""The control: the reference in fp8 in the program's place.  At tiny sizes
on the CPU its reading of each cell's compared number lies above the
program's on the same prompts and tokens; on the card (``-m gpu``), at
the cell's own size, the program reads under the cell's limit and the
control over it."""
import time

import pytest

from agentbench import cells
from agentbench.tests import tiny

CELLS = ["olmoe-1b-7b.mapreduce", "rwkv6-7b.agent"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program_at_tiny_sizes(cell):
    (number,) = cells.limits(cell)["numbers"]
    # a mean gap over two tiny calls swings with which calls finished in
    # the window, and so with the CPU's speed: a larger sample over eight
    # seeds (one seed's program reads 0 to 0.005, its control 0.006 to 0.024)
    _, _, limits = tiny.files(cell)
    limits["min_tokens"] = 240
    program = control = 0.0
    for seed in range(1, 9):
        got = tiny.run(cell, seed, control=True, limits=limits)["control"]
        program += got[number]
        control += got["control_" + number]
    assert control > 3 * program, (program, control)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels and the cell's sizes")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_at_the_cells_size(card, cell):
    from agentbench import harness

    limits = cells.limits(cell)
    res = harness.run_cell(cell, 3000000777, 15.0, False, time.perf_counter(), control=True)
    for number, limit in limits["numbers"].items():
        assert res["control"][number] <= limit
        assert res["control"]["control_" + number] > limit
