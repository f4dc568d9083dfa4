"""On the card, at the cells' own sizes: the control of each cell comes
out not correct, and a short run of the program correct.

    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py

Skipped without a card."""

import time

import pytest

from portbench.core import harness

pytestmark = pytest.mark.cuda


def run(cell_name, control, seed):
    cell, config, traffic, bench = harness.cell_files(cell_name)
    res, _ = harness.run_cell(cell, config, traffic, bench, seed, 2.0,
                              False, "cuda", time.perf_counter(),
                              control=control)
    return res


@pytest.mark.parametrize("cell", ["landiff-2b.denoise",
                                  "landiff-2b.vae-decode"])
def test_control_fails_and_program_passes(card, cell):
    assert not run(cell, True, 2220000001)["correct"]
    assert run(cell, False, 2220000003)["correct"]
