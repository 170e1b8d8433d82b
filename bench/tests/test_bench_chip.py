"""The verdict's control at each cell's own size, on the card.

Run on a machine with a CUDA device:
``PYTHONPATH=src python -m pytest -q -m gpu bench/tests/test_bench_chip.py``.
Without one each case skips.
"""
from __future__ import annotations

import pytest

from bench import control, harness

CELLS = [c["name"] for c in harness.load_spec()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's size")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_is_not_correct_at_the_cells_size(card, cell, seed):
    got = control.control_checks(cell, seed, card)
    print(got)  # the control's readings, the upper end of each limit
    assert got["correct"] is False
    assert max(got["checks"].values()) > 0
