"""On the card only (marker ``cuda``; skipped where there is none): the
cell at its own size, one seed of the program, which is correct, and one
of the control, which is not.  On the card:

    python -m pytest portbench/tests/test_portbench_card.py -m cuda -q
"""

import pytest
import torch

from portbench import control

WORKLOAD = "centroidal-solve-b2048"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the tile kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("is_control,correct", [(False, True),
                                                (True, False)])
def test_the_cell_at_its_own_size(card, is_control, correct):
    got = control.readings(WORKLOAD, 6001, 3.0, is_control)
    assert got["correct"] is correct, got["numbers"]
