"""The benchmark's CPU tests: one thread each, small sizes, the program on
the CPU.  Run from the repository's root:

    python -m pytest portbench/tests -q
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a size the CPU holds: 16 recorded ticks after the cell's 12-solve warm
# chain, where a sound run reads its numbers as on the card; and a quicker
# one for runs that are to come out not correct
SMALL_SOLVE = {"batch": 16, "warm_chain": 12, "warm_up_steps": 1}
QUICK_SOLVE = {"batch": 16, "warm_chain": 3, "warm_up_steps": 0}
