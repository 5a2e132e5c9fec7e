"""The controls, kept as a test: on the card, the plain reference in TF32
put in the program's place fails each cell's limits (`correct` false),
at sizes a test run holds.  The full-size readings are taken by
control.py (PERF.md gives them).  Skips without a card."""

import pytest
import torch

from h100_bench import check
from h100_bench.tests.control import control_numbers
from h100_bench.tests.small import SEED

# each cell's scale cut for a test run; widths and depths as published
CUTS = {"darknet_r.serve": {"pool": 32},
        "capsule.serve": {"pool": 1024},
        "capsule.train": {"n": 1024},
        "darknet_r.train": {"n": 96}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUTS))
def test_the_control_fails_the_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is the reference in "
                    "TF32, which only the card computes")
    from h100_bench import harness
    cell = harness.Cell(harness.load_spec(), name)
    cell.traffic.update(CUTS[name])
    correct, checks = check.judge(control_numbers(cell, SEED, "cuda"),
                                  cell.limits)
    assert correct is False, checks
