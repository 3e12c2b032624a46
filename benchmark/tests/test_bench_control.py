"""The control of ``correct`` on the card: the reference computed with TF32
products in the program's place fails each cell's comparison, at the
cell's widths with a little of its traffic (``tiny.small_spec``). The chip
readings the limits rest on come from ``benchmark/control.py`` at the
cells' own sizes (PERF.md)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

CELLS = ["cur7-serve-rel", "cur5-train-shuffled", "cur7-eval-file"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32, which only the card has")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(card, tmp_path, cell):
    from benchmark.tests.tiny import run_small

    out = run_small(tmp_path, cell, seed=2147483701, control="tf32")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes(card, tmp_path, cell):
    from benchmark.tests.tiny import run_small

    out = run_small(tmp_path, cell, seed=2147483703)
    assert out["correct"], out["checks"]
