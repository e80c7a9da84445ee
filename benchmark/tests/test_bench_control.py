"""On the card: the control (the reference in TF32 in the program's place)
comes out not correct at each cell's own size, on three seeds. Run it
there with `python3 -m pytest benchmark/tests/test_bench_control.py
-q -p no:cacheprovider`."""

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the control runs at the cell's size")
    found, ctx = harness.context(cell, seed, "cuda")
    numbers = harness.driver(found["traffic"]["kind"]).control(ctx)
    limits = harness.limits(cell)
    assert any(v > limits[k] for k, v in numbers.items()), numbers
