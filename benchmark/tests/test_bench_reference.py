"""The plain reference agrees with the program at a tiny size on the CPU,
for each traffic mix; planted faults make `correct` come out false."""

import pytest

from benchmark import harness
from benchmark.tests._tiny import TINY

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
FAULT_CASES = [(w, f) for w in CELLS for f in harness.driver(
    harness.find_cell(BENCH, w)["traffic"]["kind"]).FAULTS]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_program(cell):
    r = harness.run_cell(cell, 2 ** 31 + 12345, 0.0, False, "cpu",
                         overrides=TINY)
    numbers = {k: v["value"] for k, v in r["compared"].items()}
    # float32 on both sides, the same draws: rounding only
    assert max(numbers.values()) < 1e-5, numbers
    assert r["correct"] and r["failed"] == 0


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_fault_is_not_correct(cell, fault):
    r = harness.run_cell(cell, 777, 0.0, False, "cpu", overrides=TINY,
                         fault=fault)
    assert not r["correct"], r["compared"]
