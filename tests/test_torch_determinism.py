"""The tracking-parity check's pieces (`mneslam_tpu_torch/tools/
prof_determinism.py`, used by `chip_smoke.py` phase 4) on the CPU: the run
repeats bit for bit, and the deterministic block restores the settings it
changed."""

import warnings

import torch

from mneslam_tpu_torch.tools.prof_determinism import (deterministic,
                                                      repeat_diff,
                                                      tracking_parity_run)

torch.set_num_threads(1)


def test_tracking_parity_run_repeats_on_cpu():
    a, b = tracking_parity_run("cpu"), tracking_parity_run("cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "poses": (8, 7), "disps": (8, 12, 16), "target": (18, 12, 16, 2),
        "weight": (18, 12, 16, 2)}
    assert all(torch.isfinite(v).all() for v in a.values())
    assert repeat_diff(a, b) == dict.fromkeys(a, 0.0)
    one = tracking_parity_run("cpu", updates=1)
    assert all(v > 0.0 for v in repeat_diff(a, one).values())


def test_deterministic_block_restores_settings():
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    with deterministic(True, True) as caught:
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        warnings.warn("recorded")
    assert [str(w.message) for w in caught] == ["recorded"]
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == prev
