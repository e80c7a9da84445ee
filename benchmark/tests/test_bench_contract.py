"""The last line's contract, and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests._tiny import TINY

RUN = os.path.join(harness.HERE, "run.py")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["room0.mapping", "room0.closure"])
def test_result_keys(cell, traced):
    r = harness.run_cell(cell, 4_294_967_311, 0.0, traced, "cpu",
                         overrides=TINY)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    r.pop("numbers")
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert r["device"]["window_s"] > 0
    else:
        assert "setup_s" in r["metrics"]
        assert all(v["value"] > 0 for v in r["metrics"].values())
    for c in r["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_without_cuda_no_result():
    p = _run([RUN, "--workload", "room0.mapping", "--seed", "5",
              "--seconds", "1", "--trace", "0"], harness.ROOT)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "refused" in p.stderr


def test_alone_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _run([str(tmp_path / "benchmark" / "run.py"), "--workload",
              "room0.mapping", "--seed", "5", "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()
