"""`cli.main --num_agents 2 --device_mesh` under a world of 4 ranks on the
CPU (2 agents x 2 row ranks: `cli._fleet_world`), on
configs/Replica/room0_v5e8_fleet.yaml's keys (mapping.shard_plane_rows,
shard_gather_every 1) at the tiny widths of tests/test_torch_fleet.py,
against the one-process `--device_mesh` run. The render is fp32, as in
`chip_smoke.py` 14c: over several ranks the bf16 render's partial
cotangents are rounded to bf16 on each rank and summed in bf16, which
moves the losses by up to 9e-4 relative after 6 iterations here (on
the card `chip_smoke.py` 14b holds the bf16 sums by one batch's
gradient). The ranks are
`tests/_torch_dist.py`'s (gloo, one thread each, 60 s timeouts); each
calls `cli.main`, as `torchrun` would start it.
"""

import json
import os

import numpy as np
import torch
import yaml

from mneslam_tpu_torch import cli
from test_torch_fleet import fleet_overrides
from tests._torch_dist import REPO, run_ranks

torch.set_num_threads(1)


def _losses(agent_dir) -> list:
    with open(os.path.join(agent_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r["loss"] for r in rows if r.get("kind") == "metric"]


def _fleet_yaml(tmp_path) -> str:
    ov = fleet_overrides(tmp_path / "unused", "fleet")
    ov["mapping"].update(first_iters=6, iters=2)
    del ov["data"]["output"], ov["loop_bound"]
    ov.update(inherit_from="configs/Replica/room0_v5e8_fleet.yaml",
              dataset="synthetic", mode="mapping")
    ov["data"]["num_frames"] = 5
    ov["meshing"] = {"resolution": 0.3}
    ov["training"]["render_dtype"] = "float32"
    path = tmp_path / "fleet.yaml"
    path.write_text(yaml.safe_dump(ov))
    return str(path)


def test_cli_device_mesh_on_a_world_of_four_ranks(tmp_path, monkeypatch):
    """Every rank exits 0: each leader returns its agent's result, each
    follower None; both agents' outputs are written, and only by the
    leaders; each per-keyframe loss within rtol 1e-4 of the one-process
    run's."""
    monkeypatch.chdir(REPO)     # the configs' inherit_from paths
    path = _fleet_yaml(tmp_path)
    argv = ["--config", path, "--num_agents", "2", "--device_mesh",
            "--device", "cpu"]
    outs = run_ranks("cli", 4, tmp_path, {"argv": argv + [
        "--output", str(tmp_path / "world")]})
    one = cli.main(argv + ["--output", str(tmp_path / "one")])
    assert [o["result"] is None for o in outs] == [False, True, False, True]
    for r in (0, 1):
        got = outs[2 * r]["result"]
        assert got["keyframes"] == one[r]["keyframes"] == 3
        d = tmp_path / "world" / "fleet" / f"agent_{r}"
        assert (d / "final_checkpoint.npz").exists()
        assert (d / "mesh" / "final_mesh.ply").exists()
        ref = _losses(tmp_path / "one" / "fleet" / f"agent_{r}")
        assert len(ref) == 3
        np.testing.assert_allclose(_losses(d), ref, rtol=1e-4)
    written = sorted(p.parent.name for p in (tmp_path / "world").rglob("*")
                     if p.is_file())
    assert set(written) <= {"agent_0", "agent_1", "mesh"}
