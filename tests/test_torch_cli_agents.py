"""The multi-agent CLI of the port on the CPU: two agents in one process
over the on-disk exchange, one process per agent (--spawn, as
tests/test_cli.py:133-147), per-agent --resume paths and config files,
--device_mesh over several ranks (not ported) and the default device."""

import os
import subprocess
import sys

import pytest
import torch
import yaml

from mneslam_tpu_torch import cli
from mneslam_tpu_torch.agents.comms import FileComms
from mneslam_tpu_torch.agents.runner import MultiAgentRunner
from mneslam_tpu_torch.slam import MNESLAM
from test_torch_agents import tiny_overrides

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_yaml(tmp_path, exp):
    ov = tiny_overrides(tmp_path / "out")
    ov["mapping"].update(first_iters=20, iters=4, keyframe_every=3)
    ov.update(dataset="synthetic")
    ov["data"].update(output=str(tmp_path / "out"), exp_name=exp,
                      num_frames=6)
    ov["meshing"] = {"resolution": 0.25}
    ov["loop_detection"].update(sim_threshold=0.95, min_time_diff=100)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(ov))
    return path


def _assert_file_comms_surface(root):
    for rank in (0, 1):
        d = root / f"agent_{rank}"
        for name in ("key_est_poses.npy", "key_timestamps.npy",
                     "latest_checkpoint.npz", "metrics.jsonl",
                     "final_checkpoint.npz"):
            assert (d / name).exists(), (rank, name)
        assert list((d / "descriptors").glob("*.npz")), rank


def test_cli_two_agents_in_process(tmp_path):
    """`--num_agents 2 --device cpu --file_comms` in one process: both
    agents map, exchange over the on-disk protocol, return their
    results."""
    path = _tiny_yaml(tmp_path, "inproc")
    res = cli.main(["--config", str(path), "--num_agents", "2",
                    "--device", "cpu", "--file_comms"])
    assert len(res) == 2 and all(r["keyframes"] == 2 for r in res)
    # one process, one FileComms (rank 0's, as in the JAX package): every
    # descriptor lies under agent_0, tagged with its agent
    root = tmp_path / "out" / "inproc"
    db = FileComms(str(root), rank=0).descriptors()
    assert {e["agent_id"] for e in db} == {0, 1}
    for rank in (0, 1):
        for name in ("key_est_poses.npy", "latest_checkpoint.npz",
                     "final_checkpoint.npz"):
            assert (root / f"agent_{rank}" / name).exists(), (rank, name)


def test_cli_spawn_runs_one_process_per_agent(tmp_path):
    """`--num_agents 2 --spawn --device cpu` (tests/test_cli.py:133-147):
    both children exit 0 and write the FileComms surface."""
    path = _tiny_yaml(tmp_path, "mp")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "mneslam_tpu_torch.cli", "--config",
         str(path), "--num_agents", "2", "--spawn", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2000:])
    _assert_file_comms_surface(tmp_path / "out" / "mp")


def test_cli_device_mesh_raises_and_resume_paths(tmp_path, monkeypatch):
    path = _tiny_yaml(tmp_path, "x")
    # several agents over a world of ranks run as the mesh fleet
    # (--device_mesh: tests/test_torch_fleet_composed_cli.py); without it,
    # or with one process per agent, a world raises, naming what runs
    with monkeypatch.context() as m:
        m.setattr(torch.distributed, "is_initialized", lambda: True)
        m.setattr(torch.distributed, "get_rank", lambda: 0)
        m.setattr(torch.distributed, "get_world_size", lambda: 4)
        with pytest.raises(NotImplementedError, match="--device_mesh"):
            cli.main(["--config", str(path), "--num_agents", "2",
                      "--device", "cpu"])
        for flag in ("--spawn", "--file_comms"):
            with pytest.raises(NotImplementedError,
                               match="one process per agent"):
                cli.main(["--config", str(path), "--num_agents", "2",
                          "--device_mesh", flag, "--device", "cpu"])
    # N agents: agent r resumes from PATH.agent<r>
    seen = []
    monkeypatch.setattr(MNESLAM, "load_full_state",
                        lambda self, p: seen.append(p))
    monkeypatch.setattr(MultiAgentRunner, "run_mapping_only",
                        lambda self: None)
    monkeypatch.setattr(MNESLAM, "terminate", lambda self: {})
    cli.main(["--config", str(path), "--num_agents", "2", "--device", "cpu",
              "--resume", "state.npz"])
    assert seen == ["state.npz.agent0", "state.npz.agent1"]
    assert cli.derive_agent_config(str(path), 1) == str(path)
    (tmp_path / "tiny_agent1.yaml").write_text("mode: mapping\n")
    assert cli.derive_agent_config(str(path), 1) == str(
        tmp_path / "tiny_agent1.yaml")


def test_multiagent_entry_points_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _tiny_yaml(tmp_path, "gpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config", str(path), "--num_agents", "2"])
