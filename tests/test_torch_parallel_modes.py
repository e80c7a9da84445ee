"""Port parity: the row-sharded mapper's stale-table and fold modes
(`mapping.shard_prefetch`, `shard_gather_every`, `shard_fold`) on 2 ranks
against the JAX package's 2-device row-sharded `Mapper.optimize`
(tests/test_parallel.py:198, :348, :365, :387), with JAX's draws. The
ranks and tolerances are test_torch_parallel_optimize.py's.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.data.synthetic import SyntheticBoxDataset as JSyntheticBox
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from test_torch_parallel_optimize import (OVERRIDES, RTOL, assert_params_close,
                                          jax_mapping_run)
from tests._torch_dist import run_optimize, run_ranks

torch.set_num_threads(1)

# (mapping keys, iterations of one map call)
MODES = {
    "prefetch1": ({"shard_prefetch": 1}, 4),
    "prefetch2": ({"shard_prefetch": 2}, 4),
    # two whole 2-blocks and the remainder block
    "gather2": ({"shard_gather_every": 2}, 5),
}


def _overrides(keys):
    o = copy.deepcopy(OVERRIDES)
    o["mapping"].update(keys)
    return o


@pytest.fixture(scope="module")
def jax_state0():
    """One JAX start for every mode (init_state compiles per mapper)."""
    cfg = jmake_config(OVERRIDES)
    n = JSyntheticBox(cfg, num_frames=2, half=1.6).num_rays_to_save
    jm = JMapper(cfg, JSceneRep(cfg), num_kf=4, rays_per_kf=n)
    return jm.init_state(jax.random.PRNGKey(2))


def test_stale_and_fold_modes_match_jax(tmp_path, jax_state0):
    """Each mode on 2 ranks equals JAX's 2-device program on the same
    draws (loss rtol 1e-4, parameters atol 3e-5); fold "before" equals
    fold "after" on the port's ranks, at the sync seam and under
    gather_every 2 (the seam's fold orders are held against JAX in
    test_torch_parallel.py)."""
    runs, refs = [], []
    for name, (keys, iters) in MODES.items():
        run, losses, params = jax_mapping_run(
            _overrides(keys), 2, schedule=((0, 3, 4, iters),),
            state0=jax_state0)
        runs.append(run)
        refs.append((name, losses, params))
    extra = []
    for keys in ({}, {"shard_fold": "before"},
                 {"shard_gather_every": 2, "shard_fold": "before"}):
        run = copy.deepcopy(runs[2])
        run["overrides"] = _overrides(keys)
        extra.append(run)
    outs = run_ranks("optimize", 2, tmp_path, runs + extra)
    for rank_out in outs:
        for got, (name, losses, params) in zip(rank_out, refs):
            np.testing.assert_allclose(got["metrics"][0]["loss"], losses[0],
                                       rtol=RTOL, err_msg=name)
            assert_params_close(got["params"], params)
        after_sync, before_sync, before_g2 = rank_out[-3:]
        for a, b in ((after_sync, before_sync), (rank_out[2], before_g2)):
            np.testing.assert_allclose(b["metrics"][0]["loss"],
                                       a["metrics"][0]["loss"], rtol=RTOL)
            assert_params_close(b["params"], a["params"])
    # prefetch 2 takes exactly `iters` Adam steps (the first is skipped,
    # the trailing one applied)
    assert set(outs[0][1]["steps"].values()) == {4}


@pytest.mark.parametrize("keys", [{"shard_prefetch": 1},
                                  {"shard_gather_every": 4}])
def test_one_iteration_of_a_stale_mode_is_the_sync_seam(keys):
    """Iteration 0 consumes a table gathered from the current parameters,
    so one iteration of prefetch 1, or of gather_every 4 (its remainder
    block), equals the sync seam bit for bit (tests/test_parallel.py:246,
    :348)."""
    rng = np.random.default_rng(0)
    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.models.scene_rep import SceneRep

    cfg = make_config(OVERRIDES)
    ds = SyntheticBoxDataset(cfg, num_frames=1, half=1.6)
    item = ds[0]
    params = _port_params(cfg)
    scene = SceneRep(cfg, "cpu")
    S = scene.n_range_d + scene.n_samples_d
    n = ds.num_rays_to_save
    rays = np.zeros((4, n, 7), np.float32)
    px = rng.integers(0, ds.H * ds.W, n)
    rays[0] = np.concatenate([item["direction"].reshape(-1, 3)[px],
                              item["rgb"].reshape(-1, 3)[px],
                              item["depth"].reshape(-1)[px, None]], -1)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[0] = item["c2w"]
    call = {"db_rays": rays, "frame_ids": np.array([0, -1, -1, -1], np.int32),
            "count": 1, "kf_poses": poses,
            "frame": {k: item[k] for k in ("direction", "rgb", "depth")},
            "pose": item["c2w"],
            "draws": [(rng.integers(0, n, 64), rng.integers(0, 768, 16),
                       rng.uniform(size=(80, S)).astype(np.float32))]}
    outs = []
    for k in ({}, keys):
        run = {"overrides": _overrides(k),
               "num_kf": 4, "rays_per_kf": n, "params": params,
               "calls": [call]}
        outs.append(run_optimize(run, rows=True, mesh=True))
    assert outs[0]["metrics"] == outs[1]["metrics"]
    for a, b in zip(jax.tree.leaves(outs[0]["params"]),
                    jax.tree.leaves(outs[1]["params"])):
        np.testing.assert_array_equal(a, b)


def _port_params(cfg):
    from mneslam_tpu_torch.models.scene_rep import SceneRep
    from mneslam_tpu_torch.utils.convert import params_to_numpy

    return params_to_numpy(SceneRep(cfg, "cpu").init_params(
        torch.Generator().manual_seed(3)))
