"""Ranks of the port's distributed CPU tests, each its own process.

    python -m tests._torch_dist CASE RANK WORLD STORE IN OUT

`run_ranks(case, world, tmp_path, payload)` starts WORLD such processes
(gloo on the CPU, one thread each), which join one process group through a
`file://` store under tmp_path (no port is opened) with a 60 s timeout on
every collective, run `CASES[case](rank, world, payload)` and save its
result; the caller waits at most 60 s for them, and fails when a rank
fails or hangs. Imports no JAX: the ranks run the port alone.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 60.0


def run_ranks(case: str, world: int, tmp_path, payload,
              timeout: float = JOIN_TIMEOUT_S) -> list:
    """Run `case` on `world` ranks -> each rank's result, in rank order."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    src = os.path.join(tmp, f"{case}_in.pt")
    torch.save(payload, src)
    store = os.path.join(tmp, f"{case}_store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        out = os.path.join(tmp, f"{case}_out{rank}.pt")
        log = open(os.path.join(tmp, f"{case}_log{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dist", case, str(rank),
             str(world), store, src, out], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), out, log))
    deadline = time.monotonic() + timeout
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    codes = [p.returncode for p, _, _ in procs]
    if any(codes):
        logs = [open(log.name).read()[-3000:] for _, _, log in procs]
        raise AssertionError(f"{case}: rank exit codes {codes} (killed "
                             f"after {timeout:.0f} s if negative)\n"
                             + "\n".join(logs))
    return [torch.load(out, weights_only=False) for _, out, _ in procs]


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def case_seam(rank, world, p):
    """The collective seam on this rank's block: the table, and the block's
    cotangent for this rank's table cotangent, by the seam and by
    consume(gather)."""
    from mneslam_tpu_torch.parallel import mesh as pm

    C, H, W = p["shape"]
    group = pm.make_mesh(1).group()
    pad_h = -(-H // world) * world
    out = {}
    for fold in ("after", "before"):
        seam = pm.make_row_sharded_pack(group, (C, H, W), pad_h, fold=fold)
        flat = torch.as_tensor(p["x"]).permute(1, 2, 0).reshape(H * W, C)
        flat = torch.cat([flat, flat.new_zeros(((pad_h - H) * W, C))])
        blk = flat[rank * seam.B:(rank + 1) * seam.B].clone()
        d = torch.as_tensor(p["d"][rank])
        x = blk.clone().requires_grad_(True)
        table = seam(x)
        (table * d).sum().backward()
        x2 = blk.clone().requires_grad_(True)
        (seam.consume(x2, seam.gather(x2)) * d).sum().backward()
        out[fold] = {"table": _np(table), "grad": _np(x.grad),
                     "grad_consume": _np(x2.grad)}
    return out


def _mapper_from_run(run, rows: bool, mesh, shard_axes=None):
    """The port's mapper and state of `run` (see `run_optimize`), before
    its first call's keyframe DB is loaded. `mesh`: a `Mesh`, True (every
    rank in one slice) or False."""
    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
    from mneslam_tpu_torch.models.scene_rep import SceneRep
    from mneslam_tpu_torch.parallel import mesh as pm
    from mneslam_tpu_torch.utils.convert import params_from_jax

    cfg = make_config(run["overrides"])
    if mesh is True:
        mesh = pm.make_mesh(1)
    m = Mapper(cfg, SceneRep(cfg, "cpu"), num_kf=run["num_kf"],
               rays_per_kf=run["rays_per_kf"], mesh=mesh or None,
               shard_plane_rows=rows, shard_axes=shard_axes)
    st = m.init_state(torch.Generator().manual_seed(0))
    st.params = params_from_jax(run["params"])
    st.optimizer = make_optimizer(cfg, st.params)
    return m, st


def _load_call(st, call):
    """A call's keyframe DB, keyframe poses, frame and pose into `st` ->
    (frame, pose, draws)."""
    st.db.rays.copy_(torch.tensor(call["db_rays"]))
    st.db.frame_ids.copy_(torch.tensor(call["frame_ids"]))
    st.db.count = int(call["count"])
    st.kf_poses.copy_(torch.tensor(call["kf_poses"]))
    frame = {k: torch.tensor(v) for k, v in call["frame"].items()}
    # u may be a dict of uniform parts (`models.scene_rep.uniforms`)
    draws = [tuple({k: torch.tensor(v) for k, v in a.items()}
                   if isinstance(a, dict) else torch.tensor(a) for a in d)
             for d in call["draws"]]
    return frame, torch.tensor(call["pose"]), draws


def run_optimize(run, rows: bool = True, mesh=True,
                 shard_axes=None) -> dict:
    """The port's mapper from `run["params"]` (a JAX params tree), then
    `optimize` once per entry of `run["calls"]` on that call's keyframe
    DB, keyframe poses, frame and pose, with its replayed draws (one
    (g_idx, c_idx, u) per iteration) -> per-call metrics, the parameters
    and Adam's step per leaf. `mesh`: True over every rank of the world,
    or a `Mesh` whose `shard_axes` ranks shard (row-sharded with `rows`,
    else ray-sharded)."""
    from mneslam_tpu_torch.models.scene_rep import param_items
    from mneslam_tpu_torch.utils.convert import params_to_numpy

    m, st = _mapper_from_run(run, rows, mesh, shard_axes)
    metrics = []
    for call in run["calls"]:
        frame, pose, draws = _load_call(st, call)
        st, met = m.optimize(st, frame, pose, None, iters=len(draws),
                             draws=draws)
        metrics.append({k: float(v) for k, v in met.items()})
    steps = {path: int(st.optimizer.state[t]["step"])
             for path, t in param_items(st.params)}
    return {"metrics": metrics, "params": params_to_numpy(st.params),
            "steps": steps, "n_global": m.n_global, "n_cur": m.n_cur}


def run_gradients(run, rows: bool = True, mesh: bool = True) -> list:
    """`Mapper.gradients` on the first call's first draws -> one numpy
    array per parameter leaf."""
    m, st = _mapper_from_run(run, rows, mesh)
    frame, pose, draws = _load_call(st, run["calls"][0])
    return [_np(g) for g in m.gradients(st, frame, pose, None,
                                        draws=draws[0])]


def case_gradients(rank, world, p):
    """`run_gradients` row-sharded and ray-sharded over the world."""
    return {"rows": run_gradients(p, rows=True),
            "rays": run_gradients(p, rows=False)}


def case_optimize(rank, world, p):
    """`run_optimize` for every run of the payload."""
    return [run_optimize(run, rows=run.get("rows", True)) for run in p]


def case_composed_optimize(rank, world, p):
    """The mapper of agent rank // R on the (agent, ray) mesh of
    len(p) agents, row-sharded over its slice (shard_axes ("ray",)):
    `run_optimize` of that agent's run -> (agent, the run's result)."""
    from mneslam_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(len(p))
    agent = rank // int(mesh.shape["ray"])
    return agent, run_optimize(p[agent], mesh=mesh, shard_axes=("ray",))


def case_descriptors(rank, world, p):
    """MeshComms over an agent axis of `world` slices: each rank writes its
    agent's descriptors into its block, then reads every agent's."""
    from mneslam_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(world)
    local = torch.as_tensor(p["descs"][rank:rank + 1])
    return {"shape": mesh.shape,
            "gathered": _np(pm.all_gather_descriptors(local, mesh))}


def case_mesh(rank, world, p):
    """`make_mesh` on this world: the clamped shapes, and each axis
    group's size, index and source rank with a sum, a gather, a broadcast
    from index 0 and from the last index, and a metadata all-gather over
    it; whether this rank may take the leaders' group."""
    from mneslam_tpu_torch.parallel import mesh as pm

    shapes = {n: pm.make_mesh(n).shape for n in p["n_agents"]}
    mesh = pm.make_mesh(p["grid"])
    out = {"shapes": shapes, "groups": {}}
    for axes in (("agent",), ("ray",), ("agent", "ray")):
        g = mesh.group(axes)
        x = torch.tensor([float(rank)])
        out["groups"]["/".join(axes)] = {
            "size": g.size, "index": g.index, "src": g.src,
            "sum": float(pm.all_reduce(x, g)),
            "gather": pm.all_gather_rows(x, g).tolist(),
            "bcast": float(pm.broadcast(x.clone(), g)),
            "bcast_last": float(pm.broadcast(x.clone(), g,
                                             root=g.size - 1)),
            "values": pm.all_gather_values([rank, 7 * rank], g).tolist()}
    try:
        out["leaders_size"] = mesh.leaders().size
    except ValueError:
        out["leaders_size"] = None
    return out


def case_slam(rank, world, p):
    """`MNESLAM` with mapping.shard_plane_rows: rank 0 runs the agent
    (mapping-only, or SLAM with the oracle update), the others follow."""
    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.models.scene_rep import param_leaves
    from mneslam_tpu_torch.slam import MNESLAM
    from mneslam_tpu_torch.tools.validate_dataset import OracleMNESLAM

    cfg = make_config(p["overrides"])
    ds = SyntheticBoxDataset(cfg, num_frames=p["num_frames"])
    cls = OracleMNESLAM if (cfg["mode"] == "slam" and rank == 0) else MNESLAM
    slam = cls(cfg, ds, rank=0, device="cpu")
    out = {"shard_rows": slam.mapper.shard_rows, "follower": slam.follower,
           "group_size": slam.mapper.group.size,
           "tracker": slam.tracker is not None}
    if slam.follower:
        slam.follow()
    elif cfg["mode"] == "slam":
        res = slam.run_slam()
        out.update(ate=res["ate"]["rmse"], counter=slam.tracker.counter,
                   mapped=len(slam.mapped_timestamps))
    else:
        slam.run_mapping_only(log_every=100)
        slam.release_followers()
    out["metrics"] = slam.metrics_log
    out["params"] = [_np(t) for t in param_leaves(slam.map_state.params)]
    out["kf_poses"] = _np(slam.map_state.kf_poses)
    out["db_count"] = slam.map_state.db.count
    return out


def case_cli(rank, world, p):
    """`cli.main` in a started world: the row-sharded run, or the fleet's
    refusal."""
    from mneslam_tpu_torch import cli

    try:
        res = cli.main(p["argv"])
    except NotImplementedError as e:
        return {"raised": str(e)}
    return {"result": None if res is None else
            {k: v for k, v in res.items() if k != "ate"}}


class Slice:
    """Frames [lo, hi) of a dataset, frame ids from 0
    (tests/test_torch_multiagent.py's)."""

    def __init__(self, ds, lo, hi):
        self.ds, self.lo, self.n = ds, lo, hi - lo
        self.num_rays_to_save = ds.num_rays_to_save

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        item = self.ds[self.lo + i]
        item["frame_id"] = i
        return item


def record_matches(collab) -> list:
    """Wrap the collaboration's loop detector: -> the list it appends
    (agent, kf id, match agent, match kf id) to for every match."""
    found = []
    det = collab.loop_detector

    def match(des, kf, agent, orig=det.match):
        info = orig(des, kf, agent)
        if info is not None:
            found.append((agent, kf, int(info["match_agent_id"]),
                          int(info["match_kf_id"])))
        return info
    det.match = match
    return found


def fleet_agents(p, mesh=None, rank=0):
    """The agents of a fleet run `p` (overrides, num_frames, segments):
    all of them in one process (no mesh), or this rank's agent of `mesh`
    (its slice's leader or a follower)."""
    import copy

    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.slam import MNESLAM
    from mneslam_tpu_torch.tools.validate_dataset import OracleMNESLAM

    cfg = make_config(p["overrides"])
    ds = SyntheticBoxDataset(cfg, num_frames=p["num_frames"])
    segs = p["segments"]
    mine = range(len(segs)) if mesh is None else \
        [rank // int(mesh.shape["ray"])]
    out = []
    for r in mine:
        lead = mesh is None or mesh.group(("ray",)).index == 0
        cls = OracleMNESLAM if cfg["mode"] == "slam" and lead else MNESLAM
        out.append(cls(copy.deepcopy(cfg), Slice(ds, *segs[r]), rank=r,
                       world_size=len(segs), device="cpu", mesh=mesh))
    return out


def fleet_result(fleet, agents, loops, results=None) -> dict:
    """What a fleet's agents did: per agent its mapped keyframes, losses,
    tracker and map counters, collaboration counters, closure, map, APE
    (`results`: the terminates' results by agent, in SLAM mode) and the
    descriptor DB's (agent, kf) keys."""
    from mneslam_tpu_torch.models.scene_rep import param_leaves

    out = {"loops": loops, "db": sorted(
        (int(e["agent_id"]), int(e["kf_id"]))
        for e in fleet.comms.descriptors()), "agents": {}}
    for a, c in zip(agents, fleet.collabs):
        out["agents"][a.rank] = {
            "mapped": list(a.mapped_timestamps),
            "losses": [float(m["loss"]) for m in a.metrics_log],
            "counter": None if a.tracker is None else a.tracker.counter,
            "map_counter": a.map_counter,
            "accepted": c.closures_accepted, "rejected": c.closures_rejected,
            "alignments": c.alignments, "distillations": c.distillations,
            "aligned": c.aligned_poses_c2w,
            "closure": (c.closure_relative, c.closure_loop_ts),
            "kf_poses": _np(a.map_state.kf_poses),
            "raw": a.kf_poses_raw(len(a.mapped_timestamps)),
            "params": [_np(t) for t in param_leaves(a.map_state.params)],
            "ate": None if results is None else
            results[a.rank]["ate"]["rmse"]}
    return out


def case_fleet(rank, world, p):
    """The composed fleet on this world: rank r builds agent r // R on its
    segment; the slice's leader runs `ComposedFleet` (mapping-only, or
    SLAM with the oracle update, then terminate), the others follow ->
    the rank's role and, on a leader, `fleet_result`."""
    from mneslam_tpu_torch.models.scene_rep import param_leaves
    from mneslam_tpu_torch.parallel import fleet as pf
    from mneslam_tpu_torch.parallel import mesh as pm

    n = len(p["segments"])
    mesh = pm.make_mesh(n)
    rows = bool(p["overrides"]["mapping"].get("shard_plane_rows", False))
    pf.composed_layout(mesh, n, rows)
    slam, = fleet_agents(p, mesh, rank)
    out = {"mesh": dict(mesh.shape), "agent": slam.rank,
           "follower": slam.follower, "shard_rows": slam.mapper.shard_rows}
    if slam.follower:
        slam.follow()
        out["params"] = [_np(t) for t in param_leaves(slam.map_state.params)]
        return out
    note = io.StringIO()
    with contextlib.redirect_stdout(note):
        fleet = pf.MeshAgentFleet([slam], mesh=mesh, n_agents=n)
    out.update(composed=type(fleet).__name__, note=note.getvalue())
    loops = record_matches(fleet.collab)
    if slam.mode == "mapping":
        fleet.run_mapping_only()
        results = None
    else:
        results = {slam.rank: fleet.run_slam()[0]}
    out.update(fleet_result(fleet, [slam], loops, results))
    return out


CASES = {"seam": case_seam, "optimize": case_optimize,
         "gradients": case_gradients, "mesh": case_mesh,
         "descriptors": case_descriptors, "slam": case_slam, "cli": case_cli,
         "fleet": case_fleet, "composed_optimize": case_composed_optimize}


def main(argv):
    import torch.distributed as dist

    case, rank, world, store, src, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = CASES[case](rank, world, torch.load(src, weights_only=False))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, out + ".tmp")
    os.replace(out + ".tmp", out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
