"""Command-line entry: one agent or several, SLAM or mapping-only mode.

    python -m mneslam_tpu_torch.cli --config CONFIG.yaml \
        [--num_agents N] [--mode slam|mapping] [--output OUT] \
        [--device cuda|cpu] [--resume FULL_STATE.npz] [--file_comms] \
        [--spawn]

Runs on the GPU by default and raises when there is none, unless
`--device cpu` is given. `--mode` overrides the config's `mode`.
`--resume` restores a full-state checkpoint (`MNESLAM.save_full_state`)
before the run, which then continues from it; with N > 1 agents agent
`rank` reads `PATH.agent<rank>`. A SLAM run prints its APE (Sim(3)) line at
the end and returns it in the result's "ate". `main` returns one agent's
result, or N agents' as a list.

With N > 1 agents (`--num_agents`, alias `--num_gpus`) each agent reads
`CONFIG_agent<rank>.yaml` where that file exists, else CONFIG. The agents
(one included) run through `agents/runner.MultiAgentRunner`: round-robin
in one process on one device, exchanging through memory; `--file_comms`
exchanges through the on-disk protocol under `<output>/<exp_name>/`
instead, and `--spawn` runs each agent as its own OS process over that
protocol (each child gets the parent's `--device`).

`--device_mesh` runs the agents as one mesh fleet
(`parallel/fleet.MeshAgentFleet`): on one device every agent sits in one
slice, and each round maps every agent's pending keyframe in one
super-step.

Under `torchrun --nproc_per_node=N` (WORLD_SIZE > 1) the ranks form one
world (`parallel/mesh.init_world`: NCCL with cuda:LOCAL_RANK when every
rank has a GPU of its own, gloo for `--device cpu` or for more ranks than
GPUs; the choice is printed). With `--device_mesh` the world runs the
composed fleet, agents x row groups: every rank builds the mesh once
(`parallel/mesh.make_mesh(num_agents)`, R ranks a slice), rank r builds
agent r // R from its config, the slice's first rank leads the agent
(the fleet's rounds, every output of `agent_<id>/`; it prints `agent
<id>: <result>`) and the others follow its map calls, row-sharded over the
slice with `mapping.shard_plane_rows`. Without `--device_mesh` the world
runs one agent whose mapper is row-sharded over every rank
(`mapping.shard_plane_rows` must be set): rank 0 leads, the other ranks
follow. One process starts no world. Port of `mneslam_tpu/cli.py`.
"""

from __future__ import annotations

import argparse
import os


def derive_agent_config(config_path: str, rank: int) -> str:
    """`X_agent<rank>.yaml` beside `X.yaml` when it exists, else X."""
    base, ext = os.path.splitext(config_path)
    cand = f"{base}_agent{rank}{ext}"
    return cand if os.path.exists(cand) else config_path


def _spawn_processes(args):
    """One OS process per agent over the on-disk FileComms protocol; each
    child runs at its own pace and polls the shared output tree for the
    others' descriptors, keyframes and checkpoints. Raises SystemExit when
    a child fails."""
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "mneslam_tpu_torch.cli",
           "--config", args.config, "--num_agents", str(args.num_agents),
           "--spawn", "--device", args.device]
    for flag in ("output", "mode", "resume"):
        if getattr(args, flag):
            cmd += [f"--{flag}", getattr(args, flag)]
    procs = []
    for rank in range(args.num_agents):
        print(f"spawning agent {rank}/{args.num_agents} ...", flush=True)
        procs.append(subprocess.Popen(cmd + ["--spawn_rank", str(rank)]))
    codes = [p.wait() for p in procs]
    for rank, rc in enumerate(codes):
        print(f"agent {rank}: exit {rc}")
    if any(codes):
        raise SystemExit(f"agent process failed: exit codes {codes}")
    return codes


def _load_config(args, path):
    from .config import default_config, deep_update, load_config

    cfg = deep_update(default_config(), load_config(path))
    if args.output:
        cfg["data"]["output"] = args.output
    if args.mode is not None:
        cfg["mode"] = args.mode
    return cfg


def _fleet_world(args, rank: int, device: str):
    """The composed fleet over a world of ranks: this rank's agent, led
    through `parallel/fleet.ComposedFleet` on the slice's first rank,
    following its leader's map calls on the others -> the leader's
    result (None on a follower)."""
    from .data.datasets import get_dataset
    from .parallel import fleet as pfleet
    from .parallel.mesh import make_mesh
    from .slam import MNESLAM

    n = args.num_agents
    mesh = make_mesh(n)
    agent = rank // int(mesh.shape["ray"])
    cfg = _load_config(args, derive_agent_config(args.config, agent)
                       if n > 1 else args.config)
    pfleet.composed_layout(mesh, n, bool(cfg["mapping"].get(
        "shard_plane_rows", False)))
    slam = MNESLAM(cfg, get_dataset(cfg), rank=agent, device=device,
                   world_size=n, mesh=mesh)
    if args.resume:
        slam.load_full_state(args.resume if n == 1
                             else f"{args.resume}.agent{agent}")
    if slam.follower:
        slam.follow()
        return None
    try:
        fleet = pfleet.ComposedFleet([slam], mesh=mesh, n_agents=n)
        if slam.mode == "mapping":
            fleet.run_mapping_only()
            result = slam.terminate()
        else:
            result = fleet.run_slam()[0]
    finally:
        slam.release_followers()
    print(f"agent {agent}: {result}")
    return result


def _row_sharded_world(args, rank: int, device: str):
    """One agent over a world of ranks: rank 0 runs it with the
    row-sharded mapper, the others follow its map calls -> rank 0's
    result (None on a follower)."""
    from .agents.runner import MultiAgentRunner
    from .data.datasets import get_dataset
    from .slam import MNESLAM

    if args.spawn or args.file_comms:
        raise NotImplementedError(
            "--spawn and --file_comms run one process per agent, without "
            "torchrun; several agents over a world of ranks run as the "
            "mesh fleet (--device_mesh)")
    if args.num_agents > 1:
        raise NotImplementedError(
            "several agents over a world of ranks run as the mesh fleet: "
            "pass --device_mesh")
    cfg = _load_config(args, args.config)
    if not bool(cfg["mapping"].get("shard_plane_rows", False)):
        raise ValueError("a world of several ranks runs the row-sharded "
                         "mapper: set mapping.shard_plane_rows")
    # the agent's rank is 0 on every process: its generators are seeded
    # by it, never by the process's rank
    agent = MNESLAM(cfg, get_dataset(cfg), rank=0, device=device)
    if args.resume:
        agent.load_full_state(args.resume)
    if agent.follower:
        agent.follow()
        return None
    try:
        runner = MultiAgentRunner([agent])
        if agent.mode == "mapping":
            runner.run_mapping_only()
            result = agent.terminate()
        else:
            result = runner.run_slam()[0]
    finally:
        agent.release_followers()
    print(f"agent 0 (rank {rank} of a row-sharded world): {result}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="MNESLAM multi-agent SLAM (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--num_agents", "--num_gpus", type=int, default=1,
                    dest="num_agents")
    ap.add_argument("--mode", choices=["slam", "mapping"], default=None,
                    help="default: the config's mode (slam if unset)")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu only "
                         "when asked for)")
    ap.add_argument("--file_comms", action="store_true",
                    help="exchange through the on-disk protocol")
    ap.add_argument("--spawn", action="store_true",
                    help="run each agent as its own OS process over the "
                         "on-disk protocol")
    ap.add_argument("--spawn_rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # a spawned child's rank
    ap.add_argument("--device_mesh", action="store_true",
                    help="run the agents as a mesh fleet: one mapping "
                         "super-step per round")
    ap.add_argument("--resume", default=None,
                    help="full-state checkpoint to restore before running")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from .parallel.mesh import init_world

    started_here = not dist.is_initialized()
    rank, world, device = init_world(args.device)
    if world > 1:
        try:
            if args.device_mesh and not (args.spawn or args.file_comms):
                return _fleet_world(args, rank, device)
            return _row_sharded_world(args, rank, device)
        finally:
            if started_here:
                dist.destroy_process_group()
    if args.spawn and args.num_agents > 1 and args.spawn_rank is None:
        return _spawn_processes(args)

    from .agents.comms import FileComms, InMemoryComms
    from .agents.runner import MultiAgentRunner
    from .data.datasets import get_dataset
    from .slam import MNESLAM

    ranks = (list(range(args.num_agents)) if args.spawn_rank is None
             else [args.spawn_rank])
    agents = []
    for rank in ranks:
        path = (derive_agent_config(args.config, rank)
                if args.num_agents > 1 else args.config)
        cfg = _load_config(args, path)
        agent = MNESLAM(cfg, get_dataset(cfg), rank=rank, device=args.device,
                        world_size=args.num_agents)
        if args.resume:
            agent.load_full_state(args.resume if args.num_agents == 1
                                  else f"{args.resume}.agent{rank}")
        agents.append(agent)

    if args.device_mesh:
        from .parallel.fleet import MeshAgentFleet

        fleet = MeshAgentFleet(agents)
        if agents[0].mode == "mapping":
            fleet.run_mapping_only()
            results = [a.terminate() for a in agents]
        else:
            results = fleet.run_slam()
        for rank, r in zip(ranks, results):
            print(f"agent {rank}: {r}")
        return results[0] if args.num_agents == 1 else results

    if args.file_comms or args.spawn_rank is not None:
        cfg = agents[0].config
        comms = FileComms(os.path.join(cfg["data"]["output"],
                                       cfg["data"]["exp_name"]),
                          rank=ranks[0])
    else:
        comms = InMemoryComms()
    # one agent runs through the runner too, as in the JAX package: it
    # publishes, and closes loops with itself when loop_detection is on
    runner = MultiAgentRunner(agents, comms=comms)
    if agents[0].mode == "mapping":
        runner.run_mapping_only()
        results = [a.terminate() for a in agents]
    else:
        results = runner.run_slam()
    for rank, r in zip(ranks, results):
        print(f"agent {rank}: {r}")
    return results[0] if args.num_agents == 1 else results


if __name__ == "__main__":
    main()
