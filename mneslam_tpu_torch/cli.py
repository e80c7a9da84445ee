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
protocol (each child gets the parent's `--device`). Port of
`mneslam_tpu/cli.py`; the device-mesh fleet (`--device_mesh`) is not
ported yet.
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
                    help="agents as device-mesh slices (not ported)")
    ap.add_argument("--resume", default=None,
                    help="full-state checkpoint to restore before running")
    args = ap.parse_args(argv)

    if args.device_mesh:
        raise NotImplementedError(
            "--device_mesh (the mesh agent fleet, parallel/fleet.py) is not "
            "ported yet: ROADMAP.md Queue 1 item 4")
    if args.spawn and args.num_agents > 1 and args.spawn_rank is None:
        return _spawn_processes(args)

    from .agents.comms import FileComms, InMemoryComms
    from .agents.runner import MultiAgentRunner
    from .config import default_config, deep_update, load_config
    from .data.datasets import get_dataset
    from .slam import MNESLAM

    ranks = (list(range(args.num_agents)) if args.spawn_rank is None
             else [args.spawn_rank])
    agents = []
    for rank in ranks:
        path = (derive_agent_config(args.config, rank)
                if args.num_agents > 1 else args.config)
        cfg = deep_update(default_config(), load_config(path))
        if args.output:
            cfg["data"]["output"] = args.output
        if args.mode is not None:
            cfg["mode"] = args.mode
        agent = MNESLAM(cfg, get_dataset(cfg), rank=rank, device=args.device,
                        world_size=args.num_agents)
        if args.resume:
            agent.load_full_state(args.resume if args.num_agents == 1
                                  else f"{args.resume}.agent{rank}")
        agents.append(agent)

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
