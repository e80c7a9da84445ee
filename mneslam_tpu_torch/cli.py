"""Command-line entry: one agent, SLAM or mapping-only mode.

    python -m mneslam_tpu_torch.cli --config CONFIG.yaml \
        [--mode slam|mapping] [--output OUT] [--device cuda|cpu]

Runs on the GPU by default and raises when there is none, unless
`--device cpu` is given. `--mode` overrides the config's `mode`. Port of
the single-agent paths of `mneslam_tpu/cli.py`; the multi-agent runner is
not ported yet.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="MNESLAM single-agent run (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--mode", choices=["slam", "mapping"], default=None,
                    help="default: the config's mode (slam if unset)")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu only "
                         "when asked for)")
    args = ap.parse_args(argv)

    from .config import default_config, deep_update, load_config
    from .data.datasets import get_dataset
    from .slam import MNESLAM

    cfg = deep_update(default_config(), load_config(args.config))
    if args.output:
        cfg["data"]["output"] = args.output
    if args.mode is not None:
        cfg["mode"] = args.mode
    agent = MNESLAM(cfg, get_dataset(cfg), rank=0, device=args.device)
    if agent.mode == "slam":
        result = agent.run_slam()
    else:
        agent.run_mapping_only()
        result = agent.terminate()
    print(f"agent 0: {result}")
    return result


if __name__ == "__main__":
    main()
