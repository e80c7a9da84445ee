#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip.

    python3 benchmark/calibrate.py --workload room0.mapping \
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7,8,9 \
        --seconds 4 --faults half_batch \
        --out chiprun_out/calib/room0.mapping.json

For each of `--seeds`: one run of the cell at its own size (a window of
`--seconds`, at least one step) and the numbers it compares. For each of
`--control-seeds`: the control, the reference in TF32 in the program's
place. For each fault the cell's traffic can have (`--faults`: those
named) and each of `--fault-seeds`: a run with that fault planted under
the timed path. Writes every reading to `--out` and prints one line a
reading. Not a run of the benchmark: nothing is timed.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

def ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--fault-seeds", type=ints, default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--faults", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    found, _ = harness.context(args.workload, 0, "cuda")
    drv = harness.driver(found["traffic"]["kind"])
    out = {"workload": args.workload, "device":
           torch.cuda.get_device_name(0), "sound": [], "control": [],
           "faults": []}

    def emit(group, entry):
        out[group].append(entry)
        print(group, json.dumps(entry), flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             "cuda")
        emit("sound", {"seed": seed, "numbers": r["numbers"],
                       "attempted": r["attempted"],
                       "s": time.perf_counter() - t})
    for seed in args.control_seeds:
        _, ctx = harness.context(args.workload, seed, "cuda")
        emit("control", {"seed": seed, "numbers": drv.control(ctx)})
    faults = [f for f in args.faults.split(",") if f] or drv.FAULTS
    for fault in faults:
        for seed in args.fault_seeds:
            r = harness.run_cell(args.workload, seed, 0.0, False, "cuda",
                                 fault=fault)
            emit("faults", {"fault": fault, "seed": seed,
                            "numbers": r["numbers"]})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
