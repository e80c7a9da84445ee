"""One run of one cell, found by name in BENCHMARK.json.

A cell names a configuration (`configs/<config>.json`: the configuration
as it is run, with its source, its cuts and what the benchmark assumed)
and a traffic mix (`traffic/<traffic>.json`: parameters read by the driver
of its `kind`, `drive/<kind>.py`). Each per-layer metric is a reader of its
own, `metrics/<metric>.py`. A new cell, configuration, mix or metric is a
new file and a new entry in BENCHMARK.json.

A run: set-up (inputs and weights from the seed, the program built, its
first steps driven and captured for the comparison, every shape of the
window warmed), one warm step, then the window: whole steps until
`--seconds` have passed, closed by a synchronisation. With `--trace 1`
the benchmark's spans are synchronised and the per-layer metrics are read
from `trace_steps` whole steps without the profiler (host-clock spans)
and as many under it (the device trace). After the window the peak memory is read, the program's state is
freed and the reference judges what the program produced.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import trace as trace_lib

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mneslam_tpu")


class Refused(RuntimeError):
    """A run that must print no result."""


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: Dict, workload: str) -> Dict:
    """-> {"cell", "config" (the configurations entry), "config_file" (its
    file's contents), "traffic" (the mix's parameters), "end_to_end",
    "per_layer" (the metric entries this cell reports)}."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json "
                      f"(have {sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = _read_json(os.path.join(HERE, "traffic",
                                      f"{cell['traffic']}.json"))

    def mine(m):
        return workload in m.get("workloads", [workload])

    return {"cell": cell, "config": conf,
            "config_file": _read_json(os.path.join(ROOT, conf["file"])),
            "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def driver(kind: str):
    return importlib.import_module(f"benchmark.drive.{kind}")


def reader(metric: str):
    """The reader of a per-layer metric: `metrics/<metric>.py`'s `read`."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def limits(workload: str) -> Dict[str, float]:
    return _read_json(os.path.join(HERE, "limits", f"{workload}.json"))


def derive_seed(seed: int, salt: int) -> int:
    """A 63-bit seed for one input stream of a run's seed."""
    return (int(seed) * 1000003 + salt * 7919 + 17) % (2 ** 63 - 1)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Context:
    """What a driver gets: the configuration as run, the mix, the seed,
    the device, the spans and (tests only) a fault to plant."""

    def __init__(self, found: Dict, seed: int, device: torch.device,
                 spans: trace_lib.Spans, out_dir: str,
                 overrides: Optional[Dict] = None,
                 fault: Optional[str] = None):
        cfg = copy.deepcopy(found["config_file"]["config"])
        if overrides:
            _deep_update(cfg, overrides.get("config", {}))
        traffic = copy.deepcopy(found["traffic"])
        if overrides:
            traffic.update(overrides.get("traffic", {}))
        self.cfg = cfg
        self.assumed = found["config_file"].get("assumed", {})
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.spans = spans
        self.out_dir = out_dir
        self.fault = fault

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def _deep_update(base: Dict, over: Dict) -> Dict:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def context(workload: str, seed: int, device="cuda",
            overrides: Optional[Dict] = None, fault: Optional[str] = None,
            out_dir: str = "", traced: bool = False,
            root: str = ROOT) -> Tuple[Dict, "Context"]:
    """-> (the cell as `find_cell` gives it, a driver's Context)."""
    device = torch.device(device)
    found = find_cell(load_benchmark(root), workload)
    return found, Context(found, seed, device,
                          trace_lib.Spans(traced, device), out_dir,
                          overrides, fault)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", overrides: Optional[Dict] = None,
             fault: Optional[str] = None, t_start: Optional[float] = None,
             root: str = ROOT) -> Dict:
    """One run -> the result's object (the last line's keys; the numbers
    compared, each with its limit from `limits/<workload>.json`, under
    "compared", last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="mneslam_bench_") as out_dir:
        found, ctx = context(workload, seed, device, overrides, fault,
                             out_dir, traced, root)
        drv = driver(found["traffic"]["kind"])
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state = drv.setup(ctx)
        drv.step(ctx, state)                       # the warm step
        ctx.sync()
        setup_s = time.perf_counter() - t_start

        view = None
        steps = work = 0
        if not traced:
            t0 = time.perf_counter()
            while not drv.full(ctx, state):
                work += drv.step(ctx, state)
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            ctx.sync()
            window_s = time.perf_counter() - t0
        else:
            view, window_s, steps, work = _traced_window(ctx, drv, state)
        if device.type == "cuda":
            peak = max(torch.cuda.max_memory_allocated(i)
                       for i in range(torch.cuda.device_count()))
        else:
            peak = 0
        bad = forbidden_modules()
        if bad:
            raise Refused(f"modules of JAX or the JAX package are loaded: "
                          f"{bad}")
        attempted, failed = drv.outcome(ctx, state, steps)
        if traced:
            metrics = {}
            for m in found["per_layer"]:
                v = reader(m["name"])(view)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = drv.end_to_end(ctx, state, work, steps, window_s)
            e2e["setup_s"] = setup_s
            metrics = {}
            for m in found["end_to_end"]:
                if m["name"] not in e2e:
                    raise Refused(f"the driver reports no {m['name']}")
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        check_state = drv.release(ctx, state)
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = drv.check(ctx, check_state)
    lim = limits(workload)
    compared = {k: {"value": numbers.get(k, math.inf), "limit": v}
                for k, v in lim.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values()) and failed == 0
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if traced:
        busy = view.busy_us(*view.window_us) * 1e-6 if view.window_us \
            else 0.0
        dev["busy_s"] = busy
        dev["window_s"] = window_s
        if view.window_us:
            result["breakdown"] = trace_lib.breakdown(view)
    result["numbers"] = numbers          # every reading, for calibration
    result["compared"] = compared
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules of JAX or the JAX package are loaded: {bad}")
    return result


def _traced_window(ctx, drv, state):
    """Two phases of `trace_steps` whole steps each, spans on: the first
    without the profiler, for the host-clock span metrics (the profiler's
    cost per launch would be in them), the second under the profiler (the
    device's activity only), for the device metrics -> (View, the second
    phase's window_s, steps, work). On the CPU nothing is profiled: there
    is no device trace to read."""
    from torch.profiler import ProfilerActivity, profile

    cuda = ctx.device.type == "cuda"
    n = int(ctx.traffic["trace_steps"])
    drv.trace_begin(ctx, state)

    def steps_of(count):
        steps = work = 0
        while steps < count and not drv.full(ctx, state):
            with ctx.spans.span("step"):
                work += drv.step(ctx, state)
            steps += 1
        return steps, work

    steps_of(n)
    host_spans = ctx.spans
    ctx.spans = trace_lib.Spans(True, ctx.device)   # the drivers' spans
    with profile(activities=[ProfilerActivity.CUDA] if cuda else
                 [ProfilerActivity.CPU]) as prof:
        ctx.sync()
        t0 = time.perf_counter()
        if cuda:
            torch.cuda._sleep(1000)          # the marker of the window
        steps, work = steps_of(n)
        if cuda:
            torch.cuda._sleep(1000)          # the marker of its end
        ctx.sync()
        window_s = time.perf_counter() - t0
    extra = drv.trace_end(ctx, state)
    ops, notes, window = trace_lib.collect(prof, ctx.spans, t0, window_s) \
        if cuda else ([], [], None)
    view = trace_lib.View(spans=host_spans, window_s=window_s, work=work,
                          steps=steps, device_ops=ops, annotations=notes,
                          window_us=window, extra=extra)
    return view, window_s, steps, work


def main(args) -> int:
    """The command line's run: refuses without enough CUDA devices or with
    JAX loaded; prints the compared numbers as the last lines of standard
    error and the result as the last line of standard output."""
    t_start = args.t_start
    try:
        bench = load_benchmark()
        found = find_cell(bench, args.workload)
        chips = int(found["cell"]["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA device(s); "
                          f"torch.cuda.is_available() is "
                          f"{torch.cuda.is_available()}")
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start=t_start)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    del result["numbers"]
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
