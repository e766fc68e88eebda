"""The benchmark's harness: one cell of ``BENCHMARK.json`` per run.

Everything particular to a cell is found by name:

- ``BENCHMARK.json``'s ``workloads`` entry names its configuration and
  traffic mix; ``configs`` gives the configuration's file;
- ``perfbench/traffic/<traffic>.json``: the mix, whose ``entry`` names the
  module of ``perfbench/entries/`` that drives the program with it;
- ``perfbench/limits/<workload>.json``: the limit of each number that
  decides ``correct``;
- ``perfbench/e2e/<metric>.py`` and ``perfbench/layer_metrics/<metric>.py``:
  each metric's reader, ``read(ctx)`` -> a number, or None where it finds
  nothing to read.

A run: the entry's set-up (the program built from the seed, every shape
warmed, a training cell's first steps), the window (``--seconds``), with
``--trace 1`` a second window of the same length under the profiler, the
device's peak memory over the windows, the program's state freed, the
reference's comparison, then the result: the end-to-end metrics
(``--trace 0``) or the per-layer ones (``--trace 1``).  Readers of the
host's clock read the untraced window, readers of the trace the traced
one, so the profiler's cost stays out of the host-clock numbers.

``setup_s`` is the set-up less the seconds that the benchmark's own
reference spends in it (``Context.reference_time``: the BN statistics of
the seeded weights, calibrated by the reference's forwards).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from perfbench.lib import trace as trace_mod
from perfbench.lib import traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "ams_tpu")


class Context:
    """One run's cell, inputs and findings, as entries and readers see
    them."""

    def __init__(self, root, bench, cell, seed, seconds, trace, device):
        self.root = Path(root)
        self.bench, self.cell, self.name = bench, cell, cell["name"]
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        with open(self.root / conf["file"]) as f:
            self.config = json.load(f)
        self.traffic = traffic_mod.load(self.root, cell["traffic"])
        with open(self.root / "perfbench" / "limits" / (self.name + ".json")) \
                as f:
            self.limits = json.load(f)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.setup_s = None
        self.reference_s = 0.0   # set-up seconds in the benchmark's reference
        self.window = None       # the entry's record of the untraced window
        self.traced_window = None    # ... of the traced window
        self.trace_data = None   # trace_mod.Trace of the traced window
        self.facts = {}          # shapes and counts the entry records
        self.t0 = time.perf_counter()
        self.log_to = sys.stderr

    @contextlib.contextmanager
    def reference_time(self):
        """Counts the block's seconds (the device's work included) as the
        benchmark's, not the program's set-up."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" \
            else (lambda: None)
        sync()
        t = time.perf_counter()
        try:
            yield
        finally:
            sync()
            self.reference_s += time.perf_counter() - t

    def log(self, msg: str) -> None:
        """A line on standard error with the seconds since the run began."""
        print("[%8.2f s] %s" % (time.perf_counter() - self.t0, msg),
              file=self.log_to, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None):
    """The top-level names among ``names`` (default: the loaded modules)
    that are one of ``FORBIDDEN``, compared whole (``ams_tpu_torch`` is
    not ``ams_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metrics(ctx: Context, kind: str) -> dict:
    folder = {"end_to_end": "e2e", "per_layer": "layer_metrics"}[kind]
    out = {}
    for m in ctx.bench[kind]:
        if not applies(m, ctx.name):
            continue
        path = ctx.root / "perfbench" / folder / (m["name"] + ".py")
        mod = load_module(path, "perfbench_metric_"
                          + m["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is None:
            if kind == "end_to_end":
                raise RuntimeError("end-to-end metric %s has no value"
                                   % m["name"])
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return "nvidia-smi failed: %s" % e


def run_cell(root, bench, workload, seed, seconds, trace, device="cuda",
             t0=None, log=sys.stderr):
    """Run one cell and return its result (the dict printed as the last
    line of standard output)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    ctx = Context(root, bench, cell, seed, seconds, trace, device)
    ctx.t0, ctx.log_to = t0, log
    entry = load_module(ctx.root / "perfbench" / "entries"
                        / (ctx.traffic["entry"] + ".py"),
                        "perfbench_entry_" + ctx.traffic["entry"])
    on_card = ctx.device.type == "cuda"

    ctx.log("set-up of %s, seed %d" % (workload, ctx.seed))
    state = entry.setup(ctx)
    traced_ok = trace and on_card and trace_mod.profiler_works()
    ctx.setup_s = time.perf_counter() - t0 - ctx.reference_s
    if on_card:     # the peak of the windows, not of the inputs' making
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.log("window of %g s" % ctx.seconds)
    ctx.window = entry.window(ctx, state)
    windows = [ctx.window]
    if traced_ok:
        ctx.log("traced window of %g s" % ctx.seconds)
        ctx.traced_window, ctx.trace_data = trace_mod.traced(
            lambda: entry.window(ctx, state))
        windows.append(ctx.traced_window)
    if trace and ctx.trace_data is None:
        print("torch.profiler recorded no device time: the device metrics "
              "are not measured", file=log)
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else None
    entry.release(ctx, state)
    if on_card:
        torch.cuda.empty_cache()
    attempted = sum(w["attempted"] for w in windows)
    failed = sum(w["failed"] for w in windows)
    ctx.log("windows closed: %d requests; the reference's check"
            % attempted)
    numbers = entry.check(ctx, state)
    ctx.log("check done")

    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(ctx, kind)
    checks = {}
    for name, value in numbers.items():
        if name in ctx.limits:
            checks[name] = {"value": float(value),
                            "limit": float(ctx.limits[name]["limit"])}
        else:
            print("reading %s %r (not compared; PERF.md)" % (name, value),
                  file=log)
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    found = forbidden_modules()
    if found:
        raise RuntimeError("the run loaded %s" % ", ".join(found))

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if on_card
           else "cpu", "count": 1 if on_card else 0,
           "memory_peak_bytes": peak}
    if trace and ctx.trace_data is not None:
        dev["busy_s"] = ctx.trace_data.busy_s
        dev["window_s"] = ctx.trace_data.window_s
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": dev}
    if trace and ctx.trace_data is not None:
        result["breakdown"] = ctx.trace_data.breakdown()
    result["checks"] = checks
    return result


def main(argv, t0) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print("no workload %r in BENCHMARK.json" % args.workload,
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print("the cell needs %d CUDA device(s); this machine has %d"
              % (cell["chips"], torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 3
    result = run_cell(root, bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0)
    print("card: %s (peaks: bf16 989 TFLOP/s dense, HBM 3.35 TB/s, at "
          "700 W)" % power_line(), file=sys.stderr)
    for name, c in result["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    print(json.dumps(result))
    return 0
