"""The readings that a cell's limits are set from, on the chip at the
cell's own size (the benchmark's runs do not run this):

    python3 perfbench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out file.jsonl]

For every seed of ``--seeds`` the program's reading: a training cell's
set-up (its checked steps) against the reference, a serving cell's set-up
and a short window (``--seconds``) whose sampled answers the reference
checks.  For every seed of ``--control-seeds`` the control's: the
reference one precision step below the configuration's in the program's
place, and for a training cell the fault of a half batch (the loss and
gradient of half the minibatch) in the reference; a state left unchanged
reads 1 on the change numbers and needs no run.  Each reading is one JSON
line.  All seeds run in one process.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.lib import serving  # noqa: E402
from perfbench.reference.common import CONTROL_ROUNDING  # noqa: E402


def readings(bench, workload, seeds, control_seeds, seconds, device,
             root=ROOT):
    """The readings, one dict per seed and kind (module docstring)."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)

    def context(seed):
        return harness.Context(root, bench, cell, seed, seconds, False,
                               device)

    probe = context(0)
    name = probe.traffic["entry"]
    entry = harness.load_module(
        Path(root) / "perfbench" / "entries" / (name + ".py"),
        "perfbench_entry_" + name)
    training = hasattr(entry, "reference_record")
    for seed in seeds:
        ctx = context(seed)
        t0 = time.perf_counter()
        st = entry.setup(ctx)
        if not training:
            ctx.window = entry.window(ctx, st)
        entry.release(ctx, st)
        yield {"kind": "program", "seed": seed,
               "numbers": entry.check(ctx, st),
               "seconds": time.perf_counter() - t0}
        del st
        torch.cuda.empty_cache() if device == "cuda" else None
    for seed in control_seeds:
        ctx = context(seed)
        st = entry.inputs(ctx)
        rounding = CONTROL_ROUNDING[ctx.config["compute_dtype"]]
        if training:
            k = ctx.traffic["checked_steps"]
            want = entry.reference_record(ctx, st, [None] * k)
            ctl = entry.reference_record(ctx, st, entry.control_roundings(ctx))
            half = entry.reference_record(ctx, st, [None] * k,
                                          half_batch=True)
            yield {"kind": "control", "seed": seed,
                   "roundings": entry.control_roundings(ctx),
                   "numbers": entry.numbers(ctl, want, st["params0"])}
            yield {"kind": "fault_half_batch", "seed": seed,
                   "numbers": entry.numbers(half, want, st["params0"])}
        else:
            batches = range(int(ctx.traffic["sample_requests"]))
            yield {"kind": "control", "seed": seed, "rounding": rounding,
                   "numbers": serving.control_gaps(
                       ctx, st, entry.reference_logits, rounding, batches)}
        del st
        torch.cuda.empty_cache() if device == "cuda" else None


def main(argv):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    out = open(args.out, "a") if args.out else None
    for rec in readings(bench, args.workload, ints(args.seeds),
                        ints(args.control_seeds), args.seconds, args.device):
        rec["workload"] = args.workload
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
