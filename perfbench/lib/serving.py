"""What the serving entries share: the pool of seeded frame batches, the
window's request loop, and the seeded sample of answers that the check
compares."""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from perfbench.lib import compare, frames, seeds
from perfbench.lib.traffic import Schedule


def pool(ctx) -> np.ndarray:
    """``pool_batches`` x ``batch`` seeded frames of the mix's size, made
    on the device and handed to the program as the host array a caller
    holds: (pool_batches, batch, h, w, 3) uint8."""
    tr = ctx.traffic
    n, b = tr["pool_batches"], tr["batch"]
    out = frames.frames(n * b, tr["height"], tr["width"],
                        seeds.sub(ctx.seed, "pool"), ctx.device)
    return out.cpu().numpy().reshape(n, b, tr["height"], tr["width"], 3)


def window(ctx, call, batches: np.ndarray) -> dict:
    """Requests of ``call(frames)`` until ``--seconds`` have passed: the
    next is sent when the last is answered (closed loop), or when it falls
    due (open loop; its latency counts from then).  Keeps a seeded
    reservoir of ``sample_requests`` answers for the check."""
    tr = ctx.traffic
    sched = Schedule(tr, ctx.seed)
    pick = random.Random(seeds.sub(ctx.seed, "sample"))
    k = int(tr["sample_requests"])
    sample, lat = [], []
    i = failed = frames_done = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        due = t0 + sched.next_due()
        if due - t0 >= ctx.seconds:      # falls due after the window
            break
        if tr["loop"] == "open":
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        b = sched.batch(i)
        start = time.perf_counter() if tr["loop"] == "closed" else due
        out = call(batches[b])
        lat.append((time.perf_counter() - start) * 1e3)
        frames_done += len(batches[b])
        if len(sample) < k:
            sample.append((b, out))
        else:
            j = pick.randrange(i + 1)
            if j < k:
                sample[j] = (b, out)
        i += 1
    return {"attempted": i, "failed": failed,
            "window_s": time.perf_counter() - t0, "frames": frames_done,
            "latencies_ms": lat, "sample": sample}


def blocks(x: torch.Tensor, size: int):
    for s in range(0, x.shape[0], size):
        yield x[s:s + size]


def answer_gaps(ctx, st, logits_fn, answers) -> dict:
    """The widest gap of ``answers`` ([(pool batch, ids)]) against
    ``logits_fn(ctx, st, frames)``'s blocks of reference logits."""
    worst = 0.0
    for b, ids in answers:
        ids, at = torch.from_numpy(np.asarray(ids)), 0
        for logits in logits_fn(ctx, st, st["batches"][b]):
            n = logits.shape[0]
            worst = max(worst, compare.served_gap(logits, ids[at:at + n]))
            at += n
    return {"served_gap": worst}


def control_gaps(ctx, st, logits_fn, rounding, batches) -> dict:
    """The same number for the reference at ``rounding`` in the program's
    place: the gap of the id that the rounded logits put first."""
    worst = 0.0
    for b in batches:
        want = logits_fn(ctx, st, st["batches"][b])
        got = logits_fn(ctx, st, st["batches"][b], rounding)
        for w, g in zip(want, got):
            worst = max(worst, compare.served_gap(w, g.argmax(dim=1)))
    return {"served_gap": worst}
