"""Is the port's distillation round deterministic on the card?

    python tools/torch_round_determinism.py [--iters 6] [--time-iters 20]

Runs the same coord_desc_auto round (video 0 of a MultiVideoServer at
256x512, minibatch 10, seeded frames and labels, cold Adam slots) twice
in three forms: bf16 (the server's own, matmul resize), f32 with the
gather resize, and f32 with the fused loss (chip_smoke.py phase 4's
round); each under three settings: PyTorch's defaults, cuDNN's
deterministic mode, and ``torch.use_deterministic_algorithms(True,
warn_only=True)`` as well.  Prints for each pair the largest parameter
and loss differences and the selection mask's flips, and under the third
setting every distinct warning torch raised, which names each op that has
no deterministic implementation.  Then times ``--time-iters`` iterations
of the f32 fused round (phase 4's setup) under each setting, in turns,
by CUDA events: what each costs.  Needs
a CUDA device; run from the repo root.
"""

import argparse
import dataclasses
import os
import sys
import warnings

# the H100's default cuBLAS workspace, named so that deterministic
# algorithms may be turned on (before the first cuBLAS call)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ams_tpu_torch.distill.train_step import make_distill_round  # noqa: E402
from ams_tpu_torch.runtime.multi_server import MultiVideoServer  # noqa: E402
from ams_tpu_torch.utils.platform import resolve_device  # noqa: E402

FORMS = {"bf16": dict(compute_dtype="bfloat16"),
         "f32 gather": dict(compute_dtype="float32"),
         "f32 fused": dict(compute_dtype="float32", fused_loss=True)}
SETTINGS = (("default", False, False),
            ("cudnn deterministic", True, False),
            ("deterministic algorithms", True, True))


def set_deterministic(cudnn_det, all_det):
    torch.backends.cudnn.deterministic = cudnn_det
    torch.use_deterministic_algorithms(all_det, warn_only=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--time-iters", type=int, default=20)
    a = ap.parse_args(argv)
    dev = resolve_device("cuda")
    srv = MultiVideoServer(video_ids=(25, 22, 12, 17), height=256,
                           batch_size=10, lr=1e-3,
                           strategy="coord_desc_auto", device=dev)
    rng = np.random.RandomState(0)
    frames = cs.synthetic_frames(80, 256, 512, 3)
    labels = rng.choice(np.array(srv.class_indices),
                        (80, 256, 512)).astype(np.uint8)
    for v in range(4):
        srv.ingest(v, list(frames[v::4]), list(labels[v::4]))
    mem = srv.memories[0]
    f0 = torch.from_numpy(mem.stacked()[0]).to(dev)
    l0 = torch.from_numpy(mem.stacked()[1]).to(dev)

    def single(spec):
        # the fused loss takes no class mask: that form trains the union
        fused = spec.fused_loss
        return make_distill_round(spec)(
            cs.video_slice(srv.params_V, 0), cs.video_slice(srv.opt_V, 0),
            f0, l0, len(mem), torch.Generator(device=dev).manual_seed(1000),
            1e-3, cs.video_slice(srv.mask_V, 0),
            class_mask=None if fused else srv.class_mask_V[0])

    def diff(a, b):
        flips = sum(int((a[2][k] != b[2][k]).sum()) for k in a[2])
        return ("params %.3g, losses %.3g, mask flips %d"
                % (cs.tree_max_abs_diff(a[0], b[0]),
                   float((a[3] - b[3]).abs().max()), flips))

    print(cs.nvidia_smi(), torch.__version__, flush=True)
    for label, cudnn_det, all_det in SETTINGS:
        set_deterministic(cudnn_det, all_det)
        for form, kw in FORMS.items():
            spec = dataclasses.replace(srv.spec, iters=a.iters, **kw)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                runs = single(spec), single(spec)
            print("%s, %s, %d iterations twice: %s"
                  % (label, form, a.iters, diff(*runs)), flush=True)
            for msg in sorted({str(w.message).split("\n")[0]
                               for w in caught}):
                print("  warning: %s" % msg, flush=True)
    set_deterministic(False, False)

    # the cost of each setting on phase 4's round, in turns
    spec = dataclasses.replace(srv.spec, iters=a.time_iters,
                               **FORMS["f32 fused"])
    times = {label: [] for label, _, _ in SETTINGS}
    single(dataclasses.replace(spec, iters=2))      # warm-up
    for label, cudnn_det, all_det in SETTINGS + SETTINGS[::-1]:
        set_deterministic(cudnn_det, all_det)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        single(spec)
        end.record()
        torch.cuda.synchronize()
        times[label].append(start.elapsed_time(end) / a.time_iters)
    set_deterministic(False, False)
    print("f32 fused round (phase 4's), %d iterations, ms per iteration: %s"
          % (a.time_iters, "; ".join(
              "%s %s" % (label, ["%.2f" % t for t in ts])
              for label, ts in times.items())), flush=True)

if __name__ == "__main__":
    main()
