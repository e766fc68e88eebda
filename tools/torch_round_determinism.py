"""Is the port's distillation round deterministic on the card?

    python tools/torch_round_determinism.py

Runs the same 6-iteration coord_desc_auto round (video 0 of a
MultiVideoServer at 256x512, minibatch 10, seeded frames and labels, cold
Adam slots) twice, in bf16 and f32, under three settings: PyTorch's
defaults, cuDNN's deterministic mode, and ``torch.use_deterministic_
algorithms(True)`` as well; and prints for each pair the largest
parameter and loss differences and the selection mask's flips.  Needs a
CUDA device; run from the repo root.
"""

import dataclasses
import os
import sys

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


def main():
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
        return make_distill_round(spec)(
            cs.video_slice(srv.params_V, 0), cs.video_slice(srv.opt_V, 0),
            f0, l0, len(mem), torch.Generator(device=dev).manual_seed(1000),
            1e-3, cs.video_slice(srv.mask_V, 0),
            class_mask=srv.class_mask_V[0])

    def diff(a, b):
        flips = sum(int((a[2][k] != b[2][k]).sum()) for k in a[2])
        return ("params %.3g, losses %.3g, mask flips %d"
                % (cs.tree_max_abs_diff(a[0], b[0]),
                   float((a[3] - b[3]).abs().max()), flips))

    print(cs.nvidia_smi(), torch.__version__)
    for label, cudnn_det, all_det in (("default", False, False),
                                      ("cudnn deterministic", True, False),
                                      ("deterministic algorithms", True,
                                       True)):
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(all_det, warn_only=True)
        for dtype in ("bfloat16", "float32"):
            spec = dataclasses.replace(srv.spec, iters=6,
                                       compute_dtype=dtype)
            print("%s, %s, 6 iterations twice: %s"
                  % (label, dtype, diff(single(spec), single(spec))))
            one = dataclasses.replace(spec, iters=1)
            print("  1 iteration twice: %s" % diff(single(one), single(one)))


if __name__ == "__main__":
    main()
