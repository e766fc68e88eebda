"""Multi-device paths (counterpart of ams_tpu.parallel)."""

from ams_tpu_torch.parallel.mesh import init_multi_host, make_mesh  # noqa: F401
from ams_tpu_torch.parallel.sharded import (  # noqa: F401
    make_multi_video_round,
    make_sharded_distill_round,
    make_sharded_labeler,
    make_vmapped_multi_video_round,
    stack_videos,
)
