"""Student network and its BN-folded deploy form (counterpart of ams_tpu.models)."""

from ams_tpu_torch.models.mobilenetv2_deeplab import (  # noqa: F401
    StudentConfig,
    block_names,
    init_student_params,
    preprocess,
    student_forward,
    student_logits,
)
