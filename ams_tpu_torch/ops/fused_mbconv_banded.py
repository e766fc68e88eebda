"""Banded fused MBConv block, stride 1 or 2, for the bf16 folded client.

Counterpart of ``ams_tpu/ops/fused_mbconv_banded.py`` (K4).  On the TPU
this kernel exists because the whole-image kernel (K3) cannot hold the
large early stages in VMEM: it bands the image by rows, assembles a
one-row halo from three shifted views of the input, and decomposes
stride 2 into parity planes fed by 0/1 decimation matmuls, all Mosaic
workarounds.  On the card the same block is the same kernel as K3
(``csrc/mbconv.cu``): each thread block loads its output tile's input
window with the halo, and stride 2 is only an index computation there.

``banded_supported`` is copied from the JAX package unchanged, so that
``student_forward_folded(fused_blocks="banded")`` routes the same blocks
to the kernel as JAX does.  ``mbconv_banded``'s launches are counted as
``mbconv_banded``, so that K4's launches can be told from K3's.
"""

from __future__ import annotations

from ams_tpu_torch.ops.fused_mbconv import launch, mbconv_plain

SOURCE = "ams_tpu_torch/csrc/mbconv.cu"
REPLACES = ("ams_tpu/ops/fused_mbconv_banded.py:67,112 (_s1_kernel, "
            "_s2_kernel; pallas_call :275, mbconv_banded :208)")

_SUBLANE = 16  # the TPU's bf16 sublane tile, kept for banded_supported


def banded_supported(h, w, stride, rate=1) -> bool:
    """Static eligibility: the geometry the JAX kernel bands.

    Stride 1 bands any geometry; stride 2 needs an even height and a
    width that is a multiple of 16 (the TPU's row-parity view), so the
    real odd stride-2 stages stay unfused, as in JAX."""
    if rate != 1 or stride not in (1, 2):
        return False
    if stride == 2 and (h % 2 or w % _SUBLANE):
        return False
    return -(-h // stride) >= 2


def mbconv_banded(x, w_expand, b_expand, w_dw, b_dw, w_proj, b_proj, *,
                  stride=1, residual=False):
    """One fused MBConv block at stride 1 or 2 (K4), TF-'SAME' padding:
    (B, Cin, H, W) bf16 -> (B, Cout, ceil(H/s), ceil(W/s)) bf16,
    channels-last.  Weights as ``fused_mbconv.FusedBlock``."""
    if x.device.type == "cpu":
        return mbconv_plain(x, w_expand, b_expand, w_dw, b_dw, w_proj,
                            b_proj, stride=stride, rate=1, residual=residual)
    if x.device.type != "cuda":
        raise ValueError("mbconv_banded runs on cpu or cuda tensors, not %s"
                         % x.device)
    return launch("mbconv_banded", x, w_expand, b_expand, w_dw, b_dw,
                  w_proj, b_proj, stride=stride, rate=1, residual=residual)
