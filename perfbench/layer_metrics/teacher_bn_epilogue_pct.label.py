"""Share of the AMS teacher's (output stride 16) folded inference BNs
in the traced window whose offset rode in the epilogue of the
convolution that produced the tensor: 100 x the program's ``teacher/bn_epilogue`` records over those
and its ``teacher/bn_pass`` records (an offset added as a pass of its
own).  None without such records (a program that runs BN unfolded)."""

from perfbench.lib import spans


def read(ctx):
    recs = spans.records(ctx)
    fused = len(spans.named(recs, "teacher/bn_epilogue"))
    passes = len(spans.named(recs, "teacher/bn_pass"))
    if not fused + passes:
        return None
    return 100.0 * fused / (fused + passes)
