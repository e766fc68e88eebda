"""Device-idle milliseconds per ``labeler/label`` call of the traced
window inside the labeler's host steps: the program's spans
``labeler/pad``, ``labeler/join`` and ``labeler/unpad``."""

from perfbench.lib import spans

HOST_STEPS = ("labeler/pad", "labeler/join", "labeler/unpad")


def read(ctx):
    recs = spans.records(ctx)
    calls = len(spans.named(recs, "labeler/label"))
    if not calls:
        return None
    return spans.idle_inside(ctx.trace_data, recs, HOST_STEPS) / 1e6 / calls
