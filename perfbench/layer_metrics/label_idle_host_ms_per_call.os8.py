"""Device-idle milliseconds per ``labeler/label`` call of the traced
window inside the labeler's host steps (``labeler/pad``,
``labeler/join``, ``labeler/unpad``): the label cell's reader, at the
OS8 cell's 4x bytes per frame."""

from perfbench.layer_metrics import label_idle_host_ms_per_call

read = label_idle_host_ms_per_call.read
