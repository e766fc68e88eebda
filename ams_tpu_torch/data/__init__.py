"""Frames, labels and their memory, without OpenCV (counterpart of
ams_tpu.data)."""
