"""Model-delta wire codec (counterpart of ams_tpu.stream)."""
