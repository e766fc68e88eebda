"""Student network and its BN-folded deploy form (counterpart of ams_tpu.models)."""
