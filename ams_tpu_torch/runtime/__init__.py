"""The SemanticNetwork facade (counterpart of ams_tpu.runtime)."""
