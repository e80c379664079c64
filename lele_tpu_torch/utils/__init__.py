"""Host utilities of the port (counterpart of lele_tpu.utils)."""
