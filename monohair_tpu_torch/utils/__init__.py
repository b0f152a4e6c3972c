"""Quality metrics of the port (port of monohair_tpu/utils)."""
