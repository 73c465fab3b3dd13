"""Multi-process helpers of the port (twins of navillm_tpu/parallel)."""
