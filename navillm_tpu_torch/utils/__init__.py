"""Config, logging and registries of the port (twins of navillm_tpu/utils)."""
