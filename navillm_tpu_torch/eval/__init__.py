"""Evaluation scorers of the port (its copy of navillm_tpu/eval)."""
