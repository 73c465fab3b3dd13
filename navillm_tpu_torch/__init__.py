"""navillm_tpu_torch: the PyTorch/CUDA port of navillm_tpu for one NVIDIA H100.

It mirrors navillm_tpu's layout and names. The JAX package stays the
reference: every module here is held against its JAX twin by the
tests/test_torch_*.py parity tests. The port imports torch and never jax;
its host layer (sim, feature DB, metrics, loaders, tokenizer) is imported
from navillm_tpu where that module's import chain is numpy-only.

What runs today: greedy R2R streaming evaluation (agents/mp3d_agent.py
R2RAgent.validate_streaming) through the device-memory eval step, with
every Llama layer's attention in the hand-written CUDA kernel
csrc/flash_attn_fwd.cu. It serves only, with no gradients.
"""

__version__ = "0.1.0"
