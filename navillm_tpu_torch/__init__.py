"""navillm_tpu_torch: the PyTorch/CUDA port of navillm_tpu for one NVIDIA H100.

It mirrors navillm_tpu's layout and names. The JAX package stays the
reference: every module here is held against its JAX twin by the
tests/test_torch_*.py parity tests. The port imports torch and never jax;
its host layer (sim, feature DB, metrics, loaders, tokenizer) is imported
from navillm_tpu where that module's import chain is numpy-only.

What runs today: greedy R2R streaming evaluation (agents/mp3d_agent.py
R2RAgent.validate_streaming) through the device-memory eval step, and R2R
teacher-forcing training (training/train_loop.py train_one_epoch ->
R2RAgent.train -> agents/fused_teacher.py) with AdamW. Every Llama
layer's attention runs in hand-written CUDA kernels: the forward in
csrc/flash_attn_fwd.cu, its gradient in csrc/flash_attn_bwd.cu.
"""

__version__ = "0.1.0"
