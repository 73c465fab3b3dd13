"""navillm_tpu_torch: the PyTorch/CUDA port of navillm_tpu for one NVIDIA H100.

It mirrors navillm_tpu's layout and names. The JAX package stays the
reference: every module here is held against its JAX twin by the
tests/test_torch_*.py parity tests. The port imports torch and nothing of
navillm_tpu or jax: it keeps its own copies of the host layer (sim/ with
navsim.cpp, data/metrics, loaders and feature_db, models/tokenization).

What runs today: greedy R2R streaming evaluation (agents/mp3d_agent.py
R2RAgent.validate_streaming) through the device-memory eval step, and R2R
teacher-forcing training (training/train_loop.py train_one_epoch ->
R2RAgent.train -> agents/fused_teacher.py) with AdamW. Every Llama
layer's attention runs in hand-written CUDA kernels: the forward in
csrc/flash_attn_fwd.cu, its gradient in csrc/flash_attn_bwd.cu (dK, dV)
and csrc/flash_attn_bwd_dq.cu (dQ). With the LLM in int4, its layer
matmuls run in csrc/matmul_q4.cu.
"""

__version__ = "0.1.0"
