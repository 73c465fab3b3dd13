"""navillm_tpu_torch: the PyTorch/CUDA port of navillm_tpu for one NVIDIA H100.

It mirrors navillm_tpu's layout and names. The JAX package stays the
reference: every module here is held against its JAX twin by the
tests/test_torch_*.py parity tests. The port imports torch and nothing of
navillm_tpu or jax: it keeps its own copies of the host layer (sim/ with
navsim.cpp, data/metrics, loaders and feature_db, models/tokenization).

What runs today: streaming evaluation of R2R, CVDN, EQA (generated
answers, the oracle pass), REVERIE and SOON (object grounding), greedy or
sampled on the card (agents/mp3d_agent.py validate_streaming), through the
device-memory eval step, uncached or prefix-cached; ScanQA's generated
answers (agents/llava_agent.py validate, scored by eval/captioning.py);
and training on every task of the paper's mix, R2R, CVDN, REVERIE, SOON,
the augmented R2R and REVERIE sets, ScanQA and LLaVA (training/
train_loop.py train_one_epoch -> agent.train -> agents/fused_teacher.py:
teacher forcing, and the fused DAgger half with actions drawn on the card,
with the object-grounding, summarization and FGR2R heads; or the 3D-QA
answer loss), with AdamW, driven from the command line by ``python -m
navillm_tpu_torch.train`` (YAML config, validation, model selection,
checkpoints, resume), on one card or, under ``torchrun``, over a dp x tp
grid of cards (parallel/: the LLM split Megatron-style, gradients
averaged over the data group, ZeRO-1 moments); and the offline view
features, the EVA02-CLIP and CLIP towers over rendered or simulated views
into HDF5 (vision/). Every Llama
layer's attention runs in hand-written CUDA kernels: the forward in
csrc/flash_attn_fwd.cu, its gradient in csrc/flash_attn_bwd.cu (dK, dV)
and csrc/flash_attn_bwd_dq.cu (dQ). With the LLM in int4, its layer
matmuls run in csrc/matmul_q4.cu.
"""

__version__ = "0.1.0"
