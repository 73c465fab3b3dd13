"""Mask utilities (torch twin of navillm_tpu/ops/masking.py)."""
from __future__ import annotations

import torch

# Large negative instead of -inf: keeps softmax NaN-free for fully-masked
# rows (left-padded prompts under causal attention have them).
NEG_INF = -1e30


def gen_seq_masks(seq_lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool validity mask."""
    pos = torch.arange(max_len, device=seq_lens.device)[None, :]
    return pos < seq_lens[:, None]
