"""Multi-head attention: a hand-written CUDA flash kernel + the eager path.

Torch twin of navillm_tpu/ops/attention.py. Layouts are the JAX
package's: q [B, T, NH, D]; k, v [B, S, NKV, D]; kv_mask [B, S] bool
(the eager path also takes [B, T, S]).

- ``attention_eager`` is the twin of ``_attention_xla``.
- ``flash_attention_fwd`` launches ``csrc/flash_attn_fwd.cu``, the Hopper
  port of the Pallas kernel ``_flash_kernel``; on CPU tensors it runs
  ``flash_attention_fwd_reference``, its plain version.
- ``multi_head_attention`` dispatches: CUDA tensors go to the kernel at
  every shape, CPU tensors to the eager path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .masking import NEG_INF


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, NKV, D] -> [B, S, NKV*n_rep, D] (grouped-query broadcast)."""
    if n_rep == 1:
        return x
    b, s, nkv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, nkv, n_rep, d) \
        .reshape(b, s, nkv * n_rep, d)


def _scores(q, k, kv_mask, causal, scale):
    """Masked f32 scores [B, NH, T, S] (k already GQA-expanded)."""
    t, s = q.shape[1], k.shape[1]
    scores = torch.einsum("btnd,bsnd->bnts", q.float(), k.float()) * scale
    if kv_mask is not None:
        if kv_mask.dim() == 2:
            kv_mask = kv_mask[:, None, :]
        scores = scores.masked_fill(~kv_mask[:, None, :, :], NEG_INF)
    if causal:
        qi = torch.arange(t, device=q.device)[:, None]
        kj = torch.arange(s, device=q.device)[None, :]
        scores = scores.masked_fill(kj > qi + (s - t), NEG_INF)
    return scores


def _expand_gqa(q, k, v):
    rep = q.shape[2] // k.shape[2]
    return repeat_kv(k, rep), repeat_kv(v, rep)


def attention_eager(q, k, v, kv_mask, causal, scale):
    """Einsum + masked softmax with f32 scores (twin of _attention_xla).

    kv_mask may be [B, S] (per key) or [B, T, S] (per query)."""
    k, v = _expand_gqa(q, k, v)
    probs = torch.softmax(_scores(q, k, kv_mask, causal, scale), -1)
    return torch.einsum("bnts,bsnd->btnd", probs.to(q.dtype), v)


def flash_attention_fwd_reference(q, k, v, kv_mask, causal, scale
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash kernel: (O [B, T, NH, D] in
    q's dtype, lse [B, NH, T] f32). Takes what the kernel takes: a [B, S]
    kv_mask, and T == S under causal. Rows that see no valid key differ
    from the kernel (here: a uniform average over all S keys); they are
    don't-care for every caller."""
    k, v = _expand_gqa(q, k, v)
    scores = _scores(q, k, kv_mask, causal, scale)
    lse = torch.logsumexp(scores, -1)
    probs = torch.softmax(scores, -1).to(q.dtype)
    return torch.einsum("bnts,bsnd->btnd", probs, v), lse


def _flash_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd").lib
    fn = lib.navillm_flash_attn_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 6 + [i32] * 6 + [i64] * 13
                       + [ctypes.c_float, i32, ptr])
        fn.restype = i32
        lib.navillm_cuda_error_string.argtypes = [i32]
        lib.navillm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v, kv_mask, causal):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.bfloat16 or x.dim() != 4:
            raise ValueError(f"flash kernel: {name} must be a 4-d bf16 "
                             f"tensor on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} needs a dense last dim, "
                             f"strides in multiples of 8 and 16-byte "
                             f"alignment, got strides {x.stride()}")
    b, t, nh, d = q.shape
    s, nkv = k.shape[1], k.shape[2]
    if k.shape != (b, s, nkv, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k/v shapes {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if d not in (64, 128) or nh % nkv:
        raise ValueError(f"flash kernel: head_dim {d} (needs 64 or 128), "
                         f"{nh} heads over {nkv} kv heads")
    if causal and t != s:
        raise ValueError("flash kernel: causal attention needs q_len == "
                         "kv_len")
    if kv_mask.shape != (b, s) or kv_mask.dtype != torch.bool \
            or kv_mask.device != q.device or kv_mask.stride(-1) != 1:
        raise ValueError(f"flash kernel: kv_mask must be a dense [B, S] "
                         f"bool tensor, got {kv_mask.dtype} "
                         f"{tuple(kv_mask.shape)}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash kernel is forward-only: call it under "
                           "torch.no_grad() or torch.inference_mode()")


def flash_attention_fwd(q, k, v, kv_mask: Optional[torch.Tensor] = None, *,
                        causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (O [B, T, NH, D] bf16, lse [B, NH, T] f32).

    CUDA tensors launch csrc/flash_attn_fwd.cu on the current stream (and
    count it in ``flash_attention_fwd.launches``); CPU tensors run
    flash_attention_fwd_reference."""
    if not q.is_cuda:
        return flash_attention_fwd_reference(q, k, v, kv_mask, causal, scale)
    b, t, nh, d = q.shape
    s, nkv = k.shape[1], k.shape[2]
    if kv_mask is None:
        kv_mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    _check_kernel_inputs(q, k, v, kv_mask, causal)
    lib = _flash_lib()
    o = torch.empty((b, t, nh, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nh, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.navillm_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, t, s, nh, nkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], kv_mask.stride(0),
        *o.stride()[:3], float(scale), int(causal), stream)
    if err:
        raise RuntimeError("flash kernel launch failed: "
                           + lib.navillm_cuda_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def multi_head_attention(q, k, v, *, kv_mask=None, causal=True, scale=None,
                         impl: str = "auto"):
    """Dispatch between the flash kernel and the eager path.

    impl: "auto" (kernel for CUDA tensors at every shape, eager for CPU
    tensors), "kernel" (raises on CPU tensors) or "eager".
    Returns [B, T, NH, D] in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "eager"
    if impl == "kernel":
        if not q.is_cuda:
            raise ValueError("impl='kernel' needs CUDA tensors; the kernel "
                             "has no CPU version")
        return flash_attention_fwd(q, k, v, kv_mask, causal=causal,
                                   scale=scale)[0]
    if impl == "eager":
        return attention_eager(q, k, v, kv_mask, causal, scale)
    raise ValueError(f"unknown attention impl {impl!r}")
