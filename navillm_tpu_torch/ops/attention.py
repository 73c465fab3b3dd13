"""Multi-head attention: a hand-written CUDA flash kernel + the eager path.

Torch twin of navillm_tpu/ops/attention.py. Layouts are the JAX
package's: q [B, T, NH, D]; k, v [B, S, NKV, D]; kv_mask [B, S] bool
(the eager path also takes [B, T, S]).

- ``attention_eager`` is the twin of ``_attention_xla``.
- ``flash_attention_fwd`` launches ``csrc/flash_attn_fwd.cu``, the Hopper
  port of the Pallas kernel ``_flash_kernel``; on CPU tensors it runs
  ``flash_attention_fwd_reference``, its plain version.
- ``flash_attention_bwd`` is the twin of ``_flash_backward``:
  ``flash_attention_bwd_dq`` launches ``csrc/flash_attn_bwd_dq.cu`` (the
  port of ``_flash_bwd_dq_kernel``), which also writes delta =
  rowsum(O * dO) in f32, then ``flash_attention_bwd_dkv`` launches
  ``csrc/flash_attn_bwd.cu`` (the port of ``_flash_bwd_dkv_kernel``) on
  that delta; on CPU tensors they run their plain versions
  (``attention_delta`` for delta).
- ``window_attention`` launches ``csrc/flash_attn_window_fwd.cu``, the
  prefix-cached step's window over its two K/V sources (no TPU kernel:
  JAX runs it through XLA); on CPU tensors it runs
  ``window_attention_reference``, the eager path over the concatenated
  sources.
- ``FlashAttention`` is the twin of ``_flash_differentiable``: the forward
  kernel, saving (q, k, v, mask, O, lse), and the backward kernels.
- ``multi_head_attention`` dispatches: CUDA tensors go to the kernels at
  every shape (through ``FlashAttention`` when a gradient is needed), CPU
  tensors to the eager path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..utils.profiling import count
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
    """Masked scores [B, NH, T, S] in f32, or f64 for f64 inputs (k
    already GQA-expanded)."""
    t, s = q.shape[1], k.shape[1]
    dt = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("btnd,bsnd->bnts", q.to(dt), k.to(dt)) * scale
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


def _check_tma_operand(what, name, x, q):
    """x is a 4-d bf16 tensor on q's device that TMA can read: a dense
    last dim, strides in multiples of 8 elements, 16-byte aligned."""
    st = x.stride()
    if x.dtype != torch.bfloat16 or len(st) != 4 or x.device != q.device:
        raise ValueError(f"{what}: {name} must be a 4-d bf16 tensor on "
                         f"{q.device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    if st[3] != 1 or (st[0] | st[1] | st[2]) % 8 or x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} needs a dense last dim, strides "
                         f"in multiples of 8 and 16-byte alignment, got "
                         f"strides {st}")


def _check_kernel_inputs(q, k, v, kv_mask, causal):
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tma_operand("flash kernel", name, x, q)
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


# ------------------------------------------------------------- backward --- #
def attention_delta(o, do) -> torch.Tensor:
    """delta = rowsum(O * dO) in f32, [B, NH, T] (as _flash_backward)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, kv_mask, lse, delta, do, causal, scale):
    """P [B, NH, T, S] f32, zero where lse <= NEG_INF/2 (rows that saw no
    valid key); dS rounded to q's dtype; k GQA-expanded."""
    k, v = _expand_gqa(q, k, v)
    lse = lse[..., None]
    p = torch.exp(_scores(q, k, kv_mask, causal, scale) - lse)
    p = torch.where(lse > NEG_INF / 2, p, torch.zeros((), device=p.device))
    dp = torch.einsum("btnd,bsnd->bnts", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return p, ds, k


def _sum_groups(x, nkv: int):
    """[B, S, NH, D] per query head -> [B, S, NKV, D] per kv head."""
    b, s, nh, d = x.shape
    return x.reshape(b, s, nkv, nh // nkv, d).sum(3)


def flash_attention_bwd_dkv_reference(q, k, v, kv_mask, lse, delta, do,
                                      causal, scale):
    """Plain version of the dK/dV kernel: dV = P^T dO, dK = dS^T Q, with
    bf16 operands rounded where the kernel rounds them and f32 sums."""
    p, ds, _ = _bwd_probs(q, k, v, kv_mask, lse, delta, do, causal, scale)
    dv = torch.einsum("bnts,btnd->bsnd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bnts,btnd->bsnd", ds, q.float())
    nkv = k.shape[2]
    return _sum_groups(dk, nkv).to(k.dtype), _sum_groups(dv, nkv).to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, kv_mask, lse, delta, do,
                                     causal, scale):
    """Plain version of the dQ kernel: dQ = dS K."""
    _, ds, k = _bwd_probs(q, k, v, kv_mask, lse, delta, do, causal, scale)
    return torch.einsum("bnts,bsnd->btnd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_reference(q, k, v, kv_mask, o, lse, do, causal,
                                  scale):
    """Plain version of flash_attention_bwd: (dq, dk, dv)."""
    delta = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, kv_mask, lse, delta,
                                               do, causal, scale)
    dq = flash_attention_bwd_dq_reference(q, k, v, kv_mask, lse, delta, do,
                                          causal, scale)
    return dq, dk, dv


def _entry_lib(source: str, entry: str, argtypes) -> ctypes.CDLL:
    """csrc/<source>.cu, with its C entry point ``entry`` bound."""
    lib = _build.load(source).lib
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.navillm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.navillm_cuda_error_string.restype = ctypes.c_char_p
    return lib


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# nine pointers (dK/dV: q k v mask dout lse delta dk dv; dQ: q k v mask
# dout lse o delta dq), B T S NH NKV D, the input strides, the strided
# outputs' strides, scale, causal, stream
_DKV_ARGS = ([_PTR] * 9 + [_I32] * 6 + [ctypes.POINTER(_I64)] + [_I64] * 6
             + [ctypes.c_float, _I32, _PTR])
_DQ_ARGS = ([_PTR] * 9 + [_I32] * 6 + [ctypes.POINTER(_I64)] + [_I64] * 3
            + [ctypes.c_float, _I32, _PTR])


def _check_like_q(q, name, x):
    if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
            or x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(f"flash backward: {name} must be laid out like q, "
                         f"got {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()}")


def _check_rows_f32(q, name, x):
    b, t, nh, _ = q.shape
    if x.shape != (b, nh, t) or x.dtype != torch.float32 \
            or x.device != q.device or not x.is_contiguous():
        raise ValueError(f"flash backward: {name} must be a dense f32 "
                         f"[B, NH, T] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")


def _bwd_launch_args(q, k, v, kv_mask, lse, do, causal, o=None):
    """Check what the backward kernels take; return the shared dimensions
    and the element strides of q, k, v, mask, do (and o)."""
    _check_kernel_inputs(q, k, v, kv_mask, causal)
    _check_like_q(q, "dO", do)
    _check_rows_f32(q, "lse", lse)
    b, t, nh, d = q.shape
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               kv_mask.stride(0), *do.stride()[:3]]
    if o is not None:
        _check_like_q(q, "O", o)
        strides += o.stride()[:3]
    return ([b, t, k.shape[1], nh, k.shape[2], d],
            (ctypes.c_longlong * len(strides))(*strides))


def _raise_on_error(lib, err: int, what: str):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.navillm_cuda_error_string(err).decode())


def flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do, *,
                            causal: bool, scale: float):
    """(dK, dV) in k's layout and dtype. delta is rowsum(O * dO) [B, NH, T]
    f32, as flash_attention_bwd_dq returns it. CUDA tensors launch the
    dK/dV kernel (counted in ``flash_attention_bwd_dkv.launches``); CPU
    tensors run flash_attention_bwd_dkv_reference."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_reference(q, k, v, kv_mask, lse, delta,
                                                 do, causal, scale)
    dims, strides = _bwd_launch_args(q, k, v, kv_mask, lse, do, causal)
    _check_rows_f32(q, "delta", delta)
    lib = _entry_lib("flash_attn_bwd", "navillm_flash_attn_bwd_dkv",
                     _DKV_ARGS)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = lib.navillm_flash_attn_bwd_dkv(
        *(x.data_ptr() for x in (q, k, v, kv_mask, do, lse, delta, dk, dv)),
        *dims, strides, *dk.stride()[:3], *dv.stride()[:3], float(scale),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, err, "flash dK/dV kernel")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, kv_mask, lse, o, do, *, causal: bool,
                           scale: float):
    """(dQ in q's layout and dtype, delta = rowsum(O * dO) [B, NH, T] f32).
    CUDA tensors launch the dQ kernel, which computes delta in its prologue
    (counted in ``flash_attention_bwd_dq.launches``); CPU tensors run
    attention_delta and flash_attention_bwd_dq_reference."""
    if not q.is_cuda:
        delta = attention_delta(o, do)
        return flash_attention_bwd_dq_reference(
            q, k, v, kv_mask, lse, delta, do, causal, scale), delta
    dims, strides = _bwd_launch_args(q, k, v, kv_mask, lse, do, causal, o)
    lib = _entry_lib("flash_attn_bwd_dq", "navillm_flash_attn_bwd_dq",
                     _DQ_ARGS)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    err = lib.navillm_flash_attn_bwd_dq(
        *(x.data_ptr() for x in (q, k, v, kv_mask, do, lse, o, delta, dq)),
        *dims, strides, *dq.stride()[:3], float(scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, err, "flash dQ kernel")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, kv_mask, o, lse, do, *, causal: bool,
                        scale: float):
    """Flash-attention backward (twin of _flash_backward): (dq, dk, dv).

    o and lse are the forward's outputs (lse [B, NH, T] f32). The dQ
    kernel runs first and also returns delta = rowsum(O * dO) in f32, as
    the JAX code computes it; the dK/dV kernel reads it."""
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.bool, device=q.device)
    dq, delta = flash_attention_bwd_dq(q, k, v, kv_mask, lse, o, do,
                                       causal=causal, scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do,
                                     causal=causal, scale=scale)
    return dq, dk, dv


# ---------------------------------------------- prefix-cached window --- #
def window_mask(prefix_mask, win_mask) -> torch.Tensor:
    """[B, S, P+S] visibility of a prefix-cached window: each window query
    sees every valid prefix key and the valid window keys up to itself."""
    b, p = prefix_mask.shape
    s = win_mask.shape[1]
    qi = torch.arange(s, device=win_mask.device)[:, None]
    sm = (qi >= qi.T)[None] & win_mask[:, None, :]
    return torch.cat([prefix_mask[:, None, :].expand(b, s, p), sm], dim=-1)


def window_attention_reference(q, k_prefix, v_prefix, prefix_mask, k_win,
                               v_win, win_mask, *, scale: float):
    """Plain version of the window kernel: the two K/V sources
    concatenated, then attention_eager under window_mask."""
    keys = torch.cat([k_prefix.to(k_win.dtype), k_win], dim=1)
    vals = torch.cat([v_prefix.to(v_win.dtype), v_win], dim=1)
    return attention_eager(q, keys, vals, window_mask(prefix_mask, win_mask),
                           False, scale)


# eight pointers (q, k_prefix, v_prefix, prefix_mask, k_win, v_win,
# win_mask, o), B S P NH NKV D, the strides, scale, stream
_WINDOW_ARGS = [_PTR] * 8 + [_I32] * 6 + [_I64] * 20 + [ctypes.c_float, _PTR]


def _check_window_inputs(q, k_prefix, v_prefix, prefix_mask, k_win, v_win,
                         win_mask):
    what = "window kernel"
    for name, x in (("q", q), ("k_prefix", k_prefix), ("v_prefix", v_prefix),
                    ("k_win", k_win), ("v_win", v_win)):
        _check_tma_operand(what, name, x, q)
    b, s, nh, d = q.shape
    p, nkv = k_prefix.shape[1], k_prefix.shape[2]
    if k_win.shape != (b, s, nkv, d) or v_win.shape != k_win.shape \
            or k_prefix.shape != (b, p, nkv, d) \
            or v_prefix.shape != k_prefix.shape:
        raise ValueError(f"{what}: K/V shapes {tuple(k_prefix.shape)} "
                         f"{tuple(v_prefix.shape)} (prefix), "
                         f"{tuple(k_win.shape)} {tuple(v_win.shape)} (window) "
                         f"do not match q {tuple(q.shape)}")
    if d not in (64, 128) or nh % nkv:
        raise ValueError(f"{what}: head_dim {d} (needs 64 or 128), {nh} "
                         f"heads over {nkv} kv heads")
    for name, m, n in (("prefix_mask", prefix_mask, p),
                       ("win_mask", win_mask, s)):
        if m.dtype != torch.bool or m.shape != (b, n) or m.stride(1) != 1 \
                or m.device != q.device:
            raise ValueError(f"{what}: {name} must be a dense [B, {n}] bool "
                             f"tensor on {q.device}, got {m.dtype} "
                             f"{tuple(m.shape)} on {m.device}")


def window_attention(q, k_prefix, v_prefix, prefix_mask, k_win, v_win,
                     win_mask, *, scale: float) -> torch.Tensor:
    """Attention of an S-token window over a row's cached prefix and
    itself: O [B, S, NH, D].

    q [B, S, NH, D]; k_prefix, v_prefix [B, P, NKV, D] with prefix_mask
    [B, P]; k_win, v_win [B, S, NKV, D] with win_mask [B, S]. Each query
    sees the valid prefix keys and the valid window keys up to itself
    (window_mask). CUDA tensors launch csrc/flash_attn_window_fwd.cu on the
    current stream (counted in ``window_attention.launches``); it takes
    bf16 with head_dim 64 or 128 and raises on anything else. CPU tensors
    run window_attention_reference. While a profiler records, each call
    adds one to the trace's counter ``window_kernel`` or ``window_eager``
    (utils/profiling.count)."""
    if not q.is_cuda:
        count(window_eager=1)
        return window_attention_reference(q, k_prefix, v_prefix, prefix_mask,
                                          k_win, v_win, win_mask, scale=scale)
    _check_window_inputs(q, k_prefix, v_prefix, prefix_mask, k_win, v_win,
                         win_mask)
    lib = _entry_lib("flash_attn_window_fwd", "navillm_flash_attn_window_fwd",
                     _WINDOW_ARGS)
    b, s, nh, d = q.shape
    o = torch.empty((b, s, nh, d), dtype=q.dtype, device=q.device)
    err = lib.navillm_flash_attn_window_fwd(
        *(x.data_ptr() for x in (q, k_prefix, v_prefix, prefix_mask, k_win,
                                 v_win, win_mask, o)),
        b, s, k_prefix.shape[1], nh, k_win.shape[2], d,
        *q.stride()[:3], *k_prefix.stride()[:3], *v_prefix.stride()[:3],
        prefix_mask.stride(0), *k_win.stride()[:3], *v_win.stride()[:3],
        win_mask.stride(0), *o.stride()[:3], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, err, "window attention kernel")
    window_attention.launches += 1
    count(window_kernel=1)
    return o


window_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (twin of _flash_differentiable).

    Forward: the forward kernel, saving q, k, v, the mask, O and lse only.
    Backward: the dK/dV and dQ kernels, which recompute P tile by tile.
    On CPU tensors both run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, kv_mask, causal=causal,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, o, lse,
                                         do.contiguous(), causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None, None


def multi_head_attention(q, k, v, *, kv_mask=None, causal=True, scale=None,
                         impl: str = "auto"):
    """Dispatch between the flash kernels and the eager path.

    impl: "auto" (kernels for CUDA tensors at every shape, eager for CPU
    tensors), "kernel" (raises on CPU tensors) or "eager". With grad
    enabled and an input that needs a gradient, the kernel path goes
    through FlashAttention. Returns [B, T, NH, D] in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "eager"
    if impl == "kernel":
        if not q.is_cuda:
            raise ValueError("impl='kernel' needs CUDA tensors; the kernel "
                             "has no CPU version")
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v)):
            if kv_mask is None:
                kv_mask = torch.ones(k.shape[:2], dtype=torch.bool,
                                     device=q.device)
            return FlashAttention.apply(q, k, v, kv_mask, causal, scale)
        return flash_attention_fwd(q, k, v, kv_mask, causal=causal,
                                   scale=scale)[0]
    if impl == "eager":
        return attention_eager(q, k, v, kv_mask, causal, scale)
    raise ValueError(f"unknown attention impl {impl!r}")
