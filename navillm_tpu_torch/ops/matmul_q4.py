"""int4 dequant-matmul: a hand-written CUDA kernel + its plain version.

Torch twin of navillm_tpu/ops/matmul_q4.py. The weight format is
models/quant.py's: ``q4p`` uint8 [h, o/2], byte c holding output channels
2c (low nibble) and 2c+1 (high nibble) in two's complement, and group
scales ``s`` [h/G, o] with G = h // s.shape[0].

- ``matmul_q4`` launches ``csrc/matmul_q4.cu``, the Hopper port of the
  Pallas kernel ``_mm4_kernel``, on CUDA tensors (counted in
  ``matmul_q4.launches``); on CPU tensors it runs ``matmul_q4_reference``.
  ``matmul_q4.int8_launches`` counts the launches with int8 x (w4a8),
  ``matmul_q4.f32_launches`` those with f32 x (split by the kernel into a
  bf16 high and low part, accumulated in f32 as the Pallas kernel does).
  On CUDA it raises ``ValueError`` for what the kernel does not take and
  never falls back; f32 x is never rounded to bf16 once and sent down the
  bf16 path (that is another function).
- ``matmul_q4_reference`` is the plain version, in the Pallas kernel's k
  order: one f32 product per group, scaled per column and summed over the
  groups in order.
- ``unpack_q4`` is the twin of llama._unpack_q4 (the inverse of
  models/quant.py:pack_int4).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# the kernel's group limits: a multiple of one wgmma step's depth (16 bf16
# or 32 int8 values) that divides its 128-deep k tile
_KERNEL_K_TILE = 128


def unpack_q4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., h, o/2] -> int8 [..., h, o], low nibble = even channel."""
    lo = (p & 0xF).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


def _shapes(x, q4p, s):
    h, o2 = q4p.shape
    o, ng = 2 * o2, s.shape[0]
    if x.shape[-1] != h or ng == 0 or h % ng or s.shape != (ng, o):
        raise ValueError(f"matmul_q4: x {tuple(x.shape)}, q4p "
                         f"{tuple(q4p.shape)} and s {tuple(s.shape)} do not "
                         f"fit y = x @ dequant(q4p, s)")
    return h, o, ng, h // ng


def _out_dtype(x, out_dtype):
    if out_dtype is not None:
        return out_dtype
    return torch.float32 if x.dtype == torch.int8 else x.dtype


def matmul_q4_reference(x, q4p, s, out_dtype=None) -> torch.Tensor:
    """Plain version: acc += (x_g.float() @ q_g.float()) * s_g.float() over
    the groups in order, then one cast to the out dtype. With int8 x each
    group's product is a sum of integers below 2**24, so it is exact in f32
    (TF32 must be off on the card)."""
    h, o, ng, g = _shapes(x, q4p, s)
    lead = x.shape[:-1]
    xf = x.reshape(-1, h)
    acc = torch.zeros((xf.shape[0], o), dtype=torch.float32, device=x.device)
    for i in range(ng):
        q = unpack_q4(q4p[i * g:(i + 1) * g]).float()
        acc += (xf[:, i * g:(i + 1) * g].float() @ q) * s[i].float()
    return acc.to(_out_dtype(x, out_dtype)).reshape(*lead, o)


def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_q4").lib
    fn = lib.navillm_matmul_q4
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        fn.restype = i32
        lib.navillm_cuda_error_string.argtypes = [i32]
        lib.navillm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(xf, q4p, s, out_dtype, g):
    dev = xf.device
    if xf.dtype not in (torch.bfloat16, torch.int8, torch.float32):
        raise ValueError(f"matmul_q4 kernel: x must be bf16, f32 or int8, "
                         f"got {xf.dtype}")
    if q4p.dtype != torch.uint8 or s.dtype not in (torch.bfloat16,
                                                   torch.float32):
        raise ValueError(f"matmul_q4 kernel: q4p must be uint8 and s bf16 or "
                         f"f32, got {q4p.dtype} and {s.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"matmul_q4 kernel: out_dtype must be bf16 or f32, "
                         f"got {out_dtype}")
    if q4p.device != dev or s.device != dev:
        raise ValueError("matmul_q4 kernel: x, q4p and s must be on one "
                         "device")
    step = 32 if xf.dtype == torch.int8 else 16
    if g % step or _KERNEL_K_TILE % g:
        raise ValueError(f"matmul_q4 kernel: group size {g} must be a "
                         f"multiple of {step} that divides "
                         f"{_KERNEL_K_TILE} for {xf.dtype} x")
    for name, t, align in (("x", xf, 16), ("q4p", q4p, 16),
                           ("s", s, 8 if s.dtype == torch.float32 else 4)):
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"matmul_q4 kernel: {name} must be dense and "
                             f"{align}-byte aligned, got strides "
                             f"{t.stride()} at address {t.data_ptr():#x}")


def matmul_q4(x, q4p, s, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(q4p, s) for x [..., h] -> [..., o] in ``out_dtype``
    (default: x's dtype, f32 for int8 x; the caller applies int8 x's row
    scale). CUDA tensors launch csrc/matmul_q4.cu on the current stream
    (f32 x: with a bf16 [2, m, h] scratch for its split); CPU tensors run
    matmul_q4_reference."""
    if not x.is_cuda:
        return matmul_q4_reference(x, q4p, s, out_dtype)
    h, o, _, g = _shapes(x, q4p, s)
    out_dtype = _out_dtype(x, out_dtype)
    lead = x.shape[:-1]
    xf = x.reshape(-1, h)
    _check_kernel_inputs(xf, q4p, s, out_dtype, g)
    m = xf.shape[0]
    y = torch.empty((m, o), dtype=out_dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, o)
    if m > 65535 * 128:
        raise ValueError(f"matmul_q4 kernel: {m} rows exceed its grid")
    lib = _lib()
    f32_x = xf.dtype == torch.float32
    scratch = torch.empty((2, m, h), dtype=torch.bfloat16,
                          device=x.device) if f32_x else None
    err = lib.navillm_matmul_q4(
        xf.data_ptr(), q4p.data_ptr(), s.data_ptr(), y.data_ptr(),
        scratch.data_ptr() if f32_x else None, m, h, o, g,
        2 if f32_x else int(xf.dtype == torch.int8),
        int(s.dtype == torch.float32), int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("matmul_q4 kernel launch failed: "
                           + lib.navillm_cuda_error_string(err).decode())
    matmul_q4.launches += 1
    matmul_q4.int8_launches += int(xf.dtype == torch.int8)
    matmul_q4.f32_launches += int(f32_x)
    return y.reshape(*lead, o)


matmul_q4.launches = 0
matmul_q4.int8_launches = 0
matmul_q4.f32_launches = 0
