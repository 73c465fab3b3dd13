"""Optimizer: global-norm clip, AdamW and a constant-with-warmup LR.

Torch twin of navillm_tpu/training/optim.py::make_optimizer without the
8-bit moments: the optax chain clip_by_global_norm(max) -> adamw(b1 0.9,
b2 0.999, eps 1e-8 outside the square root, bias correction, decoupled
weight decay) with the schedule constant_with_warmup. As optax's
scale_by_adam does for bf16 parameters, the moments are kept in each
parameter's dtype. Parameters, moments and gradients are updated in
place, one leaf at a time, so a step's scratch is two tensors the size of
the largest leaf (where the JAX step donates its buffers).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def constant_with_warmup(lr: float, num_warmup_steps: int
                         ) -> Callable[[int], float]:
    """LR at optimizer step ``step`` (counted from 0)."""
    def sched(step: int) -> float:
        if num_warmup_steps <= 0:
            return lr
        return lr * min((step + 1.0) / max(1, num_warmup_steps), 1.0)
    return sched


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32, on the
    device (no host sync)."""
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
          for g in grads]
    return torch.stack(sq).sum().sqrt()


class AdamW:
    """clip_by_global_norm -> AdamW -> schedule over a dict of named
    parameters. ``step(grads)`` takes the gradients under the same names
    (it scales them in place when clipping) and returns the pre-clip
    global norm as a device scalar."""

    def __init__(self, params: Dict[str, torch.Tensor], lr_schedule,
                 grad_clip_norm: float = 40.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params = params
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        with torch.no_grad():
            self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads[n] for n in self.params)
        # optax's rule: scale by max/norm only when norm >= max
        factor = torch.where(norm < self.grad_clip_norm,
                             torch.ones_like(norm),
                             self.grad_clip_norm / norm)
        lr = self.lr_schedule(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for n, p in self.params.items():
            g = grads[n].mul_(factor)
            m, v = self.mu[n], self.nu[n]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)
        return norm


def make_optimizer(params: Dict[str, torch.Tensor], lr: float = 1e-5,
                   num_warmup_steps: int = 0, grad_clip_norm: float = 40.0,
                   weight_decay: float = 0.0) -> AdamW:
    """Twin of make_optimizer (moments_8bit and optax.MultiSteps are not
    ported: train_one_epoch accumulates gradients itself)."""
    return AdamW(params, constant_with_warmup(lr, num_warmup_steps),
                 grad_clip_norm=grad_clip_norm, weight_decay=weight_decay)
