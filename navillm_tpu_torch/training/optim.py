"""Optimizer: global-norm clip, AdamW (or 8-bit Adam moments) and a
constant-with-warmup LR.

Torch twin of navillm_tpu/training/optim.py::make_optimizer: the optax chain
clip_by_global_norm(max) -> adamw(b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias correction, decoupled weight decay) with the schedule
constant_with_warmup. As optax's scale_by_adam does for bf16 parameters,
AdamW keeps the moments in each parameter's dtype. Parameters, moments and
gradients are updated in place, one leaf at a time, so a step's scratch is
two tensors the size of the largest leaf (where the JAX step donates its
buffers).

``moments_8bit=True`` swaps AdamW's moment store for the blockwise 8-bit one
of ``scale_by_adam_q8`` (8-bit Adam, Dettmers et al. 2021), with the JAX
package's codes: leaves with ndim >= 2 and at least ``_MIN_QUANT_SIZE``
elements keep int8 ``m`` and uint8 square-root-domain ``v`` in the
parameter's shape with f32 scales per ``_GROUP`` elements of the last axis;
smaller leaves keep exact f32 moments. The update math runs in f32:
dequantize, EMA, bias-correct, ``m_hat / (sqrt(v_hat) + eps)``, requantize,
then weight decay and the learning rate, after clipping, in optax's order.
The port's layer weights are stacked ``[L, ...]`` (at 7B ``w_gate`` is
1.44 G elements), so a leaf is updated in slices of whole rows of its last
axis, ``_SLICE_ELEMENTS`` at a time, and the f32 transients stay at a few
slices (~64 MB each) whatever the leaf's size.

Under a mesh plan (parallel/mesh.py) the parameters are this rank's
shards and the gradients are already averaged over the data group
(runner.take_grads). ``set_plan`` gives the optimizer the leaves' specs:
the clip's global norm then sums the model-split leaves' squares over
the model group (the replicated ones count once), and ``shard_zero1``
(ZeRO-1) keeps each large leaf's moments for this rank's slice along
``mesh.zero1_axis`` only: the step updates that slice of the parameter
and the data group all-gathers the updated parameter. ``layout`` says,
for every leaf, which axes are split, so checkpoints gather and re-slice
the state (training/checkpoints.py).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..parallel.mesh import tp_axis, zero1_axis


def constant_with_warmup(lr: float, num_warmup_steps: int
                         ) -> Callable[[int], float]:
    """LR at optimizer step ``step`` (counted from 0), computed in f32 as the
    JAX schedule computes it."""
    def sched(step: int) -> float:
        if num_warmup_steps <= 0:
            return lr
        frac = np.float32(step + 1.0) / np.float32(max(1, num_warmup_steps))
        return float(np.float32(lr) * np.minimum(frac, np.float32(1.0)))
    return sched


def global_norm(grads, split=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32, on the
    device (no host sync). split: one flag per gradient, True where it is
    this rank's shard of a leaf the model ``group`` splits: those squares
    are summed over the group, the others counted once."""
    grads = list(grads)
    sq = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
          for g in grads]
    if split is None or group is None:
        return torch.stack(sq).sum().sqrt()
    zero = torch.zeros((), device=sq[0].device)
    part = sum((q for q, f in zip(sq, split) if f), zero)
    rest = sum((q for q, f in zip(sq, split) if not f), zero)
    return (group.all_reduce(part) + rest).sqrt()


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
        # under a plan: {name: (spec, zero1 axis or None)}
        self.plan = None
        self.layout = {n: ((), None) for n in params}
        with torch.no_grad():
            self._init_moments()

    # ------------------------------------------------ plan and ZeRO-1 --- #
    def set_plan(self, plan, specs):
        """The mesh plan and {name: spec} of the (sharded) parameters."""
        self.plan = plan
        self.layout = {n: (tuple(specs.get(n, ())), None)
                       for n in self.params}

    def _zero_group(self, n: str):
        """The 8-bit store's group along the last axis (None: AdamW)."""
        return None

    def shard_zero1(self, plan, min_size: int = 1 << 16):
        """ZeRO-1: the moments of every leaf with a zero1_axis keep only
        this rank's slice over the data group (made anew: call before the
        first step; a resume restores into the slices)."""
        if self.plan is None:
            self.plan = plan
        for n, p in self.params.items():
            spec, _ = self.layout[n]
            ax = zero1_axis(p.shape, spec, plan.dp_size, min_size,
                            plan.tp_size, self._zero_group(n))
            self.layout[n] = (spec, ax)
        with torch.no_grad():
            self._init_moments()

    def _local(self, n: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of a parameter-shaped tensor (a view),
        or the tensor."""
        ax = self.layout[n][1]
        if ax is None:
            return t
        k = t.shape[ax] // self.plan.dp_size
        return t.narrow(ax, self.plan.dp_rank * k, k)

    def _shape(self, n: str, p: torch.Tensor):
        return tuple(self._local(n, p).shape)

    def _norm(self, grads) -> torch.Tensor:
        names = list(self.params)
        if self.plan is None or self.plan.tp_size == 1:
            return global_norm(grads[n] for n in names)
        return global_norm((grads[n] for n in names),
                           [tp_axis(self.layout[n][0]) is not None
                            for n in names], self.plan.model)

    def _gather(self, n: str, p: torch.Tensor, local: torch.Tensor):
        """Write the data group's updated slices into the whole parameter
        (a no-op for a leaf without a ZeRO-1 axis)."""
        ax = self.layout[n][1]
        if ax is not None:
            p.copy_(self.plan.data.all_gather(local.contiguous(), dim=ax))

    def _init_moments(self):
        self.mu = {n: torch.zeros(self._shape(n, p), dtype=p.dtype,
                                  device=p.device)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(m) for n, m in self.mu.items()}

    def state_trees(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The moment store under the field names of optax's state
        (training/checkpoints.py saves it under them)."""
        return {"mu": self.mu, "nu": self.nu}

    def moment_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for tree in
                   self.state_trees().values() for t in tree.values())

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        norm = self._norm(grads)
        # optax's rule: scale by max/norm only when norm >= max
        factor = torch.where(norm < self.grad_clip_norm,
                             torch.ones_like(norm),
                             self.grad_clip_norm / norm)
        lr = self.lr_schedule(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for n, p_all in self.params.items():
            p = self._local(n, p_all)
            g = self._local(n, grads[n]).mul_(factor)
            m, v = self.mu[n], self.nu[n]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)
            self._gather(n, p_all, p)
        return norm


# ---------------------------------------------------------------------------
# Blockwise 8-bit Adam moments
# ---------------------------------------------------------------------------

# leaves smaller than this keep exact f32 moments; 1-D leaves (biases,
# layernorm gains) always do, whatever their size
_MIN_QUANT_SIZE = 4096
_GROUP = 256
# elements per slice of the 8-bit update (whole rows of the last axis)
_SLICE_ELEMENTS = 1 << 24


def _group_size(last_dim: int) -> int:
    """Quantization group along the last axis; the whole axis when the dim
    does not divide."""
    return _GROUP if last_dim % _GROUP == 0 else last_dim


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (IEEE, as XLA's and the card's
    are; the CPU's vectorized f32 sqrt is not: it goes through f64 there)."""
    if x.device.type == "cpu":
        return x.double().sqrt().float()
    return x.sqrt()


def quantize_signed(x: torch.Tensor, group: int):
    """x f32 [..., L] -> (int8 codes [..., L], f32 scales [..., L/g]).
    Symmetric linear per group; zero groups get scale 1 (codes 0)."""
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // group, group)
    s = xb.abs().amax(dim=-1) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.round(xb / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(x.shape), s


def dequantize_signed(q: torch.Tensor, s: torch.Tensor, group: int):
    xb = q.reshape(*q.shape[:-1], q.shape[-1] // group, group).float()
    return (xb * s[..., None]).reshape(q.shape)


def quantize_sqrt(v: torch.Tensor, group: int):
    """Second moment, v >= 0: linear uint8 codes in the sqrt domain, which
    keeps the small entries of a group with one large entry resolved."""
    r = _sqrt(v)
    rb = r.reshape(*r.shape[:-1], r.shape[-1] // group, group)
    s = rb.amax(dim=-1) / 255.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.round(rb / s[..., None]).clamp(0, 255).to(torch.uint8)
    return q.reshape(v.shape), s


def dequantize_sqrt(q: torch.Tensor, s: torch.Tensor, group: int):
    rb = q.reshape(*q.shape[:-1], q.shape[-1] // group, group).float()
    r = (rb * s[..., None]).reshape(q.shape)
    return r * r


def _quantized_leaf(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.numel() >= _MIN_QUANT_SIZE


class AdamQ8(AdamW):
    """clip_by_global_norm -> scale_by_adam_q8 -> add_decayed_weights ->
    scale_by_learning_rate (the chain JAX's make_optimizer(moments_8bit=
    True) builds), with AdamW's interface. The state, under optax's field
    names: ``qm`` (int8 codes, or f32 moments for a small leaf), ``ms``
    (f32 group scales, or a 0-d zero), ``qv`` (uint8 codes or f32) and
    ``vs``."""

    def _zero_group(self, n: str):
        p = self.params[n]
        return _group_size(p.shape[-1]) if _quantized_leaf(p) else None

    def set_plan(self, plan, specs):
        """As AdamW's; a model split of the last axis must keep the 8-bit
        groups of the whole leaf inside each shard."""
        super().set_plan(plan, specs)
        for n, p in self.params.items():
            ax = tp_axis(self.layout[n][0])
            if plan.tp_size > 1 and _quantized_leaf(p) and ax is not None \
                    and ax % p.dim() == p.dim() - 1:
                whole = p.shape[-1] * plan.tp_size
                if p.shape[-1] % _group_size(whole):
                    raise NotImplementedError(
                        f"8-bit Adam moments of {n}: the model split leaves "
                        f"{p.shape[-1]} of {whole} columns per rank, which "
                        f"cuts the {_group_size(whole)}-wide groups; use "
                        f"AdamW (no --adam_8bit) at this tp_size")
        with torch.no_grad():
            self._init_moments()

    def _init_moments(self):
        self.qm, self.ms, self.qv, self.vs = {}, {}, {}, {}
        for n, p in self.params.items():
            kw = dict(device=p.device)
            shape = self._shape(n, p)
            if _quantized_leaf(p):
                g = _group_size(p.shape[-1])
                scales = (*shape[:-1], shape[-1] // g)
                self.qm[n] = torch.zeros(shape, dtype=torch.int8, **kw)
                self.qv[n] = torch.zeros(shape, dtype=torch.uint8, **kw)
                self.ms[n] = torch.ones(scales, **kw)
                self.vs[n] = torch.ones(scales, **kw)
            else:
                self.qm[n] = torch.zeros(shape, **kw)
                self.qv[n] = torch.zeros(shape, **kw)
                self.ms[n] = torch.zeros((), **kw)
                self.vs[n] = torch.zeros((), **kw)

    def state_trees(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"qm": self.qm, "ms": self.ms, "qv": self.qv, "vs": self.vs}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        norm = self._norm(grads)
        clip = norm < self.grad_clip_norm
        scale = np.float32(-self.lr_schedule(self.count))
        lr_scale = {dt: torch.tensor(scale, dtype=dt, device=norm.device)
                    for dt in {p.dtype for p in self.params.values()}}
        self.count += 1
        # 1 - b ** count in f32, as the JAX update computes it
        bc1, bc2 = (float(np.float32(1.0) - np.float32(b)
                          ** np.float32(self.count))
                    for b in (self.b1, self.b2))
        for n, p_all in self.params.items():
            # a ZeRO-1 slice is updated in a contiguous copy, then gathered
            zero = self.layout[n][1] is not None
            p = self._local(n, p_all)
            g = self._local(n, grads[n])
            if zero:
                p, g = p.contiguous(), g.contiguous()
            last = p.shape[-1] if p.dim() else 1
            rows = p.numel() // max(last, 1)
            step = max(1, _SLICE_ELEMENTS // max(last, 1))
            # views: the slices are written in place
            flat = [t.view(rows, -1) if t.dim() else t.view(1, 1)
                    for t in (p, g, self.qm[n], self.qv[n])]
            coded = self.qm[n].dtype == torch.int8
            if coded:
                gsz = _group_size(last)
                ms, vs = (self.ms[n].view(rows, -1),
                          self.vs[n].view(rows, -1))
            for r in range(0, rows, step):
                pr, gr, qm, qv = (t[r:r + step] for t in flat)
                # optax's clip: t, or (t / norm) * max, in the grad's dtype
                gr = torch.where(clip, gr, (gr / norm.to(gr.dtype))
                                 * self.grad_clip_norm)
                gf = gr.float()
                if coded:
                    m = dequantize_signed(qm, ms[r:r + step], gsz)
                    v = dequantize_sqrt(qv, vs[r:r + step], gsz)
                else:
                    m, v = qm, qv
                m = self.b1 * m + (1.0 - self.b1) * gf
                v = self.b2 * v + (1.0 - self.b2) * gf * gf
                upd = (m / bc1) / (_sqrt(v / bc2) + self.eps)
                if coded:
                    q, s = quantize_signed(m, gsz)
                    qm.copy_(q)
                    ms[r:r + step].copy_(s)
                    q, s = quantize_sqrt(v, gsz)
                    qv.copy_(q)
                    vs[r:r + step].copy_(s)
                else:
                    qm.copy_(m)
                    qv.copy_(v)
                upd = upd.to(gr.dtype)
                if self.weight_decay:
                    upd = upd + self.weight_decay * pr
                pr.add_(lr_scale[upd.dtype] * upd)
            self._gather(n, p_all, p)
        return norm


def make_optimizer(params: Dict[str, torch.Tensor], lr: float = 1e-5,
                   num_warmup_steps: int = 0, grad_clip_norm: float = 40.0,
                   weight_decay: float = 0.0,
                   moments_8bit: bool = False) -> AdamW:
    """Twin of make_optimizer (optax.MultiSteps is not ported:
    train_one_epoch accumulates gradients itself). ``moments_8bit`` keeps
    the moments in the 8-bit store (AdamQ8)."""
    cls = AdamQ8 if moments_8bit else AdamW
    return cls(params, constant_with_warmup(lr, num_warmup_steps),
               grad_clip_norm=grad_clip_norm, weight_decay=weight_decay)
