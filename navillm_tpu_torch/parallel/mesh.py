"""The (data, model) process grid over torch.distributed: data and tensor
parallelism of the port.

Torch twin of navillm_tpu/parallel/mesh.py. JAX lays its devices out as a
('data', 'model') mesh inside one program and lets GSPMD insert the
collectives; here there is one process per card (torchrun), and the grid,
the local shards and the collectives are explicit:

  - rank r is (dp_rank, tp_rank) = (r // tp, r % tp), the order of
    make_mesh's ``reshape(dp_size, tp_size)``;
  - the *data group* holds the ranks with the same tp_rank: every rank of
    it reads its own batches (the loaders shard by its rank and size), and
    gradients are averaged over it;
  - the *model group* holds the ranks with the same dp_rank: they run one
    host loop in lockstep on the same batches and split the LLM
    megatron-style (models/llama.py: column-split wq/wk/wv/w_gate/w_up
    and lm_head, row-split wo/w_down and the vocabulary rows of embed);
  - ZeRO-1: the optimizer's moments of a large leaf keep only this rank's
    slice over the data group (``zero1_axis``); the optimizer updates its
    slice and the data group all-gathers the updated parameters.

A partition spec is a tuple with one entry per axis: "model" where the
model group splits that axis, None where it is whole (JAX's
PartitionSpec, as a plain tuple).

Backend: NCCL when each rank has a card of its own, gloo on the CPU or
when the caller names it (two ranks that share one card: NCCL refuses
them). A gloo group stages CUDA tensors through host memory explicitly
(``Group.staged``): each collective copies the tensor to the host, runs
there and copies the result back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]


class Group:
    """One process group of the grid: its ranks, this rank's index in it,
    and its collectives. ``pg`` None is the trivial group of one rank,
    whose collectives return their input."""

    def __init__(self, ranks: Sequence[int], pg, backend: str):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank()) \
            if pg is not None else 0
        self.pg = pg
        self.backend = backend
        # collectives launched on CUDA tensors through host memory
        self.staged_calls = 0

    def staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _run(self, t: torch.Tensor, fn) -> torch.Tensor:
        """fn(contiguous tensor) in place, through the host on gloo."""
        if self.staged(t):
            self.staged_calls += 1
            h = t.detach().to("cpu")
            fn(h)
            return h.to(t.device)
        t = t.detach().contiguous().clone()
        fn(t)
        return t

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: the sum (or max) of ``t`` over the group."""
        if self.pg is None:
            return t
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._run(t, lambda x: dist.all_reduce(x, rop, group=self.pg))

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The members' tensors concatenated along ``dim``, in group
        order."""
        if self.pg is None:
            return t
        src = t.detach().to("cpu") if self.staged(t) else \
            t.detach().contiguous()
        if self.staged(t):
            self.staged_calls += 1
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.pg)
        return torch.cat(parts, dim=dim).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The group member ``src``'s tensor, on every member."""
        if self.pg is None:
            return t
        root = self.ranks[src]
        return self._run(t, lambda x: dist.broadcast(x, root, group=self.pg))


@dataclasses.dataclass
class MeshPlan:
    dp_size: int
    tp_size: int
    rank: int
    world_size: int
    data: Group        # same tp_rank: batches differ, gradients averaged
    model: Group       # same dp_rank: one host loop, the LLM split
    device: torch.device
    backend: str

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp_size

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp_size

    @property
    def model_group(self) -> Optional[Group]:
        """The model group when it splits the LLM (tp > 1), else None."""
        return self.model if self.tp_size > 1 else None

    def describe(self) -> str:
        return (f"mesh: dp={self.dp_size} tp={self.tp_size} over "
                f"{self.world_size} processes, backend {self.backend}"
                + (" (CUDA tensors staged through host memory)"
                   if self.backend == "gloo" and self.device.type == "cuda"
                   else ""))


def make_mesh(dp_size: int = -1, tp_size: int = 1,
              device=None) -> MeshPlan:
    """The grid over the initialized default process group (or over this
    process alone when none is initialized). ``device``: this rank's
    device (default: the card of LOCAL_RANK; raises without CUDA).
    Every rank must call it: the groups are created collectively."""
    import os
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if dp_size == -1:
        dp_size = n // tp_size
    if dp_size * tp_size != n:
        raise ValueError(f"dp_size {dp_size} x tp_size {tp_size} != world "
                         f"size {n}: one process per card (launch with "
                         f"torchrun --nproc_per_node)")
    backend = dist.get_backend() if initialized else "none"
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make_mesh places this rank "
                               "on the card of LOCAL_RANK; pass "
                               "device='cpu' to build the grid on the CPU")
        device = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    data_groups = [[d * tp_size + t for d in range(dp_size)]
                   for t in range(tp_size)]
    model_groups = [[d * tp_size + t for t in range(tp_size)]
                    for d in range(dp_size)]

    def mine(groups):
        """new_group is collective: every rank creates every group."""
        out = None
        for ranks in groups:
            pg = dist.new_group(ranks) if initialized and n > 1 else None
            if rank in ranks:
                out = Group(ranks, pg if len(ranks) > 1 else None, backend)
        return out

    data = mine(data_groups)
    model = mine(model_groups)
    return MeshPlan(dp_size=dp_size, tp_size=tp_size, rank=rank,
                    world_size=n, data=data, model=model,
                    device=torch.device(device), backend=backend)


def replicated(plan: MeshPlan) -> Spec:
    """The spec of a leaf every rank holds whole."""
    return ()


def _spec_at(specs, path: Sequence[str]) -> Spec:
    node = specs
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return replicated(None)
        node = node[k]
    return node if isinstance(node, tuple) else replicated(None)


def tp_axis(spec: Spec) -> Optional[int]:
    """The axis the model group splits, or None."""
    return spec.index("model") if "model" in spec else None


def local_slice(x: torch.Tensor, spec: Spec, plan: MeshPlan,
                name: str = "") -> torch.Tensor:
    """This rank's shard of a whole leaf under ``spec`` (a contiguous
    copy, so every shard is 16-byte aligned for the kernels)."""
    ax = tp_axis(spec)
    if ax is None or plan.tp_size == 1:
        return x
    ax = ax % x.dim()
    n = x.shape[ax]
    if n % plan.tp_size:
        raise ValueError(f"{name}: axis {ax} of {tuple(x.shape)} does not "
                         f"divide by the model degree {plan.tp_size}")
    k = n // plan.tp_size
    return x.narrow(ax, plan.tp_rank * k, k).contiguous()


def shard_params(params: Dict[str, Any], specs: Dict[str, Any],
                 plan: MeshPlan, group_size: Optional[int] = None
                 ) -> Dict[str, Any]:
    """The local shards of a whole parameter tree (nested dicts or
    ParamTrees of tensors) under ``specs``, which mirror the tree with
    spec leaves; leaves without a spec stay whole (replicated).

    int4 leaves ({"q4p" [.., h, o/2] uint8, "s" [.., h/G, o]}): the packed
    axis holds channel pairs, so a column split must leave each rank a
    whole number of pairs; the group scales follow the weight (columns
    with a column split, rows with a row split), so a row split of h must
    land on the G-wide groups."""

    def walk(node, path):
        if hasattr(node, "items") and not isinstance(node, torch.Tensor):
            items = dict(node.items())
            if "q4p" in items:
                return q4(items, path)
            return {k: walk(v, path + (k,)) for k, v in items.items()}
        return local_slice(node, _spec_at(specs, path), plan,
                           "/".join(path))

    def q4(leaf, path):
        spec = _spec_at(specs, path + ("q4p",))
        q, s = leaf["q4p"], leaf["s"]
        ax = tp_axis(spec)
        if ax is None or plan.tp_size == 1:
            return {"q4p": q, "s": s}
        name = "/".join(path)
        ax = ax % q.dim()
        if ax == q.dim() - 1:
            if q.shape[-1] % plan.tp_size:
                raise ValueError(
                    f"{name}: q4p's last axis {q.shape[-1]} (= "
                    f"out_channels/2) must divide by the model degree "
                    f"{plan.tp_size}: a shard's output-channel count would "
                    f"be odd, splitting a nibble pair across shards")
            return {"q4p": local_slice(q, spec, plan, name),
                    "s": local_slice(s, spec, plan, name)}
        h = q.shape[ax]
        g = h // s.shape[ax]
        if (h // plan.tp_size) % g:
            raise ValueError(f"{name}: a row split of h={h} over "
                             f"{plan.tp_size} ranks must land on the "
                             f"{g}-wide int4 groups")
        return {"q4p": local_slice(q, spec, plan, name),
                "s": local_slice(s, spec, plan, name)}

    return walk(params, ())


def zero1_axis(shape: Sequence[int], spec: Spec, dp_size: int,
               min_size: int = 1 << 16, tp_size: int = 1,
               group: Optional[int] = None) -> Optional[int]:
    """The axis of a leaf (local shape under ``spec``) whose optimizer
    moments ZeRO-1 splits over the data group, or None: the first axis
    the model group leaves whole whose size divides by dp_size (and is
    above 1), for leaves of at least ``min_size`` elements in all (JAX's
    rule). ``group``: the 8-bit store's quantization group along the last
    axis, which a split of the last axis must keep whole."""
    if dp_size <= 1:
        return None
    numel = 1
    for d in shape:
        numel *= d
    if numel * (tp_size if tp_axis(spec) is not None else 1) < min_size:
        return None
    tax = tp_axis(spec)
    tax = tax % len(shape) if tax is not None else None
    for i, d in enumerate(shape):
        if i == tax or d <= 1 or d % dp_size:
            continue
        if group is not None and i == len(shape) - 1 and \
                (d // dp_size) % group:
            continue
        return i
    return None


def zero1_shard_opt_state(opt, plan: MeshPlan, min_size: int = 1 << 16):
    """ZeRO-1 (Rajbhandari et al. 2019) on an optimizer of
    training/optim.py: each large leaf's moments keep only this rank's
    slice over the data group, on top of the model group's split. Params
    and gradients stay whole over the data group (plain DDP semantics,
    loss-equal); the optimizer updates its slice and all-gathers the
    updated parameters. Returns ``opt``."""
    if plan is None or plan.dp_size <= 1:
        return opt
    opt.shard_zero1(plan, min_size)
    return opt


def nav_param_specs(nav_cfg, quantized: bool = False,
                    bits: int = 8) -> Dict[str, Any]:
    """Specs of the NavModel tree: the LLM's per llama.partition_specs;
    the panorama encoder and the heads replicated (under 1% of the
    parameters)."""
    from ..models import llama as L
    return {"llm": L.partition_specs(nav_cfg.llm, quantized=quantized,
                                     bits=bits)}


def flat_specs(specs: Dict[str, Any], prefix: str = "") -> Dict[str, Spec]:
    """{dotted name: spec} of a spec tree (the names of named_parameters)."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# --------------------------------------------------- the TP collectives -- #
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (the
    input of a column-split matmul: each rank sees part of its
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward (the partial products of a
    row-split matmul, the masked embedding rows); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The members' last axes concatenated forward (the column-split
    logits); this rank's columns of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return group.all_gather(x, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.group.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, group: Optional[Group]):
    if group is None or not _grad(x):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Optional[Group]):
    if group is None:
        return x
    if _grad(x):
        return _ReduceFromModel.apply(x, group)
    return group.all_reduce(x)


def gather_from_model(x: torch.Tensor, group: Optional[Group]):
    if group is None:
        return x
    if _grad(x):
        return _GatherFromModel.apply(x, group)
    return group.all_gather(x, dim=-1)
