"""Checkpointing: save and restore the model's parameters and optimizer state.

Twin of navillm_tpu/training/checkpoints.py (reference tools/optims.py:
7-32, 65-78): a checkpoint holds {params [, optimizer state, epoch]};
restore is shape-tolerant and non-strict (an entry whose shape differs
from the live tensor's is skipped and logged); the resume epoch is the
saved epoch + 1.

Every tensor is stored under the JAX package's flat key: ``params/`` + the
parameter's path with "/" for "." (``params/llm/layers/wq``), and the
optimizer state under the flat names of the optax state that
``make_optimizer`` builds (chain(clip_by_global_norm, chain(moment store,
add_decayed_weights, scale_by_learning_rate))): ``opt/1/0/.count``, the
moment store's fields ``opt/1/0/.<field>/<path>`` (AdamW's ``mu`` and
``nu``; the 8-bit store's ``qm``, ``ms``, ``qv`` and ``vs``) and the
schedule's ``opt/1/2/.count``. So a checkpoint one package writes restores
into the other, moments and step count included.

Backends, behind one API, each written to a temporary file renamed into
place, beside a JSON header {"epoch", "backend", "has_opt"}:
  - "npz" (below 1 GiB of parameters): the JAX package's layout, bf16
    stored as f32 (np.savez has no bf16);
  - "torch" (from 1 GiB): one ``torch.save`` file of the same flat keys,
    bf16 kept as bf16 (a 7B tree is ~13.5 GB, not 27), read back through
    a memory map. The JAX package writes orbax there, which the port
    cannot read: restoring an orbax checkpoint raises.

Under a mesh plan (parallel/mesh.py) the live tensors are shards: the
model group's split of each LLM leaf (``specs``) and, for the moments,
ZeRO-1's slice over the data group (the optimizer's ``layout``). Saving
gathers every tensor whole (all ranks take part) and rank 0 writes the
file a single-card run writes; loading reads the whole file on every rank
and copies each rank's slices, after a barrier.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

SEP = "/"
TORCH_THRESHOLD_BYTES = 1 << 30
# optax's chain(clip_by_global_norm, adamw(schedule)) state, flattened (the
# moment store's fields are under OPT_STATE + field)
OPT_COUNT = "opt/1/0/.count"
OPT_STATE = "opt/1/0/."
OPT_SCHEDULE_COUNT = "opt/1/2/.count"
SUFFIXES = (".npz", ".pt", ".json")


def _named(params) -> Dict[str, torch.Tensor]:
    """{dotted name: tensor} of a ParamTree (any nn.Module) or such a
    dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _key(prefix: str, name: str) -> str:
    return prefix + SEP + name.replace(".", SEP)


def flat_state(params, opt_state=None) -> Dict[str, torch.Tensor]:
    """The checkpoint's flat keys -> tensors (the live ones, not copies)."""
    flat = {_key("params", n): p.detach() for n, p in _named(params).items()}
    if opt_state is not None:
        count = torch.tensor(opt_state.count, dtype=torch.int32)
        flat[OPT_COUNT] = flat[OPT_SCHEDULE_COUNT] = count
        for field, tree in opt_state.state_trees().items():
            flat.update({_key(OPT_STATE + field, n): m
                         for n, m in tree.items()})
    return flat


def _layouts(params, opt_state, specs) -> Dict[str, Any]:
    """{flat key: (spec, zero1 axis)} of every sharded tensor."""
    specs = specs or {}
    out = {_key("params", n): (tuple(specs.get(n, ())), None)
           for n in _named(params)}
    if opt_state is not None:
        for field, tree in opt_state.state_trees().items():
            for n, t in tree.items():
                if t.dim():                 # 0-d scales are whole
                    out[_key(OPT_STATE + field, n)] = opt_state.layout[n]
    return out


def _gather(t: torch.Tensor, layout, plan) -> torch.Tensor:
    """A shard made whole: the data group's ZeRO-1 slices, then the model
    group's split."""
    from ..parallel.mesh import tp_axis
    spec, zax = layout
    if zax is not None and plan.dp_size > 1:
        t = plan.data.all_gather(t, dim=zax)
    ax = tp_axis(spec)
    if ax is not None and plan.tp_size > 1:
        t = plan.model.all_gather(t, dim=ax)
    return t


def _slice(t: torch.Tensor, layout, plan) -> torch.Tensor:
    """This rank's shard of a whole tensor (the inverse of _gather)."""
    from ..parallel.mesh import local_slice
    spec, zax = layout
    t = local_slice(t, spec, plan)
    if zax is not None and plan.dp_size > 1:
        k = t.shape[zax] // plan.dp_size
        t = t.narrow(zax, plan.dp_rank * k, k)
    return t


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()                 # lossless; restore casts back
    return t.cpu().numpy()


def save_checkpoint(path, params, opt_state=None, epoch: Optional[int] = None,
                    backend: str = "auto", plan=None, specs=None):
    """Write ``path``.npz or ``path``.pt and ``path``.json. ``params``: a
    ParamTree or {dotted name: tensor}; ``opt_state``: the port's AdamW or
    AdamQ8. Under a ``plan`` every rank calls it with its shards and the
    parameters' {name: spec} ``specs``; rank 0 writes the whole tensors."""
    path = Path(path)
    flat = flat_state(params, opt_state)
    if plan is not None and plan.world_size > 1:
        lay = _layouts(params, opt_state, specs)
        flat = {k: (_gather(v, lay[k], plan) if k in lay else v)
                for k, v in flat.items()}
        if plan.rank != 0:
            return
    path.parent.mkdir(parents=True, exist_ok=True)
    if backend == "auto":
        nbytes = sum(v.numel() * v.element_size() for k, v in flat.items()
                     if k.startswith("params" + SEP))
        backend = "torch" if nbytes >= TORCH_THRESHOLD_BYTES else "npz"
    header: Dict[str, Any] = {"epoch": epoch, "backend": backend}
    if opt_state is not None:
        header["has_opt"] = True
    if backend == "npz":
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **{k: _numpy(v) for k, v in flat.items()})
        os.replace(tmp, path.with_suffix(".npz"))
    elif backend == "torch":
        tmp = path.with_suffix(".tmp.pt")
        torch.save(flat, tmp)
        os.replace(tmp, path.with_suffix(".pt"))
    else:
        raise ValueError(f"unknown checkpoint backend {backend!r} (npz, "
                         f"torch; orbax is the JAX package's)")
    with open(path.with_suffix(".json"), "w") as f:
        json.dump(header, f)


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    # ascontiguousarray makes a 0-d array 1-d: keep the shape
    a = np.ascontiguousarray(x).reshape(x.shape)
    if x.dtype.kind == "V" and x.dtype.itemsize == 2:
        # a legacy JAX npz leaf: bf16 bits that np.savez wrote as void
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _restore_into(live: Dict[str, torch.Tensor], flat, prefix: str,
                  logger=None, plan=None, layouts=None):
    """Copy flat entries into the live tensors in place, casting to their
    dtype and device (under a plan, this rank's slice of each); entries
    whose shape differs are skipped and logged."""
    skipped = []
    with torch.no_grad():
        for name, t in live.items():
            key = _key(prefix, name)
            if key not in flat:
                continue
            src = flat[key]
            if plan is not None and key in (layouts or {}):
                src = _slice(_as_tensor(src), layouts[key], plan)
            if tuple(src.shape) != tuple(t.shape):
                skipped.append((key, tuple(src.shape), tuple(t.shape)))
                continue
            t.copy_(_as_tensor(src).to(t.dtype))
    if logger is not None:
        for key, got, want in skipped:
            logger.info("Ignore weight %s: %s (model wants %s)"
                        % (key, got, want))
    return skipped


def load_checkpoint(path, params, opt_state=None, logger=None, plan=None,
                    specs=None) -> Tuple[Any, Any, int]:
    """Restore into ``params`` (and the optimizer's ``opt_state``) in place.
    Under a ``plan`` (with the parameters' ``specs``) each rank copies its
    slices of the whole file. Returns (params, opt_state,
    resume_from_epoch)."""
    path = Path(path)
    if plan is not None and plan.world_size > 1:
        import torch.distributed as dist
        dist.barrier()
    lay = _layouts(params, opt_state, specs) if plan is not None else None
    header = {}
    if path.with_suffix(".json").exists():
        header = json.loads(path.with_suffix(".json").read_text())
    backend = header.get("backend")
    if backend is None:
        backend = next((b for b, s in (("npz", ".npz"), ("torch", ".pt"),
                                       ("orbax", ".orbax"))
                        if path.with_suffix(s).exists()), None)
    if backend == "orbax":
        raise RuntimeError(
            f"{path.with_suffix('.orbax')} is an orbax checkpoint (the JAX "
            f"package's backend from 1 GiB), which the port cannot read; "
            f"re-save it from JAX with backend='npz'")
    if backend == "torch":
        flat = torch.load(path.with_suffix(".pt"), map_location="cpu",
                          mmap=True, weights_only=True)
    elif backend == "npz":
        data = np.load(path.with_suffix(".npz"), allow_pickle=False)
        flat = {k: data[k] for k in data.files}
    else:
        raise FileNotFoundError(f"no checkpoint at {path}")

    _restore_into(_named(params), flat, "params", logger, plan, lay)
    if opt_state is not None and OPT_COUNT in flat:
        opt_state.count = int(_as_tensor(flat[OPT_COUNT]))
        for field, tree in opt_state.state_trees().items():
            _restore_into(tree, flat, OPT_STATE + field, logger, plan, lay)
    epoch = header.get("epoch")
    return params, opt_state, (epoch + 1) if epoch is not None else 0


def checkpoint_exists(path) -> bool:
    p = Path(path)
    return any(p.with_suffix(s).exists() for s in (".npz", ".pt", ".orbax"))


def remove_checkpoint(path):
    """Delete a checkpoint's files (the retention policy's worst epoch)."""
    p = Path(path)
    for suffix in SUFFIXES:
        if p.with_suffix(suffix).exists():
            p.with_suffix(suffix).unlink()
