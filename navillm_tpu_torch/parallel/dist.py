"""Process start-up and object gathering over torch.distributed.

Twin of navillm_tpu/parallel/dist.py, for one process per card:

  - ``init_distributed`` joins the process group that ``torchrun`` (or the
    caller) describes: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT, or an explicit ``init_method``. NCCL when each local rank
    has a card of its own, gloo otherwise (the CPU, or ranks that share a
    card); the caller may name the backend, and the choice is printed;
  - ``all_gather_objects`` exchanges a picklable object with every member
    of a group (default: all ranks): each pickles it, the lengths are
    gathered, every payload is padded to the longest and gathered as
    uint8, then each is unpickled at its own length (JAX's padded-pickle
    exchange). One process returns ``[obj]``;
  - ``merge_dist_results`` flattens the ranks' prediction lists
    (validation merges them on rank 0).
"""
from __future__ import annotations

import os
import pickle
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Join the process group; True when one was joined (world size above
    1), False for a single process. Without arguments everything comes
    from torchrun's environment."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None \
        else int(os.environ.get("WORLD_SIZE", 1))
    if world_size <= 1:
        return False
    rank = rank if rank is not None else int(os.environ["RANK"])
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = "nccl" if torch.cuda.is_available() and \
            torch.cuda.device_count() >= local else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    if rank == 0:
        print(f"torch.distributed: backend {backend}, world size "
              f"{world_size}", flush=True)
    return True


def all_gather_objects(obj: Any, group=None) -> List[Any]:
    """[every member's obj] in rank order. ``group``: a parallel.mesh.Group
    (the data group for validation) or None for all ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    pg = getattr(group, "pg", None)
    if group is not None and pg is None:
        return [obj]                     # a group of one
    n = dist.get_world_size(pg)
    if n == 1:
        return [obj]
    payload = torch.from_numpy(
        np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy())
    # gloo runs on host tensors; NCCL needs them on this rank's card
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(pg) == "nccl" else torch.device("cpu")
    lens = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([payload.numel()], device=dev),
                    group=pg)
    sizes = [int(x) for x in lens]
    padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    padded[: payload.numel()] = payload.to(dev)
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded, group=pg)
    return [pickle.loads(p[:k].cpu().numpy().tobytes())
            for p, k in zip(parts, sizes)]


def merge_dist_results(results: List[List[Any]]) -> List[Any]:
    """Flatten per-rank prediction lists (reference train.py:177-181)."""
    out = []
    for res in results:
        out.extend(res)
    return out
