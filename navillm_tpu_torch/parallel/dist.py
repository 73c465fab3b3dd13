"""Prediction gathering for validation (twin of navillm_tpu/parallel/dist.py,
in its single-process form).

The port runs on one card: ``all_gather_objects`` returns ``[obj]``, what
the JAX helper returns when jax.process_count() == 1. A multi-process run
(torch.distributed initialized with more than one rank) raises: the mesh,
ZeRO-1 and the object all-gather are ROADMAP A10.
"""
from __future__ import annotations

from typing import Any, List


def all_gather_objects(obj: Any) -> List[Any]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError("gathering predictions across processes "
                                  "is not ported yet (ROADMAP A10)")
    return [obj]


def merge_dist_results(results: List[List[Any]]) -> List[Any]:
    """Flatten per-rank prediction lists (reference train.py:177-181)."""
    out = []
    for res in results:
        out.extend(res)
    return out
