"""Parameter trees as nn.Modules.

The JAX package keeps parameters as nested dicts (pytrees) and passes
them to pure functions. ``ParamTree`` holds the same nested dict as an
``nn.Module`` (one frozen ``nn.Parameter`` per leaf, one child module per
sub-dict), and indexes like the dict, so the port's functions read
``params["layers"]["wq"]`` from either form and ``.to(device)`` /
``state_dict()`` work on the whole tree.
"""
from __future__ import annotations

from typing import Any, Dict

from torch import nn


class ParamTree(nn.Module):
    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules
