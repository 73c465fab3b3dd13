"""Name-keyed registries for datasets and agents (twin of
navillm_tpu/utils/registry.py). An unknown name raises KeyError, as in
the JAX package."""
from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Callable] = {}

    def register(self, name: str) -> Callable[[Callable], Callable]:
        def deco(obj: Callable) -> Callable:
            if name in self._items:
                raise KeyError(f"duplicate {self.kind} registration: {name}")
            self._items[name] = obj
            obj.name = name
            return obj
        return deco

    def get(self, name: str) -> Callable:
        if name not in self._items:
            raise KeyError(f"unknown {self.kind} '{name}'; known: "
                           f"{sorted(self._items)}")
        return self._items[name]

    def build(self, name: str, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def keys(self):
        return self._items.keys()


DATASETS = Registry("dataset")
AGENTS = Registry("agent")
