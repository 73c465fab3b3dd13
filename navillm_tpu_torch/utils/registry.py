"""Name-keyed registries for datasets and agents (twin of
navillm_tpu/utils/registry.py). A name the JAX package registers but the
port does not yet raises NotImplementedError naming its ROADMAP item."""
from typing import Callable, Dict

# the JAX package's registered names that the port lacks, by ROADMAP item
PENDING = {"cvdn": "A8", "r2r_aug": "A8", "reverie_aug": "A8",
           "scanqa": "A8", "llava": "A8", "coco": "A8"}


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
            if name in PENDING:
                raise NotImplementedError(
                    f"the {self.kind} '{name}' is not ported yet (ROADMAP "
                    f"{PENDING[name]}); ported: {sorted(self._items)}")
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
