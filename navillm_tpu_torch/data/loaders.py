"""Per-task loaders and the ratio-weighted meta-sampler.

The port's copy of ``Dataloader`` and ``MetaLoader`` from
navillm_tpu/data/loaders.py, with the same names and order of batches
(plain Python over numpy RNGs, which replace the reference's torch
DataLoader + DistributedSampler + dist.broadcast MetaLoader,
tasks/loaders.py:12-250):
  - Dataloader: seeded shuffle, rank-sharded, identity collate;
  - MetaLoader: multinomial task sampling from a *shared-seed* RNG — all
    hosts draw the same task id with zero collectives, unless
    off_batch_task desynchronizes on purpose;
  - exhausted task iterators re-init with an epoch-bumped shuffle
    (StopIteration handling at loaders.py:181-189).
Batches are host-side lists; the agents move fixed-shape arrays to the
card. ``create_dataloaders`` (the config-driven multi-dataset builder)
waits for the port's dataset registry.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np


class Dataloader:
    """Seeded, rank-sharded, batching iterator over a dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 rank: int = 0, world_size: int = 1, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        # pad so every rank gets the same count (DistributedSampler style)
        if self.world_size > 1:
            per = -(-n // self.world_size)
            order = np.concatenate([order, order[: per * self.world_size - n]])
            order = order[self.rank::self.world_size]
        return order

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self):
        idx = self._indices()
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            samples = [self.dataset[int(j)] for j in chunk]
            yield self.dataset.collate_batch(samples)


class MetaLoader:
    """Ratio-weighted infinite sampler over named task loaders."""

    def __init__(self, loaders: Dict[str, Tuple[Dataloader, float]],
                 dist_coef: float = 1.0, seed: int = 0,
                 off_batch_task: bool = False, rank: int = 0):
        self.names: List[str] = []
        self.loaders: Dict[str, Dataloader] = {}
        self.iters: Dict[str, Iterator] = {}
        ratios: List[float] = []
        for name, (loader, ratio) in loaders.items():
            self.names.append(name)
            self.loaders[name] = loader
            self.iters[name] = iter(loader)
            ratios.append(float(ratio))
        p = np.asarray(ratios) * dist_coef
        self.probs = p / p.sum()
        # shared seed => identical task sequence on every host
        self.task_rng = np.random.RandomState(
            seed + (rank if off_batch_task else 0))
        self.epochs = {name: 0 for name in self.names}

    def __iter__(self):
        return self

    def __next__(self):
        task_idx = int(self.task_rng.choice(len(self.names), p=self.probs))
        name = self.names[task_idx]
        try:
            batch = next(self.iters[name])
        except StopIteration:
            self.epochs[name] += 1
            self.loaders[name].set_epoch(self.epochs[name])
            self.iters[name] = iter(self.loaders[name])
            batch = next(self.iters[name])
        return name, batch
