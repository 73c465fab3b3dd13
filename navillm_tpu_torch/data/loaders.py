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
card. ``create_dataloaders`` makes the loaders of a stage from the config,
over the port's dataset registry (data/datasets.py).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

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


# task name -> registry name, and task name -> feature-DB key
# (reference tasks/loaders.py:33-40)
NAME_OF = {"R2R": "r2r", "REVERIE": "reverie", "CVDN": "cvdn",
           "SOON": "soon", "EQA": "eqa", "ScanQA": "scanqa",
           "LLaVA": "llava", "R2R_AUG": "r2r_aug",
           "REVERIE_AUG": "reverie_aug", "COCO": "coco"}
FEAT_KEY = {"R2R": "mp3d", "REVERIE": "mp3d", "CVDN": "mp3d",
            "SOON": "mp3d", "EQA": "mp3d", "R2R_AUG": "mp3d",
            "REVERIE_AUG": "mp3d", "ScanQA": "scan_qa", "LLaVA": "coco"}


def create_dataloaders(args, config, training: bool, world=None,
                       feat_dbs=None, obj_feat_dbs=None, stage=None,
                       test_datasets: Optional[List[str]] = None,
                       logger=None):
    """{task: (Dataloader, ratio)} and {task: dataset} for a stage (twin
    of create_dataloaders; reference tasks/loaders.py:12-87): the stage
    section gives SOURCE and Ratio; feature DBs are injected by the caller
    or built from the config (build_world_and_data). A source the port
    has no dataset for raises (utils/registry.py)."""
    from .datasets import load_dataset

    stage = stage or args.stage
    stage_cfg = config[{"pretrain": "Pretrain", "multi": "Multi"}
                       .get(stage, stage)]
    sources = list(stage_cfg.SOURCE)
    ratios = list(stage_cfg.get("Ratio", [1] * len(sources)))
    if test_datasets is not None:
        keep = [i for i, s in enumerate(sources) if s in test_datasets]
        sources = [sources[i] for i in keep]
        ratios = [ratios[i] for i in keep]

    loaders: Dict[str, Tuple[Dataloader, float]] = {}
    datasets: Dict[str, Any] = {}
    for source, ratio in zip(sources, ratios):
        ds = load_dataset(NAME_OF[source], args, config, training=training,
                          logger=logger, source=source, world=world)
        if feat_dbs is not None:
            obj_db = None
            if obj_feat_dbs is not None:
                if source.startswith("REVERIE"):
                    obj_db = obj_feat_dbs.get("reverie")
                elif source == "SOON":
                    obj_db = obj_feat_dbs.get("soon")
            ds.init_feat_db(feat_dbs[FEAT_KEY[source]], obj_db)
        bs = args.batch_size if training else args.val_batch_size
        # one shard per rank of the data group: the ranks of a model group
        # (tp_size consecutive ranks) read the same batches
        tp = max(getattr(args, "tp_size", 1), 1)
        loaders[source] = (Dataloader(ds, bs, shuffle=training,
                                      rank=args.rank // tp,
                                      world_size=max(args.world_size // tp,
                                                     1),
                                      seed=args.seed), float(ratio))
        datasets[source] = ds
    return loaders, datasets
