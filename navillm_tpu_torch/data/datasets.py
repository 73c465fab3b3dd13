"""Dataset registry (twin of navillm_tpu/data/datasets/__init__.py;
reference tasks/datasets/__init__.py:14-16). ``load_dataset(name, args,
config, training=..., logger=..., source=..., world=...)`` builds a
dataset from the task config as the JAX package's does: ``r2r``,
``r2r_aug``, ``cvdn``, ``eqa``, ``reverie``, ``reverie_aug``, ``soon``,
``scanqa`` and ``llava``. Another name raises KeyError, as in JAX."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from ..sim.env import WorldModel
from ..utils.registry import DATASETS
from .aug import R2RAugDataset, REVERIEAugDataset
from .cvdn import CVDNDataset
from .eqa import EQADataset
from .llava import LLaVADataset
from .r2r import R2RDataset
from .reverie import REVERIEDataset
from .scanqa import ScanQADataset
from .soon import SOONDataset


def load_dataset(name: str, *args, **kwargs):
    return DATASETS.build(name, *args, **kwargs)


def dataset_section(config, src):
    """The source's section: top-level or nested under ``Dataset`` (the
    reference nests them, configs/multi.yaml:20)."""
    if src in config:
        return config[src]
    return config["Dataset"][src]


def get_anno_file_path(data_dir, dataset_path, filename) -> Path:
    if str(dataset_path).startswith("/"):
        return Path(dataset_path) / filename
    return Path(data_dir) / dataset_path / filename


def _from_config(cls, args, config, training, logger, source, world, **kw):
    """cls over the split's annotation file (mp3d_base's rules: "train"
    when training, else args.validation_split; angle features as the
    config's Feature section or args give them)."""
    split = "train" if training else args.validation_split
    section = dataset_section(config, source)
    anno = get_anno_file_path(args.data_dir, section.DIR,
                              section.SPLIT[split])
    if world is None:
        world = WorldModel(str(Path(args.data_dir) / "connectivity"))
    angle = config.Feature.angle_feat_size if "Feature" in config \
        else args.angle_feat_size
    ds = cls(anno, world, angle_feat_size=angle, debug=args.debug,
             training=training, split=split, **kw)
    if logger is not None:
        logger.info("[INFO] %s loaded with %d instructions, split: %s"
                    % (cls.__name__, len(ds.alldata), ds.split))
    return ds


@DATASETS.register("r2r")
def r2r_from_config(args, config, training: bool = False, logger=None,
                    source: Optional[str] = "R2R",
                    world: Optional[WorldModel] = None) -> R2RDataset:
    return _from_config(R2RDataset, args, config, training, logger,
                        source or "R2R", world)


@DATASETS.register("r2r_aug")
def r2r_aug_from_config(args, config, training: bool = False, logger=None,
                        source: Optional[str] = "R2R_AUG",
                        world: Optional[WorldModel] = None) -> R2RAugDataset:
    return _from_config(R2RAugDataset, args, config, training, logger,
                        source or "R2R_AUG", world)


@DATASETS.register("cvdn")
def cvdn_from_config(args, config, training: bool = False, logger=None,
                     source: Optional[str] = "CVDN",
                     world: Optional[WorldModel] = None) -> CVDNDataset:
    """CVDNDataset, cut to args.max_datapoints and with args.path_type's
    path correction."""
    return _from_config(CVDNDataset, args, config, training, logger,
                        source or "CVDN", world,
                        max_datapoints=args.max_datapoints,
                        path_type=args.path_type)


@DATASETS.register("eqa")
def eqa_from_config(args, config, training: bool = False, logger=None,
                    source: Optional[str] = "EQA",
                    world: Optional[WorldModel] = None) -> EQADataset:
    """EQADataset, its answer vocabulary from the section's ANSWER_VOCAB
    file."""
    section = dataset_section(config, source or "EQA")
    with open(get_anno_file_path(args.data_dir, section.DIR,
                                 section.ANSWER_VOCAB)) as f:
        vocab = json.load(f)
    return _from_config(EQADataset, args, config, training, logger,
                        source or "EQA", world, answer_vocab=vocab)


def _max_objects(config, training: bool):
    """The objects kept per viewpoint: Feature.max_objects in training,
    all of them in evaluation (mp3d_base's rule)."""
    if training and "Feature" in config:
        return config.Feature.get("max_objects", None)
    return None


def _reverie(cls, args, config, training, logger, source, world):
    """cls over the section's bbox_file (the base REVERIE section's, which
    the augmented set shares, when there is one)."""
    section = dataset_section(config, source)
    try:
        base = dataset_section(config, "REVERIE")
    except KeyError:
        base = section
    return _from_config(cls, args, config, training, logger, source, world,
                        bbox_file=get_anno_file_path(args.data_dir, base.DIR,
                                                     base.bbox_file),
                        max_objects=_max_objects(config, training),
                        multi_endpoints=args.multi_endpoints)


@DATASETS.register("reverie")
def reverie_from_config(args, config, training: bool = False, logger=None,
                        source: Optional[str] = "REVERIE",
                        world: Optional[WorldModel] = None) -> REVERIEDataset:
    return _reverie(REVERIEDataset, args, config, training, logger,
                    source or "REVERIE", world)


@DATASETS.register("reverie_aug")
def reverie_aug_from_config(args, config, training: bool = False,
                            logger=None, source: Optional[str] = "REVERIE_AUG",
                            world: Optional[WorldModel] = None
                            ) -> REVERIEAugDataset:
    return _reverie(REVERIEAugDataset, args, config, training, logger,
                    source or "REVERIE_AUG", world)


@DATASETS.register("soon")
def soon_from_config(args, config, training: bool = False, logger=None,
                     source: Optional[str] = "SOON",
                     world: Optional[WorldModel] = None) -> SOONDataset:
    return _from_config(SOONDataset, args, config, training, logger,
                        source or "SOON", world,
                        max_objects=_max_objects(config, training))


def _qa_from_config(cls, args, config, training, logger, source):
    """cls over the split's annotation file ("train" when training, else
    args.validation_split), cut to args.max_datapoints."""
    split = "train" if training else args.validation_split
    section = dataset_section(config, source)
    return cls(get_anno_file_path(args.data_dir, section.DIR,
                                  section.SPLIT[split]), split=split,
               max_datapoints=args.max_datapoints, logger=logger)


@DATASETS.register("scanqa")
def scanqa_from_config(args, config, training: bool = False, logger=None,
                       source: Optional[str] = "ScanQA",
                       world: Optional[WorldModel] = None) -> ScanQADataset:
    return _qa_from_config(ScanQADataset, args, config, training, logger,
                           source or "ScanQA")


@DATASETS.register("llava")
def llava_from_config(args, config, training: bool = False, logger=None,
                      source: Optional[str] = "LLaVA",
                      world: Optional[WorldModel] = None) -> LLaVADataset:
    return _qa_from_config(LLaVADataset, args, config, training, logger,
                           source or "LLaVA")
