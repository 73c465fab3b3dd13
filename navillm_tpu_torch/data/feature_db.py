"""Feature stores: precomputed visual features keyed by scan_viewpoint.

The port's copy of the view-feature stores of navillm_tpu/data/feature_db.py
(reference tasks/feature_db.py), with the same names and numerics:
  - ImageFeaturesDB: HDF5 view features ([36, D] per viewpoint, or [N, D]
    frame features for ScanQA/COCO), lazy reads + optional cache
    (feature_db.py:18-31); h5py is imported at first read, so the port
    imports without it;
  - SyntheticImageFeaturesDB: deterministic hash-seeded features for
    hermetic tests and the card's smoke run;
  - create_feature_db: source -> ImageFeaturesDB from a config map.
``get_batch_features`` assembles a fixed-shape [B, 36, D] array for a batch
of viewpoints in one call. The REVERIE/SOON object stores come with object
grounding.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

NUM_VIEWS = 36


class ImageFeaturesDB:
    """HDF5-backed view features (reference feature_db.py:11-31)."""

    def __init__(self, img_ft_file: str, image_feat_size: int,
                 cache: bool = False):
        self.img_ft_file = str(img_ft_file)
        self.image_feat_size = image_feat_size
        self.cache = cache
        self._store: Dict[str, np.ndarray] = {}
        self._h5 = None

    def _file(self):
        if self._h5 is None:
            import h5py
            self._h5 = h5py.File(self.img_ft_file, "r")
        return self._h5

    def get_image_feature(self, scan: str, viewpoint: Optional[str] = None
                          ) -> np.ndarray:
        key = f"{scan}_{viewpoint}" if viewpoint is not None else scan
        ft = self._store.get(key)
        if ft is None:
            d = self._file()[key]
            ft = np.asarray(d)
            ft = (ft[: self.image_feat_size] if ft.ndim == 1
                  else ft[:, : self.image_feat_size]).astype(np.float32)
            if self.cache:
                self._store[key] = ft
        return ft

    def get_batch_features(self, keys: Sequence[Tuple[str, str]]) -> np.ndarray:
        """[(scan, viewpoint)] -> [B, 36, D] float32 in one call."""
        out = np.zeros((len(keys), NUM_VIEWS, self.image_feat_size), np.float32)
        for i, (scan, vp) in enumerate(keys):
            out[i] = self.get_image_feature(scan, vp)
        return out


class SyntheticImageFeaturesDB:
    """Deterministic per-(scan, viewpoint) random features for tests."""

    def __init__(self, image_feat_size: int = 32, num_views: int = NUM_VIEWS,
                 scale: float = 1.0):
        self.image_feat_size = image_feat_size
        self.num_views = num_views
        self.scale = scale

    def get_image_feature(self, scan: str, viewpoint: Optional[str] = None
                          ) -> np.ndarray:
        key = f"{scan}_{viewpoint}".encode()
        seed = int.from_bytes(hashlib.md5(key).digest()[:4], "little")
        r = np.random.RandomState(seed)
        return (r.randn(self.num_views, self.image_feat_size)
                .astype(np.float32) * self.scale)

    def get_batch_features(self, keys):
        return np.stack([self.get_image_feature(s, v) for s, v in keys])


def create_feature_db(config: Dict, image_feat_size: int, data_dir: str
                      ) -> Dict[str, ImageFeaturesDB]:
    """Map of source -> DB (reference feature_db.py:34-42)."""
    ret = {}
    for source, rel in config.items():
        path = rel if str(rel).startswith("/") else os.path.join(data_dir, rel)
        ret[source] = ImageFeaturesDB(path, image_feat_size)
    return ret
