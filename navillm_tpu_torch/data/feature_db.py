"""Feature stores: precomputed visual features keyed by scan_viewpoint.

The port's copy of navillm_tpu/data/feature_db.py (reference
tasks/feature_db.py), with the same names and numerics:
  - ImageFeaturesDB: HDF5 view features ([36, D] per viewpoint, or [N, D]
    frame features for ScanQA/COCO), lazy reads + optional cache
    (feature_db.py:18-31), read through the port's own HDF5 reader
    (utils/hdf5.py: no h5py);
  - SyntheticImageFeaturesDB: deterministic hash-seeded features for
    hermetic tests and the card's smoke run;
  - REVERIEObjectFeatureDB / SOONObjectFeatureDB: object crops with their
    angle and bbox-size features (feature_db.py:45-151), over an LMDB +
    msgpack store (``_LMDBStore``) that imports lmdb and msgpack only when
    it is built, or over an injected store;
  - _SyntheticObjectStore / synthetic_object_db: hash-seeded objects per
    viewpoint in either store's layout;
  - create_feature_db / create_object_feature_db: source -> DB from a
    config map.
``get_batch_features`` assembles a fixed-shape [B, 36, D] array for a batch
of viewpoints in one call.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..sim.geometry import angle_feature, convert_elevation, convert_heading
from ..utils import hdf5

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
        self._open_lock = threading.Lock()

    def _file(self):
        # the prefetcher's threads may make the first read: open once
        if self._h5 is None:
            with self._open_lock:
                if self._h5 is None:
                    self._h5 = hdf5.File(self.img_ft_file, "r")
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


def _bbox_size_fts(w: float, h: float, norm_w: float, norm_h: float
                   ) -> np.ndarray:
    a = np.zeros(3, np.float32)
    a[:2] = [h / norm_h, w / norm_w]
    a[2] = a[0] * a[1]
    return a


class _LMDBStore:
    def __init__(self, path: str):
        import lmdb
        import msgpack
        import msgpack_numpy
        msgpack_numpy.patch()
        self._msgpack = msgpack
        self.env = lmdb.open(path, readonly=True)

    def get(self, key: str):
        with self.env.begin() as txn:
            data = txn.get(key.encode("ascii"))
        return None if data is None else self._msgpack.unpackb(data)


class REVERIEObjectFeatureDB:
    """REVERIE objects (reference feature_db.py:45-92): bbox [x, y, w, h],
    sizes normalized by the 640x480 frame."""

    def __init__(self, obj_ft_file: str, obj_feat_size: int,
                 im_width: int = 640, im_height: int = 480, store=None):
        self.obj_feat_size = obj_feat_size
        self.im_width, self.im_height = im_width, im_height
        self.store = store if store is not None else _LMDBStore(obj_ft_file)
        self._cache: Dict[str, tuple] = {}

    def load_feature(self, scan, viewpoint, max_objects=None):
        key = f"{scan}_{viewpoint}"
        if key not in self._cache:
            data = self.store.get(key)
            if data is not None:
                fts = np.asarray(data["fts"])[:, : self.obj_feat_size].astype(np.float32)
                attrs = {k: v for k, v in data.items() if k != "fts"}
            else:
                fts = np.zeros((0, self.obj_feat_size), np.float32)
                attrs = {}
            self._cache[key] = (fts, attrs)
        fts, attrs = self._cache[key]
        if max_objects is not None:
            fts = fts[:max_objects]
            attrs = {k: v[:max_objects] for k, v in attrs.items()}
        return fts, attrs

    def get_object_feature(self, scan, viewpoint, base_heading, base_elevation,
                           angle_feat_size, max_objects=None):
        fts, attrs = self.load_feature(scan, viewpoint, max_objects)
        n = len(fts)
        ang = np.zeros((n, angle_feat_size), np.float32)
        box = np.zeros((n, 3), np.float32)
        ids: List = []
        if n > 0:
            for k, center in enumerate(attrs["centers"]):
                ang[k] = angle_feature(center[0] - base_heading,
                                       center[1] - base_elevation,
                                       angle_feat_size)
                w, h = attrs["bboxes"][k][2:]
                box[k] = _bbox_size_fts(w, h, self.im_width, self.im_height)
            ids = list(attrs["obj_ids"])
        return fts, ang, box, ids


class SOONObjectFeatureDB:
    """SOON objects (reference feature_db.py:95-151): xyxy bboxes /224,
    plus normalized [0,1) object directions."""

    def __init__(self, obj_ft_file: str, obj_feat_size: int, store=None):
        self.obj_feat_size = obj_feat_size
        self.store = store if store is not None else _LMDBStore(obj_ft_file)
        self._cache: Dict[str, tuple] = {}

    def load_feature(self, scan, viewpoint, max_objects=None):
        key = f"{scan}_{viewpoint}"
        if key not in self._cache:
            data = self.store.get(key)
            if data is not None:
                fts = np.asarray(data["fts"])[:, : self.obj_feat_size].astype(np.float32)
                attrs = {
                    "directions": data["2d_centers"],
                    "obj_ids": data["obj_ids"],
                    "bboxes": np.asarray(data["xyxy_bboxes"]),
                }
            else:
                fts = np.zeros((0, self.obj_feat_size), np.float32)
                attrs = {}
            self._cache[key] = (fts, attrs)
        fts, attrs = self._cache[key]
        if max_objects is not None:
            fts = fts[:max_objects]
            attrs = {k: v[:max_objects] for k, v in attrs.items()}
        return fts, attrs

    def get_object_feature(self, scan, viewpoint, base_heading, base_elevation,
                           angle_feat_size, max_objects=None):
        fts, attrs = self.load_feature(scan, viewpoint, max_objects)
        n = len(fts)
        ang = np.zeros((n, angle_feat_size), np.float32)
        loc = np.zeros((n, 3), np.float32)
        directions: List = []
        ids: List = []
        if n > 0:
            for k, center in enumerate(attrs["directions"]):
                ang[k] = angle_feature(center[0] - base_heading,
                                       center[1] - base_elevation,
                                       angle_feat_size)
                x1, y1, x2, y2 = attrs["bboxes"][k]
                loc[k] = _bbox_size_fts(x2 - x1, y2 - y1, 224, 224)
            directions = [[convert_heading(c[0]), convert_elevation(c[1])]
                          for c in attrs["directions"]]
            ids = list(attrs["obj_ids"])
        return fts, ang, loc, directions, ids


class _SyntheticObjectStore:
    """In-memory object store: n_objects per viewpoint, hash-seeded."""

    def __init__(self, obj_feat_size: int = 16, n_objects: int = 3,
                 style: str = "reverie"):
        self.obj_feat_size = obj_feat_size
        self.n_objects = n_objects
        self.style = style

    def get(self, key: str):
        seed = int.from_bytes(hashlib.md5(key.encode()).digest()[:4], "little")
        r = np.random.RandomState(seed)
        n = self.n_objects
        data = {
            "fts": r.randn(n, self.obj_feat_size).astype(np.float32),
            "obj_ids": [str(seed % 1000 + i) for i in range(n)],
        }
        centers = r.rand(n, 2) * [2 * np.pi, np.pi] - [0, np.pi / 2]
        if self.style == "reverie":
            data["centers"] = centers
            data["bboxes"] = np.concatenate(
                [r.rand(n, 2) * 100, 20 + r.rand(n, 2) * 100], axis=1)
        else:
            data["2d_centers"] = centers
            xy = r.rand(n, 2) * 100
            data["xyxy_bboxes"] = np.concatenate([xy, xy + 20 + r.rand(n, 2) * 80],
                                                 axis=1)
        return data


def synthetic_object_db(style: str, obj_feat_size: int = 16, n_objects: int = 3):
    store = _SyntheticObjectStore(obj_feat_size, n_objects, style)
    if style == "reverie":
        return REVERIEObjectFeatureDB("", obj_feat_size, store=store)
    return SOONObjectFeatureDB("", obj_feat_size, store=store)


def create_feature_db(config: Dict, image_feat_size: int, data_dir: str
                      ) -> Dict[str, ImageFeaturesDB]:
    """Map of source -> DB (reference feature_db.py:34-42)."""
    ret = {}
    for source, rel in config.items():
        path = rel if str(rel).startswith("/") else os.path.join(data_dir, rel)
        ret[source] = ImageFeaturesDB(path, image_feat_size)
    return ret


def create_object_feature_db(config: Dict, obj_feat_size: int, data_dir: str):
    """source -> object DB (reference feature_db.py:153-167)."""
    ret = {}
    for source, rel in config.items():
        path = rel if str(rel).startswith("/") else os.path.join(data_dir, rel)
        if source == "reverie":
            ret[source] = REVERIEObjectFeatureDB(path, obj_feat_size)
        elif source == "soon":
            ret[source] = SOONObjectFeatureDB(path, obj_feat_size)
    return ret
