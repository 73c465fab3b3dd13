"""Offline view-feature extraction: images -> ViT on the card -> HDF5.

Torch twin of navillm_tpu/vision/extract.py. Host threads (or spawned
worker processes) decode and preprocess images while the ViT
(vision/vit.py) runs fixed-size batches on the card; one writer streams
gzip'd [36, D] (or [D]) datasets into HDF5 under the ``<scan>_<viewpoint>``
keys the feature DBs read (data/feature_db.py), through the port's own
HDF5 writer (utils/hdf5.py, h5py's layout without h5py):
``write_features`` is the one dataset call every writer makes.

Image sources:
  - DirectoryImageSource: pre-rendered views on disk,
    <root>/<scan>/<viewpoint>_<ix>.(jpg|png), ix in [0, 36);
  - MatterSimImageSource: renders through the upstream C++ simulator
    when the ``MatterSim`` module is importable.

PIL is imported where an image is decoded, so the device half
(``FeatureExtractor.encode`` on preprocessed [N, S, S, 3] f32 arrays) and
the writer run without it.
"""
from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import hdf5
from .vit import ViTConfig, vit_forward_features

# CLIP normalization (EVA uses the same openai statistics)
MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def write_features(f, key: str, feats) -> None:
    """One dataset of the extractors' layout into ``f`` (an
    ``hdf5.File(path, "w")``): ``feats`` as f32, gzip'd at h5py's default
    level and chunk shape, as the JAX extractor's ``create_dataset(key,
    data=..., compression="gzip")`` lays it out."""
    f.create_dataset(key, data=np.asarray(feats, np.float32),
                     compression="gzip")


def preprocess_image(img, image_size: int) -> np.ndarray:
    """PIL image -> normalized [S, S, 3] f32 (shorter side resized to S,
    bicubic, then a center crop: CLIP's)."""
    from PIL import Image
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((max(image_size, int(round(w * scale))),
                      max(image_size, int(round(h * scale)))),
                     Image.BICUBIC)
    w, h = img.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (arr - MEAN) / STD


class DirectoryImageSource:
    def __init__(self, root: str | Path):
        self.root = Path(root)

    def views(self, scan: str, viewpoint: str, num_views: int = 36):
        from PIL import Image
        out = []
        for ix in range(num_views):
            for ext in (".jpg", ".png"):
                p = self.root / scan / f"{viewpoint}_{ix}{ext}"
                if p.exists():
                    out.append(Image.open(p))
                    break
            else:
                raise FileNotFoundError(
                    f"missing rendered view {scan}/{viewpoint}_{ix}")
        return out


class MatterSimImageSource:
    """Renders the 36 views of a viewpoint through MatterSim: 12 headings
    at each of 3 elevations (-30, 0, +30 degrees), view index 0 first."""

    def __init__(self, connectivity_dir: str, scan_dir: str,
                 width: int = 640, height: int = 480, vfov: float = 60):
        import MatterSim
        sim = MatterSim.Simulator()
        sim.setNavGraphPath(connectivity_dir)
        sim.setDatasetPath(scan_dir)
        sim.setCameraResolution(width, height)
        sim.setCameraVFOV(math.radians(vfov))
        sim.setDiscretizedViewingAngles(True)
        sim.setDepthEnabled(False)
        sim.setPreloadingEnabled(False)
        sim.setBatchSize(1)
        sim.initialize()
        self.sim = sim

    def views(self, scan: str, viewpoint: str, num_views: int = 36):
        from PIL import Image
        images = []
        for ix in range(num_views):
            if ix == 0:
                self.sim.newEpisode([scan], [viewpoint], [0],
                                    [math.radians(-30)])
            elif ix % 12 == 0:
                self.sim.makeAction([0], [1.0], [1.0])
            else:
                self.sim.makeAction([0], [1.0], [0])
            state = self.sim.getState()[0]
            assert state.viewIndex == ix
            bgr = np.array(state.rgb, copy=True)
            images.append(Image.fromarray(bgr[:, :, ::-1]))
        return images


def _params_device(params) -> torch.device:
    return params["patch_embed"]["w"].device


class _Batched:
    """The device half shared by both extractors: fixed-size batches of
    preprocessed images through the ViT."""

    def __init__(self, params, cfg: ViTConfig, batch_size: int):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.device = _params_device(params)
        # forwards run and images encoded (pad rows not counted)
        self.forward_calls = 0
        self.images = 0

    def _forward_batched(self, arrs) -> np.ndarray:
        """[N, S, S, 3] preprocessed images (numpy or a tensor) -> [N,
        width] f32 features on the host. Each chunk of ``batch_size`` runs
        as one forward; the last is padded with zero images to the batch
        size and the pad sliced off, so every forward has one shape."""
        feats = []
        for k in range(0, len(arrs), self.batch_size):
            chunk = torch.as_tensor(arrs[k: k + self.batch_size])
            n = chunk.shape[0]
            if n < self.batch_size:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (self.batch_size - n, *chunk.shape[1:]))])
            with torch.inference_mode():
                out = vit_forward_features(
                    self.params, self.cfg,
                    chunk.to(self.device, non_blocking=True))
            self.forward_calls += 1
            self.images += n
            feats.append(out[:n].float().cpu().numpy())
        return np.concatenate(feats, 0)

    def encode(self, arrs) -> np.ndarray:
        """Preprocessed images [N, S, S, 3] f32 -> [N, width] features."""
        return self._forward_batched(arrs)


class FeatureExtractor(_Batched):
    """The ViT in fixed-size batches over an image stream -> HDF5."""

    def __init__(self, params, cfg: ViTConfig, batch_size: int = 36,
                 decode_workers: int = 4):
        super().__init__(params, cfg, batch_size)
        self._pool = ThreadPoolExecutor(decode_workers)

    def encode_images(self, images) -> np.ndarray:
        """PIL images -> [N, width] features."""
        arrs = list(self._pool.map(
            lambda im: preprocess_image(im, self.cfg.image_size), images))
        return self._forward_batched(np.stack(arrs))

    def extract_to_hdf5(self, out_file: str | Path, source,
                        scanvp_list: Sequence[Tuple[str, str]],
                        num_views: int = 36, progress: bool = True):
        with hdf5.File(out_file, "w") as f:
            for i, (scan, vp) in enumerate(scanvp_list):
                fts = self.encode_images(source.views(scan, vp, num_views))
                key = f"{scan}_{vp}"
                write_features(f, key, fts)
                if progress and i % 50 == 0:
                    print(f"[{i}/{len(scanvp_list)}] {key}", flush=True)


class ParallelFeatureExtractor(_Batched):
    """Spawned decode workers + one consumer on the card + one HDF5 writer
    thread.

        workers (spawn, N): (scan, vp) -> decode the views -> preprocess
                            -> put [V, S, S, 3] f32
        this process:       fixed-size batches -> ViT -> put (key, feats)
        writer thread:      create_dataset(key, gzip)

    There is one card, so the forward stays in this process and the
    parallelism goes to decoding. Results flow through bounded queues to
    keep memory flat; the writer thread alone holds the HDF5 file (one
    writer appends to it). A worker's error and the
    writer's are raised here once the queues are drained."""

    def __init__(self, params, cfg: ViTConfig, batch_size: int = 36,
                 num_workers: int = 4, queue_depth: int = 8):
        super().__init__(params, cfg, batch_size)
        self.num_workers = max(1, num_workers)
        self.queue_depth = queue_depth

    @staticmethod
    def _decode_worker(source, image_size, task_q, out_q, num_views):
        """Runs in a spawned child (numpy and PIL only). ``source`` is a
        zero-argument factory, called here (one simulator per worker), or
        a picklable source object."""
        if callable(source) and not hasattr(source, "views"):
            source = source()
        while True:
            task = task_q.get()
            if task is None:
                out_q.put(None)
                return
            idx, scan, vp = task
            try:
                images = source.views(scan, vp, num_views)
                arr = np.stack([preprocess_image(im, image_size)
                                for im in images])
                out_q.put((idx, scan, vp, arr))
            except Exception as e:      # surfaced by the consumer
                out_q.put((idx, scan, vp, e))

    def extract_to_hdf5(self, out_file: str | Path, source,
                        scanvp_list: Sequence[Tuple[str, str]],
                        num_views: int = 36, progress: bool = True
                        ) -> float:
        """Returns images per second (decode + forward + write, wall)."""
        import multiprocessing as mp
        import queue as _q
        import threading
        import time

        # spawn, not fork: this process holds the CUDA context and live
        # threads, which a forked child must not inherit
        ctx = mp.get_context("spawn")
        task_q = ctx.Queue()
        out_q = ctx.Queue(maxsize=self.queue_depth)
        for i, (scan, vp) in enumerate(scanvp_list):
            task_q.put((i, scan, vp))
        for _ in range(self.num_workers):
            task_q.put(None)
        workers = [ctx.Process(
            target=self._decode_worker,
            args=(source, self.cfg.image_size, task_q, out_q, num_views),
            daemon=True) for _ in range(self.num_workers)]
        for w in workers:
            w.start()

        write_q: "_q.Queue" = _q.Queue(maxsize=self.queue_depth)
        write_err: List[BaseException] = []

        def writer():
            try:
                with hdf5.File(out_file, "w") as f:
                    while True:
                        item = write_q.get()
                        if item is None:
                            return
                        write_features(f, *item)
            except BaseException as e:
                write_err.append(e)
                # keep draining so the consumer never blocks on a full
                # queue behind a dead writer
                while write_q.get() is not None:
                    pass

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()

        t0 = time.perf_counter()
        n_img = 0
        done_workers = 0
        pending_err: Optional[Exception] = None
        try:
            while done_workers < self.num_workers:
                item = out_q.get()
                if item is None:
                    done_workers += 1
                    continue
                idx, scan, vp, arr = item
                if isinstance(arr, Exception):
                    pending_err = pending_err or arr
                    continue
                feats = self._forward_batched(arr)
                write_q.put((f"{scan}_{vp}", feats.astype(np.float32)))
                n_img += arr.shape[0]
                if progress and idx % 50 == 0:
                    print(f"[{idx}/{len(scanvp_list)}] {scan}_{vp}",
                          flush=True)
        finally:
            write_q.put(None)
            wt.join()
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()
        if pending_err is not None:
            raise pending_err
        if write_err:
            raise write_err[0]
        dt = time.perf_counter() - t0
        return n_img / dt if dt > 0 else 0.0


def list_scan_viewpoints(connectivity_dir: str | Path,
                         scans: Optional[Iterable[str]] = None
                         ) -> List[Tuple[str, str]]:
    """All (scan, viewpoint) pairs of the connectivity JSONs."""
    from ..sim.graph import load_connectivity
    conn = Path(connectivity_dir)
    if scans is None:
        scans = sorted(p.name.replace("_connectivity.json", "")
                       for p in conn.glob("*_connectivity.json"))
    out = []
    for scan in scans:
        ids, _, _, _ = load_connectivity(conn, scan)
        out.extend((scan, vp) for vp in ids)
    return out
