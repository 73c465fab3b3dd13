"""Asynchronous feature prefetch: warm the next step's viewpoint features.

The port's copy of navillm_tpu/data/prefetch.py, with the same names and
semantics. While the card runs a step, a pool of worker threads reads the
features of every candidate viewpoint of the current observations (the
superset of wherever the policy can move next) into the feature store's
``_store`` cache, so the ``get_obs`` after the action finds them there
instead of reading the HDF5 file on the critical path (reference
feature_db.py:18-31).

- Keys are deduplicated within one ``prefetch_candidates`` call.
- Once ``_store`` holds ``cache_limit`` entries nothing more is fetched.
  Nothing is ever evicted, and a store built with ``cache=False`` never
  inserts on its own reads, so after ``cache_limit`` viewpoints (~604 MB
  at [36, 1024] f32) prefetching stops for the rest of the process.
- A store without ``_store`` (``SyntheticImageFeaturesDB``) is read and
  the result thrown away.
- A failed read is swallowed: the real read on the critical path raises
  it again.

It touches host memory only and imports neither torch nor anything of the
device path.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Set, Tuple


class FeaturePrefetcher:
    def __init__(self, feat_db, workers: int = 4, cache_limit: int = 4096):
        self.feat_db = feat_db
        self.pool = ThreadPoolExecutor(workers)
        self.cache_limit = cache_limit
        self._pending = []

    def _fetch(self, scan: str, vp: str):
        try:
            store = getattr(self.feat_db, "_store", None)
            if store is not None and len(store) >= self.cache_limit:
                return
            ft = self.feat_db.get_image_feature(scan, vp)
            if store is not None:
                # one dict store: atomic under the GIL
                store[f"{scan}_{vp}"] = ft
        except Exception:
            pass    # best effort: the read on the critical path raises

    def prefetch_candidates(self, obs: Sequence[dict]):
        """Submit one fetch per distinct (scan, candidate viewpoint) of
        ``obs``."""
        seen: Set[Tuple[str, str]] = set()
        for ob in obs:
            for cand in ob.get("candidate", []):
                key = (ob["scan"], cand["viewpointId"])
                if key not in seen:
                    seen.add(key)
                    self._pending.append(self.pool.submit(self._fetch, *key))
        self._pending = [f for f in self._pending if not f.done()]

    def drain(self):
        """Wait for every fetch still pending."""
        for f in self._pending:
            f.result()
        self._pending = []
