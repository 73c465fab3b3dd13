"""Time the port's HDF5 reader and writer (navillm_tpu_torch/utils/hdf5.py)
on the host, beside h5py's where h5py is installed.

    python scripts/hdf5_bench.py [--keys 64] [--reps 5]

Writes KEYS [36, 1024] f32 datasets in the extractors' layout
(``create_dataset(key, data=..., compression="gzip")``) once through the
port's writer and once through h5py, then reads every dataset of the
port's file REPS times through each reader, in the order port, h5py,
port, h5py. Prints write MB/s (of f32 features), the ms to open and index
the file and ms per [36, 1024] read. Host numbers only: nothing here runs
on a card.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from navillm_tpu_torch.utils import hdf5  # noqa: E402


def _write(open_file, path, arrays) -> float:
    t0 = time.perf_counter()
    with open_file(path, "w") as f:
        for key, a in arrays.items():
            f.create_dataset(key, data=a, compression="gzip")
    return time.perf_counter() - t0


def _read_ms(open_file, path, keys, reps) -> float:
    with open_file(path, "r") as f:
        t0 = time.perf_counter()
        for _ in range(reps):
            for k in keys:
                f[k][...]
        return 1e3 * (time.perf_counter() - t0) / (reps * len(keys))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    try:
        import h5py
    except ImportError:
        h5py = None
    rng = np.random.RandomState(0)
    arrays = {f"scan_vp{k:05d}": rng.randn(36, 1024).astype(np.float32)
              for k in range(args.keys)}
    mb = sum(a.nbytes for a in arrays.values()) / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        ours = f"{tmp}/port.h5"
        print(f"port writer: {mb / _write(hdf5.File, ours, arrays):.1f} MB/s")
        if h5py is not None:
            print(f"h5py writer: "
                  f"{mb / _write(h5py.File, f'{tmp}/h5py.h5', arrays):.1f} "
                  f"MB/s")
        t0 = time.perf_counter()
        hdf5.File(ours).close()
        print(f"port open and index of {args.keys} keys: "
              f"{1e3 * (time.perf_counter() - t0):.3f} ms")
        readers = [("port", hdf5.File)] + (
            [("h5py", h5py.File)] if h5py is not None else [])
        for rnd in range(2):
            for name, open_file in readers:
                ms = _read_ms(open_file, ours, list(arrays), args.reps)
                print(f"{name} reader, round {rnd}: {ms:.4f} ms per "
                      f"[36, 1024] read")


if __name__ == "__main__":
    main()
