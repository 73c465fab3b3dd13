"""Write the HDF5 fixtures: small files of every layout the port's HDF5
reader (``navillm_tpu_torch/utils/hdf5.py``) reads, made by h5py, each
beside an ``.npz`` of its datasets.

``tests/fixtures/hdf5/`` holds:
  - ``extractor.h5``: datasets as the JAX extractors write them
    (``create_dataset(key, data=f32, compression="gzip")``, h5py's chunk
    shape and gzip level 4): a [36, 1024] MP3D viewpoint, a [1024] COCO
    image and a [5, 1024] block of ScanQA frames;
  - ``layouts.h5``: chunks that do not divide the shape, contiguous and
    compact layouts, shuffle + gzip + fletcher32, f16, big-endian f64,
    int32 and uint8, a scalar, nested groups, and DUET-style string
    attributes (``scanId``, ``viewpointId``) on a dataset and on the file;
  - ``many_keys.h5``: MANY_KEYS tiny datasets, enough that the root
    group's B-tree has more than one level.
``<name>.npz`` holds every dataset of ``<name>.h5`` under its path
(``a/b/c`` for a nested one). The ``.h5`` files come out byte for byte
the same on every run (h5py records no times by default).

chip_smoke.py reads these files without h5py on the card's machine, and
``tests/test_torch_hdf5.py`` reads them with both readers. Needs h5py.

Usage: python scripts/data_tools/make_hdf5_fixture.py [--out DIR]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
FIXTURE = ROOT / "tests" / "fixtures" / "hdf5"
MANY_KEYS = 400


def _extractor(rng):
    return {"scan0_vp0": rng.randn(36, 1024).astype(np.float32),
            "391895": rng.randn(1024).astype(np.float32),
            "scene0000_00_frames": rng.randn(5, 1024).astype(np.float32)}


def _layouts(rng):
    """path -> (array, create_dataset keywords)."""
    return {
        "edge_chunks": (rng.randn(10, 7).astype(np.float32),
                        dict(chunks=(4, 3), compression="gzip",
                             compression_opts=6)),
        "contiguous": (rng.randn(6, 5).astype(np.float32), {}),
        "compact": (np.arange(12, dtype=np.int32).reshape(3, 4),
                    dict(_compact=True)),
        "filtered": (rng.randn(9, 11).astype(">f8"),
                     dict(chunks=(4, 4), compression="gzip", shuffle=True,
                          fletcher32=True)),
        "half": (rng.randn(4, 33).astype(np.float16),
                 dict(compression="gzip")),
        "int32": (rng.randint(-2 ** 31, 2 ** 31 - 1, (7, 3), np.int64)
                  .astype(np.int32), dict(chunks=(2, 2))),
        "big_endian": (rng.randn(3, 8).astype(">f4"), {}),
        "bytes": (rng.randint(0, 255, 40).astype(np.uint8),
                  dict(compression="gzip", compression_opts=9)),
        "scalar": (np.float64(2.5), {}),
        "a/b/deep": (rng.randn(2, 3).astype(np.float32),
                     dict(compression="gzip")),
        "a/sibling": (np.arange(5, dtype="<i8"), {}),
    }


def _many_keys():
    return {f"scan{k % 7}_{k * 2654435761 % 2 ** 32:08x}":
            np.array([k, -k], np.int32) for k in range(MANY_KEYS)}


def write(out: Path) -> None:
    import h5py
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(19)

    data = _extractor(rng)
    with h5py.File(out / "extractor.h5", "w") as f:
        for key, arr in data.items():
            f.create_dataset(key, data=arr, compression="gzip")
    np.savez_compressed(out / "extractor.npz", **data)

    layouts = _layouts(rng)
    with h5py.File(out / "layouts.h5", "w") as f:
        f.attrs["scanId"] = "17DRP5sb8fy"
        for path, (arr, kw) in layouts.items():
            if kw.pop("_compact", False):
                space = h5py.h5s.create_simple(arr.shape)
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_layout(h5py.h5d.COMPACT)
                dcpl.set_obj_track_times(False)     # as h5py's default
                h5py.h5d.create(f.id, path.encode(),
                                h5py.h5t.py_create(arr.dtype), space,
                                dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL,
                                                 arr)
            else:
                d = f.create_dataset(path, data=arr, **kw)
                if path == "contiguous":
                    d.attrs["scanId"] = "17DRP5sb8fy"
                    d.attrs["viewpointId"] = \
                        "10c252c90fa24ef3b698c6f54d984c5c"
                    d.attrs["image_w"] = 640
    np.savez_compressed(out / "layouts.npz",
                        **{p: a for p, (a, _) in layouts.items()})

    keys = _many_keys()
    with h5py.File(out / "many_keys.h5", "w") as f:
        for key, arr in keys.items():
            f[key] = arr
    np.savez_compressed(out / "many_keys.npz", **keys)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    write(ap.parse_args(argv).out)


if __name__ == "__main__":
    main()
