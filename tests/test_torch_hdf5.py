"""The port's HDF5 reader and writer (navillm_tpu_torch/utils/hdf5.py)
against h5py: every layout the reader takes, read bit for bit as h5py
reads it; the writer's files read by h5py with h5py's own chunking and
gzip level; unsupported structures raising by name; threads reading at
once; and the JAX feature store (h5py) against the port's on one file."""
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from navillm_tpu.data.feature_db import ImageFeaturesDB as JImageFeaturesDB  # noqa: E402
from navillm_tpu_torch.data.feature_db import (ImageFeaturesDB,  # noqa: E402
                                               create_feature_db)
from navillm_tpu_torch.utils import hdf5  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "hdf5"
MP3D_KEYS = 10567


def _datasets(group, prefix=""):
    """path -> h5py dataset, nested groups walked."""
    out = {}
    for k in group.keys():
        obj = group[k]
        if isinstance(obj, h5py.Group):
            out.update(_datasets(obj, f"{prefix}{k}/"))
        else:
            out[prefix + k] = obj
    return out


def _same(got, want):
    """Bit for bit: the same type (byte order included), shape and bytes."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _assert_reads_as_h5py(path):
    with h5py.File(path, "r") as ref, hdf5.File(path, "r") as f:
        assert f.keys() == list(ref.keys())
        for name, d in _datasets(ref).items():
            got = f[name]
            assert name in f and got.shape == d.shape and got.dtype == d.dtype
            assert got.chunks == d.chunks
            assert got.compression == d.compression
            assert got.compression_opts == d.compression_opts
            assert got.shuffle == d.shuffle and got.fletcher32 == d.fletcher32
            _same(got[...], d[...])
            _same(np.asarray(got), d[()])
    return True


# ---------------- the committed fixture


@pytest.mark.parametrize("name", ["extractor", "layouts", "many_keys"])
def test_fixture_reads_as_h5py_and_npz(name):
    path = FIXTURE / f"{name}.h5"
    assert _assert_reads_as_h5py(path)
    with np.load(FIXTURE / f"{name}.npz") as z, hdf5.File(path) as f:
        assert z.files and all(k in f for k in z.files)
        for k in z.files:
            _same(f[k][...], z[k])


def test_fixture_script_writes_the_committed_files(tmp_path):
    import runpy
    mod = runpy.run_path(str(ROOT / "scripts/data_tools/make_hdf5_fixture.py"))
    mod["write"](tmp_path)
    for name in ("extractor", "layouts", "many_keys"):
        assert (tmp_path / f"{name}.h5").read_bytes() == \
            (FIXTURE / f"{name}.h5").read_bytes(), name
        with np.load(tmp_path / f"{name}.npz") as a, \
                np.load(FIXTURE / f"{name}.npz") as b:
            assert a.files == b.files
            for k in a.files:
                _same(a[k], b[k])


def test_fixture_covers_the_layouts():
    with hdf5.File(FIXTURE / "layouts.h5") as f:
        kinds = {k: f[k]._layout[0] for k in f.keys() if k != "a"}
        assert kinds["compact"] == 0 and kinds["contiguous"] == 1 \
            and kinds["edge_chunks"] == 2
        assert f["filtered"].fletcher32 and f["filtered"].shuffle
        assert f["filtered"].dtype == np.dtype(">f8")
        assert f["a"]["b"]["deep"].shape == f["a/b/deep"].shape == (2, 3)
    with hdf5.File(FIXTURE / "many_keys.h5") as f:
        assert _group_levels(f) > 1


# ---------------- every layout, made here by h5py


def _layout_cases():
    r = np.random.RandomState(7)
    return {
        "mp3d_gzip": (r.randn(36, 1024).astype(np.float32),
                      dict(compression="gzip")),
        "edge_chunks": (r.randn(13, 10).astype(np.float32),
                        dict(chunks=(4, 3), compression="gzip")),
        "edge_chunks_3d": (r.randn(5, 6, 7).astype(np.float32),
                           dict(chunks=(2, 4, 3))),
        "contiguous": (r.randn(36, 64).astype(np.float32), {}),
        "compact": (r.randn(3, 5).astype(np.float32), "compact"),
        "shuffle_gzip_fletcher32": (
            r.randn(17, 9).astype(np.float32),
            dict(chunks=(5, 4), compression="gzip", shuffle=True,
                 fletcher32=True)),
        "fletcher32_odd_bytes": (r.randint(0, 255, (9, 7)).astype(np.uint8),
                                 dict(chunks=(3, 3), fletcher32=True)),
        "f16": (r.randn(36, 40).astype(np.float16), dict(compression="gzip")),
        "f64": (r.randn(6, 40).astype(np.float64), dict(compression="gzip")),
        "int32": (r.randint(-9999, 9999, (8, 8)).astype(np.int32),
                  dict(compression="gzip", compression_opts=1)),
        "int64_be": (r.randint(-9999, 9999, (4, 4)).astype(">i8"), {}),
        "f32_be": (r.randn(36, 16).astype(">f4"),
                   dict(compression="gzip", shuffle=True)),
        "uint16": (r.randint(0, 60000, 50).astype(np.uint16), {}),
        "one_dim": (r.randn(1024).astype(np.float32),
                    dict(compression="gzip")),
        "one_dim_many_chunks": (r.randn(5000).astype(np.float32),
                                dict(chunks=(7,), compression="gzip")),
        "unlimited": (r.randn(30).astype(np.float32),
                      dict(maxshape=(None,), chunks=(8,))),
        "scalar": (np.float32(1.5), {}),
        "empty": (np.zeros((0, 4), np.float32), {}),
        "zeros_never_written": (None, dict(shape=(6, 5), dtype="f4",
                                           chunks=(2, 2), fillvalue=3.5)),
    }


@pytest.mark.parametrize("case", sorted(_layout_cases()))
def test_reader_matches_h5py(case, tmp_path):
    arr, kw = _layout_cases()[case]
    path = tmp_path / f"{case}.h5"
    with h5py.File(path, "w") as f:
        if kw == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"x", h5py.h5t.py_create(arr.dtype),
                            h5py.h5s.create_simple(arr.shape), dcpl=dcpl) \
                .write(h5py.h5s.ALL, h5py.h5s.ALL, arr)
        elif arr is None:
            f.create_dataset("x", **kw)
        else:
            f.create_dataset("x", data=arr, **kw)
    assert _assert_reads_as_h5py(path)


def _first_block_types(f, addr):
    """The message types in the first block of a v1 object header."""
    block = f._pread(addr + 16, hdf5._uint(f._pread(addr, 16), 8, 4))
    types, p = [], 0
    while p + 8 <= len(block):
        types.append(hdf5._uint(block, p, 2))
        p += 8 + hdf5._uint(block, p + 2, 2)
    return types


def test_nested_groups_and_string_attributes(tmp_path):
    """DUET-style files: string attributes on the file, the groups and the
    datasets are skipped without being decoded, and a header that they
    push into a continuation block is followed."""
    path = tmp_path / "nested.h5"
    r = np.random.RandomState(3)
    with h5py.File(path, "w") as f:
        f.attrs["description"] = "views"
        g = f.create_group("scan/a")
        g.attrs["scanId"] = "17DRP5sb8fy"
        for k in range(3):
            d = g.create_dataset(f"vp{k}", data=r.randn(36, 8).astype("f4"),
                                 compression="gzip")
            d.attrs["scanId"] = "17DRP5sb8fy"
            d.attrs["viewpointId"] = f"{k:032x}"
            d.attrs["heading"] = np.arange(36) * 30.0
        # enough attributes that vp0's header continues in a second block
        for k in range(30):
            g["vp0"].attrs[f"note{k}"] = f"view {k} " * 3
        f.create_group("scan/empty")
        f["top"] = np.arange(4)
    assert _assert_reads_as_h5py(path)
    with hdf5.File(path) as f:
        assert 0x10 in _first_block_types(f, f["scan/a"]._links["vp0"][0])
        assert f.keys() == ["scan", "top"]
        assert f["scan"].keys() == ["a", "empty"]
        assert f["scan/empty"].keys() == [] and len(f["scan/a"]) == 3
        assert "scan/a/vp2" in f and "scan/a/vp3" not in f \
            and "top/x" not in f
        with h5py.File(path) as ref:
            _same(f["/scan/a/vp1"][...], ref["scan/a/vp1"][...])
            _same(f["scan"]["a"]["vp0"][...], ref["scan/a/vp0"][...])
        with pytest.raises(KeyError, match="missing"):
            f["scan/missing"]


def _group_levels(f) -> int:
    stab = f._header(f._root, "/")[0]
    return f._btree_node(hdf5._uint(stab.data, 0, 8), 0, 8, "/")[0] + 1


def _mp3d_keys(n):
    return [f"scan{k % 90:02d}_{(k * 2654435761) % 2 ** 32:08x}"
            f"{k:024x}" for k in range(n)]


def test_a_group_of_mp3d_size(tmp_path):
    """10,567 keys (MP3D's viewpoints): the group B-tree h5py grows has
    more than one level, and the root's map holds every key."""
    path = tmp_path / "mp3d_keys.h5"
    keys = _mp3d_keys(MP3D_KEYS)
    with h5py.File(path, "w") as f:
        for k, key in enumerate(keys):
            f[key] = np.array([k], np.int32)
    with hdf5.File(path) as f:
        assert _group_levels(f) > 1
        assert sorted(f.keys()) == sorted(keys)
        for k in range(0, MP3D_KEYS, 97):
            _same(f[keys[k]][...], np.array([k], np.int32))


# ---------------- the writer, read by h5py


@pytest.mark.parametrize("shape", [(36, 1024), (1024,), (5, 1024),
                                   (300, 1024), (36, 768), (1, 1024)])
def test_writer_matches_h5py_layout(shape, tmp_path):
    """The extractors' call, create_dataset(key, data=f32,
    compression="gzip"): h5py reads the port's file equal, with the chunk
    shape and gzip level h5py gives the same call."""
    arr = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    ours, theirs = tmp_path / "ours.h5", tmp_path / "theirs.h5"
    with hdf5.File(ours, "w") as f:
        f.create_dataset("scan_vp", data=arr, compression="gzip")
    with h5py.File(theirs, "w") as f:
        f.create_dataset("scan_vp", data=arr, compression="gzip")
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        da, db = a["scan_vp"], b["scan_vp"]
        assert (da.chunks, da.compression, da.compression_opts,
                da.shuffle, da.fletcher32) == \
            (db.chunks, db.compression, db.compression_opts, db.shuffle,
             db.fletcher32)
        assert da.chunks is not None and da.compression_opts == 4
        _same(da[...], arr)
        sl = tuple(slice(1, 3) for _ in shape)      # one chunk's lookup
        _same(da[sl], arr[sl])
    assert _assert_reads_as_h5py(ours)


@pytest.mark.parametrize("dtype", ["<f4", ">f4", "<f2", "<f8", ">f8", "<i4",
                                   ">i2", "<u1", "<u8", "<i8"])
def test_writer_types_and_layouts(dtype, tmp_path):
    r = np.random.RandomState(1)
    base = r.randn(11, 9) * 100
    arr = base.astype(dtype) if np.dtype(dtype).kind == "f" \
        else np.abs(base).astype(dtype)
    path = tmp_path / "types.h5"
    with hdf5.File(path, "w") as f:
        f["plain"] = arr
        f.create_dataset("gzip", data=arr, compression="gzip")
        f.create_dataset("row", data=arr[0], compression="gzip")
        f["scalar"] = arr[0, 0]
    with h5py.File(path) as g:
        assert sorted(g.keys()) == ["gzip", "plain", "row", "scalar"]
        assert g["plain"].chunks is None
        assert g["gzip"].compression_opts == 4
        for k, want in (("plain", arr), ("gzip", arr), ("row", arr[0])):
            _same(g[k][...], want)
        _same(g["scalar"][()], arr[0, 0])
    assert _assert_reads_as_h5py(path)


def test_writer_at_mp3d_size_read_by_h5py(tmp_path):
    """10,567 keys through the port's writer: the group B-tree it builds at
    close() has more than one level, and h5py finds every key by its
    B-tree search. The gzip dataset's 128 chunks overflow one chunk-index
    node, so its B-tree has two levels too."""
    path = tmp_path / "many.h5"
    keys = _mp3d_keys(MP3D_KEYS)
    with hdf5.File(path, "w") as f:
        for k, key in enumerate(keys):
            f[key] = np.array([k, -k], np.int32)
        f.create_dataset("chunks", data=np.arange(1 << 19, dtype=np.float32),
                         compression="gzip")
    with h5py.File(path) as g:
        assert len(g) == MP3D_KEYS + 1
        for k in range(0, MP3D_KEYS, 53):
            _same(g[keys[k]][...], np.array([k, -k], np.int32))
        _same(g["chunks"][12345:12360],
              np.arange(12345, 12360, dtype=np.float32))
    with hdf5.File(path) as f:
        assert _group_levels(f) > 2
        assert sorted(f.keys()) == sorted(keys + ["chunks"])
        _same(f["chunks"][...], np.arange(1 << 19, dtype=np.float32))


def test_writer_refuses_what_it_does_not_write(tmp_path):
    with hdf5.File(tmp_path / "w.h5", "w") as f:
        f["x"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="already exists"):
            f["x"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="no '/'"):
            f.create_dataset("a/b", data=np.zeros(2))
        with pytest.raises(ValueError, match="lzf"):
            f.create_dataset("y", data=np.zeros(2), compression="lzf")
        with pytest.raises(ValueError, match="not written"):
            f.create_dataset("s", data=np.array(["ab"]))
        with pytest.raises(ValueError, match="scalar"):
            f.create_dataset("z", data=np.float32(1), compression="gzip")
    with pytest.raises(ValueError, match="mode 'a'"):
        hdf5.File(tmp_path / "w.h5", "a")


@pytest.mark.parametrize("shape,typesize", [
    ((36, 1024), 4), ((1024,), 4), ((5, 1024), 4), ((10567, 1024), 4),
    ((36, 768), 2), ((3, 4), 8), ((100000,), 1), ((7, 0, 3), 4),
    ((40, 40, 40), 8)])
def test_guess_chunk_is_h5pys(shape, typesize):
    from h5py._hl.filters import guess_chunk
    assert hdf5.guess_chunk(shape, typesize) == \
        guess_chunk(shape, None, typesize)


def _fletcher32_loop(data: bytes) -> int:
    """H5_checksum_fletcher32 as HDF5 writes it, one word at a time."""
    s1 = s2 = 0
    n, p = len(data) // 2, 0
    while n:
        t = min(n, 360)
        n -= t
        for _ in range(t):
            s1 += (data[p] << 8) | data[p + 1]
            p += 2
            s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[p] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & 0xFFFFFFFF


@pytest.mark.parametrize("n", [0, 1, 2, 719, 720, 721, 4096, 9001])
def test_fletcher32_is_hdf5s(n):
    for fill in ("random", "ones"):
        data = (np.random.RandomState(n).randint(0, 256, n, np.int64)
                .astype(np.uint8).tobytes() if fill == "random"
                else b"\xff" * n)
        assert hdf5.fletcher32(data) == _fletcher32_loop(data)


# ---------------- what is not read raises, naming the structure


def _chunk_addr(path, name):
    with h5py.File(path) as f:
        info = f[name].id.get_chunk_info(0)
        return info.byte_offset, info.size


def test_fletcher32_mismatch_raises(tmp_path):
    path = tmp_path / "bad.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(64, dtype=np.float32),
                         chunks=(16,), fletcher32=True)
    addr, size = _chunk_addr(path, "x")
    raw = bytearray(path.read_bytes())
    raw[addr + 5] ^= 0x10
    path.write_bytes(bytes(raw))
    with h5py.File(path) as f, pytest.raises(OSError):
        f["x"][...]
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match=r"bad\.h5.*fletcher32"):
            f["x"][...]


def _unsupported_cases():
    def latest(path):
        with h5py.File(path, "w", libver="latest") as f:
            f["x"] = np.arange(3)

    def v108(path):
        with h5py.File(path, "w", libver=("v108", "latest")) as f:
            f["x"] = np.arange(3)

    def lzf(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.arange(50.0), compression="lzf")

    def string(path):
        with h5py.File(path, "w") as f:
            f["x"] = np.array([b"ab", b"cd"])

    def compound(path):
        with h5py.File(path, "w") as f:
            f["x"] = np.zeros(2, [("a", "f4"), ("b", "i4")])

    def tracked_order(path):
        with h5py.File(path, "w") as f:
            f.create_group("x", track_order=True)

    def soft_link(path):
        with h5py.File(path, "w") as f:
            f["y"] = np.arange(3)
            f["x"] = h5py.SoftLink("/y")

    def external(path):
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.arange(4.0),
                             external=[(str(path) + ".raw", 0, 64)])

    return {"superblock v3": latest, "superblock v2": v108,
            r"filter 32000 \(lzf\)": lzf, "datatype class string": string,
            "datatype class compound": compound,
            "v2 object header": tracked_order, "soft link": soft_link,
            "external data files": external}


@pytest.mark.parametrize("structure", sorted(_unsupported_cases()))
def test_unsupported_structure_raises(structure, tmp_path):
    path = tmp_path / "unsupported.h5"
    _unsupported_cases()[structure](path)
    with pytest.raises(ValueError, match=rf"unsupported\.h5.*{structure}"):
        with hdf5.File(path) as f:
            f["x"][...]


def test_not_hdf5_raises(tmp_path):
    path = tmp_path / "x.h5"
    path.write_bytes(b"\0" * 2000)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(path)


# ---------------- threads, and the feature stores


def test_threads_read_what_one_thread_reads(tmp_path):
    """Eight threads on one reader (the prefetcher's workers): no shared
    file position, so each read equals the single-threaded one."""
    path = tmp_path / "views.h5"
    r = np.random.RandomState(5)
    keys = [f"scan_{k}" for k in range(24)]
    with h5py.File(path, "w") as f:
        for k in keys:
            f.create_dataset(k, data=r.randn(36, 256).astype(np.float32),
                             compression="gzip")
        f.create_dataset("flat", data=r.randn(36, 256).astype(np.float32))
    keys.append("flat")
    f = hdf5.File(path)
    want = {k: f[k][...] for k in keys}
    got, errors = [], []
    barrier = threading.Barrier(8)

    def worker(t):
        try:
            barrier.wait()
            for rep in range(4):
                for k in keys[t % 5:] + keys[: t % 5]:
                    got.append((k, f[k][...]))
        except BaseException as e:      # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    f.close()
    assert not errors, errors
    assert len(got) == 8 * 4 * len(keys)
    for k, a in got:
        _same(a, want[k])


@pytest.fixture
def view_file(tmp_path):
    """Extractor-layout views ([36, 48] gzip'd) and COCO-style 1-D rows."""
    path = tmp_path / "feats" / "views.hdf5"
    path.parent.mkdir()
    r = np.random.RandomState(11)
    with h5py.File(path, "w") as f:
        for s in range(2):
            for v in range(5):
                f.create_dataset(f"scan{s}_vp{v}",
                                 data=r.randn(36, 48).astype(np.float32),
                                 compression="gzip")
        for i in range(3):
            f.create_dataset(f"coco{i}", data=r.randn(48).astype(np.float32),
                             compression="gzip")
    return path


@pytest.mark.parametrize("size", [48, 32])
def test_image_features_db_matches_jax(view_file, size):
    got = create_feature_db({"mp3d": "feats/views.hdf5"}, size,
                            str(view_file.parents[1]))["mp3d"]
    want = JImageFeaturesDB(str(view_file), size)
    assert isinstance(got, ImageFeaturesDB)
    for s in range(2):
        for v in range(5):
            _same(got.get_image_feature(f"scan{s}", f"vp{v}"),
                  want.get_image_feature(f"scan{s}", f"vp{v}"))
    for i in range(3):
        _same(got.get_image_feature(f"coco{i}"),
              want.get_image_feature(f"coco{i}"))
    batch = [("scan1", "vp3"), ("scan0", "vp0"), ("scan1", "vp3")]
    _same(got.get_batch_features(batch), want.get_batch_features(batch))
    assert not got._store and isinstance(got._h5, hdf5.FileReader)
    cached = ImageFeaturesDB(str(view_file), size, cache=True)
    first = cached.get_image_feature("scan0", "vp1")
    assert cached.get_image_feature("scan0", "vp1") is first
    assert list(cached._store) == ["scan0_vp1"]
