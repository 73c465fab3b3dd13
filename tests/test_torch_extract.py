"""The port's extraction pipeline (navillm_tpu_torch/vision/extract.py)
against the JAX one (navillm_tpu/vision/extract.py): preprocessing bit for
bit, an HDF5 round trip read by the port's ImageFeaturesDB, the parallel
extractor against the serial path, worker errors raised, the viewpoint
listing, and the extraction entry points."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")
h5py = pytest.importorskip("h5py")

from navillm_tpu.vision import extract as JE  # noqa: E402
from navillm_tpu_torch.data.feature_db import ImageFeaturesDB  # noqa: E402
from navillm_tpu_torch.vision import extract as TE  # noqa: E402
from navillm_tpu_torch.vision.vit import ViTConfig, init_vit_params  # noqa

torch.set_num_threads(1)


def _write_views(root, scan, vp, n=4, size=32):
    from PIL import Image
    d = root / scan
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(abs(hash((scan, vp))) % 2 ** 31)
    for ix in range(n):
        arr = (rng.rand(size, size + 8, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"{vp}_{ix}.png")


def _tiny():
    cfg = ViTConfig.tiny()
    return cfg, init_vit_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


@pytest.mark.parametrize("shape", [(60, 80), (80, 60), (28, 28), (31, 97)])
def test_preprocess_matches_jax(shape):
    from PIL import Image
    arr = (np.random.RandomState(1).rand(*shape, 3) * 255).astype(np.uint8)
    img = Image.fromarray(arr)
    got = TE.preprocess_image(img, 28)
    ref = JE.preprocess_image(img, 28)
    assert got.shape == (28, 28, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TE.MEAN, JE.MEAN)
    np.testing.assert_array_equal(TE.STD, JE.STD)


def test_extract_to_hdf5_roundtrip(tmp_path):
    cfg, params = _tiny()
    imgroot = tmp_path / "views"
    scanvps = [("scanA", "vp0"), ("scanA", "vp1"), ("scanB", "vp0")]
    for scan, vp in scanvps:
        _write_views(imgroot, scan, vp)
    out = tmp_path / "features.hdf5"
    fe = TE.FeatureExtractor(params, cfg, batch_size=3)
    fe.extract_to_hdf5(out, TE.DirectoryImageSource(imgroot), scanvps,
                       num_views=4, progress=False)
    # 4 views in batches of 3: two forwards per viewpoint, the pad sliced
    assert fe.forward_calls == 6 and fe.images == 12
    db = ImageFeaturesDB(str(out), image_feat_size=cfg.width)
    ft = db.get_image_feature("scanA", "vp0")
    assert ft.shape == (4, cfg.width) and np.isfinite(ft).all()
    src = TE.DirectoryImageSource(imgroot)
    again = fe.encode_images(src.views("scanA", "vp0", 4))
    np.testing.assert_allclose(ft, again, rtol=1e-4, atol=1e-5)
    # the device half on preprocessed arrays equals the image path
    arrs = np.stack([TE.preprocess_image(im, cfg.image_size)
                     for im in src.views("scanA", "vp0", 4)])
    np.testing.assert_array_equal(fe.encode(arrs), again)


def _serial(tmp_path, cfg, params, imgroot, scanvps):
    serial = tmp_path / "serial.hdf5"
    TE.FeatureExtractor(params, cfg, batch_size=4).extract_to_hdf5(
        serial, TE.DirectoryImageSource(imgroot), scanvps, num_views=4,
        progress=False)
    return serial


@pytest.mark.parametrize("factory", [False, True])
def test_parallel_matches_serial(tmp_path, factory):
    cfg, params = _tiny()
    imgroot = tmp_path / "views"
    scanvps = [(f"scan{i % 3}", f"vp{i}") for i in range(5)]
    for scan, vp in scanvps:
        _write_views(imgroot, scan, vp)
    serial = _serial(tmp_path, cfg, params, imgroot, scanvps)
    source = functools.partial(TE.DirectoryImageSource, imgroot) \
        if factory else TE.DirectoryImageSource(imgroot)
    par = tmp_path / "par.hdf5"
    pe = TE.ParallelFeatureExtractor(params, cfg, batch_size=4,
                                     num_workers=2, queue_depth=3)
    assert pe.extract_to_hdf5(par, source, scanvps, num_views=4,
                              progress=False) > 0
    with h5py.File(serial, "r") as fs, h5py.File(par, "r") as fp:
        assert set(fs.keys()) == set(fp.keys()) == {
            f"{s}_{v}" for s, v in scanvps}
        for k in fs.keys():
            np.testing.assert_allclose(fs[k][...], fp[k][...], rtol=1e-4,
                                       atol=1e-5)


def test_parallel_raises_worker_error(tmp_path):
    cfg, params = _tiny()
    imgroot = tmp_path / "views"
    _write_views(imgroot, "scanA", "vp0")
    pe = TE.ParallelFeatureExtractor(params, cfg, batch_size=4,
                                     num_workers=1)
    with pytest.raises(FileNotFoundError):
        pe.extract_to_hdf5(tmp_path / "err.hdf5",
                           TE.DirectoryImageSource(imgroot),
                           [("scanA", "vp0"), ("scanA", "MISSING")],
                           num_views=4, progress=False)


def test_list_scan_viewpoints_matches_jax(world_dir):
    got = TE.list_scan_viewpoints(world_dir)
    assert got == JE.list_scan_viewpoints(world_dir)
    assert {s for s, _ in got} == {"scan0", "scan1"}
    assert TE.list_scan_viewpoints(world_dir, ["scan1"]) == \
        JE.list_scan_viewpoints(world_dir, ["scan1"])


def test_entry_points_on_the_cpu(tmp_path, world_dir, monkeypatch):
    """Both entry points at the CPU with random weights, the tower shrunk
    to the tiny config (the EVA02-L tower is too slow for a CPU test)."""
    from navillm_tpu_torch.vision import extract_features_frames as EF
    from navillm_tpu_torch.vision import extract_features_mp3d as EM
    from navillm_tpu_torch.vision import vit as TV
    from PIL import Image

    tiny = ViTConfig.tiny(style="eva02", mlp_ratio=8 / 3, rope_pt_grid=16)
    monkeypatch.setattr(TV.ViTConfig, "eva02_clip_l_14_336",
                        classmethod(lambda cls, **kw: tiny))
    scanvps = TE.list_scan_viewpoints(world_dir, ["scan1"])
    imgroot = tmp_path / "views"
    for scan, vp in scanvps:
        _write_views(imgroot, scan, vp, n=36, size=20)
    out = tmp_path / "mp3d.hdf5"
    EM.main(["--connectivity_dir", str(world_dir), "--image_dir",
             str(imgroot), "--output_file", str(out), "--scans", "scan1",
             "--batch_size", "36", "--device", "cpu"])
    with h5py.File(out, "r") as f:
        assert set(f.keys()) == {f"{s}_{v}" for s, v in scanvps}
        assert f[f"{scanvps[0][0]}_{scanvps[0][1]}"].shape == (36, 64)

    frames = tmp_path / "frames"
    for scene in ("s0", "s1"):
        (frames / scene / "color").mkdir(parents=True)
        for k in range(3):
            Image.fromarray(np.full((20, 30, 3), 40 * k + 10, np.uint8)) \
                .save(frames / scene / "color" / f"{k}.jpg")
    out2 = tmp_path / "frames.hdf5"
    EF.main(["--image_dir", str(frames), "--output_file", str(out2),
             "--device", "cpu"])
    with h5py.File(out2, "r") as f:
        assert set(f.keys()) == {f"s{i}_{k}" for i in (0, 1)
                                 for k in range(3)}
        assert f["s0_1"].shape == (64,)
