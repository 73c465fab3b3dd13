"""Extract per-frame features (ScanQA scenes, COCO images) with the
EVA02-CLIP-L-14-336 tower on the card.

  python -m navillm_tpu_torch.vision.extract_features_frames \
      --image_dir data/scanqa_frames --output_file scanqa.hdf5 [--flat]

``--image_dir`` holds <scene_id>/color/<frame>.jpg (ScanQA) or, with
``--flat``, <image_id>.jpg (COCO). HDF5 keys: "<scene>_<frame>" or
"<image_id>".
"""
import argparse
from pathlib import Path


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--output_file", required=True)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--flat", action="store_true",
                    help="flat image dir (COCO) instead of scene/color/*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights without --checkpoint")
    return ap


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    from PIL import Image

    from ..utils import hdf5
    from .extract import FeatureExtractor, write_features
    from .extract_features_mp3d import load_eva02

    cfg, params = load_eva02(args.checkpoint, args.device, args.seed)
    fe = FeatureExtractor(params, cfg, args.batch_size)
    root = Path(args.image_dir)
    with hdf5.File(args.output_file, "w") as f:
        if args.flat:
            items = [(p.stem, [p]) for p in sorted(root.glob("*.jpg"))]
        else:
            items = [(d.name, sorted((d / "color").glob("*.jpg")))
                     for d in sorted(root.iterdir()) if d.is_dir()]
        for key, paths in items:
            fts = fe.encode_images([Image.open(p) for p in paths])
            if args.flat:
                write_features(f, key, fts[0])
            else:
                for p, ft in zip(paths, fts):
                    write_features(f, f"{key}_{p.stem}", ft)
            print(key, flush=True)


if __name__ == "__main__":
    main()
