"""Extract 36-view MP3D features with the EVA02-CLIP-L-14-336 tower on the
card.

  python -m navillm_tpu_torch.vision.extract_features_mp3d \
      --connectivity_dir data/connectivity \
      --image_dir data/rendered_views \
      --checkpoint data/models/EVA02-CLIP-L-14-336.pt \
      --output_file data/eva_features/mp3d_EVA02-CLIP-L-14-336.hdf5

Views come from a pre-rendered directory (``--image_dir``,
<scan>/<viewpoint>_<ix>.jpg) or are rendered through MatterSim
(``--scan_dir``). ``--workers N`` decodes in N spawned processes with one
HDF5 writer thread; 0 decodes in threads of this process. ``--device
cpu`` runs the tower on the CPU.
"""
import argparse
import functools


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--connectivity_dir", required=True)
    ap.add_argument("--scan_dir", default=None,
                    help="MP3D scans for MatterSim rendering")
    ap.add_argument("--image_dir", default=None,
                    help="pre-rendered views <scan>/<vp>_<ix>.jpg")
    ap.add_argument("--checkpoint", default=None,
                    help="EVA-CLIP state dict (torch .pt); random init if "
                         "absent")
    ap.add_argument("--output_file", required=True)
    ap.add_argument("--batch_size", type=int, default=36)
    ap.add_argument("--scans", nargs="*", default=None)
    ap.add_argument("--workers", type=int, default=0,
                    help="decode worker processes (0 = threads in this "
                         "process; N > 0 spawns N workers and one HDF5 "
                         "writer thread)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights without --checkpoint")
    return ap


def load_eva02(checkpoint, device, seed: int = 0):
    """(cfg, params) of EVA02-CLIP-L-14-336 on ``device``: converted from
    a ``torch.load``-able ``visual.*`` state dict, or random weights drawn
    from ``seed`` (with a warning) when there is no checkpoint."""
    import torch

    from .vit import ViTConfig, convert_eva02_clip, init_vit_params

    cfg = ViTConfig.eva02_clip_l_14_336()
    if checkpoint:
        sd = torch.load(checkpoint, map_location="cpu")
        return cfg, convert_eva02_clip(sd, cfg, device=device)
    print("WARNING: no --checkpoint, using random ViT weights")
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, init_vit_params(cfg, gen, device=device)


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    from .extract import (DirectoryImageSource, FeatureExtractor,
                          MatterSimImageSource, ParallelFeatureExtractor,
                          list_scan_viewpoints)

    cfg, params = load_eva02(args.checkpoint, args.device, args.seed)
    if args.image_dir:
        factory = functools.partial(DirectoryImageSource, args.image_dir)
    else:
        # one simulator per worker
        factory = functools.partial(MatterSimImageSource,
                                    args.connectivity_dir, args.scan_dir)

    scanvps = list_scan_viewpoints(args.connectivity_dir, args.scans)
    print(f"extracting {len(scanvps)} viewpoints -> {args.output_file}")
    if args.workers > 0:
        pe = ParallelFeatureExtractor(params, cfg, args.batch_size,
                                      num_workers=args.workers)
        ips = pe.extract_to_hdf5(args.output_file, factory, scanvps)
        print(f"throughput: {ips:.1f} images/sec "
              f"(~{len(scanvps) * 36 / max(ips, 1e-9) / 3600:.1f} h for "
              f"this viewpoint set)")
    else:
        FeatureExtractor(params, cfg, args.batch_size).extract_to_hdf5(
            args.output_file, factory(), scanvps)


if __name__ == "__main__":
    main()
