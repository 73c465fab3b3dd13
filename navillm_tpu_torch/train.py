"""CLI entry point of the port: multi-task training / evaluation.

    python -m navillm_tpu_torch.train --stage multi \
        --cfg_file configs/multi.yaml --data_dir data --output_dir output

Twin of the repository's train.py over navillm_tpu_torch: read_args (the
YAML through the port's own reader) -> run_training. It runs on the card
unless ``--device cpu`` is given.
"""
from pathlib import Path

from .training.train_loop import run_training
from .utils.config import read_args
from .utils.logging_utils import create_logger, log_config


def main(argv=None):
    args, cfg = read_args(argv)
    logger = create_logger(log_file=str(Path(args.output_dir) / "train.log"),
                           rank=args.rank)
    logger.info("args: %s" % args)
    log_config(cfg, logger)
    results = run_training(args, cfg, logger)
    logger.info("Best Results: %s" % (results,))
    return results


if __name__ == "__main__":
    main()
