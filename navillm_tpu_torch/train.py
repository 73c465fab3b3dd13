"""CLI entry point of the port: multi-task training / evaluation.

    python -m navillm_tpu_torch.train --stage multi \
        --cfg_file configs/multi.yaml --data_dir data --output_dir output

    torchrun --nproc_per_node 8 -m navillm_tpu_torch.train --stage multi \
        --cfg_file configs/multi.yaml --tp_size 2 ...

Twin of the repository's train.py over navillm_tpu_torch: read_args (the
YAML through the port's own reader) -> run_training. It runs on the card
unless ``--device cpu`` is given. Under torchrun there is one process per
card: the process group is joined from torchrun's environment (NCCL with
a card per rank, gloo otherwise), the ranks form a dp x tp grid
(--tp_size; dp is the rest), --batch_size is per card, and rank 0 logs
and writes the checkpoints.
"""
from pathlib import Path

from .parallel.dist import init_distributed
from .training.train_loop import run_training
from .utils.config import read_args
from .utils.logging_utils import create_logger, log_config


def main(argv=None):
    args, cfg = read_args(argv)
    if init_distributed():
        import torch.distributed as dist
        args.rank, args.world_size = dist.get_rank(), dist.get_world_size()
    logger = create_logger(log_file=str(Path(args.output_dir) / "train.log"),
                           rank=args.rank)
    logger.info("args: %s" % args)
    log_config(cfg, logger)
    results = run_training(args, cfg, logger)
    logger.info("Best Results: %s" % (results,))
    return results


if __name__ == "__main__":
    main()
