"""Rank-aware logging (twin of navillm_tpu/utils/logging_utils.py;
reference tools/common_utils.py:45-68)."""
import logging
import sys
from pathlib import Path
from typing import Optional


def create_logger(log_file: Optional[str] = None, rank: int = 0,
                  name: str = "navillm_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if log_file is not None and rank == 0:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def log_config(cfg, logger: logging.Logger, prefix: str = "cfg"):
    for k, v in cfg.items():
        if isinstance(v, dict):
            log_config(v, logger, prefix=f"{prefix}.{k}")
        else:
            logger.info("%s.%s = %s", prefix, k, v)
