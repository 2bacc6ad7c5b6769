"""Rank-aware logging (port of ``deepspeed_tpu/utils/logging.py``; ref:
deepspeed/utils/logging.py).  The logger is a child of the package's, with
its own handler, so the modules that log through ``__name__`` keep
propagating as they did."""

from __future__ import annotations

import logging
import os
import sys

logger = logging.getLogger("deepspeed_tpu_torch.log")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [dstpu] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper())
    logger.propagate = False


def process_rank() -> int:
    """This process's rank in the default process group (0 without one):
    the port's ``jax.process_index()``."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def log_dist(message: str, ranks=(0,), level: int = logging.INFO) -> None:
    """Log only on the given process ranks (ref: deepspeed.utils.log_dist)."""
    if process_rank() in ranks or -1 in ranks:
        logger.log(level, message)
