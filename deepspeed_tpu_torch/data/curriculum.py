"""Curriculum learning (port of ``deepspeed_tpu/data/curriculum.py``; ref:
deepspeed/runtime/data_pipeline/curriculum_scheduler.py +
deepspeed/runtime/data_pipeline/config.py).

The reference schedules a "difficulty" (canonically sequence length) from
``min_difficulty`` to ``max_difficulty`` with fixed_linear / fixed_root /
fixed_discrete / custom schedules; the training loop truncates or re-packs
each batch to the current difficulty.

``difficulty_step`` (the reference's quantization knob, default 8 there
for sentence packing) makes difficulties move only in multiples of it.  The
schedules, the quantization and the truncation are the JAX package's, so a
port engine truncates each batch to the same length at the same step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CurriculumConfig:
    """ref: data_pipeline/config.py curriculum_learning block keys."""

    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"   # fixed_linear|fixed_root|fixed_discrete
    # schedule_config sub-keys (flattened, same names as reference):
    total_curriculum_step: int = 1000
    difficulty_step: int = 8
    root_degree: int = 2
    difficulty: Tuple[int, ...] = ()       # fixed_discrete: difficulty list
    max_step: Tuple[int, ...] = ()         # fixed_discrete: step boundaries

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CurriculumConfig":
        flat = dict(d)
        sched = flat.pop("schedule_config", {})
        flat.update(sched)
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in flat.items() if k in known}
        for tup in ("difficulty", "max_step"):
            if tup in kw:
                kw[tup] = tuple(kw[tup])
        return cls(**kw)


class CurriculumScheduler:
    """ref: curriculum_scheduler.py CurriculumScheduler — maps global step
    → difficulty."""

    def __init__(self, cfg: CurriculumConfig):
        self.cfg = cfg
        if cfg.schedule_type == "fixed_discrete":
            if not cfg.difficulty or len(cfg.max_step) != len(cfg.difficulty) - 1:
                raise ValueError(
                    "fixed_discrete needs difficulty list and max_step with "
                    "len(difficulty)-1 boundaries")
        elif cfg.schedule_type not in ("fixed_linear", "fixed_root"):
            raise ValueError(f"unknown schedule_type {cfg.schedule_type}")

    def _quantize(self, diff: float) -> int:
        c = self.cfg
        q = max(1, c.difficulty_step)
        d = int(diff // q) * q
        return int(min(max(d, c.min_difficulty), c.max_difficulty))

    def get_difficulty(self, global_step: int) -> int:
        c = self.cfg
        if not c.enabled:
            return c.max_difficulty
        if c.schedule_type == "fixed_discrete":
            for bound, diff in zip(c.max_step, c.difficulty):
                if global_step <= bound:
                    return int(diff)
            return int(c.difficulty[-1])
        frac = min(1.0, global_step / max(1, c.total_curriculum_step))
        if c.schedule_type == "fixed_root":
            frac = frac ** (1.0 / c.root_degree)
        diff = c.min_difficulty + (c.max_difficulty - c.min_difficulty) * frac
        return self._quantize(diff)


def truncate_to_difficulty(batch: Dict[str, torch.Tensor] | torch.Tensor,
                           seqlen: int,
                           seq_keys: Sequence[str] = ("input_ids", "labels",
                                                      "attention_mask",
                                                      "position_ids")):
    """Truncate the sequence axis (axis 1) to ``seqlen`` — the reference's
    batch post-processing for seqlen curriculum (megatron utils
    curriculum truncation)."""
    if isinstance(batch, dict):
        return {k: (v[:, :seqlen] if k in seq_keys and v.ndim >= 2 else v)
                for k, v in batch.items()}
    return batch[:, :seqlen]


# the one list of batch keys that carry a sequence axis — shared by
# every engine's curriculum hook so the engines cannot drift
ENGINE_SEQ_KEYS = ("tokens", "input_ids", "labels", "attention_mask",
                   "position_ids", "loss_mask", "segment_ids")


def apply_seqlen_curriculum(batch, scheduler, global_step: int):
    """One engine-facing entrypoint (``TrainingEngine.train_batch`` calls
    this): truncate the batch to the
    scheduler's current difficulty when the curriculum is seqlen-typed,
    pass the batch through untouched otherwise.  The untouched case is
    deliberate, not a silent gap: non-seqlen curriculum types are
    DATA-SAMPLING curricula — the loader/:class:`DifficultyIndexer`
    restricts which samples are drawn, and there is nothing for the
    engine's batch hook to do (same division of labor as the
    reference's data_efficiency pipeline vs megatron truncation)."""
    if scheduler is None or scheduler.cfg.curriculum_type != "seqlen":
        return batch
    return truncate_to_difficulty(
        batch, scheduler.get_difficulty(global_step),
        seq_keys=ENGINE_SEQ_KEYS)


# ------------------------------------------------- difficulty-ordered sampling
class DifficultyIndexer:
    """Data-analysis half of curriculum (ref: data_pipeline/data_sampling/
    data_analyzer.py, simplified): pre-computes a difficulty value per
    sample and serves index batches restricted to the current difficulty
    ceiling."""

    def __init__(self, difficulties: Sequence[float], seed: int = 0):
        self.diff = np.asarray(difficulties, np.float64)
        self.order = np.argsort(self.diff, kind="stable")
        self.sorted_diff = self.diff[self.order]
        self.rng = np.random.RandomState(seed)

    def eligible(self, max_difficulty: float) -> np.ndarray:
        hi = np.searchsorted(self.sorted_diff, max_difficulty, side="right")
        return self.order[:hi]

    def sample(self, batch_size: int, max_difficulty: float) -> np.ndarray:
        pool = self.eligible(max_difficulty)
        if len(pool) == 0:
            pool = self.order[:1]
        return self.rng.choice(pool, size=batch_size,
                               replace=len(pool) < batch_size)
