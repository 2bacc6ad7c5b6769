"""Elastic training config (port of ``deepspeed_tpu/elasticity.py``; ref:
deepspeed/elasticity/elasticity.py).

From an ``elasticity`` config block (``max_train_batch_size``,
``micro_batch_sizes``, ``min/max_gpus``, ``prefer_larger_batch``) the
reference computes the GPU counts a job may run at and the (batch, micro,
accum) triple for each, so the same job can resume after losing or gaining
GPUs.  The same arithmetic here, kept as the JAX package has it, with its
mesh addition: for a GPU count :func:`mesh_factorizations` lists the
``data`` x ``model`` layouts that fill it.
:meth:`~deepspeed_tpu_torch.config.Config.resolve_batch_sizes` resolves
the batch from an enabled block.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class ElasticityConfig:
    """ref: elasticity/config.py ElasticityConfig."""

    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: Sequence[int] = (2, 4, 6)
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0                 # accepted for parity; scheduler hint
    prefer_larger_batch: bool = True
    version: float = 0.1

    @classmethod
    def from_dict(cls, d: Dict) -> "ElasticityConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _candidate_batches(max_batch: int, micro_batches: Sequence[int]) -> List[int]:
    """All batch sizes reachable as micro * accum <= max (ref:

    elasticity.py ``get_valid_gpus``' candidate enumeration)."""
    out = set()
    for mb in micro_batches:
        b = mb
        while b <= max_batch:
            out.add(b)
            b += mb
    return sorted(out)


def get_valid_gpus(batch_size: int, micro_batches: Sequence[int],
                   min_gpus: int, max_gpus: int) -> List[int]:
    """GPU counts at which ``batch_size`` divides evenly over some micro
    batch (ref: elasticity.py get_valid_gpus)."""
    valid = set()
    for mb in micro_batches:
        if batch_size % mb:
            continue
        max_chips = batch_size // mb
        for i in range(1, max_chips + 1):
            if max_chips % i == 0:
                chips = max_chips // i  # accum = i
                if min_gpus <= chips <= max_gpus:
                    valid.add(chips)
    return sorted(valid)


def get_best_candidate_batch_size(
        max_batch: int, micro_batches: Sequence[int], min_gpus: int,
        max_gpus: int, prefer_larger: bool = True) -> Tuple[int, List[int]]:
    """Pick the candidate batch usable at the MOST GPU counts, tie-broken
    by batch size (ref: elasticity.py _get_compatible_gpus_v01)."""
    best: Tuple[int, List[int]] = (0, [])
    for b in _candidate_batches(max_batch, micro_batches):
        gpus = get_valid_gpus(b, micro_batches, min_gpus, max_gpus)
        better = len(gpus) > len(best[1])
        tie = len(gpus) == len(best[1]) and best[0] and (
            b > best[0] if prefer_larger else b < best[0])
        if gpus and (better or tie):
            best = (b, gpus)
    if not best[1]:
        raise ValueError(
            f"no valid (batch, chips) combo for max_batch={max_batch} "
            f"micros={list(micro_batches)} chips=[{min_gpus},{max_gpus}]")
    return best


def compute_elastic_config(cfg: ElasticityConfig,
                           world_size: int = 0) -> Dict:
    """ref: elasticity.py compute_elastic_config.

    Returns the final batch size, valid GPU counts, and — when
    ``world_size`` is given — this run's micro batch + grad-accum.
    """
    batch, valid = get_best_candidate_batch_size(
        cfg.max_train_batch_size, cfg.micro_batch_sizes,
        cfg.min_gpus, cfg.max_gpus, cfg.prefer_larger_batch)
    out = {"train_batch_size": batch, "valid_gpus": valid}
    if world_size:
        if world_size not in valid:
            raise ValueError(
                f"world size {world_size} incompatible with elastic batch "
                f"{batch}; valid sizes: {valid}")
        per_chip = batch // world_size
        micro = max(mb for mb in cfg.micro_batch_sizes if per_chip % mb == 0)
        out["train_micro_batch_size_per_gpu"] = micro
        out["gradient_accumulation_steps"] = per_chip // micro
    return out


def mesh_factorizations(n_chips: int, axes: Sequence[str] = ("data", "model"),
                        max_model: int = 0) -> List[Dict[str, int]]:
    """Valid mesh shapes for ``n_chips`` devices over the given axes (the
    JAX package's addition: an elastic resume also picks a layout).
    2-axis enumeration; larger meshes compose by calling this per axis
    pair."""
    assert len(axes) == 2
    out = []
    for m in range(1, n_chips + 1):
        if n_chips % m == 0 and (not max_model or m <= max_model):
            out.append({axes[0]: n_chips // m, axes[1]: m})
    return out
