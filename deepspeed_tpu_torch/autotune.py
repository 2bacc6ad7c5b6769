"""Config autotuner (port of ``deepspeed_tpu/autotune.py``; ref:
deepspeed/autotuning/autotuner.py).

The reference launches sweeps of real training runs over zero-stage /
micro-batch / offload spaces and picks the fastest.  Here, as in the JAX
package, the tuner runs in-process: grid (or user-listed) candidates over
micro batch, remat policy, zero stage; each candidate's engine is built,
timed over a few steps and freed before the next is built; the best config
is cached to JSON keyed by (device name, device count, space, workload) so
later jobs skip the sweep.

A candidate fails, and is recorded as failed, only for what a config can
cause: the card running out of memory (``torch.OutOfMemoryError``) or a
refusal of the config or the engine (``ValueError``,
``NotImplementedError``).  Any other error, such as a kernel that does not
build or launch, propagates out of :meth:`Autotuner.tune`: a broken kernel
must not quietly crown the candidate that avoids it.
"""

from __future__ import annotations

import copy
import gc
import hashlib
import itertools
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

# Default space mirrors the reference's tuning knobs
# (ref: autotuning/config.py tuner spaces).
DEFAULT_SPACE: Dict[str, List[Any]] = {
    "zero_optimization.stage": [0, 1, 2, 3],
    "train_micro_batch_size_per_gpu": [1, 2, 4, 8],
    "activation_checkpointing.policy": ["none", "save_dots", "full"],
}
REMAT_KEY = "activation_checkpointing.policy"

# what marks a candidate failed; everything else propagates
CANDIDATE_ERRORS = (torch.OutOfMemoryError, ValueError, NotImplementedError)


def set_by_path(d: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def expand_space(space: Dict[str, List[Any]]) -> List[Dict[str, Any]]:
    """Cartesian product of the space -> list of override dicts."""
    keys = sorted(space)
    out = []
    for combo in itertools.product(*(space[k] for k in keys)):
        out.append(dict(zip(keys, combo)))
    return out


def _space_key(space_or_candidates, extra: str = "") -> str:
    blob = json.dumps(space_or_candidates, sort_keys=True, default=str) + extra
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class Autotuner:
    """Measure candidates, keep the fastest, cache the verdict.

    ``build_fn``: ``overrides -> step()``, a zero-arg callable that runs ONE
    full training step with the overrides applied; raise one of
    :data:`CANDIDATE_ERRORS` to mark the candidate invalid.
    ``candidates``: override dicts (dotted config keys), e.g. from
    :func:`expand_space`.  ``cache_path``: JSON result cache; ``None``
    disables caching.
    """

    def __init__(self, build_fn: Callable[[Dict[str, Any]], Callable[[], Any]],
                 candidates: Iterable[Dict[str, Any]],
                 cache_path: Optional[str] = "autotune_cache.json",
                 iters: int = 3, warmup: int = 1,
                 workload_key: str = ""):
        self.build_fn = build_fn
        self.candidates = list(candidates)
        self.cache_path = cache_path
        self.iters = iters
        self.warmup = warmup
        self.workload_key = workload_key  # distinguishes models/workloads
        self.results: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- cache
    def _cache_key(self) -> str:
        if torch.cuda.is_available():
            dev = torch.cuda.get_device_name()
            n = torch.cuda.device_count()
        else:
            dev, n = "cpu", 1
        return _space_key(self.candidates, f"{dev}:{n}:{self.workload_key}")

    def _load_cache(self) -> Optional[Dict[str, Any]]:
        if not self.cache_path or not os.path.exists(self.cache_path):
            return None
        try:
            with open(self.cache_path) as f:
                return json.load(f).get(self._cache_key())
        except (OSError, ValueError):
            return None

    def _store_cache(self, entry: Dict[str, Any]) -> None:
        if not self.cache_path:
            return
        data = {}
        if os.path.exists(self.cache_path):
            try:
                with open(self.cache_path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
        data[self._cache_key()] = entry
        with open(self.cache_path, "w") as f:
            json.dump(data, f, indent=1)

    # ------------------------------------------------------------- measure
    def _measure(self, overrides: Dict[str, Any]) -> float:
        step = self.build_fn(overrides)
        try:
            for _ in range(self.warmup):
                step()
            _sync()
            t0 = time.perf_counter()
            for _ in range(self.iters):
                step()
            _sync()
            return (time.perf_counter() - t0) / self.iters
        finally:
            # the candidate's engine goes before the next one is built
            del step
            _free()

    def tune(self) -> Dict[str, Any]:
        """Returns ``{"overrides": best, "step_time_s": t, "results": [...]}``."""
        cached = self._load_cache()
        if cached is not None:
            logger.info("autotune: cache hit (%s)", self._cache_key())
            return cached
        best: Optional[Tuple[float, Dict[str, Any]]] = None
        for ov in self.candidates:
            try:
                t = self._measure(ov)
            except CANDIDATE_ERRORS as e:
                self.results.append({"overrides": ov, "error": str(e)[:200]})
                logger.info("autotune: %s failed: %s", ov, e)
                _free()
                continue
            self.results.append({"overrides": ov, "step_time_s": t})
            if best is None or t < best[0]:
                best = (t, ov)
            logger.info("autotune: %s -> %.2f ms", ov, t * 1e3)
        if best is None:
            raise RuntimeError("autotune: every candidate failed")
        entry = {"overrides": best[1], "step_time_s": best[0],
                 "results": self.results}
        self._store_cache(entry)
        return entry


def _shape_key(tree) -> Any:
    from deepspeed_tpu_torch._tree import tree_map

    return tree_map(lambda x: str(tuple(getattr(x, "shape", ())))
                    + str(getattr(x, "dtype", "")), tree)


def autotune_config(base_config: Dict[str, Any], loss_fn: Callable,
                    params: Any, batch: Any,
                    space: Optional[Dict[str, List[Any]]] = None,
                    cache_path: Optional[str] = "autotune_cache.json",
                    iters: int = 3, device=None,
                    loss_for: Optional[Callable[[str], Callable]] = None
                    ) -> Dict[str, Any]:
    """End-to-end: sweep engine configs, return the winning config dict
    (ref: autotuner.tune() -> best exp's ds_config).

    Each candidate is a :class:`~deepspeed_tpu_torch.engine.TrainingEngine`
    over ``params`` (host tensors, or an init thunk) built from the
    overridden dict on ``device`` (None = CUDA), training ``loss_fn``.
    ``loss_for``: ``policy -> loss``, the model's loss under a remat
    policy; a candidate that sets ``activation_checkpointing.policy``
    trains ``loss_for(policy)`` instead, so the space's remat axis reaches
    the model (a policy the model refuses fails the candidate).  Without
    it the policy is only a config key, as in the JAX package."""
    from deepspeed_tpu_torch.config import Config
    from deepspeed_tpu_torch.engine import TrainingEngine

    space = space or DEFAULT_SPACE

    def build(overrides: Dict[str, Any]) -> Callable[[], Any]:
        d = copy.deepcopy(base_config)
        for k, v in overrides.items():
            set_by_path(d, k, v)
        conf = Config.from_dict(d)
        fn = loss_fn
        if loss_for is not None and REMAT_KEY in overrides:
            fn = loss_for(conf.activation_checkpointing.policy)
        eng = TrainingEngine(fn, params, conf, device=device)
        return lambda: eng.train_batch(batch)

    # the cache key pins the workload, not just the space: the same sweep
    # on a different model or base config must re-measure
    wkey = _space_key({"base": base_config,
                       "shapes": _shape_key((params, batch))})
    verdict = Autotuner(build, expand_space(space), cache_path=cache_path,
                        iters=iters, workload_key=wkey).tune()
    final = copy.deepcopy(base_config)
    for k, v in verdict["overrides"].items():
        set_by_path(final, k, v)
    verdict["config"] = final
    return verdict
