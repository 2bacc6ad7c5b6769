"""LR schedules (port of ``deepspeed_tpu/lr_schedules.py``; ref:
deepspeed/runtime/lr_schedules.py).

Each schedule is a pure function ``step -> lr`` of a Python int, evaluated on
the host once per optimizer step.  The arithmetic runs in float32, as the
JAX schedules do inside the jitted step, and the result comes back as a
Python float.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

Schedule = Callable[[int], float]
_F = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: float(_F(lr))


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log") -> Schedule:
    """ref: WarmupLR — warm up then hold at max."""
    lo, hi, n = _F(warmup_min_lr), _F(warmup_max_lr), warmup_num_steps
    if n <= 0:
        # no warmup: hold at max from step 0 (the log branch would divide
        # by log1p(0) == 0; warmup_steps=0 is a reachable config)
        return constant(warmup_max_lr)

    def f(step):
        s = min(_F(step), _F(n))
        if warmup_type == "log":
            frac = np.log1p(s) / np.log1p(_F(n))
        else:
            frac = s / _F(max(n, 1))
        return float(lo + (hi - lo) * frac)

    return f


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Schedule:
    """ref: WarmupDecayLR — warmup then linear decay to 0 at total steps."""
    wu = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def f(step):
        s = _F(step)
        decay = np.clip((_F(total_num_steps) - s)
                        / _F(max(total_num_steps - warmup_num_steps, 1)),
                        _F(0.0), _F(1.0))
        if s < warmup_num_steps:
            return wu(step)
        return float(_F(warmup_max_lr) * decay)

    return f


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     warmup_max_lr: float = 1e-3) -> Schedule:
    """ref: WarmupCosineLR — linear warmup then cosine decay."""
    hi = _F(warmup_max_lr)

    def f(step):
        s = _F(step)
        wu_frac = _F(warmup_min_ratio) + _F(1 - warmup_min_ratio) * np.clip(
            s / _F(max(warmup_num_steps, 1)), _F(0.0), _F(1.0))
        prog = np.clip((s - _F(warmup_num_steps))
                       / _F(max(total_num_steps - warmup_num_steps, 1)),
                       _F(0.0), _F(1.0))
        cos = _F(cos_min_ratio) + _F(1 - cos_min_ratio) * _F(0.5) * (
            _F(1) + np.cos(_F(np.pi) * prog))
        return float(hi * (wu_frac if s < warmup_num_steps else cos))

    return f


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0) -> Schedule:
    """ref: OneCycle — ramp up, ramp down, then optional decay."""
    second = cycle_second_step_size or cycle_first_step_size
    lo, hi = _F(cycle_min_lr), _F(cycle_max_lr)

    def f(step):
        s = _F(step)
        up = lo + (hi - lo) * np.clip(s / _F(cycle_first_step_size),
                                      _F(0.0), _F(1.0))
        down = hi - (hi - lo) * np.clip(
            (s - _F(cycle_first_step_size)) / _F(second), _F(0.0), _F(1.0))
        in_cycle = up if s < cycle_first_step_size else down
        total = cycle_first_step_size + second
        if s <= total:
            return float(in_cycle)
        if decay_step_size > 0:
            return float(lo * max(_F(1.0) - _F(decay_lr_rate) * (s - _F(total))
                                  / _F(decay_step_size), _F(0.0)))
        return float(lo)

    return f


def lr_range_test(lr_range_test_min_lr: float = 1e-6,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    """ref: LRRangeTest — linearly growing LR probe."""
    lo = _F(lr_range_test_min_lr)

    def f(step):
        s = _F(step)
        interval = s / _F(lr_range_test_step_size)
        if lr_range_test_staircase:
            interval = np.floor(interval)
        return float(lo * (_F(1) + interval * _F(lr_range_test_step_rate)))

    return f


_REGISTRY = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
    "constant": lambda lr=1e-3, **_: constant(lr),
}


def from_config(name: Optional[str], params: dict,
                fallback_lr: float = 1e-3) -> Schedule:
    """Build from the config ``scheduler`` block; None → constant(optimizer lr)."""
    if name is None:
        return constant(fallback_lr)
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown scheduler {name!r}; known: {sorted(_REGISTRY)}")
    # step-size params must be positive (a zero divides to NaN/inf).
    # Exempt: warmup_num_steps (0 = no warmup), decay_step_size (0 = no
    # decay phase), cycle_second_step_size (falsy = mirror the first ramp).
    for p in ("cycle_first_step_size",
              "lr_range_test_step_size", "total_num_steps"):
        if p in params and params[p] is not None and params[p] <= 0:
            raise ValueError(f"scheduler {name!r}: {p} must be positive, "
                             f"got {params[p]}")
    return _REGISTRY[key](**params)
