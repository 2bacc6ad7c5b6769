"""Synchronized timers + throughput accounting (port of
``deepspeed_tpu/timers.py``; ref: deepspeed/utils/timers.py).

As in the reference, ``SynchronizedWallClockTimer`` brackets the host clock
with a device synchronise (``torch.cuda.synchronize`` on the timer's CUDA
device; nothing on the CPU, whose ops are synchronous), so a timed region
holds the device work it launched.  ``ThroughputTimer`` reports samples/s,
tokens/s, TFLOP/s and MFU against the card's published peak.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch._device import resolve_device

logger = logging.getLogger(__name__)

# Peak dense bf16 FLOP/s by card (NVIDIA H100 SXM data sheet) and the
# reference's nominal CPU entry, so MFU math never divides by zero off the
# card.  A CUDA card not in the table raises: no peak is guessed for it.
PEAK_FLOPS = {
    "h100": 989e12,
    "cpu": 1e12,
}

# Peak HBM bandwidth by card, bytes/s (the same data sheet) — the MBU
# denominator, parallel to PEAK_FLOPS for MFU.
PEAK_HBM_BW = {
    "h100": 3.35e12,
    "cpu": 0.1e12,
}


def _peak(table: Dict[str, float], device) -> float:
    dev = resolve_device(device)
    if dev.type != "cuda":
        return table["cpu"]
    kind = torch.cuda.get_device_name(dev).lower()
    for key, val in table.items():
        if key in kind:
            return val
    raise ValueError(f"no published peak for {kind!r} in the timers' table")


def device_peak_flops(device=None) -> float:
    """Peak bf16 FLOP/s of ``device`` (None = the current CUDA card)."""
    return _peak(PEAK_FLOPS, device)


def device_peak_bandwidth(device=None) -> float:
    """Peak HBM bandwidth (bytes/s) of ``device`` (None = CUDA)."""
    return _peak(PEAK_HBM_BW, device)


def _sync(device: torch.device) -> None:
    """Drain the device's queue so the host clock brackets its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    """One named timer (ref: timers.py ``SynchronizedWallClockTimer.Timer``)."""

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = resolve_device(device)
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self.count = 0

    def start(self) -> None:
        if self.started:
            raise RuntimeError(f"timer {self.name} already started")
        _sync(self.device)
        self._start = time.perf_counter()
        self.started = True

    def stop(self, reset: bool = False) -> None:
        if not self.started:
            raise RuntimeError(f"timer {self.name} not started")
        _sync(self.device)
        dt = time.perf_counter() - self._start
        self._elapsed = dt if reset else self._elapsed + dt
        self.count += 1
        self.started = False

    def elapsed(self, reset: bool = True) -> float:
        e = self._elapsed
        if reset:
            self._elapsed = 0.0
            self.count = 0
        return e

    def mean(self) -> float:
        return self._elapsed / max(self.count, 1)


class SynchronizedWallClockTimer:
    """Named-timer registry (ref: deepspeed/utils/timers.py)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.device)
        return self.timers[name]

    def log(self, names=None, reset: bool = True) -> str:
        names = names if names is not None else sorted(self.timers)
        parts = []
        for n in names:
            if n in self.timers:
                ms = self.timers[n].elapsed(reset=reset) * 1000.0
                parts.append(f"{n}: {ms:.2f}ms")
        msg = " | ".join(parts)
        logger.info("time: %s", msg)
        return msg


class ThroughputTimer:
    """Samples/sec, tokens/sec, TFLOPs, MFU (ref: timers.py ThroughputTimer).

    ``flops_per_sample`` (if given) enables TFLOPs + MFU reporting; the
    first ``start_step`` steps are not counted (warm-up).
    """

    def __init__(self, batch_size: int, seq_len: int = 1,
                 flops_per_sample: Optional[float] = None,
                 start_step: int = 2, device=None):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.flops_per_sample = flops_per_sample
        self.start_step = start_step
        self.device = resolve_device(device)
        self.step_count = 0
        self.total_time = 0.0
        self.total_samples = 0
        self._t0 = 0.0

    def start(self) -> None:
        _sync(self.device)
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        _sync(self.device)
        dt = time.perf_counter() - self._t0
        self.step_count += 1
        if self.step_count > self.start_step:
            self.total_time += dt
            self.total_samples += self.batch_size

    @property
    def samples_per_sec(self) -> float:
        return self.total_samples / self.total_time if self.total_time else 0.0

    @property
    def tokens_per_sec(self) -> float:
        return self.samples_per_sec * self.seq_len

    @property
    def tflops(self) -> float:
        if not self.flops_per_sample:
            return 0.0
        return self.samples_per_sec * self.flops_per_sample / 1e12

    @property
    def mfu(self) -> float:
        if not self.flops_per_sample:
            return 0.0
        return (self.samples_per_sec * self.flops_per_sample
                / device_peak_flops(self.device))

    def summary(self) -> Dict[str, float]:
        return {
            "samples_per_sec": self.samples_per_sec,
            "tokens_per_sec": self.tokens_per_sec,
            "tflops": self.tflops,
            "mfu": self.mfu,
            "steps": float(max(self.step_count - self.start_step, 0)),
        }
