"""Execution tracing and the collective log (port of
``deepspeed_tpu/utils/trace.py``; ref: DeepSpeed's profiling hooks +
``deepspeed.comm`` comms_logger).

:class:`Tracer` rides ``torch.profiler`` where the JAX package rides
``jax.profiler``: a capture writes a Chrome trace (CPU ops and, on the
card, the CUDA kernels on the device's clock) under ``log_dir``, and
:meth:`Tracer.annotate` is a ``torch.profiler.record_function`` range.

The JAX package logs a collective once per *trace* of its enclosing jit, so
its counts answer "which call sites" and not "how many per step".  In the
port every collective is one executed ``torch.distributed`` call, so every
record here is one call that ran: the per-step counts and bytes are the
truth, and :meth:`CommsLogger.record` brackets the call's host wall time
(the enqueue on the card, the whole exchange on gloo)."""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple


class Tracer:
    """start/stop trace capture + named annotation ranges."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir or _default_log_dir()
        self.active = False
        self._prof = None
        self.last_trace: Optional[str] = None

    def start(self) -> None:
        import torch

        os.makedirs(self.log_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.active = True

    def stop(self) -> None:
        if self.active:
            prof, self._prof = self._prof, None
            self.active = False
            prof.__exit__(None, None, None)
            path = os.path.join(
                self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            self.last_trace = path

    @contextlib.contextmanager
    def trace(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    @staticmethod
    def annotate(name: str):
        """Named range visible in the trace's timeline."""
        import torch

        return torch.profiler.record_function(name)

    @staticmethod
    def step(step_num: int):
        """Mark one train step (a ``train_step#N`` range)."""
        import torch

        return torch.profiler.record_function(f"train_step#{step_num}")


def _default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "dstpu_trace")


_global_tracer: Optional[Tracer] = None


def get_tracer(log_dir: Optional[str] = None) -> Tracer:
    """Process-wide profiler tracer.

    ``log_dir=None`` means "whatever the singleton already uses".  An
    explicit dir re-points the idle singleton; if a capture is ACTIVE the
    running profiler owns its directory, so the change is refused with a
    warning instead of being silently dropped."""
    global _global_tracer
    if _global_tracer is None:
        _global_tracer = Tracer(log_dir)
    elif log_dir is not None and log_dir != _global_tracer.log_dir:
        if _global_tracer.active:
            from deepspeed_tpu_torch.utils.logging import logger

            logger.warning(
                "get_tracer: capture already active in %s — ignoring "
                "log_dir=%r until stop() (stop the capture before "
                "re-pointing the tracer)",
                _global_tracer.log_dir, log_dir)
        else:
            _global_tracer.log_dir = log_dir
    return _global_tracer


class CommsLogger:
    """Per-op totals (``summary()``: count, bytes, wall seconds) plus the
    most recent ``max_records`` raw ``(op, bytes, wall_s)`` records."""

    def __init__(self, enabled: bool = True, max_records: int = 10_000):
        self.enabled = enabled
        self._lock = threading.Lock()
        self.records: "collections.deque[Tuple[str, int, float]]" = \
            collections.deque(maxlen=max_records)
        self._totals: Dict[str, Dict[str, float]] = {}

    def _add(self, op: str, nbytes: int, wall_s: float) -> None:
        with self._lock:
            self.records.append((op, nbytes, wall_s))
            s = self._totals.setdefault(
                op, {"count": 0, "bytes": 0, "time_s": 0.0})
            s["count"] += 1
            s["bytes"] += nbytes
            s["time_s"] += wall_s

    @contextlib.contextmanager
    def record(self, op: str, nbytes: int):
        """Log one call of ``op`` moving ``nbytes`` (this rank's payload),
        timed by the host clock around the block."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(op, int(nbytes), time.perf_counter() - t0)

    def record_event(self, op: str, nbytes: int,
                     wall_s: float = 0.0) -> None:
        """Log one call without timing a block."""
        if self.enabled:
            self._add(op, int(nbytes), wall_s)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {op: dict(s) for op, s in self._totals.items()}

    def reset(self) -> None:
        with self._lock:
            self.records.clear()
            self._totals.clear()
