"""Collective log (port of ``CommsLogger`` from ``deepspeed_tpu/utils/
trace.py``; ref: deepspeed/comm comms_logger).

The JAX package logs a collective once per *trace* of its enclosing jit, so
its counts answer "which call sites" and not "how many per step".  In the
port every collective is one executed ``torch.distributed`` call, so every
record here is one call that ran: the per-step counts and bytes are the
truth, and :meth:`CommsLogger.record` brackets the call's host wall time
(the enqueue on the card, the whole exchange on gloo)."""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Tuple


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
