"""Failure detection (port of ``deepspeed_tpu/utils/watchdog.py``; ref:
DeepSpeed's overflow checking in ``runtime/fp16/loss_scaler.py`` + elastic
fault tolerance).

Two guards:

- :class:`NanGuard` — a finite check over a tree of tensors, reduced on
  the device (one scalar, no host sync until read); the skip-step select
  keeps ``old`` where the grads were not finite (the reference's
  ``CHECK_OVERFLOW`` + dynamic loss scaler ``skip step``).
- :class:`Watchdog` — a host-side heartbeat thread that detects
  multi-process hangs (a collective stuck because one rank died) and
  invokes a callback / aborts, the NCCL watchdog's role.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Optional

import torch

from deepspeed_tpu_torch._tree import tree_leaves, tree_map


class NanGuard:
    """Finite-check + skip-step accounting over trees of tensors."""

    @staticmethod
    def all_finite(tree: Any) -> torch.Tensor:
        """Scalar bool tensor: every floating leaf of the tree is finite
        (on the leaves' device)."""
        leaves = [torch.isfinite(x).all() for x in tree_leaves(tree)
                  if isinstance(x, torch.Tensor) and
                  (x.is_floating_point() or x.is_complex())]
        if not leaves:
            return torch.tensor(True)
        return torch.stack(leaves).all()

    @staticmethod
    def where_finite(tree: Any, new: Any, old: Any) -> Any:
        """Select ``new`` if grads were finite else keep ``old`` (skip-step)."""
        ok = NanGuard.all_finite(tree)
        return tree_map(lambda n, o: torch.where(ok.to(n.device), n, o),
                        new, old)


class Watchdog:
    """Heartbeat-based hang detector.

    Call :meth:`pet` after every completed step.  A daemon thread fires
    ``on_timeout`` (default: log + ``os._exit(42)`` so the launcher can
    restart the job) if no heartbeat arrives within ``timeout_s`` —
    detecting the classic multi-host failure where a peer dies and every
    other host blocks forever inside an ICI/DCN collective.
    """

    def __init__(self, timeout_s: float = 600.0,
                 on_timeout: Optional[Callable[[], None]] = None,
                 abort_on_timeout: bool = True,
                 poll_s: float = 1.0):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.abort_on_timeout = abort_on_timeout
        self.poll_s = poll_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self.fired = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        self._last = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dstpu-watchdog")
        self._thread.start()
        return self

    def pet(self) -> None:
        self._last = time.monotonic()

    def last_pet_age_s(self) -> float:
        """Seconds since the last heartbeat — the liveness signal
        ``/healthz`` exposes (a fleet probe sees the hang building
        BEFORE the timeout fires)."""
        return time.monotonic() - self._last

    def health(self) -> dict:
        """JSON view for health endpoints."""
        return {"fired": bool(self.fired),
                "timeout_s": self.timeout_s,
                "last_heartbeat_age_s": round(self.last_pet_age_s(), 3)}

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if time.monotonic() - self._last > self.timeout_s:
                self.fired = True
                from deepspeed_tpu_torch.utils.logging import (logger,
                                                               process_rank)

                logger.error(
                    "watchdog: no heartbeat for %.0fs on rank %d — "
                    "likely hung collective (dead peer)",
                    self.timeout_s, process_rank())
                # postmortem BEFORE callbacks or the abort: dump every
                # live flight recorder (the hung request's last events)
                # and force-flush telemetry sinks, each individually
                # guarded — a failing dump must never mask the abort
                try:
                    from deepspeed_tpu_torch import request_trace

                    paths = request_trace.postmortem_dump(
                        "watchdog_timeout")
                    if paths:
                        logger.error(
                            "watchdog: flight-recorder dump → %s",
                            ", ".join(paths))
                except Exception:
                    logger.exception(
                        "watchdog: flight-recorder dump failed")
                try:
                    from deepspeed_tpu_torch import telemetry

                    telemetry.flush_all_exporters()
                except Exception:
                    logger.exception("watchdog: telemetry flush failed")
                if self.on_timeout is not None:
                    try:
                        self.on_timeout()
                    except Exception:
                        logger.exception(
                            "watchdog: on_timeout callback raised")
                if self.abort_on_timeout:
                    os._exit(42)
                return
