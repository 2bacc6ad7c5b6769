"""Degradation primitives of the tiered KV path (the port's part of
``deepspeed_tpu/faults.py``).

Only what the KV tier needs lives here: :class:`ChecksumError` (a demoted
page whose payload no longer matches the crc32 recorded at demote time;
the promotion falls back to re-prefill) and :func:`retry_with_backoff`
(the bounded retry of a tier read).  The seeded fault plan, its injection
hooks and the structured fatal with a flight-recorder postmortem come with
the control-plane slice; an enabled ``faults`` block raises until then.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional


class ChecksumError(IOError):
    """A spilled page's payload no longer matches the checksum recorded
    at demote time — the tier entry is corrupt and must be dropped (the
    consumer falls back to re-prefill; correctness is preserved, the copy
    saving is lost)."""


def retry_with_backoff(fn: Callable[[], Any], *, attempts: int,
                       backoff_s: float = 0.0,
                       retry_on=(IOError, OSError),
                       on_retry: Optional[Callable[[int, BaseException],
                                                   None]] = None):
    """Run ``fn``, retrying up to ``attempts`` extra times on
    ``retry_on`` with exponential backoff (``backoff_s * 2**attempt``).
    The LAST failure propagates — bounded retry, never a spin."""
    a = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if a >= attempts:
                raise
            if on_retry is not None:
                on_retry(a, e)
            if backoff_s:
                time.sleep(backoff_s * (2 ** a))
            a += 1
