"""Deterministic fault injection + the shared degradation primitives it
exercises (port of ``deepspeed_tpu/faults.py``).

A failed or corrupted tier read, a slot-level exception or a saturation
burst must degrade ONE request (retry, fall back, shed, fail-and-release),
never the whole engine.  This module provides both halves of proving that:

- **Injection** (:class:`FaultPlan`): a seeded, config-driven set of
  :class:`FaultRule` entries, each addressable by *subsystem*, firing
  *rate*, trigger *count* and skip-*after* offset, so a test replays the
  exact same fault schedule from the same seed (the plan's streams are
  Python's ``random``, seeded as the JAX package seeds them, so one seed
  gives the same schedule in both packages).  Hook points consult the
  process-wide plan (installed via :func:`install_fault_plan`) through
  :func:`poll` / :func:`inject`; with no plan installed every hook is a
  single ``is None`` check.

  Subsystems wired in the port:

  ========== ===========================================================
  subsystem   hook point
  ========== ===========================================================
  aio_read    :meth:`~deepspeed_tpu_torch.io.aio.AioHandle.pread` — an
              error rule makes the read report as failed at the next
              ``wait()`` (the submit is swallowed, the buffer stays
              unfilled); a latency rule sleeps at submit.
  aio_write   :meth:`~deepspeed_tpu_torch.io.aio.AioHandle.pwrite`, same
              semantics.
  kv_corrupt  :meth:`~deepspeed_tpu_torch.inference.kv_tier.KVTierPool.
              demote` — flips a byte of the captured payload AFTER its
              checksum was recorded, so promotion's verify catches it.
  slot        the serving scheduler's per-slot work loop — raises
              :class:`InjectedFault` for one slot's request (keyed by
              ``req_id``, so ``match`` can target one request).
  sync_read   the synchronous tier-read fallback — lets tests exhaust the
              LAST degradation rung and prove the structured-fatal +
              postmortem path.
  burst       no engine hook: consumed by a traffic generator to trigger
              admission bursts (queue pressure → load shedding).
  replica     the :class:`~deepspeed_tpu_torch.fleet.FleetRouter`'s per-
              replica poll (one opportunity per replica per router
              step; ``match=`` targets a replica id).  Mode ``error``
              KILLS the replica (the router fails it over), mode
              ``latency`` STALLS it for ``latency_s`` (a stall past
              the fleet's ``fatal_stall_s`` is treated as a death),
              and the replica-only mode ``degrade`` forces its health
              to degraded for ``latency_s`` seconds (default 30) —
              quarantine/hysteresis exercise without breaking
              anything.  Combined with ``after=`` this is also how a
              chaos run kills a replica mid-rollout.
  fabric      the :class:`~deepspeed_tpu_torch.kv_fabric.KVFabric` hook
              points.  Opportunities carry prefixed keys so one rule
              targets one leg via ``match``: ``export:<keyhex>``
              (publish into the fabric — an error rule fails the
              export and the migration falls back to re-prefill),
              ``fetch:<keyhex>`` (admit out of the fabric — a latency
              rule delays the fetch, pushing the migration toward its
              ``migrate_timeout_s``; an error rule fails it), and
              ``corrupt:<keyhex>`` (an error rule flips a payload byte
              AFTER the per-buffer crc32 was recorded, so the
              admitting replica's promotion-time checksum verify must
              catch it and re-prefill).  A rule without ``match``
              fires on every leg — write ``match="export"`` etc. to
              scope it.
  scale       the :class:`~deepspeed_tpu_torch.autoscale.FleetAutoscaler`'s
              scale-up path (one opportunity per spawn attempt; key =
              the new replica id, so ``match=`` targets one).  Mode
              ``error`` = engine-factory failure (the scale-up aborts,
              is counted, and retries at a later evaluation); mode
              ``latency`` = a slow cold-start (the spawn sleeps
              ``latency_s`` before the factory runs — visible in the
              ``autoscale_cold_start_seconds`` histogram).
  scrape      the :class:`~deepspeed_tpu_torch.obs_wire.RemoteReplica` scrape
              loop (one opportunity per HTTP scrape attempt; key = the
              remote replica id, so ``match=`` targets one).  Mode
              ``error`` fails the scrape (counted in
              ``obswire_scrape_errors``, retried with backoff, and — if
              persistent — walks the replica FRESH→STALE→LOST); mode
              ``latency`` delays the scrape by ``latency_s`` capped at
              the configured ``obs_wire.timeout_s`` so an injected
              stall can never wedge the poll loop.
  transport   the :class:`~deepspeed_tpu_torch.transport.Channel` data plane
              (one opportunity per send/recv/frame; key =
              ``send:<peer>``, ``recv:<peer>`` or ``corrupt:<peer>``,
              so ``match=`` scopes a rule to one leg of one
              peer-pair).  On ``send:``/``recv:`` a latency rule
              sleeps (wire jitter) and an error rule raises
              :class:`~deepspeed_tpu_torch.transport.TransportError` — the
              reconnect/backoff path.  On ``corrupt:`` an error rule
              flips one byte of the encoded frame AFTER its crc32 was
              stamped, so the receiving side's ``decode_frame`` must
              reject it as :class:`~deepspeed_tpu_torch.transport.
              TransportCorrupt` (and a corrupted migrated page that
              somehow slipped a layer further still dies at the
              importer's promotion-time checksum).
  ========== ===========================================================

- **Degradation helpers**: :func:`retry_with_backoff` (the bounded
  retry every aio consumer shares), the typed error hierarchy
  (:class:`InjectedFault`, :class:`ChecksumError`,
  :class:`FatalStreamError`), and :func:`corrupt_array`.

Determinism contract: each rule owns a :class:`random.Random` stream
seeded from ``(plan seed, rule index)`` and advances it once per
matching opportunity, so the decision at the N-th opportunity of a
subsystem depends only on the seed and N — never on wall clock or
interleaving with other subsystems.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class InjectedFault(IOError):
    """An error deliberately raised by the fault plan at a host-side
    injection point (subclass of IOError so the bounded aio retry
    paths treat it as the transient failure it simulates)."""


class ChecksumError(IOError):
    """A spilled page's payload no longer matches the checksum recorded
    at demote time — the tier entry is corrupt and must be dropped (the
    consumer falls back to re-prefill; correctness is preserved, the
    DMA saving is lost)."""


class FatalStreamError(RuntimeError):
    """Unrecoverable tier-stream failure: retries exhausted AND the
    synchronous fallback read failed (or does not exist).  Raised only
    after a flight-recorder postmortem was dumped — ``postmortem_paths``
    names the dump files, so the operator report and the abort share a
    timeline."""

    def __init__(self, msg: str, postmortem_paths=()):
        super().__init__(msg)
        self.postmortem_paths = list(postmortem_paths)


SUBSYSTEMS = ("aio_read", "aio_write", "kv_corrupt", "slot",
              "sync_read", "burst", "replica", "scale", "fabric",
              "scrape", "transport")
MODES = ("error", "latency", "degrade")
# subsystems whose opportunities carry a key a `match` filter can test
# (aio ops and bursts are anonymous — a match there would validate
# fine and silently never fire, so it is rejected at rule build)
_KEYED_SUBSYSTEMS = ("kv_corrupt", "slot", "sync_read", "replica",
                     "scale", "fabric", "scrape", "transport")


@dataclasses.dataclass
class FaultRule:
    """One injection rule.  ``rate`` is the per-opportunity firing
    probability (1.0 = every opportunity), ``after`` skips the first N
    opportunities, ``count`` caps lifetime fires (None = unbounded) —
    together they make a schedule addressable enough for a test to say
    "fail exactly the 3rd and 4th aio reads".  ``match`` filters by
    substring on the opportunity key (e.g. a request id).  ``seen`` /
    ``fired`` are runtime accounting, exported by
    :meth:`FaultPlan.snapshot`."""

    subsystem: str
    mode: str = "error"
    rate: float = 1.0
    count: Optional[int] = None
    after: int = 0
    latency_s: float = 0.0
    match: Optional[str] = None
    seen: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.subsystem not in SUBSYSTEMS:
            raise ValueError(
                f"faults rule subsystem must be one of {SUBSYSTEMS}, "
                f"got {self.subsystem!r}")
        if self.mode not in MODES:
            raise ValueError(
                f"faults rule mode must be one of {MODES}, got "
                f"{self.mode!r}")
        self.rate = float(self.rate)
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(
                f"faults rule rate must be in (0, 1], got {self.rate}")
        self.after = int(self.after)
        if self.after < 0:
            raise ValueError(
                f"faults rule after must be >= 0, got {self.after}")
        if self.count is not None:
            self.count = int(self.count)
            if self.count < 1:
                raise ValueError(
                    f"faults rule count must be positive or null, got "
                    f"{self.count}")
        self.latency_s = float(self.latency_s)
        if self.latency_s < 0:
            raise ValueError(
                f"faults rule latency_s must be >= 0, got "
                f"{self.latency_s}")
        if self.mode == "latency" and self.latency_s == 0.0:
            raise ValueError(
                "faults rule mode 'latency' needs latency_s > 0")
        if self.mode == "degrade" and self.subsystem != "replica":
            raise ValueError(
                "faults rule mode 'degrade' only applies to the "
                "'replica' subsystem — other hook points have no "
                "degraded state to force")
        if self.match is not None and \
                self.subsystem not in _KEYED_SUBSYSTEMS:
            raise ValueError(
                f"faults rule match= only applies to keyed subsystems "
                f"{_KEYED_SUBSYSTEMS} — {self.subsystem!r} "
                "opportunities carry no key, so the rule could never "
                "fire")


class FaultPlan:
    """A seeded set of fault rules, consulted at the hook points.

    ``fire(subsystem, key)`` advances EVERY matching rule's stream (so
    determinism never depends on which rule fired first) and returns
    the rules that fired this opportunity.  :func:`poll` /
    :func:`inject` are the hook-side wrappers most call sites use.
    """

    def __init__(self, rules, seed: int = 0):
        self.seed = int(seed)
        self.rules: List[FaultRule] = []
        for r in rules:
            if isinstance(r, dict):
                known = {f.name for f in dataclasses.fields(FaultRule)}
                bad = set(r) - known
                if bad:
                    raise ValueError(
                        f"unknown faults rule keys {sorted(bad)} "
                        f"(known: {sorted(known - {'seen', 'fired'})})")
                r = FaultRule(**r)
            elif not isinstance(r, FaultRule):
                raise TypeError(
                    f"faults rules must be dicts or FaultRule, got "
                    f"{type(r).__name__}")
            self.rules.append(r)
        # one independent stream per rule, seeded off (plan seed, rule
        # index): adding a rule never perturbs another rule's schedule
        self._rngs = [random.Random((self.seed << 16) ^ (i * 2654435761))
                      for i in range(len(self.rules))]
        self._by_sub: Dict[str, List[int]] = {}
        for i, r in enumerate(self.rules):
            self._by_sub.setdefault(r.subsystem, []).append(i)
        self._lock = threading.Lock()
        self.opportunities: Dict[str, int] = {}

    @classmethod
    def from_config(cls, cfg) -> "FaultPlan":
        """Build from a :class:`~deepspeed_tpu_torch.config.FaultsConfig`."""
        return cls(cfg.rules, seed=cfg.seed)

    def fire(self, subsystem: str, key: Any = None) -> List[FaultRule]:
        """One opportunity for ``subsystem``: every matching rule draws
        (deterministically); returns the rules that fired."""
        idxs = self._by_sub.get(subsystem)
        if not idxs:
            return []
        fired: List[FaultRule] = []
        with self._lock:
            self.opportunities[subsystem] = \
                self.opportunities.get(subsystem, 0) + 1
            for i in idxs:
                rule = self.rules[i]
                if rule.match is not None and \
                        rule.match not in str(key):
                    continue
                rule.seen += 1
                # the draw happens for every seen opportunity — count
                # and after gate the EFFECT, not the stream position —
                # so changing count never shifts later decisions
                draw = rule.rate >= 1.0 or \
                    self._rngs[i].random() < rule.rate
                if rule.seen <= rule.after:
                    continue
                if rule.count is not None and rule.fired >= rule.count:
                    continue
                if draw:
                    rule.fired += 1
                    fired.append(rule)
        return fired

    def snapshot(self) -> Dict[str, Any]:
        """Accounting view: per-rule seen/fired plus per-subsystem
        opportunity counts — the injection side of the chaos soak's
        failure reconciliation."""
        with self._lock:
            return {
                "seed": self.seed,
                "opportunities": dict(self.opportunities),
                "injected": sum(r.fired for r in self.rules),
                "rules": [{
                    "subsystem": r.subsystem, "mode": r.mode,
                    "rate": r.rate, "count": r.count, "after": r.after,
                    "latency_s": r.latency_s, "match": r.match,
                    "seen": r.seen, "fired": r.fired,
                } for r in self.rules],
            }


# -------------------------------------------------- process-wide plan
# (hook points — the aio pool, the tier read fallbacks — have no engine
# handle, so the plan installs process-wide like the default tracer;
# the serving engine owns install/clear through its lifecycle)
_plan_lock = threading.Lock()
_PLAN: Optional[FaultPlan] = None


def install_fault_plan(plan: FaultPlan) -> Optional[FaultPlan]:
    """Install ``plan`` as the process-wide fault plan; returns the
    previous one (tests restore it)."""
    global _PLAN
    with _plan_lock:
        prev, _PLAN = _PLAN, plan
        return prev


def clear_fault_plan(plan: Optional[FaultPlan] = None) -> None:
    """Remove the process-wide plan.  With ``plan`` given, clears only
    if it is still the installed one (an engine tearing down must not
    yank a newer engine's plan)."""
    global _PLAN
    with _plan_lock:
        if plan is None or _PLAN is plan:
            _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def ensure_installed(plan: Optional[FaultPlan]) -> bool:
    """Install ``plan`` process-wide unless it already is the active
    plan; returns True when THIS call installed it (the caller then
    owns the matching :func:`clear_fault_plan`).  The shared
    install-once-own-once step every engine/router lifecycle runs."""
    if plan is None or active_plan() is plan:
        return False
    install_fault_plan(plan)
    return True


def poll(subsystem: str, key: Any = None
         ) -> Tuple[float, Optional[FaultRule]]:
    """Hook-side check WITHOUT side effects beyond stream advance:
    returns ``(latency_seconds, error_rule_or_None)``.  The caller
    applies the latency and interprets the error (the aio pool turns it
    into a failed-op count rather than a raise)."""
    plan = _PLAN
    if plan is None:
        return 0.0, None
    delay = 0.0
    err: Optional[FaultRule] = None
    for rule in plan.fire(subsystem, key):
        if rule.mode == "latency":
            delay += rule.latency_s
        elif err is None:
            err = rule
    return delay, err


def poll_replica(replica_id: Any) -> List[FaultRule]:
    """Fleet-router hook: one opportunity for the ``replica``
    subsystem (key = the replica id; ``match`` filters on it).
    Returns the fired rules raw — the router interprets mode
    ``error`` as kill, ``latency`` as stall-for ``latency_s``, and
    ``degrade`` as force-degrade (unlike :func:`poll`, which folds
    modes into a (delay, error) pair no router could act on)."""
    plan = _PLAN
    if plan is None:
        return []
    return plan.fire("replica", replica_id)


def inject(subsystem: str, key: Any = None) -> bool:
    """Hook-side check for plain host code points: sleeps out latency
    rules and RAISES :class:`InjectedFault` for error rules.  Returns
    True when a latency rule fired (and nothing raised)."""
    delay, err = poll(subsystem, key)
    if delay:
        time.sleep(delay)
    if err is not None:
        raise InjectedFault(
            f"injected {subsystem} fault"
            + (f" (key={key!r})" if key is not None else ""))
    return bool(delay)


# ----------------------------------------------- degradation helpers
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


def read_file_sync(path: str, shape, dtype, key: Any = None):
    """Synchronous tier-file read — the shared degradation rung below
    the aio channel (both the weight tiers and the KV spill pool fall
    here when a fence exhausted its retries).  Carries the
    ``sync_read`` injection point so tests can exhaust the last rung."""
    import numpy as np

    inject("sync_read", key=key if key is not None else path)
    arr = np.fromfile(path, dtype=np.dtype(dtype))
    want = int(np.prod(shape)) if shape else 1
    if arr.size != want:
        raise IOError(f"sync read of {path}: {arr.size} elements != "
                      f"expected {want}")
    return arr.reshape(shape)


def corrupt_array(arr) -> None:
    """Flip one byte of ``arr`` in place (the kv_corrupt injection —
    enough to break a checksum, silent to everything else)."""
    view = arr.view("u1").reshape(-1)
    view[0] ^= 0xFF


def guarded_postmortem(reason: str) -> List[str]:
    """Best-effort flight-recorder dump (a failing dump must never mask
    the fatal it documents); returns the dump paths."""
    try:
        from deepspeed_tpu_torch import request_trace

        return list(request_trace.postmortem_dump(reason) or [])
    except Exception:
        return []
