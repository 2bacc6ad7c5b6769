"""Per-tier SLO & goodput accounting for the serving control plane (port
of ``deepspeed_tpu/slo.py``).

The :class:`~deepspeed_tpu_torch.telemetry.MetricsRegistry` answers "what
are the aggregates" and the flight recorder answers "why was THIS
request slow"; this module answers the operator/router question neither
does: **is this engine meeting its latency objectives right now, and
what is its goodput as opposed to raw tokens/s?**  ZeRO-Infinity-style
tiered serving makes the distinction load-bearing (arXiv:2104.07857,
arXiv:2101.06840): a weight-stream stall can silently eat an entire
TTFT budget while tokens/s looks healthy — throughput that misses its
deadline is not goodput.

:class:`SLOTracker` is the single-engine half of ROADMAP open item 2
(multi-replica routing with SLO tiers): the router will read one
tracker per replica.  Per tier (declared in the ``slo`` config block,
:class:`~deepspeed_tpu_torch.config.SLOConfig`):

- every request is classified **attained/violated at finish** against
  the tier's objectives (TTFT target, worst inter-token gap target,
  end-to-end deadline — each optional; "exactly on the target" attains,
  the objective is an inclusive bound);
- a rolling ``window_s`` **attainment** fraction (zero-traffic windows
  report 1.0 — no request missed its objective — never NaN);
- **burn rates** over multiple windows: observed violation rate
  divided by the error budget ``1 - target`` (burn 1.0 = spending the
  budget exactly at the sustainable rate; >> 1 = the SLO will be blown
  before the window closes).  When the burn exceeds the threshold in
  EVERY configured window simultaneously, the pluggable alert hook
  fires — default: a structured ``slo_burn_alert`` event into the
  flight recorder, so the postmortem and the alert share a timeline;
- **goodput**: tokens/s counted only for SLO-attained requests, as
  first-class registry metrics next to raw throughput.

Preemption contract: the scheduler requeues a preempted request under
the SAME ``req_id`` without re-submitting, so the tracker's record —
and with it the original arrival time — survives recompute; a
preempted-then-finished request is judged against the clock its user
actually experienced.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from deepspeed_tpu_torch.config import SLOConfig, SLOTierObjective

# one finished-request sample: (t_finish, attained, generated_tokens)
_Sample = Tuple[float, bool, int]


class _TierState:
    """Per-tier accounting: objectives, registry metrics, rolling
    sample window, burn-alert hysteresis."""

    __slots__ = ("name", "objective", "samples", "alert_active",
                 "c_attained", "c_violated", "c_tokens", "c_good_tokens",
                 "c_ttft_viol", "c_itl_viol", "c_deadline_viol",
                 "c_alerts", "g_attainment", "g_goodput", "g_burn",
                 "c_shed", "c_failed")

    def __init__(self, name: str, objective: SLOTierObjective, registry,
                 burn_windows_s: Tuple[float, ...]):
        self.name = name
        self.objective = objective
        self.samples: Deque[_Sample] = collections.deque()
        self.alert_active = False
        r = registry
        self.c_attained = r.counter(
            f"slo_{name}_attained_requests",
            f"tier {name} requests that met every set objective")
        self.c_violated = r.counter(
            f"slo_{name}_violated_requests",
            f"tier {name} requests that missed an objective")
        self.c_tokens = r.counter(
            f"slo_{name}_tokens",
            f"tier {name} tokens generated (throughput numerator)")
        self.c_good_tokens = r.counter(
            f"slo_{name}_goodput_tokens",
            f"tier {name} tokens from SLO-attained requests only "
            "(goodput numerator)")
        self.c_ttft_viol = r.counter(
            f"slo_{name}_ttft_violations",
            f"tier {name} requests whose first token missed ttft_s")
        self.c_itl_viol = r.counter(
            f"slo_{name}_itl_violations",
            f"tier {name} requests whose worst inter-token gap missed "
            "itl_s")
        self.c_deadline_viol = r.counter(
            f"slo_{name}_deadline_violations",
            f"tier {name} requests that finished past deadline_s")
        self.c_alerts = r.counter(
            f"slo_{name}_burn_alerts",
            f"tier {name} multiwindow burn-rate alert trips")
        self.c_shed = r.counter(
            f"slo_{name}_shed_requests",
            f"tier {name} requests load-shed at admission (typed "
            "rejection — never ran, not counted violated; the "
            "router's retry-elsewhere signal)")
        self.c_failed = r.counter(
            f"slo_{name}_failed_requests",
            f"tier {name} requests failed by a slot/admission "
            "exception (counted violated too — a failure IS a missed "
            "objective)")
        self.g_attainment = r.gauge(
            f"slo_{name}_attainment",
            f"tier {name} rolling-window attained fraction "
            "(1.0 on zero traffic)")
        self.g_goodput = r.gauge(
            f"slo_{name}_goodput_tokens_per_s",
            f"tier {name} rolling-window attained-request tokens/s")
        self.g_burn = {
            w: r.gauge(
                f"slo_{name}_burn_rate_{int(w)}s",
                f"tier {name} violation rate / error budget over "
                f"{int(w)}s (1.0 = spending the budget exactly)")
            for w in burn_windows_s}


class SLOTracker:
    """Classify finished requests against per-tier objectives and keep
    attainment / burn / goodput live in the registry.

    Hook surface (the serving engine calls these on its lifecycle
    edges; every hook is thread-safe and O(1) amortized):

    - :meth:`on_submit` — records arrival (idempotent per ``req_id``:
      a preemption requeue that re-announced the id would NOT reset the
      arrival clock);
    - :meth:`on_token` — first call stamps TTFT, later calls track the
      worst inter-token gap; ``now`` lets the engine share one
      ``perf_counter`` read with its telemetry path;
    - :meth:`on_finish` — classifies, updates counters/windows/burn
      gauges, fires the alert hook on a multiwindow burn trip;
    - :meth:`forget` — drops an abandoned record (cancelled request)
      without classifying it.

    ``alert_hook(tier_name, info_dict)`` replaces the default
    flight-recorder event; hysteresis re-arms only after every window's
    burn falls back under the threshold.
    """

    def __init__(self, cfg: SLOConfig, registry, tracer=None,
                 alert_hook: Optional[Callable[[str, Dict[str, Any]],
                                               None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.enabled = bool(cfg.enabled)
        self.registry = registry
        self.tracer = tracer
        self.alert_hook = alert_hook
        self._clock = clock
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        # req_id -> [tier_state, t_arrival, t_first|None, last_tok_t,
        #            worst_itl, tokens]
        self._live: Dict[Any, list] = {}
        self._tiers: Dict[str, _TierState] = {}
        if self.enabled:
            for name, obj in cfg.tiers.items():
                self._tiers[name] = _TierState(
                    name, obj, registry, cfg.burn_windows_s)
            # zero-traffic contract from construction: attainment 1.0
            for ts in self._tiers.values():
                ts.g_attainment.set(1.0)

    @property
    def tiers(self) -> Tuple[str, ...]:
        return tuple(self._tiers)

    # ------------------------------------------------------------ hooks
    def on_submit(self, req_id: Any, tier: Optional[str] = None,
                  now: Optional[float] = None) -> None:
        if not self.enabled:
            return
        tier = tier or self.cfg.default_tier
        ts = self._tiers.get(tier)
        if ts is None:
            raise ValueError(
                f"request {req_id!r}: unknown SLO tier {tier!r} "
                f"(declared: {sorted(self._tiers)})")
        now = self._clock() if now is None else now
        with self._lock:
            # idempotent: a preempted request keeps its ORIGINAL
            # arrival time through the recompute requeue
            self._live.setdefault(req_id, [ts, now, None, 0.0, 0.0, 0])

    def on_token(self, req_id: Any, now: Optional[float] = None) -> None:
        if not self.enabled:
            return
        rec = self._live.get(req_id)
        if rec is None:
            return                  # submitted before the tracker
        now = self._clock() if now is None else now
        with self._lock:
            rec[5] += 1
            if rec[2] is None:
                rec[2] = now        # first token (TTFT stamp)
            else:
                gap = now - rec[3]
                if gap > rec[4]:
                    rec[4] = gap    # worst inter-token gap
            rec[3] = now

    def forget(self, req_id: Any) -> None:
        """Drop a record without classifying (cancelled request)."""
        with self._lock:
            self._live.pop(req_id, None)

    def on_shed(self, req_id: Any, tier: Optional[str] = None) -> None:
        """A load-shed admission rejection: counted per tier but NOT
        as a violation — the request never ran, and a router retries
        it elsewhere (polluting attainment with sheds would make
        shedding look like failing, inverting the incentive)."""
        if not self.enabled:
            if tier is not None:
                raise ValueError(
                    f"request {req_id!r} names SLO tier {tier!r} but "
                    "the slo block is disabled — enable it to "
                    "classify tiers")
            return
        tier = tier or self.cfg.default_tier
        ts = self._tiers.get(tier)
        if ts is None:
            raise ValueError(
                f"request {req_id!r}: unknown SLO tier {tier!r} "
                f"(declared: {sorted(self._tiers)})")
        with self._lock:
            self._live.pop(req_id, None)
        ts.c_shed.inc()

    def on_fail(self, req_id: Any,
                now: Optional[float] = None) -> None:
        """A per-request failure (slot/admission exception): counted
        failed AND violated — the user got nothing, which is the
        strongest possible objective miss — and entered into the
        rolling window so burn rates see failure storms."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._live.pop(req_id, None)
        if rec is None:
            return
        now = self._clock() if now is None else now
        ts = rec[0]
        ts.c_failed.inc()
        ts.c_violated.inc()
        ts.c_tokens.inc(rec[5])
        with self._lock:
            ts.samples.append((now, False, rec[5]))
            *_, alert = self._refresh_tier(ts, now)
        if alert is not None:
            self._fire_alert(ts.name, alert)

    def on_finish(self, req_id: Any,
                  now: Optional[float] = None) -> Optional[bool]:
        """Classify at finish; returns attained (None if unknown id)."""
        if not self.enabled:
            return None
        with self._lock:
            rec = self._live.pop(req_id, None)
        if rec is None:
            return None
        now = self._clock() if now is None else now
        ts, t_arr, t_first, _last, worst_itl, tokens = rec
        obj = ts.objective
        ttft = (t_first - t_arr) if t_first is not None else (now - t_arr)
        total = now - t_arr
        # inclusive bounds: a deadline EXACTLY met is attained
        viol_ttft = obj.ttft_s is not None and ttft > obj.ttft_s
        viol_itl = obj.itl_s is not None and worst_itl > obj.itl_s
        viol_dead = obj.deadline_s is not None and total > obj.deadline_s
        attained = not (viol_ttft or viol_itl or viol_dead)
        if viol_ttft:
            ts.c_ttft_viol.inc()
        if viol_itl:
            ts.c_itl_viol.inc()
        if viol_dead:
            ts.c_deadline_viol.inc()
        (ts.c_attained if attained else ts.c_violated).inc()
        ts.c_tokens.inc(tokens)
        if attained:
            ts.c_good_tokens.inc(tokens)
        with self._lock:
            ts.samples.append((now, attained, tokens))
            *_, alert = self._refresh_tier(ts, now)
        if alert is not None:
            self._fire_alert(ts.name, alert)
        return attained

    def maybe_refresh(self, now: Optional[float] = None,
                      min_interval_s: float = 1.0) -> None:
        """Time-driven gauge/alert refresh (the engine calls this every
        step): without it, an idle engine's burn gauges would stay
        pinned at their last finish-time values forever — a Prometheus
        scraper would see a latched alert long after every violation
        aged out of the window.  One clock compare until due."""
        if not self.enabled:
            return
        now = self._clock() if now is None else now
        if now - self._last_refresh < min_interval_s:
            return
        self._last_refresh = now
        alerts = []
        with self._lock:
            for ts in self._tiers.values():
                *_, alert = self._refresh_tier(ts, now)
                if alert is not None:
                    alerts.append((ts.name, alert))
        for name, alert in alerts:
            self._fire_alert(name, alert)

    # ---------------------------------------------------------- windows
    def _prune(self, ts: _TierState, now: float) -> None:
        horizon = now - max(self.cfg.window_s,
                            max(self.cfg.burn_windows_s))
        while ts.samples and ts.samples[0][0] < horizon:
            ts.samples.popleft()

    def _window(self, ts: _TierState, now: float,
                window_s: float) -> Tuple[int, int, int]:
        """(finished, attained, attained_tokens) within the window."""
        lo = now - window_s
        n = att = good = 0
        for t, ok, tok in reversed(ts.samples):
            if t < lo:
                break
            n += 1
            if ok:
                att += 1
                good += tok
        return n, att, good

    def _burn(self, ts: _TierState, now: float,
              window_s: float) -> float:
        """Violation rate / error budget; 0.0 on zero traffic."""
        n, att, _ = self._window(ts, now, window_s)
        if not n:
            return 0.0
        budget = max(1.0 - ts.objective.target, 1e-9)
        return ((n - att) / n) / budget

    def _refresh_tier(self, ts: _TierState, now: float):
        """Recompute a tier's gauges + alert state (lock held).
        Returns ``(n, att, good, burns, alert_info_or_None)`` — the
        caller fires the alert AFTER releasing the lock (a pluggable
        hook may call back into the tracker, e.g. ``snapshot()``, and
        the lock is non-reentrant)."""
        self._prune(ts, now)
        n, att, good = self._window(ts, now, self.cfg.window_s)
        ts.g_attainment.set(att / n if n else 1.0)
        ts.g_goodput.set(good / self.cfg.window_s)
        burns = {w: self._burn(ts, now, w)
                 for w in self.cfg.burn_windows_s}
        for w, b in burns.items():
            ts.g_burn[w].set(b)
        alert = None
        tripped = all(b > self.cfg.burn_threshold
                      for b in burns.values())
        if tripped and not ts.alert_active:
            ts.alert_active = True
            ts.c_alerts.inc()
            alert = {"tier": ts.name,
                     "threshold": self.cfg.burn_threshold,
                     "attainment": att / n if n else 1.0,
                     "target": ts.objective.target,
                     **{f"burn_{int(w)}s": round(b, 3)
                        for w, b in burns.items()}}
        elif not tripped and ts.alert_active and \
                all(b <= self.cfg.burn_threshold for b in burns.values()):
            ts.alert_active = False   # hysteresis re-arm
        return n, att, good, burns, alert

    def _fire_alert(self, tier: str, info: Dict[str, Any]) -> None:
        # individually guarded: a broken hook must never take down the
        # serving loop that tripped it
        try:
            if self.alert_hook is not None:
                self.alert_hook(tier, info)
            elif self.tracer is not None and self.tracer.enabled:
                self.tracer.event("slo_burn_alert", attrs=info)
        except Exception:
            from deepspeed_tpu_torch.utils.logging import logger

            logger.exception("slo: alert hook raised (tier %s)", tier)

    # --------------------------------------------------------- snapshot
    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Per-tier JSON view (the ``/statusz`` ``slo`` section): the
        rolling window re-evaluated at call time, so an idle engine's
        attainment decays back to 1.0 as violations age out."""
        if not self.enabled:
            return {"enabled": False}
        now = self._clock() if now is None else now
        tiers: Dict[str, Any] = {}
        alerts = []
        with self._lock:
            for name, ts in self._tiers.items():
                n, att, good, burns, alert = self._refresh_tier(ts, now)
                if alert is not None:
                    alerts.append((name, alert))
                obj = ts.objective
                tiers[name] = {
                    "objective": {
                        k: v for k, v in (
                            ("ttft_s", obj.ttft_s),
                            ("itl_s", obj.itl_s),
                            ("deadline_s", obj.deadline_s))
                        if v is not None},
                    "target": obj.target,
                    "window_s": self.cfg.window_s,
                    "window_finished": n,
                    "window_attained": att,
                    "attainment": att / n if n else 1.0,
                    "goodput_tokens_per_s": round(
                        good / self.cfg.window_s, 3),
                    "burn_rates": {f"{int(w)}s": round(b, 4)
                                   for w, b in burns.items()},
                    "burn_threshold": self.cfg.burn_threshold,
                    "alert_active": ts.alert_active,
                    "lifetime": {
                        "attained": int(ts.c_attained.value),
                        "violated": int(ts.c_violated.value),
                        "tokens": int(ts.c_tokens.value),
                        "goodput_tokens": int(ts.c_good_tokens.value),
                        "ttft_violations": int(ts.c_ttft_viol.value),
                        "itl_violations": int(ts.c_itl_viol.value),
                        "deadline_violations": int(
                            ts.c_deadline_viol.value),
                        "burn_alerts": int(ts.c_alerts.value),
                        "shed": int(ts.c_shed.value),
                        "failed": int(ts.c_failed.value),
                    },
                    "in_flight": sum(
                        1 for rec in self._live.values()
                        if rec[0] is ts),
                }
        for name, alert in alerts:
            self._fire_alert(name, alert)
        return {"enabled": True, "default_tier": self.cfg.default_tier,
                "tiers": tiers}


def fleet_rollup(snapshots, versions=None, roles=None) -> Dict[str, Any]:
    """Aggregate per-replica :meth:`SLOTracker.snapshot` dicts into one
    fleet view (the multi-replica router's ``/statusz`` ``slo``
    section).  Per tier across replicas: lifetime counters sum, the
    rolling window re-derives attainment from summed
    finished/attained, goodput sums (each replica's window tokens/s
    add), burn rates take the MAX (the alert question is "is ANY
    replica burning its budget", not the average that would let one
    sick replica hide behind two healthy ones), and ``alert_active``
    ORs.  Disabled snapshots pass through; zero-traffic tiers keep the
    1.0-attainment contract.  Snapshots may also arrive over the wire:
    a remote replica's scraped ``statusz["slo"]`` block
    (:mod:`deepspeed_tpu_torch.obs_wire`) is exactly this shape, and a
    never-scraped remote contributes ``None``, filtered like a
    disabled tracker.

    ``versions``: a weight-version label per snapshot (aligned with
    ``snapshots``).  When given and more than one distinct version is
    present, the result gains ``by_version`` — the SAME rollup
    computed per version group, keyed by ``str(version)`` — so a
    rolling update can watch the NEW version's burn rate next to the
    old one's while both serve side by side.

    ``roles``: a serving-role label per snapshot (a disaggregated
    fleet's ``"prefill"``/``"decode"``; None entries — e.g. retired
    replicas — are skipped).  With at least one labeled snapshot the
    result gains ``by_role``, the same rollup per role group, so a
    disaggregated fleet watches the prefill pool's TTFT burn apart
    from the decode pool's deadline burn (the per-role scaling signal
    the autoscaler composes on)."""
    snapshots = list(snapshots)
    if versions is not None:
        versions = list(versions)
        if len(versions) != len(snapshots):
            raise ValueError(
                f"fleet_rollup: {len(versions)} versions for "
                f"{len(snapshots)} snapshots — they must align")
    if roles is not None:
        roles = list(roles)
        if len(roles) != len(snapshots):
            raise ValueError(
                f"fleet_rollup: {len(roles)} roles for "
                f"{len(snapshots)} snapshots — they must align")
    out = _rollup(snapshots)
    if versions is not None and out.get("enabled"):
        distinct = {str(v) for s, v in zip(snapshots, versions)
                    if s and s.get("enabled")}
        if len(distinct) > 1:
            groups: Dict[str, list] = {}
            for s, v in zip(snapshots, versions):
                groups.setdefault(str(v), []).append(s)
            out["by_version"] = {v: _rollup(g)
                                 for v, g in sorted(groups.items())}
    if roles is not None and out.get("enabled"):
        rgroups: Dict[str, list] = {}
        for s, ro in zip(snapshots, roles):
            if ro is not None:
                rgroups.setdefault(str(ro), []).append(s)
        if rgroups:
            out["by_role"] = {ro: _rollup(g)
                              for ro, g in sorted(rgroups.items())}
    return out


def _rollup(snapshots) -> Dict[str, Any]:
    snaps = [s for s in snapshots if s and s.get("enabled")]
    if not snaps:
        return {"enabled": False}
    tiers: Dict[str, Dict[str, Any]] = {}
    for s in snaps:
        for name, t in s.get("tiers", {}).items():
            agg = tiers.get(name)
            if agg is None:
                agg = {
                    "objective": dict(t.get("objective", {})),
                    "target": t.get("target"),
                    "window_s": t.get("window_s"),
                    "window_finished": 0,
                    "window_attained": 0,
                    "goodput_tokens_per_s": 0.0,
                    "burn_rates": {},
                    "burn_threshold": t.get("burn_threshold"),
                    "alert_active": False,
                    "lifetime": {},
                    "in_flight": 0,
                    "replicas": 0,
                }
                tiers[name] = agg
            agg["replicas"] += 1
            agg["window_finished"] += int(t.get("window_finished", 0))
            agg["window_attained"] += int(t.get("window_attained", 0))
            agg["goodput_tokens_per_s"] = round(
                agg["goodput_tokens_per_s"]
                + float(t.get("goodput_tokens_per_s", 0.0)), 3)
            for w, b in t.get("burn_rates", {}).items():
                agg["burn_rates"][w] = max(
                    agg["burn_rates"].get(w, 0.0), float(b))
            agg["alert_active"] = (agg["alert_active"]
                                   or bool(t.get("alert_active")))
            for k, v in t.get("lifetime", {}).items():
                agg["lifetime"][k] = agg["lifetime"].get(k, 0) + int(v)
            agg["in_flight"] += int(t.get("in_flight", 0))
    for agg in tiers.values():
        n = agg["window_finished"]
        agg["attainment"] = agg["window_attained"] / n if n else 1.0
    return {"enabled": True,
            "default_tier": snaps[0].get("default_tier"),
            "replicas": len(snaps), "tiers": tiers}


class _NullSLOTracker:
    """Shared no-op stand-in when the ``slo`` block is off: every hook
    is one early return, mirroring telemetry's null metrics."""

    enabled = False
    tiers: Tuple[str, ...] = ()

    def on_submit(self, req_id, tier=None, now=None):
        if tier is not None:
            raise ValueError(
                f"request {req_id!r} names SLO tier {tier!r} but the "
                "slo block is disabled — enable it to classify tiers")

    def on_token(self, req_id, now=None):
        pass

    def on_finish(self, req_id, now=None):
        return None

    def on_shed(self, req_id, tier=None):
        if tier is not None:
            raise ValueError(
                f"request {req_id!r} names SLO tier {tier!r} but the "
                "slo block is disabled — enable it to classify tiers")

    def on_fail(self, req_id, now=None):
        pass

    def forget(self, req_id):
        pass

    def maybe_refresh(self, now=None, min_interval_s=1.0):
        pass

    def snapshot(self, now=None):
        return {"enabled": False}


NULL_SLO_TRACKER = _NullSLOTracker()
