"""Incident engine: automatic capture of the fleet's failure moments —
the trip logic of the black-box flight recorder (port of
``deepspeed_tpu/incidents.py``).

The stack already *emits* everything a postmortem needs: structured
flight-recorder events (``slo_burn_alert``, ``kv_promote_failed``,
``replica_dead``, ``rollout_halt``/``rollout_rolled_back``,
``request_shed`` storms), registry metrics, and ``/statusz``
snapshots.  What it lacked was the production answer to "were you
watching at the right moment": operators debug a 3 a.m. burn trip from
whatever ``dstpu_top`` happened to show.  :class:`IncidentManager`
closes that gap — it polls the flight-recorder ring incrementally on
the shared :class:`~deepspeed_tpu_torch.telemetry.TelemetryExporter` tick
(never the decode hot path), classifies trigger events into incident
classes, runs lightweight EWMA z-score detectors over
:class:`~deepspeed_tpu_torch.history.MetricHistory` series (TTFT p95, stall
rate, goodput collapse — the trajectory pathologies ZeRO-Infinity-
style tiered streaming develops over seconds, arXiv:2104.07857), and
on a trip captures an **incident bundle**: one atomic JSON document
(``utils/evidence.atomic_write_json``) holding

- the triggering event (or detector verdict) at t0,
- ``pre_window_s`` of metric history for the tracked series,
- the last ``ring_events`` flight-recorder events around t0,
- the ``/statusz`` + SLO snapshot at capture time,
- the history annotations (scale/rollout marks) inside the window.

Dedup discipline: trips of one incident class inside
``dedup_window_s`` are SUPPRESSED (counted, never written) — a burn
storm yields one bundle, not hundreds — and ``max_bundles`` caps a
process's total.  ``tools/incident_report.py`` renders a bundle into a
human timeline; ``dstpu_top`` shows recent incidents as a ticker row.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.config import IncidentsConfig
from deepspeed_tpu_torch.request_trace import event_to_dict
from deepspeed_tpu_torch.utils.evidence import atomic_write_json

# trigger event phase -> incident class.  These are the structured
# events the stack already emits; anything else in the ring is context,
# not a trip.
# a detector excursion must hold this many consecutive evaluations
# before it trips: percentile series are bucket-quantized, so a single
# one-bucket jump is jitter; a sustained excursion is a regime change
_DETECTOR_CONSECUTIVE = 3

TRIGGER_PHASES: Dict[str, str] = {
    "slo_burn_alert": "slo_burn",
    "kv_promote_failed": "kv_tier_fault",
    "replica_dead": "replica_failover",
    "rollout_halt": "rollback",
    "rollout_rolled_back": "rollback",
    "autoscale_up_failed": "scale_failure",
    "watchdog_fired": "watchdog",
    # a scraped out-of-process replica aged past lost_after_s (or
    # spoke an incompatible wire schema) — emitted once per outage by
    # obs_wire.RemoteReplica on the router's tracer
    "remote_lost": "remote_lost",
}


class IncidentManager:
    """Subscribe to the structured event stream + run online anomaly
    detectors; capture deduped incident bundles on trips.

    Single-writer contract: :meth:`maybe_evaluate` runs on the engine/
    router thread (exporter tick hook).  Read surfaces
    (:meth:`snapshot`) are safe from the HTTP thread — bundle metadata
    lives in an append-only list.
    """

    def __init__(self, cfg: IncidentsConfig, *, registry, tracer=None,
                 history=None,
                 statusz_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 source: str = "engine",
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.enabled = bool(cfg.enabled)
        self.tracer = tracer
        self.history = history
        self.statusz_fn = statusz_fn
        self.source = str(source)
        self._clock = clock
        self._last_eval: Optional[float] = None
        self._ring_cursor = 0
        self._last_trip: Dict[str, float] = {}     # class -> t (dedup)
        self._seq = 0
        self.bundles: List[Dict[str, Any]] = []    # meta, append-only
        # plain-int twins of the registry counters: snapshot() must
        # report true suppression/trip totals even when the manager runs
        # on a DISABLED registry (incidents needs tracing, not
        # telemetry — null metrics would read 0 forever)
        self._n_suppressed = 0
        self._n_detector = 0
        # EWMA detector state: series ->
        # [mean, var, n, streak, last_bucket_t] — last_bucket_t gates
        # the update to once per NEW history sample, whatever the
        # evaluation cadence (an explicit empty cfg.detect disables;
        # None defers to the consumer's defaults via watch_series)
        self._detect: Dict[str, List[Any]] = {
            name: [0.0, 0.0, 0, 0, None]
            for name in (cfg.detect or ())}
        # extra trip probes: zero-arg callables returning
        # (class, attrs) on a trip, None otherwise (the watchdog feed)
        self._probes: List[Callable[[], Optional[Tuple[str, Dict]]]] = []
        # named bundle attachments: zero-arg callables whose return
        # value is embedded in every bundle under its name (devprof
        # registers its compile ledger + capture references here)
        self._attachments: Dict[str, Callable[[], Any]] = {}
        r = registry
        self._c_bundles = r.counter(
            "incident_bundles_total",
            "incident bundles captured (atomic JSON, deduped per "
            "class inside incidents.dedup_window_s)")
        self._c_suppressed = r.counter(
            "incident_suppressed_total",
            "trips suppressed by per-class dedup / the bundle cap — "
            "a burn storm yields one bundle, not hundreds")
        self._c_detector = r.counter(
            "incident_detector_trips",
            "EWMA z-score anomaly-detector trips (before dedup)")

    # ------------------------------------------------------------ wiring
    def watch_series(self, name: str) -> None:
        """Add a history series to the EWMA anomaly detectors (the
        ZeRO-Inference engine registers its stream-stall p95 here)."""
        self._detect.setdefault(name, [0.0, 0.0, 0, 0, None])

    def add_probe(self, fn: Callable[[], Optional[Tuple[str, Dict]]]
                  ) -> None:
        """Register an extra trip probe, polled each evaluation:
        return ``(incident_class, attrs)`` to trip, None otherwise.
        Probes are individually guarded — a broken probe never takes
        down the tick."""
        self._probes.append(fn)

    def add_attachment(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a named bundle attachment: ``fn()`` is evaluated at
        capture time and embedded in the bundle under ``name``.  Each
        attachment is individually guarded — a broken one degrades to
        an ``{"error": ...}`` stanza, never loses the bundle."""
        self._attachments[str(name)] = fn

    # ---------------------------------------------------------- evaluate
    # dstpu: hot-path
    def maybe_evaluate(self, now: Optional[float] = None) -> bool:
        """One evaluation if ``eval_interval_s`` elapsed; safe to call
        every scheduler step (one clock compare until due)."""
        if not self.enabled:
            return False
        now = self._clock() if now is None else now
        if self._last_eval is not None and \
                now - self._last_eval < self.cfg.eval_interval_s:
            return False
        self.evaluate(now)
        return True

    def evaluate(self, now: Optional[float] = None) -> List[str]:
        """Unconditional evaluation pass: drain new ring events,
        classify triggers, run detectors and probes; capture bundles
        for surviving trips.  Returns the classes captured."""
        if not self.enabled:
            return []
        now = self._clock() if now is None else now
        self._last_eval = now
        trips: List[Tuple[str, Dict[str, Any]]] = []
        shed_seen = 0
        recorder = (self.tracer.recorder
                    if self.tracer is not None and self.tracer.enabled
                    else None)
        if recorder is not None:
            self._ring_cursor, fresh = recorder.events_since(
                self._ring_cursor)
            for e in fresh:
                cls = TRIGGER_PHASES.get(e[3])
                if cls is not None:
                    trips.append((cls, {"trigger": event_to_dict(e)}))
                elif e[3] == "request_shed":
                    shed_seen += 1
        if self.cfg.shed_storm_threshold and \
                shed_seen >= self.cfg.shed_storm_threshold:
            trips.append(("shed_storm", {"trigger": {
                "phase": "request_shed",
                "sheds_in_window": shed_seen}}))
        trips.extend(self._run_detectors())
        for probe in self._probes:
            try:
                got = probe()
            except Exception:
                got = None          # a broken probe never kills the tick
            if got is not None:
                cls, attrs = got
                trips.append((str(cls), {"trigger": dict(attrs)}))
        captured: List[str] = []
        for cls, info in trips:
            if self._capture(cls, info, now):
                captured.append(cls)
        return captured

    def _run_detectors(self) -> List[Tuple[str, Dict[str, Any]]]:
        """EWMA z-score over the configured history series: trip when
        the latest sample sits past ``z_threshold`` standard deviations
        from the running mean (two-sided — a goodput COLLAPSE is a
        negative excursion) after ``min_samples`` of warmup, AND the
        excursion sustains :data:`_DETECTOR_CONSECUTIVE` consecutive
        evaluations — a single bucket-quantized percentile jump is
        jitter, a held excursion is a regime change.  The std carries a
        relative floor so a near-constant warmup cannot make any
        ordinary fluctuation read as infinite z."""
        out: List[Tuple[str, Dict[str, Any]]] = []
        h = self.history
        if h is None or not getattr(h, "enabled", False):
            return out
        a = self.cfg.ewma_alpha
        for name, st in self._detect.items():
            pt = h.latest_point(name)
            if pt is None:
                continue
            t, x = pt
            if st[4] is not None and t <= st[4]:
                continue       # no NEW sample since the last judgment
            st[4] = t
            mean, var, n, streak = st[:4]
            if n >= self.cfg.min_samples:
                std = max(math.sqrt(max(var, 0.0)),
                          0.02 * abs(mean), 1e-9)
                z = (x - mean) / std
                if abs(z) >= self.cfg.z_threshold:
                    st[3] = streak + 1
                    if st[3] >= _DETECTOR_CONSECUTIVE:
                        st[3] = 0
                        self._c_detector.inc()
                        self._n_detector += 1
                        out.append((f"anomaly_{_slug(name)}",
                                    {"trigger": {
                                        "detector": name,
                                        "value": round(x, 6),
                                        "z": round(z, 3),
                                        "mean": round(mean, 6),
                                        "std": round(std, 6)}}))
                    # the excursion must not poison the baseline the
                    # next samples are judged against
                    continue
                st[3] = 0
            d = x - mean
            st[0] = mean + a * d
            st[1] = (1.0 - a) * (var + a * d * d)
            st[2] = n + 1
        return out

    # ------------------------------------------------------------ capture
    def _capture(self, cls: str, info: Dict[str, Any],
                 now: float) -> bool:
        last = self._last_trip.get(cls)
        if last is not None and now - last < self.cfg.dedup_window_s:
            self._c_suppressed.inc()
            self._n_suppressed += 1
            return False
        if len(self.bundles) >= self.cfg.max_bundles:
            self._c_suppressed.inc()
            self._n_suppressed += 1
            return False
        self._last_trip[cls] = now
        self._seq += 1
        bundle: Dict[str, Any] = {
            "schema_version": 1,
            "incident": cls,
            "source": self.source,
            "seq": self._seq,
            "t": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "t0_monotonic": round(now, 3),
            "pre_window_s": self.cfg.pre_window_s,
            **info,
        }
        h = self.history
        if h is not None and getattr(h, "enabled", False):
            bundle["history"] = h.snapshot(
                now=now, window_s=self.cfg.pre_window_s)
        recorder = (self.tracer.recorder
                    if self.tracer is not None and self.tracer.enabled
                    else None)
        if recorder is not None:
            bundle["ring"] = [event_to_dict(e) for e in
                              recorder.tail(self.cfg.ring_events)]
        if self.statusz_fn is not None:
            try:
                bundle["statusz"] = self.statusz_fn()
            except Exception as e:     # a broken snapshot must not
                bundle["statusz"] = {"error": repr(e)}  # lose the bundle
        for aname, afn in self._attachments.items():
            try:
                bundle[aname] = afn()
            except Exception as e:     # same contract as statusz_fn
                bundle[aname] = {"error": repr(e)}
        # source is part of the name: _seq is per-MANAGER, and a fleet-
        # level manager plus replica engine-level managers can share
        # one dir — without it their same-class bundles would collide
        # on (class, pid, seq) and atomic_write_json would overwrite
        path = os.path.join(
            self.cfg.dir,
            f"incident_{_slug(self.source)}_{_slug(cls)}_"
            f"{os.getpid()}_{self._seq}.json")
        try:
            os.makedirs(self.cfg.dir, exist_ok=True)
            atomic_write_json(bundle, path)
        except OSError:
            from deepspeed_tpu_torch.utils.logging import logger

            logger.exception("incidents: bundle write to %s", path)
            path = None
        self.bundles.append({
            "incident": cls, "seq": self._seq, "t": bundle["t"],
            "t0_monotonic": bundle["t0_monotonic"], "path": path,
        })
        self._c_bundles.inc()
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event("incident_bundle", attrs={
                "incident": cls, "seq": self._seq, "path": path})
        return True

    # ------------------------------------------------------------- read
    def snapshot(self) -> Dict[str, Any]:
        """The ``/statusz``/``/historyz`` ``incidents`` block + the
        dstpu_top ticker feed: bundle/suppression totals and recent
        bundle metadata (never bundle contents — those live on disk)."""
        if not self.enabled:
            return {"enabled": False}
        return {
            "enabled": True,
            "dir": self.cfg.dir,
            "bundles": len(self.bundles),
            "suppressed": self._n_suppressed,
            "detector_trips": self._n_detector,
            "detect_series": sorted(self._detect),
            "recent": list(self.bundles)[-8:],
        }


def _slug(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_"
                   for c in name)


class _NullIncidentManager:
    """Shared no-op stand-in when the block is off."""

    enabled = False
    bundles: List[Dict[str, Any]] = []

    def watch_series(self, name):
        pass

    def add_probe(self, fn):
        pass

    def add_attachment(self, name, fn):
        pass

    def maybe_evaluate(self, now=None):
        return False

    def evaluate(self, now=None):
        return []

    def snapshot(self):
        return {"enabled": False}


NULL_INCIDENTS = _NullIncidentManager()
