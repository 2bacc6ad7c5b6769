"""Time-series metric history: multi-resolution ring buffers over the
telemetry registry — the retained-trajectory half of the black-box
flight recorder (port of ``deepspeed_tpu/history.py``).

Every observability surface before this one answers "what is happening
NOW": the registry holds cumulative counters and last-value
gauges, ``/statusz`` is a point-in-time snapshot, and the flight
recorder keeps events but not metric values.  The elastic,
disaggregated fleet fails as *trajectories* — a burn trip is preceded
by 30 s of rising queue depth, a kv-tier breaker trip by a climbing
checksum-failure rate — and ZeRO-Infinity-style tiered streaming
(arXiv:2104.07857) makes stall/bandwidth pathologies develop over
seconds, invisible to any point-in-time gauge.

:class:`MetricHistory` samples the registry on the
:class:`~deepspeed_tpu_torch.telemetry.TelemetryExporter` tick (via
``register_tick_hook`` — never the decode hot path) into fixed-memory
rings, one per configured resolution (default 1 s × 120 and
10 s × 360):

- **counters → rates**: per-tick delta / elapsed; a counter RESET
  (value below the last observation — a swapped registry, a restarted
  subsystem) contributes the post-reset value rather than a huge
  negative spike;
- **gauges → last value**;
- **histograms → p50/p95** of the samples landed since the previous
  tick (``<name>:p50`` / ``<name>:p95`` series), estimated from the
  Prometheus bucket-count deltas; a tick with no new observations
  records a gap, not a zero.

Coarser rings aggregate the fine samples per bucket — mean for
rate/gauge series, max for percentile series (the conservative reading
for an alarm surface).  :meth:`MetricHistory.annotate` drops labeled
marks (autoscaler scale/rollout events) onto the same timeline, and
:func:`history_rollup` merges per-replica snapshots into one fleet
view the way :func:`~deepspeed_tpu_torch.slo.fleet_rollup` does for SLO
state: rate and gauge series SUM per aligned bucket, percentile series
take the MAX across replicas.

Surfaces: ``/historyz`` on the telemetry HTTP server, ``dstpu_top``
sparklines, and the pre-trip windows captured into incident bundles by
:mod:`deepspeed_tpu_torch.incidents`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.config import HistoryConfig

# series-kind tags: how samples aggregate into coarser buckets and how
# the fleet rollup merges them across replicas
RATE = "rate"          # counter delta/dt   (mean per bucket, sum fleet)
GAUGE = "gauge"        # last value         (mean per bucket, sum fleet)
PCT = "pct"            # histogram p50/p95  (max per bucket, max fleet)


class _Ring:
    """One fixed-capacity resolution ring for one series.

    Slot ``i`` holds the aggregate of every sample whose bucket index
    (``int(t / period)``) maps to ``i = bucket % capacity``; stale
    slots (lapped by the ring) are detected by their stored bucket
    index, so an idle series never replays ancient values."""

    __slots__ = ("period", "capacity", "buckets", "values",
                 "_acc_bucket", "_acc_sum", "_acc_n", "_acc_max")

    def __init__(self, period: float, capacity: int):
        self.period = float(period)
        self.capacity = int(capacity)
        # None = never-written slot: an int sentinel would collide
        # with a genuine bucket index when a window reaches past t=0
        self.buckets: List[Optional[int]] = [None] * self.capacity
        self.values: List[float] = [0.0] * self.capacity
        self._acc_bucket: Optional[int] = None
        self._acc_sum = 0.0
        self._acc_n = 0
        self._acc_max = 0.0

    def record(self, now: float, value: float, kind: str) -> None:
        b = int(now / self.period)
        if b != self._acc_bucket:
            self._flush()
            self._acc_bucket = b
        self._acc_sum += value
        self._acc_n += 1
        if self._acc_n == 1 or value > self._acc_max:
            self._acc_max = value
        # publish the in-progress aggregate immediately: a reader never
        # waits a full coarse period to see the current bucket
        i = b % self.capacity
        self.buckets[i] = b
        self.values[i] = (self._acc_max if kind == PCT
                          else self._acc_sum / self._acc_n)

    def _flush(self) -> None:
        self._acc_sum = 0.0
        self._acc_n = 0
        self._acc_max = 0.0

    def window(self, now: float, seconds: float
               ) -> List[Tuple[float, float]]:
        """(bucket start time, value) pairs inside the trailing
        window, oldest first."""
        lo = int((now - seconds) / self.period)
        hi = int(now / self.period)
        out: List[Tuple[float, float]] = []
        for b in range(max(lo, hi - self.capacity + 1), hi + 1):
            i = b % self.capacity
            if self.buckets[i] == b:
                out.append((b * self.period, self.values[i]))
        return out

    def snapshot(self, now: float) -> Dict[str, Any]:
        return {
            "period_s": self.period,
            "capacity": self.capacity,
            "points": [[round(t, 3), _round(v)] for t, v in
                       self.window(now, self.period * self.capacity)],
        }


def _round(v: float) -> float:
    return round(float(v), 6)


def _percentile_from_buckets(deltas: List[Tuple[float, int]],
                             q: float) -> Optional[float]:
    """Estimate the q-quantile from cumulative ``(le, count)`` DELTAS
    (already de-cumulated to per-bucket counts by the caller).  Returns
    the bucket upper bound holding the quantile — the standard
    Prometheus histogram_quantile reading, biased at most one bucket
    high."""
    total = sum(c for _, c in deltas)
    if total <= 0:
        return None
    target = q * total
    acc = 0
    finite = [b for b, _ in deltas if b != float("inf")]
    top = finite[-1] if finite else None
    for le, c in deltas:
        acc += c
        if acc >= target:
            # a quantile landing in the +Inf overflow bucket clamps to
            # the highest FINITE bound: an inf sample would poison the
            # EWMA detector baseline and break strict-JSON consumers
            # of /historyz and the incident bundles
            return le if le != float("inf") else top
    return top


class MetricHistory:
    """Fixed-memory multi-resolution history over a
    :class:`~deepspeed_tpu_torch.telemetry.MetricsRegistry`.

    ``maybe_sample`` is the tick entry point (rate-limited internally
    to ``sample_interval_s``, so exporter hooks and manual drivers can
    both call it freely); ``snapshot`` renders the ``/historyz``
    document; ``window``/``latest`` serve the incident engine's
    pre-trip capture and EWMA detectors; ``annotate`` drops labeled
    marks (scale/rollout events) onto the timeline.  All public
    methods are thread-safe — the HTTP thread snapshots while the
    engine thread samples."""

    def __init__(self, cfg: HistoryConfig, registry, *,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.enabled = bool(cfg.enabled) and registry.enabled
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        # per-series ring sets + per-metric last raw observations
        self._series: "Dict[str, Dict[str, Any]]" = {}   # name -> rec
        self._last_counters: Dict[str, float] = {}
        self._last_hist: Dict[str, Dict[float, int]] = {}
        self.annotations: List[Dict[str, Any]] = []
        self._filter = (set(cfg.metrics) if cfg.metrics is not None
                        else None)
        r = registry
        self._c_samples = r.counter(
            "history_samples_total",
            "history sampling ticks taken (exporter-tick cadence — "
            "never the decode hot path)")
        self._c_annotations = r.counter(
            "history_annotations_total",
            "labeled marks (scale/rollout events) dropped onto the "
            "history timeline")
        self._g_series = r.gauge(
            "history_series_tracked",
            "distinct series with live rings (bounded by "
            "history.max_series)")

    # ------------------------------------------------------------ series
    def _rec(self, name: str, kind: str) -> Optional[Dict[str, Any]]:
        rec = self._series.get(name)
        if rec is None:
            if len(self._series) >= self.cfg.max_series:
                return None              # bounded memory: drop, never grow
            # "t" = the series' last RECORD time (not bucket time):
            # the incident detectors gate on it to judge once per new
            # sample even when several samples land in one fine bucket
            rec = {"kind": kind, "t": None,
                   "rings": [_Ring(p, n) for p, n in self.cfg.rings]}
            self._series[name] = rec
            self._g_series.set(len(self._series))
        return rec

    def _record(self, name: str, kind: str, now: float,
                value: float) -> None:
        rec = self._rec(name, kind)
        if rec is None:
            return
        rec["t"] = now
        for ring in rec["rings"]:
            ring.record(now, value, kind)

    def _tracked(self, name: str) -> bool:
        return self._filter is None or name in self._filter

    # ------------------------------------------------------------ sample
    # dstpu: hot-path
    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """One history tick if ``sample_interval_s`` elapsed; safe to
        call every scheduler step (one clock compare until due)."""
        if not self.enabled:
            return False
        now = self._clock() if now is None else now
        if self._last_t is not None and \
                now - self._last_t < self.cfg.sample_interval_s:
            return False
        self.sample(now)
        return True

    def sample(self, now: Optional[float] = None) -> None:
        """Unconditional sampling pass: counters as rates, gauges as
        last value, histograms as p50/p95 of the tick's delta."""
        if not self.enabled:
            return
        now = self._clock() if now is None else now
        snap = self.registry.snapshot()
        with self._lock:
            dt = (now - self._last_t) if self._last_t is not None \
                else None
            self._last_t = now
            for name, v in snap.get("counters", {}).items():
                if not self._tracked(name):
                    continue
                last = self._last_counters.get(name)
                self._last_counters[name] = v
                if last is None or dt is None or dt <= 0:
                    continue
                # reset tolerance: a counter that went BACKWARDS was
                # restarted — the post-reset value is the true delta
                delta = v - last if v >= last else v
                self._record(f"{name}:rate", RATE, now, delta / dt)
            for name, v in snap.get("gauges", {}).items():
                if not self._tracked(name):
                    continue
                self._record(name, GAUGE, now, float(v))
            for name, h in snap.get("histograms", {}).items():
                if not self._tracked(name):
                    continue
                cum = {float(le) if le != "+Inf" else float("inf"): c
                       for le, c in h.get("buckets", {}).items()}
                last = self._last_hist.get(name, {})
                self._last_hist[name] = cum
                if not last and dt is None:
                    # first observation: no delta window yet
                    continue
                # de-cumulate, then delta against the previous tick
                # (cumulative "le" buckets subtract cleanly)
                deltas = []
                prev_new = prev_old = 0
                for le in sorted(cum):
                    d_new = cum[le] - prev_new
                    d_old = last.get(le, 0) - prev_old
                    prev_new, prev_old = cum[le], last.get(le, 0)
                    deltas.append((le, max(d_new - d_old, 0)))
                p50 = _percentile_from_buckets(deltas, 0.50)
                p95 = _percentile_from_buckets(deltas, 0.95)
                if p50 is not None:
                    self._record(f"{name}:p50", PCT, now, p50)
                if p95 is not None:
                    self._record(f"{name}:p95", PCT, now, p95)
        self._c_samples.inc()

    # -------------------------------------------------------- annotate
    def annotate(self, label: str,
                 attrs: Optional[Dict[str, Any]] = None,
                 now: Optional[float] = None) -> None:
        """Drop a labeled mark (scale event, rollout step, operator
        action) onto the history timeline; bounded ring."""
        if not self.enabled:
            return
        now = self._clock() if now is None else now
        with self._lock:
            self.annotations.append(
                {"t": round(now, 3), "label": str(label),
                 **({"attrs": dict(attrs)} if attrs else {})})
            if len(self.annotations) > self.cfg.max_annotations:
                del self.annotations[:len(self.annotations)
                                     - self.cfg.max_annotations]
        self._c_annotations.inc()

    # ------------------------------------------------------------- read
    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def latest(self, name: str) -> Optional[float]:
        """Most recent fine-ring value of one series (detector food)."""
        pt = self.latest_point(name)
        return pt[1] if pt is not None else None

    def latest_point(self, name: str) -> Optional[Tuple[float, float]]:
        """Most recent ``(sample_time, value)`` of one series — the
        SAMPLE time (not the bucket time: several samples can land in
        one fine bucket) lets the incident detectors advance once per
        NEW sample instead of once per evaluation tick, judging the
        bucket's current aggregate each time."""
        with self._lock:
            rec = self._series.get(name)
            if rec is None or rec["t"] is None:
                return None
            ring = rec["rings"][0]
            pts = ring.window(rec["t"], ring.period)
            return (rec["t"], pts[-1][1]) if pts else None

    def window(self, name: str, seconds: float,
               now: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Trailing ``seconds`` of one series from the finest ring
        whose span covers the window (falling back to the coarsest)."""
        now = self._clock() if now is None else now
        with self._lock:
            rec = self._series.get(name)
            if rec is None:
                return []
            for ring in rec["rings"]:
                if ring.period * ring.capacity >= seconds:
                    return ring.window(now, seconds)
            return rec["rings"][-1].window(now, seconds)

    def snapshot(self, now: Optional[float] = None,
                 series: Optional[List[str]] = None,
                 window_s: Optional[float] = None) -> Dict[str, Any]:
        """The ``/historyz`` document: every ring of every (selected)
        series plus annotations.  ``window_s`` trims each ring's points
        to a trailing window (the incident bundle's pre-trip capture)."""
        if not self.enabled:
            return {"enabled": False}
        now = self._clock() if now is None else now
        out_series: Dict[str, Any] = {}
        with self._lock:
            names = series if series is not None else sorted(self._series)
            for name in names:
                rec = self._series.get(name)
                if rec is None:
                    continue
                rings = []
                for ring in rec["rings"]:
                    snap = ring.snapshot(now)
                    if window_s is not None:
                        snap["points"] = [
                            [t, v] for t, v in snap["points"]
                            if t >= now - window_s]
                    rings.append(snap)
                out_series[name] = {"kind": rec["kind"], "rings": rings}
            anns = list(self.annotations)
        if window_s is not None:
            anns = [a for a in anns if a["t"] >= now - window_s]
        return {
            "enabled": True,
            "t_monotonic": round(now, 3),
            "sample_interval_s": self.cfg.sample_interval_s,
            "rings": [{"period_s": p, "capacity": n}
                      for p, n in self.cfg.rings],
            "samples": int(self._c_samples.value),
            "series": out_series,
            "annotations": anns,
        }


class _NullHistory:
    """Shared no-op stand-in when the block is off: every hook is one
    early return, mirroring telemetry's null metrics."""

    enabled = False

    def maybe_sample(self, now=None):
        return False

    def sample(self, now=None):
        pass

    def annotate(self, label, attrs=None, now=None):
        pass

    def series_names(self):
        return []

    def latest(self, name):
        return None

    def window(self, name, seconds, now=None):
        return []

    def snapshot(self, now=None, series=None, window_s=None):
        return {"enabled": False}


NULL_HISTORY = _NullHistory()


# ------------------------------------------------------------- rollup
def history_rollup(snapshots) -> Dict[str, Any]:
    """Aggregate per-replica :meth:`MetricHistory.snapshot` documents
    into one fleet view, the way :func:`~deepspeed_tpu_torch.slo.
    fleet_rollup` merges SLO snapshots: per series and ring, values SUM
    per aligned bucket for rate/gauge series (fleet queue depth is the
    sum of replica queue depths) and take the MAX for percentile
    series (the alert question is "how bad is the worst replica").
    Disabled snapshots pass through; annotations concatenate in time
    order.

    Snapshots need not come from in-process objects: the scrape plane
    (:mod:`deepspeed_tpu_torch.obs_wire`) feeds this the ``history`` block
    of a remote replica's ``/historyz`` document — same shape over the
    wire, and a never-scraped remote's ``None`` filters out here like
    a disabled ring set."""
    snaps = [s for s in snapshots if s and s.get("enabled")]
    if not snaps:
        return {"enabled": False}
    series: Dict[str, Any] = {}
    for s in snaps:
        for name, rec in s.get("series", {}).items():
            agg = series.get(name)
            if agg is None:
                agg = series[name] = {
                    "kind": rec["kind"],
                    "rings": [{"period_s": r["period_s"],
                               "capacity": r["capacity"],
                               "points": {}}
                              for r in rec["rings"]],
                }
            for ri, r in enumerate(rec["rings"]):
                if ri >= len(agg["rings"]):
                    continue
                pts = agg["rings"][ri]["points"]
                for t, v in r["points"]:
                    if rec["kind"] == PCT:
                        pts[t] = max(pts.get(t, v), v)
                    else:
                        pts[t] = pts.get(t, 0.0) + v
    for rec in series.values():
        for r in rec["rings"]:
            r["points"] = [[t, _round(v)]
                           for t, v in sorted(r["points"].items())]
    anns = sorted((a for s in snaps
                   for a in s.get("annotations", [])),
                  key=lambda a: a.get("t", 0.0))
    return {
        "enabled": True,
        "replicas": len(snaps),
        "rings": snaps[0].get("rings", []),
        "series": series,
        "annotations": anns,
    }
