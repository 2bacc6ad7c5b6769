"""Observability over the wire (port of ``deepspeed_tpu/obs_wire.py``;
no reference analogue): the scrape plane under the out-of-process fleet.

Every in-process observability surface — ``fleet_rollup``,
``history_rollup``, :meth:`TelemetryExporter.add_source`, the shared
:class:`~deepspeed_tpu_torch.request_trace.FlightRecorder`, the
:class:`~deepspeed_tpu_torch.incidents.IncidentManager` — historically held a
Python reference to the replica it observed.  A process split severs
every one of those references at once, so this module rebuilds the
spine over the ``/statusz``-shaped HTTP surface each engine already
exposes:

- **Versioned wire schema** — :func:`wire_stamp` adds
  ``wire_schema`` + wall/monotonic timestamps to every route document,
  :func:`check_wire_schema` rejects a major mismatch loudly
  (:class:`WireSchemaError`), and :func:`tracez_provider` serves the
  new ``/tracez?since=`` route: an incremental flight-recorder drain
  built on :meth:`FlightRecorder.events_since`, so a remote poller
  re-reads nothing it has already fetched.
- **:class:`RemoteReplica`** — a per-replica scrape client with
  timeout/retry/backoff (:func:`~deepspeed_tpu_torch.faults.retry_with_backoff`
  around every fetch, a ``scrape`` fault-injection point keyed by
  replica id), a FRESH→STALE→LOST staleness state machine with
  hysteresis (``fresh_after`` consecutive good scrapes to recover),
  and last-known-snapshot retention so a SIGKILLed child still renders
  in the fleet statusz — flagged LOST, never silently absent.
- **Cross-process trace correlation** — :meth:`RemoteReplica.
  estimate_clock_offset` runs an RTT-based min-RTT probe against the
  remote's monotonic clock (offset error bounded by min-RTT/2, the
  bound recorded into the merged trace meta), and
  :func:`merge_trace_segments` applies per-segment offsets when
  folding ``/tracez`` drains from many processes into one Chrome
  trace with request spans stitched across replica tags.
- **ReplicaSource contract** — the duck-typed surface
  (``statusz_row`` / ``slo_snapshot`` / ``history_snapshot`` /
  ``poll_health``) implemented by both the in-process
  :class:`~deepspeed_tpu_torch.fleet.Replica` and :class:`RemoteReplica`,
  so the router's rollups aggregate either transparently.

Nothing here imports torch: the wire plane is pure stdlib
(``urllib`` + ``json``) and must keep working when the model side of
a replica is wedged.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch import faults
from deepspeed_tpu_torch.config import ObsWireConfig
from deepspeed_tpu_torch.request_trace import (Event, event_to_dict,
                                         events_from_dicts,
                                         events_to_chrome)

# Major bumps on breaking shape changes (field removed/renamed, route
# semantics changed); minor bumps on additive fields.  A scraper built
# against major N must refuse documents from major M != N — silently
# mis-parsing a foreign schema is how fleets go dark politely.
OBS_WIRE_SCHEMA = (1, 0)
OBS_WIRE_SCHEMA_STR = ".".join(str(x) for x in OBS_WIRE_SCHEMA)

# Staleness states (strings on purpose: they travel through JSON).
FRESH = "FRESH"
STALE = "STALE"
LOST = "LOST"


class WireSchemaError(RuntimeError):
    """A scraped document's ``wire_schema`` major does not match this
    process (or the stamp is missing entirely).  Deliberately NOT an
    OSError: retry/backoff must not paper over a contract break."""


# ---------------------------------------------------------------- schema
def wire_stamp() -> Dict[str, Any]:
    """The fields every wire-served route document carries: schema
    version plus paired wall/monotonic timestamps (wall for humans and
    cross-host joins, monotonic for offset estimation and staleness
    arithmetic — never mix the two)."""
    return {"wire_schema": OBS_WIRE_SCHEMA_STR,
            "t_wall": time.time(),
            "t_mono_ns": time.monotonic_ns()}


def check_wire_schema(doc: Any, route: str = "?") -> Tuple[int, int]:
    """Validate a scraped document's stamp; returns ``(major, minor)``.

    Raises :class:`WireSchemaError` on a missing stamp or a major
    mismatch.  A minor ahead of ours is fine (additive fields); a
    minor behind is fine too (we tolerate absent additions).
    """
    if not isinstance(doc, dict) or "wire_schema" not in doc:
        raise WireSchemaError(
            f"{route}: document carries no wire_schema stamp — remote "
            "predates the wire plane or is not a deepspeed_tpu_torch replica")
    raw = str(doc["wire_schema"])
    try:
        major, minor = (int(x) for x in raw.split(".", 1))
    except ValueError:
        raise WireSchemaError(
            f"{route}: malformed wire_schema {raw!r}") from None
    if major != OBS_WIRE_SCHEMA[0]:
        raise WireSchemaError(
            f"{route}: wire_schema major mismatch — remote speaks "
            f"{raw}, this process speaks {OBS_WIRE_SCHEMA_STR}; "
            "refusing to mis-parse a foreign schema")
    return major, minor


def tracez_provider(recorder, replica: Optional[str] = None):
    """Build the ``tracez`` introspection provider for an exporter.

    The returned callable takes the raw ``?since=`` query value and
    serves one incremental segment: events with sequence index >=
    ``since`` (via :meth:`FlightRecorder.events_since` — the lock is
    held only for the returned slots) plus the new cursor, so a
    steady-state poll ships only the delta.
    """
    def provider(since: Optional[str]) -> Dict[str, Any]:
        try:
            cursor = int(since) if since else 0
        except ValueError:
            cursor = 0
        total, events = recorder.events_since(max(cursor, 0))
        doc = wire_stamp()
        doc.update({
            "since": max(cursor, 0),
            "total": total,                      # the next ?since=
            "dropped": recorder.dropped,
            "events": [event_to_dict(e) for e in events],
        })
        if replica is not None:
            doc["replica"] = replica
        return doc
    return provider


# ---------------------------------------------------------------- client
def http_get_json(url: str, timeout_s: float) -> Dict[str, Any]:
    """One JSON GET with a hard timeout.  Raises OSError-family on
    transport trouble (what retry_with_backoff retries) and ValueError
    on non-JSON bodies."""
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        body = resp.read()
    return json.loads(body.decode("utf-8"))


def http_get_text(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8")


class RemoteReplica:
    """Scrape client for one out-of-process replica.

    Implements the ReplicaSource contract from last-known snapshots:
    ``statusz_row``/``slo_snapshot``/``history_snapshot`` read the most
    recent successful scrape, so a dead child keeps rendering (flagged
    by ``scrape_state``) instead of vanishing from the rollups.

    The staleness machine is age-based with recovery hysteresis:

    - success: ``ok_streak`` grows; entering FRESH (from attach or
      after an outage) requires ``fresh_after`` consecutive good
      scrapes; once FRESH, one recent ok keeps it.
    - failure / silence: once ``now - last_ok`` passes
      ``stale_after_s`` the state reads STALE, past ``lost_after_s``
      it reads LOST.  Transitions into LOST emit a ``remote_lost``
      trace event (an incident trigger) on the tracer, once per
      outage.

    Thread-safety: ``poll``/``fetch_trace`` are expected from one
    poller thread; the read-side accessors snapshot under a lock so
    HTTP statusz threads see consistent state.
    """

    def __init__(self, url: str, rid: str,
                 cfg: Optional[ObsWireConfig] = None,
                 registry=None, tracer=None,
                 clock=time.monotonic) -> None:
        self.url = url.rstrip("/")
        self.id = rid
        self.cfg = ObsWireConfig.coerce(cfg if cfg is not None else True)
        self.tracer = tracer
        self._clock = clock
        self._lock = threading.Lock()
        self.state = STALE            # nothing known yet: not FRESH,
        self.ok_streak = 0            # not LOST either
        self.last_ok: Optional[float] = None
        self.last_error: Optional[str] = None
        self.scrapes = 0
        self.scrape_errors = 0
        self.last_latency_s = 0.0
        self.last_statusz: Optional[Dict[str, Any]] = None
        self.last_healthz: Optional[Dict[str, Any]] = None
        self.last_historyz: Optional[Dict[str, Any]] = None
        self.trace_cursor = 0
        self._last_attempt: Optional[float] = None
        self.clock_offset_ns: Optional[int] = None
        self.clock_offset_err_ns: Optional[int] = None
        self.closed = False
        if registry is not None:
            self._m_scrapes = registry.counter(
                "obswire_scrapes",
                "remote statusz scrapes attempted")
            self._m_errors = registry.counter(
                "obswire_scrape_errors",
                "remote scrapes that failed after retries")
            self._m_latency = registry.histogram(
                "obswire_scrape_latency_seconds",
                "wall time of one successful scrape cycle")
            self._m_lost = registry.counter(
                "obswire_remote_lost_transitions",
                "transitions into scrape state LOST (one per outage)")
        else:
            from deepspeed_tpu_torch.telemetry import NULL_METRIC
            self._m_scrapes = NULL_METRIC
            self._m_errors = NULL_METRIC
            self._m_latency = NULL_METRIC
            self._m_lost = NULL_METRIC

    # -------------------------------------------------------- transport
    def _get(self, route: str, query: str = "") -> Dict[str, Any]:
        """One schema-checked JSON fetch with the scrape fault hook,
        retry/backoff, and the hard per-request timeout."""
        url = f"{self.url}{route}" + (f"?{query}" if query else "")
        cfg = self.cfg

        def fetch() -> Dict[str, Any]:
            # injected latency is capped at the request budget so a
            # fault rule can slow the loop but never wedge it
            delay, err = faults.poll("scrape", self.id)
            if delay:
                time.sleep(min(delay, cfg.timeout_s))
            if err is not None:
                raise faults.InjectedFault(
                    f"injected scrape fault (key={self.id!r})")
            doc = http_get_json(url, cfg.timeout_s)
            check_wire_schema(doc, route)
            return doc

        return faults.retry_with_backoff(
            fetch, attempts=max(cfg.retries - 1, 0),
            backoff_s=cfg.backoff_s)

    # ------------------------------------------------------------- poll
    def maybe_poll(self, now: Optional[float] = None
                   ) -> Optional[bool]:
        """Scrape if ``poll_interval_s`` has elapsed since the last
        attempt (the router calls this every step; pacing lives here so
        callers need no timers).  Between due polls the staleness state
        still advances.  Returns poll()'s result, or None if not due."""
        now = self._clock() if now is None else now
        if self._last_attempt is not None and \
                now - self._last_attempt < self.cfg.poll_interval_s:
            self.refresh_state(now)
            return None
        return self.poll(now)

    def poll(self, now: Optional[float] = None) -> bool:
        """One scrape cycle: statusz + healthz + historyz.  Returns
        True on success.  Transport failures (timeouts, refused
        connections, injected ``scrape`` faults) are absorbed into the
        staleness machine — the poll loop never raises for a dead
        remote.  :class:`WireSchemaError` DOES propagate: a schema
        break is a deployment bug, not an outage."""
        now = self._clock() if now is None else now
        self._last_attempt = now
        t0 = time.monotonic()
        self._m_scrapes.inc()
        self.scrapes += 1
        try:
            statusz = self._get("/statusz")
            healthz = self._get("/healthz")
            historyz = None
            try:
                historyz = self._get("/historyz")
            except (OSError, ValueError):
                pass        # route optional: history may be disabled
        except WireSchemaError:
            self._m_errors.inc()
            self.scrape_errors += 1
            raise
        except (OSError, ValueError) as e:
            self._m_errors.inc()
            with self._lock:
                self.scrape_errors += 1
                self.last_error = repr(e)
                self.ok_streak = 0
            self.refresh_state(now)
            return False
        self.last_latency_s = time.monotonic() - t0
        self._m_latency.observe(self.last_latency_s)
        with self._lock:
            self.last_statusz = statusz
            self.last_healthz = healthz
            if historyz is not None:
                self.last_historyz = historyz
            self.last_ok = now
            self.last_error = None
            self.ok_streak += 1
        self.refresh_state(now)
        return True

    def refresh_state(self, now: Optional[float] = None) -> str:
        """Age-based state transitions (also called WITHOUT a scrape,
        so statusz readers see staleness advance between polls)."""
        now = self._clock() if now is None else now
        with self._lock:
            age = (now - self.last_ok) if self.last_ok is not None \
                else float("inf")
            prev = self.state
            if age >= self.cfg.lost_after_s:
                nxt = LOST
            elif age >= self.cfg.stale_after_s:
                nxt = STALE
            elif self.ok_streak >= self.cfg.fresh_after or \
                    (prev == FRESH and self.ok_streak > 0):
                nxt = FRESH
            else:
                # LOST (and a just-attached STALE) exits only through
                # the ok_streak gate above — the re-entry hysteresis
                nxt = prev
            self.state = nxt
        if nxt == LOST and prev != LOST:
            self._m_lost.inc()
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.event(
                    "remote_lost", req=None,
                    attrs={"replica": self.id, "url": self.url,
                           "age_s": round(age, 3)})
        return nxt

    def force_lost(self, reason: str) -> None:
        """Pin the state LOST out-of-band (the router uses this for a
        schema-incompatible remote: not an outage, but no data we can
        trust either).  Last-known snapshots are retained."""
        with self._lock:
            prev = self.state
            self.state = LOST
            self.last_error = reason
            self.ok_streak = 0
        if prev != LOST:
            self._m_lost.inc()
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.event(
                    "remote_lost", req=None,
                    attrs={"replica": self.id, "url": self.url,
                           "reason": reason})

    def age_s(self, now: Optional[float] = None) -> Optional[float]:
        now = self._clock() if now is None else now
        with self._lock:
            return None if self.last_ok is None else now - self.last_ok

    def fetch_metrics(self) -> Dict[str, Any]:
        """One ``/metrics`` scrape, parsed back through
        :func:`~deepspeed_tpu_torch.telemetry.parse_prometheus_text`.  The
        text exposition carries no JSON stamp (Prometheus grammar has
        nowhere to put one) — schema enforcement rides the JSON routes
        polled by the same client against the same server.  On-demand
        only: :meth:`poll` deliberately skips it (the statusz document
        already embeds the registry snapshot)."""
        from deepspeed_tpu_torch.telemetry import parse_prometheus_text
        cfg = self.cfg

        def fetch() -> str:
            delay, err = faults.poll("scrape", self.id)
            if delay:
                time.sleep(min(delay, cfg.timeout_s))
            if err is not None:
                raise faults.InjectedFault(
                    f"injected scrape fault (key={self.id!r})")
            return http_get_text(f"{self.url}/metrics", cfg.timeout_s)

        text = faults.retry_with_backoff(
            fetch, attempts=max(cfg.retries - 1, 0),
            backoff_s=cfg.backoff_s)
        return parse_prometheus_text(text)

    # ----------------------------------------------------- trace drain
    def fetch_trace(self, since: Optional[int] = None
                    ) -> Tuple[List[Event], Dict[str, Any]]:
        """Drain one incremental ``/tracez`` segment.  Advances the
        stored cursor (pass ``since`` to override, e.g. 0 for a full
        re-read) and returns ``(events, meta)`` where meta carries the
        remote's stamp + cursor/drop accounting."""
        cursor = self.trace_cursor if since is None else since
        doc = self._get("/tracez", f"since={cursor}")
        events = events_from_dicts(doc.get("events", []))
        self.trace_cursor = int(doc.get("total", cursor))
        meta = {k: doc.get(k) for k in
                ("wire_schema", "t_wall", "t_mono_ns", "since",
                 "total", "dropped", "replica")}
        return events, meta

    # ------------------------------------------------- clock correlation
    def estimate_clock_offset(self, probes: Optional[int] = None
                              ) -> Tuple[int, int]:
        """Min-RTT estimate of ``remote_monotonic - local_monotonic``.

        Each probe brackets one ``/healthz`` fetch with local
        ``monotonic_ns`` reads; the remote's ``t_mono_ns`` stamp is
        assumed taken at the bracket midpoint, so the sample error is
        bounded by RTT/2.  Keeping the minimum-RTT sample minimises
        that bound (NTP's core trick).  Returns and stores
        ``(offset_ns, err_bound_ns)``.
        """
        n = self.cfg.offset_probes if probes is None else int(probes)
        best_rtt = None
        best_offset = None
        for _ in range(max(n, 1)):
            t0 = time.monotonic_ns()
            doc = self._get("/healthz")
            t1 = time.monotonic_ns()
            rtt = t1 - t0
            remote = int(doc["t_mono_ns"])
            offset = remote - (t0 + t1) // 2
            if best_rtt is None or rtt < best_rtt:
                best_rtt, best_offset = rtt, offset
        self.clock_offset_ns = int(best_offset)
        self.clock_offset_err_ns = int(best_rtt // 2)
        return self.clock_offset_ns, self.clock_offset_err_ns

    # --------------------------------------------------- ReplicaSource
    def statusz_row(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Per-replica fleet statusz row, remote flavour: last-known
        engine fields plus the scrape-plane truth (state/age/errors).
        Shape-compatible with the in-process rows where the data
        exists; remote-only fields are additive."""
        now = self._clock() if now is None else now
        self.refresh_state(now)
        with self._lock:
            s = self.last_statusz or {}
            age = None if self.last_ok is None else now - self.last_ok
            row = {
                "replica": self.id,
                "remote": True,
                "url": self.url,
                "scrape_state": self.state,
                "scrape_age_s": round(age, 3) if age is not None
                else None,
                "scrape_errors": self.scrape_errors,
                "scrapes": self.scrapes,
                "scrape_latency_s": round(self.last_latency_s, 6),
                # matches the in-process fleet state vocabulary
                # (lowercase); "unknown" until the first scrape lands
                "state": "degraded"
                if (self.last_healthz or {}).get("degraded")
                else ("healthy" if self.last_healthz else "unknown"),
                "queue_depth": s.get("queue", {}).get("depth", 0),
                "active_slots": s.get("active_slots", 0),
                "uptime_s": s.get("uptime_s"),
                "role": None,
                "version": str(s.get("weights_version")),
                "mesh": s.get("mesh") or {
                    "sharded": False, "devices": 1, "axes": {},
                    "tp": 1, "ep": 1},
                "reasons": list(
                    (self.last_healthz or {}).get("reasons", [])),
            }
            if self.last_error is not None:
                row["scrape_error"] = self.last_error
            if self.clock_offset_ns is not None:
                row["clock_offset_ns"] = self.clock_offset_ns
                row["clock_offset_err_ns"] = self.clock_offset_err_ns
            return row

    def slo_snapshot(self, now: Optional[float] = None
                     ) -> Optional[Dict[str, Any]]:
        """Last-known ``statusz["slo"]`` — exactly the
        ``SLOTracker.snapshot()`` shape ``fleet_rollup`` consumes, so
        remote replicas fold into the fleet SLO with zero adaptation."""
        with self._lock:
            s = self.last_statusz
            return s.get("slo") if s else None

    def history_snapshot(self) -> Optional[Dict[str, Any]]:
        """Last-known ``historyz["history"]`` for ``history_rollup``
        (which already tolerates None/disabled snapshots)."""
        with self._lock:
            h = self.last_historyz
            return h.get("history") if h else None

    def healthz(self) -> Dict[str, Any]:
        with self._lock:
            h = dict(self.last_healthz or {})
        h["scrape_state"] = self.state
        h.setdefault("ready", self.state != LOST and bool(h))
        return h

    def close(self) -> None:
        self.closed = True


# ------------------------------------------------------------ trace merge
def merge_trace_segments(segments: List[Dict[str, Any]]
                         ) -> Dict[str, Any]:
    """Fold per-process trace segments into one Chrome trace.

    Each segment: ``{"events": [Event...], "offset_ns": int,
    "err_ns": int, "replica": str}``.  Events are shifted onto the
    LOCAL monotonic axis (``t_ns - offset_ns``), tagged with their
    replica in attrs (request spans from the same req id stitch
    naturally once they share an axis), merge-sorted, and rendered via
    :func:`events_to_chrome`.  The per-segment offsets and error
    bounds land in ``otherData.clock_offsets`` so a reader knows how
    much cross-process skew to trust.
    """
    merged: List[Event] = []
    offsets: Dict[str, Dict[str, Any]] = {}
    for seg in segments:
        off = int(seg.get("offset_ns") or 0)
        tag = str(seg.get("replica", f"r{len(offsets)}"))
        offsets[tag] = {"offset_ns": off,
                        "err_ns": int(seg.get("err_ns") or 0),
                        "events": len(seg.get("events", []))}
        for (t, req, slot, phase, attrs) in seg.get("events", []):
            a = dict(attrs) if attrs else {}
            a.setdefault("replica", tag)
            merged.append((t - off, req, slot, phase, a))
    merged.sort(key=lambda e: e[0])
    chrome = events_to_chrome(merged)
    chrome["otherData"]["clock_offsets"] = offsets
    chrome["otherData"]["merged_segments"] = len(segments)
    return chrome
