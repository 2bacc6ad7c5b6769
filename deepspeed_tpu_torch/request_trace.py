"""Per-request tracing + always-on flight recorder (port of
``deepspeed_tpu/request_trace.py``).

The :class:`~deepspeed_tpu_torch.telemetry.MetricsRegistry` answers "what
are the aggregates" (TTFT p95, prefetch hit rate); this module answers
the other two production questions ZeRO-Infinity-style streamed
execution raises (arXiv:2104.07857, arXiv:2101.06840): "why was THIS
request slow" and "what was the system doing when it hung".

Three pieces:

- :class:`FlightRecorder` — a thread-safe bounded ring of structured
  events ``(monotonic_ns, req_id, slot, phase, attrs)``.  The ring is
  preallocated; recording one event is a clock read, one lock, one
  tuple store — cheap enough to leave on in production (bounded in
  ``SERVING_OVERHEAD.json`` ``tracing_overhead``).  Overflow silently
  drops the OLDEST events: a postmortem wants the last seconds, not
  the first.
- :class:`RequestTracer` — the emitting facade every subsystem holds.
  Serving lifecycle edges (queued → admitted → prefill-chunk →
  first-token → decode-batch → preempt/requeue → finish), layer
  fetch/stall events from the streamed engines, aio submit/complete,
  ``ParamStreamEngine`` step phases, and comm-op records delta-folded
  from the backend's :class:`~deepspeed_tpu_torch.utils.trace.CommsLogger`.
  Per-request sampling (``sample_rate``) decides once per ``req_id``
  (deterministic hash) whether its lifecycle records; disabled path is
  the shared :data:`NULL_TRACER` no-op singleton, mirroring
  telemetry's null metrics.
- Exporters + postmortem.  :meth:`RequestTracer.export_chrome` writes
  Chrome trace-event JSON (catapult: per-request nested async
  begin/end spans, one named track per subsystem — loads in Perfetto /
  ``chrome://tracing``); :meth:`RequestTracer.export_jsonl` writes the
  raw structured log.  :func:`postmortem_dump` flushes every live
  recorder to disk and is invoked automatically on ``Watchdog``
  timeout (before ``os._exit(42)``), on an unhandled exception
  (:func:`install_excepthook` chains ``sys.excepthook``), or on
  ``SIGUSR1`` (:func:`install_sigusr1`) — turning a silent hang into a
  postmortem artifact whose last events identify the stuck request.

``tools/trace_report.py`` ingests either export and prints per-request
waterfalls plus a critical-path breakdown (queue wait vs prefill vs
decode vs stream-stall seconds, p50/p95).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.config import temp_path

# one event: (monotonic_ns, req_id, slot, phase, attrs-or-None)
Event = Tuple[int, Any, int, str, Optional[Dict[str, Any]]]

# phase prefix → subsystem track in the Chrome export; anything
# unlisted lands on the catch-all "events" track
_TRACKS = (
    ("aio_", "aio"),
    ("comm_", "comm"),
    ("pstream_", "param_stream"),
    ("zi_", "zero_inference"),
    ("tier_", "tier_reader"),
    ("spec_", "speculative"),
    ("kv_", "kv_tier"),
    # devprof device truth: xla_compile / profile_capture /
    # devprof_sample get their own track so steady-state recompiles
    # stand out against the request waterfall instead of drowning in
    # the catch-all events lane
    ("xla_", "xla_compile"),
    ("profile_", "xla_compile"),
    ("devprof_", "xla_compile"),
)
# NOTE: spec_accept is per-request (rides the request's async span as an
# instant, with drafted/accepted attrs); the batch-level speculation
# sweep events (spec_draft / spec_verify / spec_rollback) stay on the
# "speculative" track via the prefix table above
_SERVING_PHASES = frozenset((
    "queued", "admitted", "prefill_chunk", "first_token", "decode_batch",
    "preempt", "requeue", "finish", "spec_accept", "kv_promote"))
# NOTE: kv_promote is per-request (the promotion that gated THIS
# request's prefill rides its async span as an instant, attrs carry
# pages + wait_s, so the waterfall shows promotion time inside TTFT);
# batch-level demotions (kv_demote) stay on the "kv_tier" track via the
# prefix table above

# every enabled tracer registers here so a postmortem (watchdog
# timeout, excepthook, SIGUSR1) can dump ALL live recorders without a
# handle to any engine; weak so dead engines release their rings
_tracers: "weakref.WeakSet[RequestTracer]" = weakref.WeakSet()
_postmortem_lock = threading.Lock()


class FlightRecorder:
    """Thread-safe bounded event ring (the flight recorder proper).

    The buffer is preallocated at construction; per event the hot path
    does one lock acquire and one slot store — no list growth, no
    allocation beyond the event tuple itself.  When the ring wraps, the
    newest events win (``dropped`` counts the overwritten oldest)."""

    __slots__ = ("capacity", "_buf", "_n", "_lock", "__weakref__")

    def __init__(self, capacity: int = 65536):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: List[Optional[Event]] = [None] * capacity
        self._n = 0
        self._lock = threading.Lock()

    def append(self, event: Event) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = event
            self._n += 1

    @property
    def total(self) -> int:
        """Events ever recorded (including overwritten ones)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Oldest events lost to ring wrap."""
        return max(0, self._n - self.capacity)

    def events(self) -> List[Event]:
        """Snapshot, oldest → newest."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                return list(self._buf[:n])
            i = n % self.capacity
            return self._buf[i:] + self._buf[:i]

    def events_since(self, cursor: int) -> Tuple[int, List[Event]]:
        """Incremental poll: events with sequence index >= ``cursor``
        (oldest surviving first) plus the new cursor (``total``).  A
        caller more than ``capacity`` events behind gets just the
        surviving window — the incident engine's per-tick drain never
        re-reads what it has already classified, and the lock is held
        for a copy of only the RETURNED slots (never the whole ring —
        a 256k-capacity ring must not stall every decode-path append
        for a full-buffer copy per tick)."""
        with self._lock:
            total = self._n
            k = min(total - cursor, self.capacity, total)
            if k <= 0:
                return total, []
            start = total - k
            cap = self.capacity
            return total, [self._buf[(start + j) % cap]
                           for j in range(k)]

    def tail(self, n: int) -> List[Event]:
        """The newest ``n`` events, oldest → newest, copying only
        those slots (the incident bundle's ring slice)."""
        return self.events_since(max(self._n - int(n), 0))[1]

    def clear(self) -> None:
        """Forget everything (benchmarks drop warmup traffic here)."""
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0


class RequestTracer:
    """Event-emitting facade over a :class:`FlightRecorder`.

    ``sampled(req_id)`` is the once-per-request admission decision a
    scheduler stores on the request (deterministic: the same id always
    samples the same way, across processes too).  ``event`` appends one
    tuple; callers on hot paths gate it behind their own
    ``tracer.enabled`` bool so the disabled cost is one attribute read.
    """

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 sample_rate: float = 1.0, enabled: bool = True,
                 dump_dir: str = temp_path("dstpu_flight")):
        self.sample_rate = float(sample_rate)
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}")
        # rate 0 IS disabled: nothing may emit, including batch-level
        # and subsystem events (the "sampling=0 emits nothing" contract)
        self.enabled = bool(enabled) and self.sample_rate > 0
        self.recorder = recorder if recorder is not None \
            else FlightRecorder(1 if not self.enabled else 65536)
        self.dump_dir = dump_dir
        self._comms_seen: Dict[str, Dict[str, float]] = {}
        if self.enabled:
            _tracers.add(self)

    @classmethod
    def from_config(cls, cfg) -> "RequestTracer":
        """Build from a :class:`~deepspeed_tpu_torch.config.TracingConfig`;
        a disabled block hands back the shared :data:`NULL_TRACER`."""
        if not cfg.enabled or cfg.sample_rate <= 0:
            return NULL_TRACER
        tr = cls(FlightRecorder(cfg.ring_capacity),
                 sample_rate=cfg.sample_rate, dump_dir=cfg.dump_dir)
        if cfg.install_excepthook:
            install_excepthook()
        if cfg.sigusr1:
            install_sigusr1()
        return tr

    # ------------------------------------------------------------ emit
    def sampled(self, req_id: Any) -> bool:
        """Per-request sampling decision (stable per id)."""
        if not self.enabled:
            return False
        if self.sample_rate >= 1.0:
            return True
        h = zlib.crc32(repr(req_id).encode())
        return h < self.sample_rate * 2**32

    def event(self, phase: str, req: Any = None, slot: int = -1,
              attrs: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.recorder.append(
            (time.monotonic_ns(), req, slot, phase, attrs))

    def bind(self, **attrs) -> "RequestTracer":
        """A view of this tracer stamping ``attrs`` onto every event —
        how a fleet replica's engine tags its whole trace stream with
        its replica id without threading the id through every emit
        site.  Disabled tracers (and empty binds) return ``self``."""
        if not self.enabled or not attrs:
            return self
        return BoundTracer(self, attrs)

    # ---------------------------------------------------------- fan-in
    def fold_comms(self, comms_logger=None) -> None:
        """Delta-fold a :class:`~deepspeed_tpu_torch.utils.trace.CommsLogger`
        summary into ``comm_<op>`` events (attrs = calls/bytes/seconds
        since the last fold) — same never-double-count contract as
        ``MetricsRegistry.fan_in_comms``.  Default: the comm backend's
        process-wide logger."""
        if not self.enabled:
            return
        if comms_logger is None:
            from deepspeed_tpu_torch import comm

            comms_logger = comm.comms_logger()
        for op, rec in comms_logger.summary().items():
            last = self._comms_seen.get(op, {})
            delta = {k: rec[k] - last.get(k, 0.0) for k in rec}
            if any(v > 0 for v in delta.values()):
                self.event(f"comm_{op}", attrs=delta)
            self._comms_seen[op] = dict(rec)

    # --------------------------------------------------------- export
    def export_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event (catapult) JSON; atomic write when
        ``path`` is given, returns the trace dict either way."""
        trace = events_to_chrome(self.recorder.events())
        trace["otherData"]["dropped_events"] = self.recorder.dropped
        if path:
            from deepspeed_tpu_torch.utils.evidence import atomic_write_json

            atomic_write_json(trace, path)
        return trace

    def export_jsonl(self, path: str, reason: str = "export") -> str:
        """Structured JSONL log (one event per line, meta header
        first); returns ``path``."""
        write_jsonl(self.recorder.events(), path, reason=reason,
                    dropped=self.recorder.dropped)
        return path


class BoundTracer:
    """Attr-stamping view over a :class:`RequestTracer` (see
    :meth:`RequestTracer.bind`).  Everything but ``event`` and
    ``bind`` delegates to the base tracer, so the ring, sampling
    decisions and exports stay shared — only the emitted attrs
    change."""

    def __init__(self, base, attrs: Dict[str, Any]):
        self._base = base
        self._attrs = dict(attrs)

    def __getattr__(self, name):
        return getattr(self._base, name)

    def bind(self, **attrs) -> "BoundTracer":
        return BoundTracer(self._base, {**self._attrs, **attrs})

    def event(self, phase: str, req: Any = None, slot: int = -1,
              attrs: Optional[Dict[str, Any]] = None) -> None:
        merged = dict(self._attrs)
        if attrs:
            merged.update(attrs)
        self._base.event(phase, req, slot, merged)


# shared no-op: `event` returns at the `enabled` check, `sampled` is
# always False, and the 1-slot ring never registers for postmortems
NULL_TRACER = RequestTracer(sample_rate=0.0)


# ------------------------------------------------------------ serializers
def _jsonable(x):
    try:
        json.dumps(x)
        return x
    except (TypeError, ValueError):
        return repr(x)


def event_to_dict(e: Event) -> Dict[str, Any]:
    t, req, slot, phase, attrs = e
    d: Dict[str, Any] = {"t_ns": t, "phase": phase}
    if req is not None:
        d["req"] = _jsonable(req)
    if slot >= 0:
        d["slot"] = slot
    if attrs:
        d["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
    return d


def write_jsonl(events: List[Event], path: str, reason: str = "export",
                dropped: int = 0, meta: Optional[Dict[str, Any]] = None
                ) -> None:
    """Atomic JSONL write: meta header line + one line per event.
    ``meta`` adds fields to the header — the wire plane stamps each
    per-process segment's replica tag and measured clock offset there,
    which is where ``trace_report --merge`` reads them back."""
    from deepspeed_tpu_torch.utils.evidence import atomic_write_text

    lines = [json.dumps({"flight_recorder": {
        "reason": reason, "pid": os.getpid(),
        "t": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "events": len(events), "dropped_events": int(dropped),
        **(meta or {})}})]
    lines.extend(json.dumps(event_to_dict(e)) for e in events)
    atomic_write_text("\n".join(lines) + "\n", path)


def events_from_dicts(dicts: List[Dict[str, Any]]) -> List[Event]:
    """Inverse of :func:`event_to_dict`: serialized event dicts (a
    JSONL export's lines, or a ``/tracez`` segment's ``events`` array)
    back into tuples."""
    return [(int(d["t_ns"]), d.get("req"), int(d.get("slot", -1)),
             d["phase"], d.get("attrs")) for d in dicts]


def read_jsonl(path: str) -> List[Event]:
    """Parse a JSONL export back into event tuples (meta lines skip)."""
    dicts: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "flight_recorder" in d:
                continue
            dicts.append(d)
    return events_from_dicts(dicts)


# ---------------------------------------------------------- chrome export
def _track_for(phase: str) -> str:
    if phase in _SERVING_PHASES:
        return "serving"
    for prefix, name in _TRACKS:
        if phase.startswith(prefix):
            return name
    return "events"


def events_to_chrome(events: List[Event]) -> Dict[str, Any]:
    """Catapult trace-event JSON from an event snapshot.

    Per-request lifecycle → nested ASYNC spans on one logical track per
    request (``cat="request"``, ``id=str(req)``): ``request`` wraps
    ``queued`` → ``prefill`` → ``decode``; preempt/requeue/prefill-chunk
    render as async instants inside it.  Every begin gets a matching
    end — a request still in flight at export time closes at its last
    observed timestamp with ``args.truncated=true``, so the file always
    loads.  Subsystem point events render as thread-scoped instants on
    a named track; stall events (attrs carry ``wait_s``) render as
    complete ``X`` slices spanning the blocked interval.  ``ts`` is
    microseconds from the earliest event (monotonic origin)."""
    tids = {"serving": 1}
    out: List[Dict[str, Any]] = []
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"source": "deepspeed_tpu_torch.request_trace"}}
    # min, not events[0]: emitters read the clock BEFORE the ring lock,
    # so concurrent appends can land slightly out of timestamp order —
    # the origin must still be the earliest time or ts goes negative
    base = min(e[0] for e in events)

    def us(t_ns: int) -> float:
        return (t_ns - base) / 1000.0

    def tid(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
        return tids[track]

    # pass 1: per-request lifecycle edges (first occurrence wins except
    # finish; preempt cycles keep the original queued/admitted edge)
    reqs: Dict[Any, Dict[str, Any]] = {}
    order: List[Any] = []
    for t, req, slot, phase, attrs in events:
        if req is None or phase not in _SERVING_PHASES:
            continue
        r = reqs.get(req)
        if r is None:
            r = reqs[req] = {"instants": [], "last": t}
            order.append(req)
        r["last"] = t
        if phase in ("queued", "admitted", "first_token", "finish"):
            if phase == "finish":
                r[phase] = t
                r["finish_attrs"] = attrs
            else:
                r.setdefault(phase, t)
            if phase == "admitted" and "admit_attrs" not in r:
                r["admit_attrs"] = attrs
        else:
            r["instants"].append((t, phase, attrs))

    for req in order:
        r = reqs[req]
        rid = str(_jsonable(req))
        t_q = r.get("queued")
        if t_q is None:
            # the ring wrapped past this request's birth: anchor its
            # spans at its earliest surviving event
            t_q = min([r[k] for k in ("admitted", "first_token", "finish")
                       if k in r] + [r["last"]])
        t_end = r.get("finish", r["last"])
        truncated = "finish" not in r

        def a(ph, name, t_ns, args=None):
            ev = {"ph": ph, "cat": "request", "id": rid, "name": name,
                  "pid": 1, "tid": tids["serving"], "ts": us(t_ns)}
            if args:
                ev["args"] = args
            out.append(ev)

        a("b", "request", t_q,
          args={"truncated": True} if truncated else None)
        a("b", "queued", t_q)
        t_adm = r.get("admitted")
        if t_adm is not None:
            a("e", "queued", t_adm)
            a("b", "prefill", t_adm, args=r.get("admit_attrs"))
            t_first = r.get("first_token")
            if t_first is not None:
                a("e", "prefill", t_first)
                a("b", "decode", t_first)
                a("e", "decode", t_end)
            else:
                a("e", "prefill", t_end)
        else:
            a("e", "queued", t_end)
        for t_i, phase, attrs in r["instants"]:
            a("n", phase, t_i, args=attrs)
        a("e", "request", t_end,
          args=r.get("finish_attrs") or
          ({"truncated": True} if truncated else None))

    # pass 2: batch + subsystem events on named tracks
    for t, req, slot, phase, attrs in events:
        if req is not None and phase in _SERVING_PHASES:
            continue
        track = _track_for(phase)
        ev: Dict[str, Any] = {"cat": track, "name": phase, "pid": 1,
                              "tid": tid(track)}
        if attrs and "wait_s" in attrs:
            # recorded when the wait ENDED; render the blocked interval
            dur = max(float(attrs["wait_s"]) * 1e6, 0.001)
            ev.update(ph="X", ts=max(us(t) - dur, 0.0), dur=dur,
                      args={k: _jsonable(v) for k, v in attrs.items()})
        else:
            ev.update(ph="i", s="t", ts=us(t))
            if attrs:
                ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        out.append(ev)

    out.sort(key=lambda e: e["ts"])
    meta = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "deepspeed_tpu"}}]
    for track, t_id in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "pid": 1, "tid": t_id,
                     "name": "thread_name", "args": {"name": track}})
    for ev in out:
        if ev.get("args") is None:
            ev.pop("args", None)
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"source": "deepspeed_tpu_torch.request_trace",
                          "base_monotonic_ns": base}}


# ------------------------------------------------------------- breakdown
def _pct(vals: List[float], q: float) -> float:
    s = sorted(vals)
    return s[min(int(q * (len(s) - 1) + 0.5), len(s) - 1)]


def speculation_summary(
        spec: Dict[Any, Dict[str, int]]) -> Optional[Dict[str, Any]]:
    """Fleet-level speculation totals from per-request ``spec_accept``
    accumulations (``{req: {sweeps, drafted, accepted}}``) — shared by
    :func:`request_breakdown` and ``tools/trace_report.py``'s Chrome
    ingestion.  ``mean_accept_len`` is tokens emitted per verify sweep
    (accepted prefix + the bonus token): the factor by which one model
    sweep — and, under ZeRO-Inference, one full weight stream — was
    amortized."""
    if not spec:
        return None
    sweeps = sum(r["sweeps"] for r in spec.values())
    drafted = sum(r["drafted"] for r in spec.values())
    accepted = sum(r["accepted"] for r in spec.values())
    return {
        "sweeps": sweeps,
        "drafted_tokens": drafted,
        "accepted_tokens": accepted,
        "rejected_tokens": drafted - accepted,
        "mean_accept_len": round((accepted + sweeps) / sweeps, 4),
    }


def attach_speculation(per: Dict[Any, Dict[str, float]],
                       spec: Dict[Any, Dict[str, int]]) -> None:
    """Fold per-request speculation accumulations into the waterfall
    rows (``spec_sweeps``/``spec_drafted``/``spec_accepted`` plus the
    per-request ``spec_mean_accept_len``).  Requests with spec instants
    but no surviving lifecycle edges (ring overflow evicted them) are
    skipped — an all-zero waterfall row would inflate the request count;
    their sweeps still count in :func:`speculation_summary`."""
    for req, srec in spec.items():
        row = per.get(req)
        if row is None:
            continue
        row["spec_sweeps"] = srec["sweeps"]
        row["spec_drafted"] = srec["drafted"]
        row["spec_accepted"] = srec["accepted"]
        row["spec_mean_accept_len"] = round(
            (srec["accepted"] + srec["sweeps"]) / srec["sweeps"], 4)


def kv_tier_summary(kv: Dict[Any, Dict[str, float]]
                    ) -> Optional[Dict[str, Any]]:
    """Fleet-level KV-tier promotion totals from per-request
    ``kv_promote`` accumulations (``{req: {pages, wait_s}}``) — shared
    by :func:`request_breakdown` and ``tools/trace_report.py``'s Chrome
    ingestion.  ``wait_s`` is each promotion's submit→landed latency,
    which sits INSIDE the request's TTFT: the number that says whether
    an evicted prefix cost a DMA or a stall."""
    if not kv:
        return None
    return {
        "promotions": len(kv),
        "promoted_pages": int(sum(r["pages"] for r in kv.values())),
        "promote_wait_s": round(
            sum(r["wait_s"] for r in kv.values()), 6),
    }


def attach_kv_promotions(per: Dict[Any, Dict[str, float]],
                         kv: Dict[Any, Dict[str, float]]) -> None:
    """Fold per-request promotion accumulations into the waterfall
    rows (``kv_promote_s``/``kv_promoted_pages``).  Requests whose
    lifecycle edges the ring already lost are skipped, like
    :func:`attach_speculation`."""
    for req, krec in kv.items():
        row = per.get(req)
        if row is None:
            continue
        row["kv_promote_s"] = round(krec["wait_s"], 6)
        row["kv_promoted_pages"] = int(krec["pages"])


def summarize_components(per: Dict[Any, Dict[str, float]],
                         stall_s: float = 0.0) -> Dict[str, Any]:
    """p50/p95/mean summary over per-request component rows — the one
    summary contract, shared by :func:`request_breakdown` and
    ``tools/trace_report.py``'s Chrome ingestion."""
    summary: Dict[str, Any] = {"requests": len(per),
                               "stream_stall_s": round(stall_s, 6)}
    for comp in ("queue_wait_s", "prefill_s", "decode_s", "ttft_s",
                 "total_s", "kv_promote_s"):
        vals = [r[comp] for r in per.values() if comp in r]
        if vals:
            summary[comp] = {
                "p50": round(_pct(vals, 0.50), 6),
                "p95": round(_pct(vals, 0.95), 6),
                "mean": round(sum(vals) / len(vals), 6),
                "n": len(vals)}
    return summary


def request_breakdown(events: List[Event]) -> Dict[str, Any]:
    """Critical-path components per request + p50/p95 summary.

    ``queue_wait`` = queued→admitted, ``prefill`` = admitted→first
    token, ``decode`` = first token→finish, ``ttft`` = queued→first
    token, ``total`` = queued→finish; ``stream_stall_s`` totals every
    ``*_stall`` event's blocked seconds (the exposed — non-hidden — IO
    cost under the same window).  Traced speculation (``spec_accept``
    per sweep) folds into per-request acceptance columns and a
    fleet-level ``summary.speculation`` block, attributing the decode
    span to amortized verify sweeps."""
    edges: Dict[Any, Dict[str, int]] = {}
    spec: Dict[Any, Dict[str, int]] = {}
    kv: Dict[Any, Dict[str, float]] = {}
    stall_s = 0.0
    for t, req, slot, phase, attrs in events:
        if phase.endswith("_stall") and attrs:
            stall_s += float(attrs.get("wait_s", 0.0))
        if req is None or phase not in _SERVING_PHASES:
            continue
        if phase == "spec_accept":
            srec = spec.setdefault(
                req, {"sweeps": 0, "drafted": 0, "accepted": 0})
            srec["sweeps"] += 1
            srec["drafted"] += int((attrs or {}).get("drafted", 0))
            srec["accepted"] += int((attrs or {}).get("accepted", 0))
            continue
        if phase == "kv_promote":
            krec = kv.setdefault(req, {"pages": 0, "wait_s": 0.0})
            krec["pages"] += int((attrs or {}).get("pages", 0))
            krec["wait_s"] += float((attrs or {}).get("wait_s", 0.0))
            continue
        r = edges.setdefault(req, {})
        if phase == "finish":
            r[phase] = t
        elif phase in ("queued", "admitted", "first_token"):
            r.setdefault(phase, t)
    per: Dict[Any, Dict[str, float]] = {}
    for req, r in edges.items():
        row: Dict[str, float] = {}
        q, adm = r.get("queued"), r.get("admitted")
        first, fin = r.get("first_token"), r.get("finish")
        if q is not None and adm is not None:
            row["queue_wait_s"] = (adm - q) / 1e9
        if adm is not None and first is not None:
            row["prefill_s"] = (first - adm) / 1e9
        if first is not None and fin is not None:
            row["decode_s"] = (fin - first) / 1e9
        if q is not None and first is not None:
            row["ttft_s"] = (first - q) / 1e9
        if q is not None and fin is not None:
            row["total_s"] = (fin - q) / 1e9
        if row:
            per[req] = row
    attach_speculation(per, spec)
    attach_kv_promotions(per, kv)
    summary = summarize_components(per, stall_s)
    sp = speculation_summary(spec)
    if sp:
        summary["speculation"] = sp
    kt = kv_tier_summary(kv)
    if kt:
        summary["kv_tier"] = kt
    return {"requests": per, "summary": summary}


# ------------------------------------------------------------- postmortem
def postmortem_dump(reason: str,
                    out_dir: Optional[str] = None) -> List[str]:
    """Dump every live recorder to ``<dir>/flight_<reason>_<pid>_<i>.
    jsonl`` (comm records folded first) and run the registered flush
    callbacks.  Every step is individually guarded: a failing dump can
    never mask the abort path that invoked it.  Returns written
    paths."""
    paths: List[str] = []
    with _postmortem_lock:
        for i, tr in enumerate(list(_tracers)):
            try:
                tr.fold_comms()
            except Exception:
                pass
            try:
                if tr.recorder.total == 0:
                    continue
                d = (out_dir or os.environ.get("DSTPU_TRACE_DUMP_DIR")
                     or tr.dump_dir)
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flight_{reason}_{os.getpid()}_{i}.jsonl")
                tr.export_jsonl(path, reason=reason)
                paths.append(path)
            except Exception:
                pass
    return paths


_excepthook_installed = False


def install_excepthook() -> None:
    """Chain ``sys.excepthook``: an unhandled exception dumps the
    flight recorders before the previous hook prints the traceback.
    Idempotent."""
    global _excepthook_installed
    if _excepthook_installed:
        return
    prev = sys.excepthook

    def hook(tp, val, tb):
        try:
            postmortem_dump("exception")
        except Exception:
            pass
        prev(tp, val, tb)

    sys.excepthook = hook
    _excepthook_installed = True


def install_sigusr1() -> bool:
    """``kill -USR1 <pid>`` → postmortem dump of a LIVE process (the
    "what is it doing right now" probe).  Returns False when signals
    cannot be installed here (non-main thread)."""
    def handler(signum, frame):
        # never dump inside the handler: it interrupts the main thread
        # between bytecodes, possibly mid-`append` with a recorder lock
        # held, and the locks are non-reentrant — the probe would hang
        # the very process it is probing.  A fresh thread simply waits
        # out the interrupted holder.
        threading.Thread(target=postmortem_dump, args=("sigusr1",),
                         daemon=True).start()

    try:
        signal.signal(signal.SIGUSR1, handler)
        return True
    except ValueError:
        return False


# -------------------------------------------------------- default tracer
_default_lock = threading.Lock()
_default: Optional[RequestTracer] = None


def default_tracer() -> RequestTracer:
    """The process-wide tracer.  Subsystems without a config handle
    (the aio pool, ``ParamStreamEngine`` phase records) emit here;
    serving engines build their own from the ``tracing`` config block.
    ``DSTPU_TRACING=0`` disables it for the whole process."""
    global _default
    with _default_lock:
        if _default is None:
            enabled = os.environ.get("DSTPU_TRACING", "1").lower() \
                not in ("0", "false", "off")
            _default = RequestTracer(enabled=enabled) if enabled \
                else NULL_TRACER
        return _default


def set_default_tracer(tr: RequestTracer) -> RequestTracer:
    """Swap the process-wide tracer (tests; or to aim aio/pstream
    events at an engine's recorder).  Returns the previous one.

    Swap BEFORE constructing engines/handles: ``AioHandle`` and
    ``TierLayerReader`` resolve the default once at construction (the
    same ctor-time binding the telemetry registry uses), so handles
    built earlier keep emitting into the old ring."""
    global _default
    with _default_lock:
        prev, _default = _default, tr
        return prev
