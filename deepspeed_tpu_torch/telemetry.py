"""Unified runtime telemetry (port of ``deepspeed_tpu/telemetry.py``): one
process-wide metrics registry wired across serving, streaming, comm, and
training.

ZeRO-Infinity-style designs (arXiv:2104.07857) are bandwidth-centric —
whether the param-stream / ZeRO-Inference pipelines actually hide
NVMe→host→HBM latency is an empirical question, and the answer used to
live in ad-hoc ``stats`` dicts and scattered ``time.perf_counter()``
calls no backend ever saw.  This module is the one place those numbers
now flow through:

- :class:`Counter` / :class:`Gauge` / :class:`Histogram` primitives,
  thread-safe (streaming drain workers and the serving scheduler write
  concurrently) with Prometheus semantics (cumulative ``le`` buckets,
  implicit ``+Inf``).
- :meth:`MetricsRegistry.span`: a context manager that records wall
  time into a histogram *and* opens a
  ``torch.profiler.record_function`` (bridging to ``utils/trace.py``), so
  a host-side phase shows up both as a latency distribution and as a
  named range in a captured device timeline.
- Three sinks: a periodic bridge into the existing
  :class:`~deepspeed_tpu_torch.monitor.MonitorMaster`
  (tensorboard/wandb/csv/comet), a Prometheus text-exposition writer
  (atomic file via ``utils/evidence.atomic_write_text``, plus an
  optional stdlib-http ``/metrics`` endpoint), and the on-demand JSON
  :meth:`MetricsRegistry.snapshot`.

Disabled-path contract: a registry built with ``enabled=False`` hands
out shared no-op singletons — no lock, no ``perf_counter``, no
``TraceAnnotation`` on any hot path.  Instrumented code holds metric
OBJECTS (resolved once at construction), so the disabled cost is one
no-op method call per event.  The serving decode loop additionally
guards its timestamp-taking behind ``registry.enabled`` so even the
``perf_counter`` reads vanish when telemetry is off.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.utils.evidence import atomic_write_text

# Latency buckets (seconds) spanning sub-ms host bookkeeping to
# multi-second NVMe sweeps — the Prometheus defaults stretched one
# decade down (serving TTFT on-chip sits in the single-digit ms).
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z0-9_:]."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


class Counter:
    """Monotonic counter.  ``inc`` is thread-safe (``+=`` on a Python
    float is not atomic — the drain workers proved it)."""

    kind = "counter"
    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, bandwidth, occupancy)."""

    kind = "gauge"
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: float) -> None:
        # single store: atomic under the GIL, no lock on hot paths
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` semantics.

    ``buckets`` are inclusive upper bounds; a value exactly on a
    boundary lands in that bucket, values above the last bound land in
    the implicit ``+Inf`` bucket.  Exposition emits CUMULATIVE bucket
    counts, ``sum`` and ``count`` — the standard histogram contract.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "_lock", "_counts", "_sum",
                 "_count")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(set(b)):
            raise ValueError(
                f"histogram {name}: buckets must be strictly increasing "
                f"and non-empty, got {buckets}")
        self.name = name
        self.help = help
        self.buckets = b
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)      # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le, count)`` pairs ending with ``(inf, count)``."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for le, c in zip(self.buckets + (float("inf"),), counts):
            acc += c
            out.append((le, acc))
        return out


class _NullMetric:
    """Shared no-op stand-in for every primitive when telemetry is
    disabled: no lock, no state, one method-call of overhead.  It
    answers the full read surface of all three kinds (``value``,
    ``sum``, ``count``, ``bucket_counts``) so shims like the serving
    engines' ``stats`` read zeros instead of raising."""

    kind = "null"
    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0

    @property
    def sum(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    def bucket_counts(self) -> List[Tuple[float, int]]:
        return []


NULL_METRIC = _NullMetric()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Span:
    """Wall-time → histogram + ``torch.profiler.record_function`` range.

    The annotation makes the host phase visible in captured device
    timelines next to the kernels it overlaps — the bridge between this
    registry and ``utils/trace.py``'s Tracer captures.
    """

    __slots__ = ("_hist", "_label", "_ann", "_t0")

    def __init__(self, hist: Histogram, label: str):
        self._hist = hist
        self._label = label
        self._ann = None

    def __enter__(self):
        import torch

        self._ann = torch.profiler.record_function(self._label)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        self._ann.__exit__(*exc)
        return False


class MetricsRegistry:
    """Thread-safe named-metric registry with three export surfaces.

    ``counter``/``gauge``/``histogram`` are get-or-create (re-requesting
    a name returns the same object; a kind mismatch raises — two
    subsystems silently sharing a name as different types is a bug).
    When ``enabled=False`` every accessor returns :data:`NULL_METRIC`
    and ``span`` returns a no-op context manager.
    """

    def __init__(self, enabled: bool = True, namespace: str = "dstpu"):
        self.enabled = bool(enabled)
        self.namespace = _sanitize(namespace)
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}       # insertion-ordered
        self._comms_seen: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------ create
    def _get_or_create(self, cls, name: str, help: str, **kw):
        name = _sanitize(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            elif kw.get("buckets") is not None and \
                    tuple(float(b) for b in kw["buckets"]) != m.buckets:
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{m.buckets}, requested {tuple(kw['buckets'])}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        if not self.enabled:
            return NULL_METRIC
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        if not self.enabled:
            return NULL_METRIC
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S
                  ) -> Histogram:
        if not self.enabled:
            return NULL_METRIC
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def span(self, name: str, help: str = "",
             buckets: Sequence[float] = LATENCY_BUCKETS_S):
        """Context manager: wall time into ``{name}_seconds`` + a
        ``TraceAnnotation`` named ``{namespace}/{phase}``, where
        ``phase`` is ``name`` normalized through the devprof phase
        vocabulary — so captured device timelines use the same
        prefill/decode/spec_verify/promote/sample names the
        ``devprof_device_seconds_*`` counters report under.  The
        histogram keeps the caller's literal name (metric families are
        a stable exposition contract)."""
        if not self.enabled:
            return _NULL_SPAN
        from deepspeed_tpu_torch.devprof import canonical_phase

        h = self.histogram(f"{name}_seconds", help, buckets)
        return Span(h, f"{self.namespace}/{canonical_phase(name)}")

    # ----------------------------------------------------------- export
    def snapshot(self) -> Dict[str, Any]:
        """On-demand JSON-serializable view of every metric."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Any] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.kind == "counter":
                counters[m.name] = m.value
            elif m.kind == "gauge":
                gauges[m.name] = m.value
            else:
                hists[m.name] = {
                    "buckets": {_fmt_le(le): c
                                for le, c in m.bucket_counts()},
                    "sum": m.sum,
                    "count": m.count,
                    "mean": m.sum / m.count if m.count else 0.0,
                }
        return {"enabled": self.enabled, "namespace": self.namespace,
                "counters": counters, "gauges": gauges,
                "histograms": hists}

    def prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the registry."""
        lines: List[str] = []
        ns = self.namespace
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            full = f"{ns}_{m.name}"
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} {m.kind}")
            if m.kind in ("counter", "gauge"):
                lines.append(f"{full} {_fmt(m.value)}")
            else:
                for le, c in m.bucket_counts():
                    lines.append(
                        f'{full}_bucket{{le="{_fmt_le(le)}"}} {c}')
                lines.append(f"{full}_sum {_fmt(m.sum)}")
                lines.append(f"{full}_count {m.count}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        """Atomic exposition-file write (temp + ``os.replace``, like the
        JSON evidence writers): a scraper or a kill mid-write can only
        ever see the previous complete file."""
        atomic_write_text(self.prometheus_text(), path)

    def publish_to_monitor(self, monitor, step: int) -> None:
        """One bridge tick into a MonitorMaster: counters and gauges as
        scalars, histograms as ``_count``/``_sum``/``_mean``."""
        if monitor is None or not monitor.enabled:
            return
        scalars: Dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            tag = f"Telemetry/{m.name}"
            if m.kind in ("counter", "gauge"):
                scalars[tag] = float(m.value)
            else:
                scalars[f"{tag}_count"] = float(m.count)
                scalars[f"{tag}_sum"] = float(m.sum)
                scalars[f"{tag}_mean"] = (m.sum / m.count
                                          if m.count else 0.0)
        monitor.write_scalars(scalars, step)

    # ----------------------------------------------------------- fan-in
    def fan_in_comms(self, comms_logger, prefix: str = "comm") -> None:
        """Fold a :class:`~deepspeed_tpu_torch.utils.trace.CommsLogger`
        summary into per-op counters (``{prefix}_{op}_calls`` /
        ``_bytes`` / ``_seconds``).  Delta-tracked against the last
        fan-in, so calling this every publish tick never double-counts
        (and a logger ``reset()`` between ticks just contributes
        nothing, it cannot drive a counter backwards)."""
        if not self.enabled:
            return
        for op, rec in comms_logger.summary().items():
            last = self._comms_seen.get(op, {})
            for key, cname in (("count", "calls"), ("bytes", "bytes"),
                               ("time_s", "seconds")):
                d = rec[key] - last.get(key, 0.0)
                if d > 0:
                    self.counter(f"{prefix}_{op}_{cname}").inc(d)
            self._comms_seen[op] = dict(rec)


def _fmt(v: float) -> str:
    v = float(v)
    # non-finite gauges are legal (a diverged loss, an overflow grad
    # norm) and must export, not crash the tick — Prometheus spellings
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if v != int(v) else str(int(v))


def _fmt_le(le: float) -> str:
    return "+Inf" if le == float("inf") else _fmt(le)


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """Parse the exposition this module emits back into
    ``{metric: {"type": ..., "samples": {sample_name_or_le: value}}}``
    — the round-trip half of the Prometheus sink (tests parse what we
    emit; an external scraper sees the same grammar)."""
    out: Dict[str, Any] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            out[name] = {"type": kind, "samples": {}}
            continue
        if line.startswith("#"):
            continue
        sample, value = line.rsplit(None, 1)
        if "{" in sample:
            base, label = sample.split("{", 1)
            le = label[:-1].split("=", 1)[1].strip('"')
            key = f"{base}|le={le}"
        else:
            key = sample
        # samples belong to the most recent TYPE'd family whose name
        # prefixes them (histogram emits base_bucket/_sum/_count)
        fam = next((n for n in reversed(list(out))
                    if key.startswith(n)), None)
        if fam is None:
            raise ValueError(f"sample {sample!r} before any # TYPE line")
        out[fam]["samples"][key] = float(value)
    return out


class TelemetryExporter:
    """Periodic sink driver + live introspection server.

    Sinks: rate-limited MonitorMaster bridge + Prometheus file.
    ``maybe_export(step)`` is safe to call every iteration — it is one
    ``time.monotonic()`` compare until ``interval_s`` elapses.

    The HTTP server (``http_port``; 0 picks an ephemeral port, see
    ``.port``) renders ``/metrics`` on demand in a daemon thread, and
    doubles as the engine introspection surface: providers registered
    via :meth:`register_provider` serve ``/statusz`` (live engine
    snapshot), ``/healthz`` (liveness/readiness; returns 503 when the
    provider reports unready), and ``/requestz?id=`` (one request's
    flight-recorder events).  Unregistered introspection paths 404 —
    a bare exporter is still just a metrics endpoint.

    Lifecycle: the socket binds with ``SO_REUSEADDR`` and
    :meth:`close` is idempotent (shutdown + close + thread join), so
    back-to-back engine constructions in one process can reuse a fixed
    port without ``EADDRINUSE`` or leaking the serving thread.
    """

    def __init__(self, registry: MetricsRegistry, *, monitor=None,
                 prometheus_path: Optional[str] = None,
                 interval_s: float = 10.0,
                 http_port: Optional[int] = None):
        self.registry = registry
        self.monitor = monitor
        self.prometheus_path = prometheus_path
        self.interval_s = max(float(interval_s), 0.0)
        # None, not 0.0: monotonic() is time-since-boot, so on a host
        # up for less than interval_s a 0.0 sentinel would suppress
        # the first export entirely
        self._last: Optional[float] = None    # first call always exports
        self._step = 0
        self._httpd = None
        self._http_thread = None
        self.port: Optional[int] = None
        # introspection providers: name -> zero-arg callable returning a
        # JSON-serializable dict ("statusz", "healthz") or a one-arg
        # callable taking the request id ("requestz").  Read via a dict
        # lookup per GET — registration order and timing are free.
        self._providers: Dict[str, Any] = {}
        # additional registries appended to the /metrics exposition —
        # the fleet router registers each replica engine's registry
        # here (distinct namespaces keep the families collision-free),
        # so ONE scrape carries the rollup plus every per-replica view
        self._sources: List[MetricsRegistry] = []
        # tick hooks: the shared timed pass driven from maybe_export
        # (SLO refresh, history sampling, incident evaluation) — each
        # entry is [fn, interval_s, last_t, name, alive]
        self._tick_hooks: List[list] = []
        if http_port is not None and registry.enabled:
            self._start_http(int(http_port))
        # postmortem flushing: the watchdog's timeout path (and any
        # other abort path) force-flushes every live exporter so the
        # last scrape on disk reflects the moment of death, not the
        # last interval tick; weak so dead engines release theirs
        _exporters.add(self)

    # dstpu: hot-path
    def run_tick_hooks(self, now: Optional[float] = None) -> int:
        """Drive every registered tick hook that is due — the ONE
        timed pass shared by SLO window refresh, history sampling and
        incident-detector evaluation (each hook rate-limits on its own
        ``interval_s``; until due it costs one compare).  Called from
        :meth:`maybe_export` so a serving loop pays a single
        ``time.monotonic()`` read per step for the whole control
        plane.  Hooks are individually guarded: a broken one logs and
        is disabled rather than taking down the serving loop."""
        if not self._tick_hooks:
            return 0
        if now is None:
            now = time.monotonic()
        ran = 0
        for hook in self._tick_hooks:
            # hook = [fn, interval_s, last_t, name, alive]
            if not hook[4] or (hook[2] is not None
                               and now - hook[2] < hook[1]):
                continue
            hook[2] = now
            try:
                hook[0](now)
                ran += 1
            except Exception:
                hook[4] = False
                from deepspeed_tpu_torch.utils.logging import logger

                logger.exception(
                    "telemetry: tick hook %s raised — disabled",
                    hook[3])
        return ran

    def register_tick_hook(self, fn, interval_s: float = 1.0,
                           name: str = "") -> None:
        """Attach ``fn(now_monotonic)`` to the exporter's per-step
        timed pass (see :meth:`run_tick_hooks`).  ``interval_s``
        rate-limits the hook independently of the sink
        ``interval_s`` — history samples at 1 s while Prometheus
        writes at 10 s."""
        interval_s = float(interval_s)
        if interval_s < 0:
            raise ValueError(
                f"tick hook interval_s must be >= 0, got {interval_s}")
        self._tick_hooks.append(
            [fn, interval_s, None, name or getattr(fn, "__name__", "?"),
             True])

    def maybe_export(self, step: Optional[int] = None,
                     force: bool = False) -> bool:
        if not self.registry.enabled:
            return False
        now = time.monotonic()
        if not force:
            # hooks run only on the owner's per-step path: a forced
            # flush (watchdog postmortem, shutdown) arrives on ANOTHER
            # thread, and the hook consumers (IncidentManager, SLO
            # tracker state) are single-writer by contract — the
            # forced path wants the sinks, not the control plane
            self.run_tick_hooks(now)
        if not force and self._last is not None and \
                now - self._last < self.interval_s:
            return False
        self._last = now
        self._step = self._step + 1 if step is None else int(step)
        if self.monitor is not None and self.monitor.enabled:
            self.registry.publish_to_monitor(self.monitor, self._step)
            self.monitor.flush()
        if self.prometheus_path:
            self.registry.write_prometheus(self.prometheus_path)
        return True

    # ---------------------------------------------------- introspection
    def add_source(self, registry: MetricsRegistry) -> None:
        """Append another registry to the ``/metrics`` exposition
        (idempotent per registry).  Collision discipline is the
        caller's: give each source its own ``namespace`` — the fleet
        router uses ``dstpu_r0``, ``dstpu_r1``, … per replica."""
        if registry is not self.registry and \
                all(registry is not s for s in self._sources):
            self._sources.append(registry)

    def remove_source(self, registry: MetricsRegistry) -> None:
        """Drop a registry from the exposition (no-op if absent) —
        the fleet calls this when a replica RETIRES, so a long-lived
        elastic fleet's ``/metrics`` does not accumulate one dead
        replica's full metric set per scale cycle.  In-place mutation:
        the HTTP handler holds the live list."""
        for i, s in enumerate(self._sources):
            if s is registry:
                del self._sources[i]
                return

    def register_provider(self, name: str, fn) -> None:
        """Attach an introspection provider: ``statusz``/``healthz``/
        ``historyz`` take no args and return a JSON dict (healthz may
        include ``"ready": false`` to force a 503; historyz serves the
        metric-history rings + recent incident metadata); ``requestz``
        takes the request-id string; ``profilez`` takes the optional
        ``?capture_s=`` string (None for a plain devprof snapshot);
        ``tracez`` takes the ``?since=`` cursor string ("0" when
        absent) and returns an incremental flight-recorder segment.
        Re-registering a name replaces it (the engine owns its
        endpoints)."""
        if name not in ("statusz", "healthz", "requestz", "historyz",
                        "profilez", "tracez"):
            raise ValueError(
                f"unknown introspection provider {name!r} — expected "
                "statusz, healthz, historyz, profilez, tracez or "
                "requestz")
        self._providers[name] = fn

    # ------------------------------------------------------------- http
    def _start_http(self, port: int) -> None:
        import http.server

        registry = self.registry
        providers = self._providers
        sources = self._sources      # live list: add_source visible

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, obj, code: int = 200) -> None:
                import json

                self._send(code, (json.dumps(obj, indent=1,
                                             sort_keys=True)
                                  + "\n").encode())

            def do_GET(self):          # noqa: N802 (stdlib contract)
                from urllib.parse import parse_qs, urlparse

                u = urlparse(self.path)
                route = u.path.rstrip("/") or "/metrics"
                try:
                    if route == "/metrics":
                        text = "".join(
                            [registry.prometheus_text()]
                            + [s.prometheus_text() for s in sources
                               if s.enabled])
                        self._send(200, text.encode(),
                                   "text/plain; version=0.0.4")
                    elif route == "/statusz" and "statusz" in providers:
                        self._send_json(providers["statusz"]())
                    elif route == "/historyz" and \
                            "historyz" in providers:
                        self._send_json(providers["historyz"]())
                    elif route == "/healthz" and "healthz" in providers:
                        h = providers["healthz"]()
                        self._send_json(
                            h, 200 if h.get("ready", True) else 503)
                    elif route == "/profilez" and \
                            "profilez" in providers:
                        cs = parse_qs(u.query).get(
                            "capture_s", [None])[0]
                        self._send_json(providers["profilez"](cs))
                    elif route == "/tracez" and "tracez" in providers:
                        since = parse_qs(u.query).get(
                            "since", ["0"])[0]
                        self._send_json(providers["tracez"](since))
                    elif route == "/requestz" and \
                            "requestz" in providers:
                        rid = parse_qs(u.query).get("id", [None])[0]
                        if rid is None:
                            self._send_json(
                                {"error": "missing ?id= query"}, 400)
                        else:
                            d = providers["requestz"](rid)
                            self._send_json(
                                d, 200 if d.get("found") else 404)
                    else:
                        self.send_error(404)
                except Exception as e:   # a broken provider must not
                    try:                 # kill the serving thread
                        self._send_json({"error": repr(e)}, 500)
                    except Exception:
                        pass

            def log_message(self, *a):   # keep scrapes out of stderr
                pass

        class Server(http.server.ThreadingHTTPServer):
            # explicit (HTTPServer already sets it, but the lifecycle
            # contract — back-to-back engines on one fixed port — is
            # load-bearing enough to pin rather than inherit)
            allow_reuse_address = True
            daemon_threads = True

        self._httpd = Server(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="dstpu-telemetry-http", daemon=True)
        self._http_thread.start()

    def close(self) -> None:
        """Stop the HTTP server and join its thread.  Idempotent —
        engine teardown and explicit calls can both run it."""
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._http_thread = self._http_thread, None
        if t is not None:
            t.join(timeout=5.0)


# ----------------------------------------------------- exporter registry
_exporters: "weakref.WeakSet[TelemetryExporter]" = weakref.WeakSet()


def flush_all_exporters() -> int:
    """Force one export tick on every live :class:`TelemetryExporter`
    (Prometheus file + monitor bridge), each individually guarded —
    the watchdog calls this before ``os._exit(42)`` so a hang's final
    metric state lands on disk.  Returns the number flushed."""
    n = 0
    for e in list(_exporters):
        try:
            if e.maybe_export(force=True):
                n += 1
        except Exception:
            pass
    return n


# ------------------------------------------------------- default registry
_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry.  Subsystems without a config handle
    (the aio pool, the comm backend) record here; engines wire their
    own registry from the ``telemetry`` config block.  ``DSTPU_TELEMETRY=0``
    disables it for the whole process."""
    global _default
    with _default_lock:
        if _default is None:
            enabled = os.environ.get("DSTPU_TELEMETRY", "1").lower() \
                not in ("0", "false", "off")
            _default = MetricsRegistry(enabled=enabled)
        return _default


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests; or to point the aio/comm
    instrumentation at an engine's registry).  Returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, reg
        return prev
