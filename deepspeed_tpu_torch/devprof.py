"""Device-truth observability: compile ledger, per-phase device time,
and roofline accounting (port of ``deepspeed_tpu/devprof.py``; no
reference analogue; the fifth observability pillar next to
telemetry/tracing/history/incidents).

Every other timing surface is host wall-time (``perf_counter`` in
telemetry/request_trace), but the perf contract lives on the device.  The
JAX package's version watches XLA; the port keeps its host bookkeeping and
re-points what touched JAX:

- **Compile ledger**: the port has no jit, so nothing compiles or
  recompiles at run time (the hand-written kernels are built before the
  engine runs).  The ledger keeps the JAX schema and reports zero:
  nothing calls :meth:`DevProf.on_compile` in the port, so the
  ``steady_state_recompile`` probe never trips.

- **Per-phase device-time attribution**: sampled phases (every
  ``round(1/devprof.sample_rate)``-th of each phase) record a pair of
  ``torch.cuda.Event`` around the phase's work and read their
  ``elapsed_time`` — the device's own clock — into
  ``devprof_device_seconds_{prefill|decode|spec_verify|promote|sample}``
  counters, plus a host-vs-device gap gauge (the wait from the host's
  return to the end event's completion).  On the CPU the phase's wall
  time stands in (the work is synchronous there).

- **Roofline accounting**: the engine registers each sweep site's FLOPs
  and bytes from the shapes (:func:`~deepspeed_tpu_torch.profiler.
  transformer_decode_flops`, the weight and KV bytes a step reads) where
  the JAX engine reads XLA's cost analysis; the sentinel wrappers
  accumulate them per dispatch and :meth:`DevProf.tick` turns the counter
  deltas into live MFU/MBU gauges against
  :func:`~deepspeed_tpu_torch.timers.device_peak_flops` /
  :func:`~deepspeed_tpu_torch.timers.device_peak_bandwidth`.

On-demand device traces: ``/profilez?capture_s=`` runs a bounded
``torch.profiler`` capture (a Chrome trace) under ``tracing.dump_dir``;
the capture reference and the compile ledger ride incident bundles.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch.config import DevprofConfig, temp_path
from deepspeed_tpu_torch.timers import (device_peak_bandwidth,
                                        device_peak_flops)

# ------------------------------------------------------ phase vocabulary
# The canonical phase names every surface agrees on: the sampled
# device-time counters, the record_function labels telemetry.span()
# emits (so on-demand torch.profiler captures show the same words), and
# trace_report's device-time column.
PHASES = ("prefill", "decode", "spec_verify", "promote", "sample")

# span/metric-name aliases → canonical phase (telemetry.span() maps its
# record_function label through this, so a capture's annotations and
# the sampled attribution agree; unknown names pass through unchanged)
PHASE_ALIASES = {
    "serving_step": "decode",
    "serving_decode": "decode",
    "decode_chunk": "decode",
    "serving_prefill": "prefill",
    "chunk_prefill": "prefill",
    "prefill_chunk": "prefill",
    "spec_verify_sweep": "spec_verify",
    "verify": "spec_verify",
    "kv_promote": "promote",
    "tier_promote": "promote",
    "boundary_sample": "sample",
    "sample_rows": "sample",
}


def canonical_phase(name: str) -> str:
    """Map a span/site name onto the devprof phase vocabulary (identity
    for already-canonical or unknown names)."""
    if name in PHASES:
        return name
    return PHASE_ALIASES.get(name, name)


# default phase each sentinel site's dispatches attribute to
SITE_PHASES = {
    "prefill": "prefill",
    "chunk_prefill": "prefill",
    "decode_chunk": "decode",
    "spec_verify": "spec_verify",
}

# ------------------------------------------------------- compile ledger
class CompileLedger:
    """Append-only (bounded) record of every attributed compile (in the
    port: a load of the kernel library): which call site, when, warmup or
    steady-state, and its duration.  Thread-safe; snapshot() is what incident
    bundles and /statusz carry."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._entries: "collections.deque" = collections.deque(
            maxlen=int(capacity))
        self.warmup = 0
        self.steady = 0

    def record(self, site: str, steady: bool, n: int = 1,
               duration_s: Optional[float] = None) -> Dict[str, Any]:
        entry = {
            "site": str(site),
            "t": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "t_monotonic": round(time.monotonic(), 3),
            "phase": "steady" if steady else "warmup",
            "n": int(n),
            "duration_s": (round(float(duration_s), 6)
                           if duration_s is not None else None),
        }
        with self._lock:
            self._entries.append(entry)
            if steady:
                self.steady += n
            else:
                self.warmup += n
        return entry

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "warmup_compiles": self.warmup,
                "steady_state_compiles": self.steady,
                "entries": list(self._entries),
            }


# ----------------------------------------------------- sentinel wrapper
class _SentinelFn:
    """Counting wrapper around one sweep program: accumulates the site's
    registered flops/bytes per dispatch (the JAX wrapper also watches
    jit's cache for compiles; the port compiles nothing at call time)."""

    __slots__ = ("jfn", "site", "_dp")

    def __init__(self, jfn, site: str, dp: "DevProf"):
        self.jfn = jfn
        self.site = str(site)
        self._dp = dp

    # dstpu: hot-path
    def __call__(self, *a, **kw):
        out = self.jfn(*a, **kw)
        self._dp.on_dispatch(self.site)
        return out


# --------------------------------------------------------------- devprof
class DevProf:
    """One engine's device-truth profiler (single-writer: every mutator
    runs on the engine thread except :meth:`profilez`, which the HTTP
    thread serializes through ``_capture_lock``)."""

    def __init__(self, cfg: DevprofConfig, *, registry, tracer=None,
                 dump_dir: str = temp_path("dstpu_flight"),
                 clock=time.perf_counter, device=None):
        self.cfg = cfg
        self.enabled = bool(cfg.enabled)
        self.registry = registry
        self.tracer = tracer
        self.dump_dir = str(dump_dir)
        self._clock = clock
        self.ledger = CompileLedger()
        self.steady = False
        self._steady_t: Optional[float] = None
        self._capture_lock = threading.Lock()
        self.captures: List[Dict[str, Any]] = []
        self.device = torch.device(device) if device is not None \
            else torch.device("cuda")
        # no compile source: the ledger reports zero
        self.monitoring = False
        r = registry
        self._c_comp_warm = r.counter(
            "devprof_compiles_warmup",
            "compiles attributed before the first token of the first "
            "request (none in the port: it has no jit)")
        self._c_comp_steady = r.counter(
            "devprof_compiles_steady",
            "compiles attributed AFTER steady state began — each one is "
            "a contract violation and trips a steady_state_recompile "
            "incident (none in the port: it has no jit)")
        self._c_dev = {
            "prefill": r.counter(
                "devprof_device_seconds_prefill",
                "sampled device seconds of prefill phases (CUDA-event "
                "elapsed time on the devprof.sample_rate cadence)"),
            "decode": r.counter(
                "devprof_device_seconds_decode",
                "sampled device-completion seconds of decode-chunk "
                "dispatches"),
            "spec_verify": r.counter(
                "devprof_device_seconds_spec_verify",
                "sampled device-completion seconds of speculative "
                "verify sweeps"),
            "promote": r.counter(
                "devprof_device_seconds_promote",
                "sampled device-completion seconds of KV-tier promote "
                "scatters"),
            "sample": r.counter(
                "devprof_device_seconds_sample",
                "sampled device-completion seconds of batched "
                "boundary-sampling fetches"),
        }
        self._c_sampled = r.counter(
            "devprof_sampled_dispatches",
            "phases that paid the sampled end-event sync "
            "(the devprof.sample_rate numerator)")
        self._g_gap = r.gauge(
            "devprof_host_device_gap_seconds",
            "EWMA of device-completion wait observed AFTER the host "
            "dispatch returned — how far the async dispatch queue "
            "runs ahead of the host clock (why host timings lie)")
        self._g_mfu = r.gauge(
            "devprof_mfu",
            "model flops utilization: registered flops dispatched "
            "per wall second / device peak flops")
        self._g_mbu = r.gauge(
            "devprof_mbu",
            "memory bandwidth utilization: registered bytes "
            "accessed per wall second / device peak HBM bandwidth")
        self._c_flops = r.counter(
            "devprof_flops_total",
            "registered flops dispatched (per-site count from the "
            "shapes x dispatch count — the MFU numerator)")
        self._c_bytes = r.counter(
            "devprof_bytes_total",
            "registered bytes accessed (per-site count from the "
            "shapes x dispatch count — the MBU numerator)")
        # deterministic per-phase stride: every round(1/rate)-th
        # dispatch pays the sync — no RNG on the hot path
        self._stride = (int(round(1.0 / cfg.sample_rate))
                        if cfg.sample_rate > 0 else 0)
        self._phase_n = {p: 0 for p in PHASES}
        self._costs: Dict[str, Dict[str, float]] = {}
        self._gap_ewma: Optional[float] = None
        # roofline tick state (counter deltas over wall intervals)
        self._tick_t: Optional[float] = None
        self._tick_flops = 0.0
        self._tick_bytes = 0.0
        self._probe_seen = 0            # incident-probe cursor
        self.peak_flops = device_peak_flops(self.device)
        self.peak_bw = device_peak_bandwidth(self.device)

    # --------------------------------------------------------- wiring
    def wrap(self, site: str, jfn):
        """Sentinel-wrap one compiled program (identity for None)."""
        if jfn is None:
            return None
        return _SentinelFn(jfn, site, self)

    def register_cost(self, site: str, flops: float,
                      bytes_accessed: float) -> None:
        self._costs[str(site)] = {"flops": float(flops),
                                  "bytes_accessed": float(bytes_accessed)}

    # ------------------------------------------------------- sentinel
    def mark_steady(self) -> None:
        """Flip warmup → steady state (the engine calls this at the
        first token of the first request).  From here every attributed
        compile is a contract violation."""
        if not self.steady:
            self.steady = True
            self._steady_t = time.monotonic()

    def on_compile(self, site: str, n: int = 1,
                   duration_s: Optional[float] = None) -> None:
        """``n`` fresh compiles at ``site``: ledger + counters + a
        ``kernel_build`` event on its own Chrome track (steady-state ones
        are flagged).  JAX's sentinels call it; nothing in the port does,
        as it has no jit."""
        entry = self.ledger.record(site, self.steady, n, duration_s)
        if self.steady:
            self._c_comp_steady.inc(n)
        else:
            self._c_comp_warm.inc(n)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event("kernel_build", attrs={
                "site": site, "n": n,
                "steady": self.steady,
                "duration_s": entry["duration_s"]})

    # dstpu: hot-path
    def on_dispatch(self, site: str) -> None:
        """Per-dispatch roofline accounting: add the site's registered
        flops/bytes to the counters (two float
        adds; uncosted sites cost one dict miss)."""
        c = self._costs.get(site)
        if c is not None:
            self._c_flops.inc(c["flops"])
            self._c_bytes.inc(c["bytes_accessed"])

    # ------------------------------------------------------- sampling
    # dstpu: hot-path
    def should_sample(self, phase: str) -> bool:
        """Deterministic stride gate: True on every
        ``round(1/sample_rate)``-th dispatch of ``phase``."""
        if self._stride == 0:
            return False
        n = self._phase_n[phase] + 1
        self._phase_n[phase] = n
        return n % self._stride == 0

    # dstpu: hot-path
    def begin(self, phase: str):
        """Open a sampled phase (None when this one is not sampled): the
        start event is recorded on the current stream before the phase's
        work is enqueued."""
        if not self.should_sample(phase):
            return None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return phase, ev, self._clock()
        return phase, None, self._clock()

    # dstpu: hot-path
    def end(self, token) -> float:
        """Close a sampled phase: record the end event, wait for it, and
        record the events' elapsed time (the span on the device's clock,
        idle gaps between the phase's kernels included) and the wait (the
        host-vs-device gap).  Returns the device seconds."""
        if token is None:
            return 0.0
        phase, start, t0 = token
        if start is None:                 # the CPU: the work was synchronous
            dt = self._clock() - t0
            self.record_device(phase, dt, gap=0.0)
            return dt
        stop = torch.cuda.Event(enable_timing=True)
        stop.record()
        t1 = self._clock()
        # dstpu: host-sync-ok: sampled devprof attribution — one event
        # wait per round(1/sample_rate) phases, the module's documented
        # measurement sync
        stop.synchronize()
        gap = self._clock() - t1
        dt = start.elapsed_time(stop) / 1e3
        self.record_device(phase, dt, gap=gap)
        return dt

    # dstpu: hot-path
    def record_device(self, phase: str, dev_s: float,
                      gap: Optional[float] = None) -> None:
        """Record an already-measured device-time sample (sites whose
        existing host sync brackets the device work — the boundary
        sample fetch — time themselves and report here)."""
        self._c_dev[phase].inc(dev_s)
        self._c_sampled.inc()
        if gap is not None:
            e = self._gap_ewma
            self._gap_ewma = gap if e is None else 0.8 * e + 0.2 * gap
            self._g_gap.set(self._gap_ewma)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.event("devprof_sample", attrs={
                "devprof_phase": phase, "dev_s": round(dev_s, 6)})

    # ------------------------------------------------------- roofline
    def tick(self, now: Optional[float] = None) -> None:
        """Exporter tick hook: turn flops/bytes counter deltas over
        the wall interval into live MFU/MBU gauges.  Rate-limited
        internally (~2/s) so the exporter-less inline path can call it
        every step without shrinking dt toward noise."""
        now = time.monotonic() if now is None else now
        if self._tick_t is not None and now - self._tick_t < 0.5:
            return
        f, b = self._c_flops.value, self._c_bytes.value
        if self._tick_t is not None:
            dt = now - self._tick_t
            if dt > 0:
                self._g_mfu.set((f - self._tick_flops) / dt /
                                self.peak_flops)
                self._g_mbu.set((b - self._tick_bytes) / dt /
                                self.peak_bw)
        self._tick_t, self._tick_flops, self._tick_bytes = now, f, b

    # -------------------------------------------------------- capture
    def capture(self, duration_s: float) -> Dict[str, Any]:
        """On-demand ``torch.profiler`` trace under ``dump_dir`` (a Chrome
        trace of the CPU ops and, on the card, the CUDA kernels),
        capped at ``cfg.capture_max_s``.  Serialized: a second capture
        request while one runs returns an error instead of corrupting
        the profiler session."""
        d = min(float(duration_s), self.cfg.capture_max_s)
        if d <= 0:
            return {"error": "capture_s must be positive"}
        # dstpu: lock-ok: non-blocking try-acquire — a concurrent
        # capture request must get an error, never queue behind a
        # running profiler session (with-scoping cannot express this)
        if not self._capture_lock.acquire(blocking=False):
            return {"error": "a capture is already running"}
        try:
            path = os.path.join(
                self.dump_dir,
                f"devprof_capture_{os.getpid()}_"
                f"{len(self.captures) + 1}")
            os.makedirs(path, exist_ok=True)
            t0 = time.monotonic()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            try:
                time.sleep(d)
            finally:
                prof.__exit__(None, None, None)
            trace = os.path.join(path, "trace.json")
            prof.export_chrome_trace(trace)
            ref = {
                "path": path,
                "trace": trace,
                "t": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "requested_s": round(float(duration_s), 3),
                "captured_s": round(time.monotonic() - t0, 3),
            }
            self.captures.append(ref)
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.event("profile_capture", attrs=dict(ref))
            return ref
        except Exception as e:
            return {"error": repr(e)}
        finally:
            self._capture_lock.release()

    def profilez(self, capture_s=None) -> Dict[str, Any]:
        """The ``/profilez`` provider: without ``capture_s`` return
        the devprof status block; with it run a bounded device-trace
        capture and return its reference."""
        if capture_s is None:
            return self.statusz_block()
        try:
            d = float(capture_s)
        except (TypeError, ValueError):
            return {"error": f"invalid capture_s {capture_s!r}"}
        # copy before annotating: capture() stored the same ref dict in
        # self.captures, and the status block embeds that list — adding
        # the block to the ORIGINAL would make the document circular
        out = dict(self.capture(d))
        out["devprof"] = self.statusz_block()
        return out

    # ----------------------------------------------------------- read
    def statusz_block(self) -> Dict[str, Any]:
        led = self.ledger.snapshot()
        dev = {p: round(float(self._c_dev[p].value), 6) for p in PHASES}
        return {
            "enabled": True,
            "steady": self.steady,
            "monitoring": self.monitoring,
            "sample_rate": self.cfg.sample_rate,
            "compiles_warmup": led["warmup_compiles"],
            "compiles_steady": led["steady_state_compiles"],
            "device_seconds": dev,
            "host_device_gap_s": (round(self._gap_ewma, 6)
                                  if self._gap_ewma is not None
                                  else None),
            "mfu": round(float(self._g_mfu.value), 6),
            "mbu": round(float(self._g_mbu.value), 6),
            "flops_total": float(self._c_flops.value),
            "bytes_total": float(self._c_bytes.value),
            "peak_flops": self.peak_flops,
            "peak_hbm_bw": self.peak_bw,
            "cost_sites": {k: dict(v) for k, v in self._costs.items()},
            "captures": list(self.captures)[-4:],
        }

    def bundle_info(self) -> Dict[str, Any]:
        """What incident bundles attach: the full compile ledger plus
        recent capture references."""
        return {
            "compile_ledger": self.ledger.snapshot(),
            "captures": list(self.captures)[-4:],
        }

    def incident_probe(self):
        """IncidentManager probe: trip once per NEW steady-state
        compile batch (cursor-based — warmup compiles never trip)."""
        n = self.ledger.steady
        if n > self._probe_seen:
            fresh = n - self._probe_seen
            self._probe_seen = n
            led = self.ledger.snapshot()
            return "steady_state_recompile", {
                "phase": "steady_state_recompile",
                "new_compiles": fresh,
                "steady_state_compiles": n,
                "recent": led["entries"][-4:],
            }
        return None


class _NullDevProf:
    """Shared no-op stand-in when the block is off: wrap() is the
    identity, every gate is False, every read surface is the disabled
    block."""

    enabled = False
    steady = False
    monitoring = False
    captures: List[Dict[str, Any]] = []

    def wrap(self, site, jfn):
        return jfn

    def register_cost(self, site, flops, bytes_accessed):
        pass

    def mark_steady(self):
        pass

    def on_compile(self, site, n=1, duration_s=None):
        pass

    def on_dispatch(self, site):
        pass

    def should_sample(self, phase):
        return False

    def begin(self, phase):
        return None

    def end(self, token):
        return 0.0

    def record_device(self, phase, dev_s, gap=None):
        pass

    def tick(self, now=None):
        pass

    def capture(self, duration_s):
        return {"error": "devprof disabled"}

    def profilez(self, capture_s=None):
        return {"enabled": False}

    def statusz_block(self):
        return {"enabled": False}

    def bundle_info(self):
        return {}

    def incident_probe(self):
        return None


NULL_DEVPROF = _NullDevProf()
