"""The serving engine's control plane (port of the control-plane half of
``deepspeed_tpu/inference/serving.py``'s ``ServingEngine``).

:class:`ControlPlane` is a mixin of
:class:`~deepspeed_tpu_torch.inference.serving.ServingEngine`: it wires the
blocks of the JAX constructor — the telemetry registry and its exporter,
per-request tracing with the flight recorder, devprof, the SLO tracker,
the seeded fault plan, load shedding, metric history and incidents — and
holds the engine's robustness and introspection surface: typed sheds
(:meth:`_shed`, :meth:`_shed_expired`), per-request failure isolation
(:meth:`_record_failure`, :meth:`_fail_slot`), the fleet handoff hooks
(:meth:`take_queued`, :meth:`abandon_inflight`), :meth:`attach_watchdog`,
and the ``/statusz``, ``/healthz``, ``/requestz``, ``/historyz`` and
``/profilez`` documents.  As in the JAX engine, ``telemetry`` and
``tracing`` are on by default (a live registry and flight recorder, no
sinks); every other block is off by default and then costs one bool test
per hook, and a disabled registry or tracer is a shared no-op singleton.

The scheduler itself (admission, prefill, decode, the KV tier) stays in
``serving.py``; its hooks call into the objects built here.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch import faults as faults_mod
from deepspeed_tpu_torch.config import (DevprofConfig, FaultsConfig,
                                        HistoryConfig, IncidentsConfig,
                                        SLOConfig, TelemetryConfig,
                                        TracingConfig)
from deepspeed_tpu_torch.devprof import NULL_DEVPROF, DevProf
from deepspeed_tpu_torch.faults import FaultPlan
from deepspeed_tpu_torch.history import NULL_HISTORY, MetricHistory
from deepspeed_tpu_torch.incidents import NULL_INCIDENTS, IncidentManager
from deepspeed_tpu_torch.obs_wire import tracez_provider, wire_stamp
from deepspeed_tpu_torch.request_trace import (BoundTracer, RequestTracer,
                                               event_to_dict)
from deepspeed_tpu_torch.slo import NULL_SLO_TRACKER, SLOTracker
from deepspeed_tpu_torch.telemetry import (LATENCY_BUCKETS_S,
                                           MetricsRegistry,
                                           TelemetryExporter)

logger = logging.getLogger(__name__)

# /healthz reports "load_shedding_active" for this long after a shed
_SHED_ACTIVE_WINDOW_S = 30.0

def _weak(bound):
    """``bound`` (a bound method of the engine) as a callable that does not
    keep the engine alive: the exporter, the incident manager and a
    watchdog hold these, and the engine holds them, so a strong reference
    would make a cycle that keeps a dropped engine's weights and KV pool on
    the card until the cycle collector runs.  After the engine is gone the
    callable returns ``{}``."""
    ref = weakref.WeakMethod(bound)

    def call(*args, **kwargs):
        fn = ref()
        return {} if fn is None else fn(*args, **kwargs)

    return call


def _req_key(req_id: Any) -> str:
    """Canonical string form of a request id: ``/requestz?id=`` arrives as
    text, so matching happens in string space."""
    return str(req_id)


class ControlPlane:
    """Mixin: the control-plane blocks of a serving engine (see the module
    docstring).  The host engine provides ``slots``, ``queue``,
    ``finished``, ``allocator``, ``_table_host``, ``trash_page`` and the
    slot-release methods."""

    def _init_control_plane(self, *, telemetry=None, tracing=None,
                            slo=None, faults=None, shed_queue_depth=0,
                            shed_expired_deadline=False, history=None,
                            incidents=None, devprof=None,
                            replica_id=None) -> None:
        # ---- telemetry: one registry for every hot-path metric;
        # ``telemetry`` accepts None/bool/dict/TelemetryConfig — or an
        # existing MetricsRegistry to share one across engines
        if isinstance(telemetry, MetricsRegistry):
            self.registry = telemetry
            tcfg = None                    # the caller owns the sinks
        else:
            tcfg = TelemetryConfig.coerce(telemetry)
            self.registry = MetricsRegistry(enabled=tcfg.enabled)
        self._tel_on = self.registry.enabled
        r = self.registry
        self._c_admitted = r.counter(
            "serving_admitted_requests", "requests admitted to a slot")
        self._c_preempted = r.counter(
            "serving_preempted_requests",
            "recompute preemptions under page pressure")
        self._c_decode_steps = r.counter(
            "serving_decode_steps", "batched decode steps (tokens/slot)")
        self._c_decode_syncs = r.counter(
            "serving_decode_syncs", "device->host token syncs")
        self._c_prefill_chunks = r.counter(
            "serving_prefill_chunks", "split-fuse prompt chunks absorbed")
        self._g_queue = r.gauge(
            "serving_queue_depth", "requests waiting for a slot")
        self._g_occupancy = r.gauge(
            "serving_batch_occupancy",
            "fraction of decode slots active this step")
        self._g_kv_util = r.gauge(
            "serving_kv_page_utilization",
            "fraction of the usable KV page pool referenced by live "
            "sequences (warm cached pages count as reclaimable)")
        self._c_admit_skips = r.counter(
            "serving_admit_skips",
            "queue entries skipped over by admission lookahead")
        self._c_pc_hits = r.counter(
            "prefix_cache_hits", "admissions that matched >= 1 cached page")
        self._c_pc_misses = r.counter(
            "prefix_cache_misses", "admissions with no cached prefix")
        self._c_pc_cached_tokens = r.counter(
            "prefix_cache_cached_tokens",
            "prompt tokens served from cached pages")
        self._c_pc_prompt_tokens = r.counter(
            "prefix_cache_prompt_tokens", "prompt tokens admitted")
        self._c_pc_evicted = r.counter(
            "prefix_cache_evicted_pages",
            "cached pages reclaimed (allocation pressure or pool cap)")
        self._g_pc_pool = r.gauge(
            "prefix_cache_pool_pages",
            "refcount-0 cached pages held warm in the pool")
        self._g_pc_frac = r.gauge(
            "prefix_cache_cached_token_fraction",
            "cumulative cached / admitted prompt tokens")
        self._evicted_seen = 0
        self._c_boundary_syncs = r.counter(
            "serving_boundary_syncs",
            "batched prefill-boundary sampling syncs")
        self._c_spec_drafted = r.counter(
            "spec_drafted_tokens",
            "draft tokens proposed across verify sweeps")
        self._c_spec_accepted = r.counter(
            "spec_accepted_tokens", "draft tokens accepted by verify")
        self._c_spec_rejected = r.counter(
            "spec_rejected_tokens",
            "draft tokens rejected (KV frontier rolled back past them)")
        self._c_spec_sweeps = r.counter(
            "spec_verify_sweeps", "batched draft-and-verify sweeps")
        self._c_spec_slots = r.counter(
            "spec_verify_slots", "slot-sweeps verified")
        self._c_spec_emitted = r.counter(
            "spec_emitted_tokens",
            "tokens emitted by verify sweeps (accepted + bonus)")
        self._h_ttft = r.histogram(
            "serving_ttft_seconds",
            "submit -> first generated token", LATENCY_BUCKETS_S)
        self._h_itl = r.histogram(
            "serving_inter_token_seconds",
            "gap between consecutive tokens of one request as a client "
            "sees them", LATENCY_BUCKETS_S)
        self._h_step_span = r.histogram(
            "serving_step_seconds",
            "scheduler iteration wall time (admit -> decode sync)")
        self._span_label = f"{r.namespace}/serving_step"
        hcfg = HistoryConfig.coerce(history)
        icfg = IncidentsConfig.coerce(incidents)
        if hcfg.enabled and not self._tel_on:
            raise ValueError(
                "history needs the telemetry block — the rings sample "
                "the metrics registry; enable telemetry (or drop the "
                "history block)")
        if icfg.enabled and not (
                tracing.enabled
                if isinstance(tracing, (RequestTracer, BoundTracer))
                else TracingConfig.coerce(tracing).enabled):
            raise ValueError(
                "incidents needs the tracing block — the trigger "
                "events (slo_burn_alert, kv_promote_failed, replica "
                "failover, rollbacks) live in the flight recorder; "
                "enable tracing (or drop the incidents block)")
        dcfg = DevprofConfig.coerce(devprof)
        if dcfg.enabled and not self._tel_on:
            raise ValueError(
                "devprof needs the telemetry block — the compile "
                "sentinel, device-time and roofline surfaces are "
                "registry metrics; enable telemetry (or drop the "
                "devprof block)")
        self.history_cfg = hcfg
        self.incidents_cfg = icfg
        self.devprof_cfg = dcfg
        # ---- robustness arguments, validated before the exporter below
        # binds a port (a raise after it would leak the server thread)
        self.shed_queue_depth = int(shed_queue_depth)
        if self.shed_queue_depth < 0:
            raise ValueError(
                f"shed_queue_depth must be >= 0 (0 = off), got "
                f"{shed_queue_depth}")
        self._shed_deadline = bool(shed_expired_deadline)
        self.slo_cfg = SLOConfig.coerce(slo)
        if self._shed_deadline and not self.slo_cfg.enabled:
            raise ValueError(
                "shed_expired_deadline needs the slo block — deadlines "
                "are per-tier SLO objectives; without it there is "
                "nothing to shed against")
        if isinstance(faults, FaultPlan):
            fcfg = FaultsConfig(enabled=True)
            self._fault_plan: Optional[FaultPlan] = faults
        else:
            fcfg = FaultsConfig.coerce(faults)
            self._fault_plan = (FaultPlan.from_config(fcfg)
                                if fcfg.enabled else None)
        self.faults_cfg = fcfg
        self._tel_exporter = None
        if tcfg is not None and self._tel_on and (
                tcfg.prometheus_path or tcfg.http_port is not None
                or hcfg.enabled or icfg.enabled):
            self._tel_exporter = TelemetryExporter(
                self.registry, prometheus_path=tcfg.prometheus_path,
                interval_s=tcfg.interval_s, http_port=tcfg.http_port)

        # ---- per-request tracing: every lifecycle edge lands in the
        # flight recorder (queued -> admitted -> prefill_chunk ->
        # first_token -> decode_batch -> preempt/requeue -> finish)
        if isinstance(tracing, (RequestTracer, BoundTracer)):
            self.tracer = tracing
        else:
            self.tracer = RequestTracer.from_config(
                TracingConfig.coerce(tracing))
        self.replica_id = None if replica_id is None else str(replica_id)
        if self.replica_id is not None:
            self.tracer = self.tracer.bind(replica=self.replica_id)
        self._trace_on = self.tracer.enabled

        # ---- device-truth observability: sampled phases timed by CUDA
        # events, an empty compile ledger (no jit), and the decode site's
        # FLOPs / bytes from the shapes for MFU / MBU
        self.devprof = (
            DevProf(dcfg, registry=self.registry, tracer=self.tracer,
                    dump_dir=getattr(self.tracer, "dump_dir",
                                     TracingConfig().dump_dir),
                    device=self.device)
            if dcfg.enabled else NULL_DEVPROF)
        self._devprof_on = self.devprof.enabled
        if self._devprof_on:
            self._prefill = self.devprof.wrap("prefill", self._prefill)
            self._decode = self.devprof.wrap("decode_chunk", self._decode)
            if self._chunk_prefill is not None:
                self._chunk_prefill = self.devprof.wrap(
                    "chunk_prefill", self._chunk_prefill)
            if dcfg.cost_analysis and self._cost_dims is not None:
                flops, nbytes = self._shape_cost(*self._cost_dims)
                self.devprof.register_cost("decode_chunk", flops, nbytes)

        # ---- KV-tier and kernel-dispatch metrics
        self._c_kvt_deferrals = r.counter(
            "kv_tier_promote_deferrals",
            "scheduler iterations a promoting slot's prefill stood aside")
        self._c_kvt_admit_waits = r.counter(
            "kv_tier_admit_waits",
            "admission attempts held back by the busy NVMe channel")
        self._c_kvt_qres_promotes = r.counter(
            "kv_tier_quant_resident_promotes",
            "tier promotions published as int8-resident pages")
        self._g_kvt_inflight = r.gauge(
            "kv_tier_promoting_pages",
            "pages with a tier promotion in flight right now")
        self._h_kvt_promote = r.histogram(
            "kv_tier_promote_seconds",
            "admission-submit -> pages-landed latency of one promotion")
        pk = self.kernels.paged_attention
        fs = "fused" if self.kernels.fused_sampling == "on" else "xla"
        self._c_kdisp_paged = r.counter(
            f"serving_kernel_dispatch_paged_{pk}",
            "decode sweeps dispatched under the resolved paged-attention "
            "policy")
        self._c_kdisp_sample = r.counter(
            f"serving_kernel_dispatch_sample_{fs}",
            "batched sampling dispatches under the resolved sampler")

        # ---- SLO & goodput accounting
        self.slo_tracker = (
            SLOTracker(self.slo_cfg, self.registry, tracer=self.tracer,
                       clock=time.perf_counter)
            if self.slo_cfg.enabled else NULL_SLO_TRACKER)
        self._slo_on = self.slo_tracker.enabled

        # ---- robustness: the fault plan installs process-wide for the
        # tier / aio hook points (the engine owns the install for its
        # lifetime; shutdown clears it)
        self._owns_fault_plan = faults_mod.ensure_installed(
            self._fault_plan)
        self._c_shed = r.counter(
            "serving_shed_requests",
            "requests rejected at admission by load shedding "
            "(queue-depth or expired-deadline; typed RequestShed)")
        self._c_failed = r.counter(
            "serving_failed_requests",
            "requests failed by a slot/admission exception and released "
            "in isolation (typed RequestFailed; the engine kept serving)")
        self._c_kvt_checksum = r.counter(
            "kv_tier_checksum_failures",
            "promotions that hit a spilled-page checksum mismatch")
        self._c_kvt_fb_events = r.counter(
            "kv_tier_fallback_events",
            "promotions abandoned after an unrecoverable tier read / "
            "checksum failure — the span fell back to re-prefill")
        self._c_kvt_fb_pages = r.counter(
            "kv_tier_fallback_pages",
            "pages whose content was re-prefilled instead of promoted")
        # host-side ints mirror the counters so /statusz and the
        # reconciliation work with telemetry disabled
        self._n_submitted = 0       # arrivals (queued + shed)
        self._n_shed = 0
        self._n_failed = 0
        self._shed_by_reason: Dict[str, int] = {"queue_depth": 0,
                                                "deadline": 0}
        self._last_shed_t: Optional[float] = None

        # ---- time-series history + incident capture
        self.history = (MetricHistory(hcfg, self.registry)
                        if hcfg.enabled else NULL_HISTORY)
        if icfg.enabled:
            detect = icfg.detect if icfg.detect is not None else (
                ("serving_ttft_seconds:p95",)
                + tuple(f"slo_{t}_goodput_tokens_per_s"
                        for t in self.slo_tracker.tiers))
            icfg = dataclasses.replace(icfg, detect=tuple(detect))
            self.incidents_cfg = icfg
            self.incident_mgr = IncidentManager(
                icfg, registry=self.registry, tracer=self.tracer,
                history=self.history if self.history.enabled else None,
                statusz_fn=_weak(self.statusz),
                source=self.replica_id or "engine")
        else:
            self.incident_mgr = NULL_INCIDENTS
        if self._devprof_on and self.incident_mgr.enabled:
            self.incident_mgr.add_probe(self.devprof.incident_probe)
            self.incident_mgr.add_attachment("devprof",
                                             self.devprof.bundle_info)
        # shared timed pass: SLO window refresh + history sampling +
        # incident evaluation ride one exporter tick-hook walk
        self._slo_tick_hooked = False
        self._tick_inline = (self._tel_exporter is None and
                             (self.history.enabled
                              or self.incident_mgr.enabled
                              or self._devprof_on))
        ex = self._tel_exporter
        if ex is not None:
            if self._slo_on:
                tracker = self.slo_tracker
                ex.register_tick_hook(
                    lambda now: tracker.maybe_refresh(),
                    interval_s=1.0, name="slo_refresh")
                self._slo_tick_hooked = True
            if self.history.enabled:
                ex.register_tick_hook(
                    self.history.maybe_sample,
                    interval_s=hcfg.sample_interval_s,
                    name="history_sample")
            if self.incident_mgr.enabled:
                ex.register_tick_hook(
                    self.incident_mgr.maybe_evaluate,
                    interval_s=icfg.eval_interval_s,
                    name="incident_evaluate")
            if self._devprof_on:
                ex.register_tick_hook(self.devprof.tick, interval_s=1.0,
                                      name="devprof_roofline")
        # ---- introspection endpoints ride the telemetry HTTP server
        self._t_start = time.perf_counter()
        self._last_step_t: Optional[float] = None
        self._watchdog = None
        if ex is not None:
            ex.register_provider("statusz", _weak(self.statusz))
            ex.register_provider("healthz", _weak(self.healthz))
            ex.register_provider("requestz", _weak(self.requestz))
            if self.history.enabled or self.incident_mgr.enabled:
                ex.register_provider("historyz", _weak(self.historyz))
            if self._devprof_on:
                ex.register_provider("profilez", _weak(self.profilez))
            if self._trace_on:
                # /tracez?since= — incremental flight-recorder drain for
                # the remote scrape plane (obs_wire)
                ex.register_provider("tracez", tracez_provider(
                    self.tracer.recorder, replica=self.replica_id))

    # ------------------------------------------------------------ the step
    def _step_control(self, inner) -> None:
        """Run one scheduler iteration ``inner`` inside the control plane:
        the step span, the exporter tick (or the inline history /
        incident / roofline pass) and the SLO window refresh."""
        self._last_step_t = time.perf_counter()   # /healthz heartbeat
        if self._tel_on:
            from deepspeed_tpu_torch.telemetry import Span

            with Span(self._h_step_span, self._span_label):
                inner()
            if self._tel_exporter is not None:
                self._tel_exporter.maybe_export()
            elif self._tick_inline:
                now = time.monotonic()
                self.history.maybe_sample(now)
                self.incident_mgr.maybe_evaluate(now)
                self.devprof.tick(now)
        else:
            inner()
            if self._tick_inline:
                self.incident_mgr.maybe_evaluate()
        if self._slo_on and not self._slo_tick_hooked:
            self.slo_tracker.maybe_refresh()

    def _step_gauges(self, active) -> None:
        """Per-step gauges (telemetry on): queue depth, occupancy, KV
        utilization and the prefix-cache pool."""
        self._g_queue.set(len(self.queue))
        self._g_occupancy.set(len(active) / self.max_batch)
        usable = self.trash_page
        self._g_kv_util.set(
            (usable - self.allocator.available) / max(usable, 1))
        if self._pc_on:
            ev = self.allocator.evicted
            if ev > self._evicted_seen:
                self._c_pc_evicted.inc(ev - self._evicted_seen)
                self._evicted_seen = ev
            self._g_pc_pool.set(len(self.allocator.pool))
            pt = self._c_pc_prompt_tokens.value
            if pt:
                self._g_pc_frac.set(self._c_pc_cached_tokens.value / pt)

    def _inject_slot(self, req_id) -> None:
        """The ``slot`` fault hook: one opportunity per slot per step."""
        if self._fault_plan is not None:
            faults_mod.inject("slot", key=req_id)

    # ------------------------------------- robustness: shed / fail / leaks
    def _shed(self, req_id, tier: Optional[str], reason: str):
        """Record a typed admission rejection: per-tier SLO shed
        accounting, telemetry, trace event, and the degraded-state clock
        /healthz reads.  Nothing about the request ran."""
        from deepspeed_tpu_torch.inference.serving import RequestShed

        self.slo_tracker.on_shed(req_id, tier)
        res = RequestShed(req_id, reason, tier)
        self.finished[req_id] = res
        self._c_shed.inc()
        self._n_shed += 1
        self._shed_by_reason[reason] = \
            self._shed_by_reason.get(reason, 0) + 1
        self._last_shed_t = time.perf_counter()
        if self._trace_on:
            self.tracer.event("request_shed", req_id, attrs={
                "reason": reason, "tier": tier,
                "queue_depth": len(self.queue)})
        self._g_queue.set(len(self.queue))
        return res

    def _shed_expired(self) -> None:
        """Deadline shedding at admission: drop queued requests whose SLO
        deadline already expired.  Runs once per step before admission."""
        now = time.perf_counter()
        kept = []
        shed = False
        for r in self.queue:
            obj = self.slo_cfg.tiers.get(r.tier or self.slo_cfg.default_tier)
            dl = obj.deadline_s if obj is not None else None
            if dl is not None and now - r.t_arrival > dl:
                self._shed(r.req_id, r.tier, "deadline")
                self._newly_finished.append(r.req_id)
                shed = True
            else:
                kept.append(r)
        if shed:
            self.queue = collections.deque(kept)

    def _record_failure(self, req, reason: str, exc: BaseException,
                        b: int = -1, generated: int = 0) -> None:
        """One failure ledger for the slot and admission paths: typed
        result, telemetry counter, SLO lifetime and trace event."""
        from deepspeed_tpu_torch.inference.serving import RequestFailed

        self._c_failed.inc()
        self._n_failed += 1
        self.slo_tracker.on_fail(req.req_id)
        self.finished[req.req_id] = RequestFailed(
            req.req_id, reason, repr(exc), req.tier, generated=generated)
        self._newly_finished.append(req.req_id)
        if self._trace_on:
            # always emitted (not sampling-gated): a failure is what the
            # flight recorder exists to explain
            self.tracer.event("request_failed", req.req_id, b, attrs={
                "error": repr(exc)[:200], "reason": reason,
                "generated": generated})

    def _fail_slot(self, b: int, exc: BaseException) -> None:
        """Per-request failure isolation: an exception in slot ``b``'s
        work fails THAT request — its promotion fenced and cancelled, its
        pages and copy-on-write refs released, its table row cleared and
        its pending boundary sample dropped — and the engine keeps
        serving the other slots (a typed :class:`RequestFailed`)."""
        s = self.slots[b]
        req = s.req
        # the message, not the exception: a handler that keeps records
        # would keep its traceback's frames, and so the engine, alive
        logger.warning(
            "serving: request %r failed in slot %d (%s) — releasing and "
            "continuing", req.req_id, b, str(exc))
        if s.promo is not None:
            try:
                self._cancel_promotion(s)
            except Exception:
                logger.exception(
                    "serving: promotion cancel during slot failure")
        self.allocator.release(s.seq_id)
        self._table_host[b, :] = self.trash_page
        self._table_dirty = self._lens_dirty = True
        self.slots[b] = None
        self._pending_boundary = [p for p in self._pending_boundary
                                  if p[0] != b]
        self._record_failure(req, "slot_exception", exc, b=b,
                             generated=len(s.generated))

    # ------------------------------------------- fleet handoff hooks
    def take_queued(self) -> list:
        """Pop and return every queued (not-yet-admitted) request — the
        drain/failover queue handoff.  Each request's SLO record is
        forgotten (the destination re-announces it; carry ``t_arrival``
        through ``submit(arrival=)``)."""
        taken, self.queue = list(self.queue), collections.deque()
        for r in taken:
            self.slo_tracker.forget(r.req_id)
        self._g_queue.set(0)
        if taken and self._trace_on:
            self.tracer.event("queue_handoff",
                              attrs={"requests": len(taken)})
        return taken

    def abandon_inflight(self) -> List[Tuple[Any, int]]:
        """Release every active slot WITHOUT finishing its request:
        promotions fenced and cancelled, pages / COW refs freed, pending
        boundary samples dropped, SLO records forgotten.  Returns
        ``[(request, tokens_generated)]``; leaves :meth:`check_leaks`
        clean."""
        out: List[Tuple[Any, int]] = []
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            if s.promo is not None:
                try:
                    self._cancel_promotion(s)
                except Exception:
                    logger.exception(
                        "serving: promotion cancel during abandon")
            self.allocator.release(s.seq_id)
            self._table_host[b, :] = self.trash_page
            self.slots[b] = None
            self.slo_tracker.forget(s.req.req_id)
            if self._trace_on:
                self.tracer.event("abandoned", s.req.req_id, b, attrs={
                    "generated": len(s.generated)})
            out.append((s.req, len(s.generated)))
        if out:
            self._table_dirty = self._lens_dirty = True
            self._pending_boundary = []
        return out

    # ------------------------------------------------------ introspection
    def attach_watchdog(self, watchdog) -> None:
        """Feed ``/healthz`` from a :class:`~deepspeed_tpu_torch.utils.
        watchdog.Watchdog`: readiness goes false the moment it fires; with
        incidents on, a fire is an incident class of its own (latched),
        captured from the watchdog thread before any abort."""
        self._watchdog = watchdog
        if self.incident_mgr.enabled:
            tripped = []

            def _wd_probe():
                if watchdog.fired and not tripped:
                    tripped.append(True)
                    return "watchdog", {"phase": "watchdog_fired",
                                        **watchdog.health()}
                return None

            self.incident_mgr.add_probe(_wd_probe)
            prev_timeout = watchdog.on_timeout
            mgr = self.incident_mgr

            def _on_timeout():
                try:
                    mgr.evaluate()
                except Exception:
                    pass        # never mask the watchdog's own path
                if prev_timeout is not None:
                    prev_timeout()

            watchdog.on_timeout = _on_timeout

    def mesh_info(self) -> Dict[str, Any]:
        """The /statusz ``mesh`` block: is this replica sharded, and over
        what (axis sizes and the ranks it spans)."""
        ms = self.mesh
        if ms is None:
            return {"sharded": False, "devices": 1, "axes": {},
                    "tp": 1, "ep": 1}
        axes = {a: int(s) for a, s in ms.sizes.items() if int(s) > 1}
        devices = 1
        for s in axes.values():
            devices *= s
        return {"sharded": any(s > 1 for s in axes.values()),
                "devices": devices, "axes": axes,
                "tp": int(ms.size("model")), "ep": int(ms.size("expert"))}

    def statusz(self) -> Dict[str, Any]:
        """Live machine-readable engine snapshot: per-slot state,
        in-flight requests with phase and age, KV / prefix-cache pool
        occupancy and fragmentation, speculation, SLO attainment per tier,
        robustness, and the full metrics snapshot.  Host bookkeeping only
        — no device sync, safe to poll."""
        now = time.perf_counter()
        slots: List[Dict[str, Any]] = []
        mapped_capacity = 0
        valid_tokens = 0
        for b, s in enumerate(self.slots):
            if s is None:
                slots.append({"slot": b, "state": "idle"})
                continue
            pages = int(np.sum(self._table_host[b] != self.trash_page))
            mapped_capacity += pages * self.page_size
            valid_tokens += self._valid_tokens(s)
            row: Dict[str, Any] = {
                "slot": b,
                "state": "prefill" if s.prefilling else "decode",
                "req": _req_key(s.req.req_id),
                "tier": s.req.tier,
                "prompt_tokens": len(s.req.tokens),
                "generated": len(s.generated),
                "max_new_tokens": s.req.max_new_tokens,
                "seq_len": s.seq_len,
                "pages": pages,
                "age_s": round(now - s.req.t_arrival, 3),
            }
            if s.prefilling:
                row["prefill_done"] = s.prefill_done
            slots.append(row)
        queue = [{"req": _req_key(r.req_id), "tier": r.tier,
                  "prompt_tokens": len(r.tokens),
                  "age_s": round(now - r.t_arrival, 3)}
                 for r in list(self.queue)[:32]]
        al = self.allocator
        usable = self.trash_page
        live = usable - al.available
        spec_slots = int(self._c_spec_slots.value)
        pt = int(self._c_pc_prompt_tokens.value)
        status: Dict[str, Any] = {
            "schema_version": 1,
            **wire_stamp(),
            "engine": type(self).__name__,
            "replica": self.replica_id,
            "weights_version": _req_key(getattr(self, "weights_version", 0)),
            "t": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "uptime_s": round(now - self._t_start, 3),
            "last_step_age_s": (round(now - self._last_step_t, 3)
                                if self._last_step_t is not None else None),
            "max_batch": self.max_batch,
            "active_slots": sum(1 for s in self.slots if s is not None),
            "slots": slots,
            "queue": {"depth": len(self.queue), "head": queue},
            "finished_pending_drain": len(self.finished),
            "kv": {
                "page_size": self.page_size,
                "pages_usable": usable,
                "pages_free": len(al.free),
                "pages_warm": len(al.pool),
                "pages_live": live,
                "utilization": round(live / max(usable, 1), 4),
                "fragmentation": round(
                    1.0 - valid_tokens / mapped_capacity, 4)
                if mapped_capacity else 0.0,
            },
            "prefix_cache": {
                "enabled": self._pc_on,
                "warm_pool_pages": len(al.pool),
                "published_lifetime": al.published,
                "evicted_lifetime": al.evicted,
                "admission_hits": int(self._c_pc_hits.value),
                "admission_misses": int(self._c_pc_misses.value),
                "token_hit_rate": round(
                    self._c_pc_cached_tokens.value / pt, 4) if pt else 0.0,
            },
            "kv_tier": {
                "enabled": self._kvt_on,
                **(self._kv_pool.occupancy() if self._kv_pool is not None
                   else {}),
                "quantize_cold": self.kv_tier.quantize_cold
                if self._kvt_on else False,
                "quantized_resident": self._quant_resident,
                "demoted_lifetime": al.demoted,
                "promoted_lifetime": al.promoted,
                "promoting_pages": len(al.promoting),
                "promote_stall_s": round(float(self._h_kvt_promote.sum), 6)
                if self._kvt_on else 0.0,
            },
            "speculative": {
                "enabled": self._spec_on,
                "verify_sweeps": int(self._c_spec_sweeps.value),
                "mean_accept_len": round(
                    self._c_spec_emitted.value / spec_slots, 4)
                if spec_slots else None,
            },
            "mesh": self.mesh_info(),
            "kernels": self.kernels.as_dict(),
            "history": {"enabled": self.history.enabled,
                        "series": len(self.history.series_names())},
            "incidents": self.incident_mgr.snapshot(),
            "devprof": self.devprof.statusz_block(),
            "telemetry": {"http_port": self._tel_exporter.port
                          if self._tel_exporter is not None else None},
        }
        metrics = self.registry.snapshot()
        status["slo"] = self.slo_tracker.snapshot(now=now)
        status["robustness"] = self._robustness_status(
            now, counters=metrics.get("counters", {}))
        status["metrics"] = metrics
        return status

    def _degraded_state(self, now: float) -> Tuple[bool, List[str]]:
        """Degraded = still serving, but shedding load or running with a
        tier disabled by repeated faults (/healthz stays ready)."""
        reasons: List[str] = []
        if self._last_shed_t is not None and \
                now - self._last_shed_t < _SHED_ACTIVE_WINDOW_S:
            reasons.append("load_shedding_active")
        if self._kv_pool is not None and self._kv_pool.disabled is not None:
            reasons.append(f"kv_tier_disabled: {self._kv_pool.disabled}")
        return bool(reasons), reasons

    def _robustness_status(self, now: float,
                           counters: Optional[Dict[str, float]] = None
                           ) -> Dict[str, Any]:
        """The /statusz ``robustness`` block: shed / failed accounting,
        tier fault and fallback counts, degraded state, and the fault
        plan's injection ledger when one is installed."""
        degraded, reasons = self._degraded_state(now)
        cnt = counters if counters is not None else (
            {} if not self._tel_on
            else self.registry.snapshot().get("counters", {}))
        out: Dict[str, Any] = {
            "degraded": degraded,
            "reasons": reasons,
            "shed_requests": self._n_shed,
            "shed_rate": round(self._n_shed / self._n_submitted, 4)
            if self._n_submitted else 0.0,
            "shed_by_reason": {k: v for k, v in
                               self._shed_by_reason.items() if v},
            "failed_requests": self._n_failed,
            "shed_queue_depth": self.shed_queue_depth,
            "shed_expired_deadline": self._shed_deadline,
            "kv_tier": {
                "fallback_events": self.kv_tier_fallback_events,
                "checksum_failures": self.kv_tier_checksum_failures,
                "disabled": (self._kv_pool.disabled
                             if self._kv_pool is not None else None),
                "spill_failures": (self._kv_pool.spill_failures
                                   if self._kv_pool is not None else 0),
            },
            "io_retries": {
                k: int(v) for k, v in cnt.items()
                if k.endswith(("_io_retries", "_sync_fallbacks",
                               "_write_retries")) and v},
        }
        if self._fault_plan is not None:
            out["faults"] = self._fault_plan.snapshot()
        return out

    def healthz(self) -> Dict[str, Any]:
        """Liveness/readiness for a supervisor probe.  ``ready`` goes
        false after :meth:`shutdown` or once an attached watchdog fired."""
        now = time.perf_counter()
        h: Dict[str, Any] = {
            **wire_stamp(),
            "alive": True,
            "ready": not self._closed,
            "replica": self.replica_id,
            "uptime_s": round(now - self._t_start, 3),
            "last_step_age_s": (round(now - self._last_step_t, 3)
                                if self._last_step_t is not None else None),
            "queue_depth": len(self.queue),
            "active_slots": sum(1 for s in self.slots if s is not None),
            "watchdog": None,
        }
        wd = self._watchdog
        if wd is not None:
            h["watchdog"] = wd.health()
            if wd.fired:
                h["ready"] = False
        degraded, reasons = self._degraded_state(now)
        h["degraded"] = degraded
        h["reasons"] = reasons
        return h

    def requestz(self, req_id) -> Dict[str, Any]:
        """ONE request: its flight-recorder events plus its current
        disposition (matched on the string form of the id)."""
        rid = str(req_id)
        events = []
        if self.tracer.enabled:
            events = [e for e in self.tracer.recorder.events()
                      if e[1] is not None and _req_key(e[1]) == rid]
        in_queue = any(_req_key(r.req_id) == rid for r in list(self.queue))
        slot = next((b for b, s in enumerate(list(self.slots))
                     if s is not None and _req_key(s.req.req_id) == rid),
                    None)
        finished = any(_req_key(k) == rid for k in list(self.finished))
        out: Dict[str, Any] = {
            "req": rid,
            "found": bool(events) or in_queue or slot is not None
            or finished,
            "state": ("finished" if finished
                      else "active" if slot is not None
                      else "queued" if in_queue
                      else "unknown"),
            "slot": slot,
            "tracing_enabled": self.tracer.enabled,
            "events": [event_to_dict(e) for e in events],
        }
        if events:
            from deepspeed_tpu_torch.request_trace import request_breakdown

            rows = request_breakdown(events)["requests"]
            if rows:
                out["breakdown"] = next(iter(rows.values()))
        return out

    def historyz(self) -> Dict[str, Any]:
        """Every metric-history ring plus recent incident metadata."""
        return {**wire_stamp(), "history": self.history.snapshot(),
                "incidents": self.incident_mgr.snapshot()}

    def profilez(self, capture_s=None) -> Dict[str, Any]:
        """devprof's status block, and with ``capture_s`` an on-demand
        ``torch.profiler`` capture under the tracer's ``dump_dir``."""
        return self.devprof.profilez(capture_s)

    def _close_control_plane(self) -> None:
        """Idempotent teardown of the control plane: clear the fault plan
        this engine installed, flush the sinks, stop the HTTP server and
        join its thread."""
        if self._owns_fault_plan:
            faults_mod.clear_fault_plan(self._fault_plan)
            self._owns_fault_plan = False
        ex, self._tel_exporter = self._tel_exporter, None
        if ex is not None:
            try:
                ex.maybe_export(force=True)
            except Exception:
                pass
            ex.close()
