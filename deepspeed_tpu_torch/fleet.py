"""Replicated serving fleet: health-aware routing, failover, and
graceful drain — the multi-replica front end (port of
``deepspeed_tpu/fleet.py``; host code over the port's serving engines).

The control plane of the single engine makes ONE
:class:`~deepspeed_tpu_torch.inference.serving.ServingEngine` degrade
predictably: typed ``RequestShed``/``RequestFailed`` results, a
degraded-but-serving ``/healthz``, per-tier shed accounting, and clean
page-leak invariants.  This module is the layer that contract was built
for: a :class:`FleetRouter` spreads open-loop traffic across N
in-process replicas — each potentially a ZeRO-Infinity-style weight-
streamed engine serving a >HBM model (arXiv:2104.07857), so the fleet
is also how streamed serving reaches aggregate throughput — and makes
the FLEET robust as the control plane made the engine robust:

- **prefix-cache-affine routing**: the prefix cache's content-addressed
  page keys make "which replica has this prompt warm" a set lookup against
  per-replica published-key digests (HBM index + spilled tier entries);
  a warm match routes there, everything else goes least-loaded.
- **health state machine with hysteresis**: each replica's existing
  signals (watchdog ``health()``, degraded ``/healthz`` reasons, the
  kv-tier circuit breaker, shed activity) feed
  HEALTHY → DEGRADED → QUARANTINED → DRAINING → DEAD; a replica must
  stay clean for ``recover_after`` consecutive polls to step back one
  state, so a flapping replica cannot oscillate in and out of the
  routing set.
- **failover with bounded retry and idempotent req_ids**: a dead or
  fatally-stalled replica's queued and zero-token in-flight requests
  re-submit to survivors (each hop charges the request's
  ``retry_budget``); a request that already emitted tokens fails typed
  (``RequestFailed(reason="replica_failed", generated=n)``) rather
  than double-generating, and NO request is ever silently dropped —
  salvage falls back to typed failure for anything it cannot re-route.
- **fleet-level admission shedding**: when the aggregate queue depth
  across routable replicas says the survivors cannot absorb the load,
  ``submit`` returns a typed ``RequestShed`` instead of queueing doomed
  work (the same first-class outcome the per-replica shedding
  produces).
- **graceful drain + rejoin** (the rolling-restart primitive):
  :meth:`FleetRouter.drain` stops new admissions to a replica, re-routes
  its queued work, lets in-flight requests finish, and republishes its
  warm prefix digest to its affinity successor so the shared-prefix
  traffic follows the warmth; :meth:`FleetRouter.rejoin` brings the
  replica (or a fresh replacement engine for a dead slot) back into
  rotation and restores its affinity from its actual warm pool.

KV fabric (``fabric=`` / the config block): with a
:class:`~deepspeed_tpu_torch.kv_fabric.KVFabric` attached, warmth moves
instead of dying with its owner —

- **cross-replica migration**: an affinity miss where another
  replica's digest (or a draining replica's still-held pages) covers
  the prompt exports the serialized, checksummed page chain into the
  fabric and admits it into the target's spill pool, so the admission
  promotes a DMA instead of re-prefilling; export errors, fetch
  latency past ``migrate_timeout_s``, and in-transit corruption all
  degrade to re-prefill through the engine's existing promotion
  fallback.
- **disaggregated prefill/decode** (``fleet.roles``): prefill
  replicas run prompts to first-token-ready, publish the KV chain,
  and decode replicas pick the request up as a migrated admission —
  failover, drain, autoscaling (per-role pressure) and rolling
  updates compose on top.

Chaos composes: the ``faults`` plan's ``replica`` rules (kill /
stall-for / force-degrade, ``match=`` a replica id) fire through the
router's per-step poll, so a chaos run can kill one of three replicas
mid-traffic and assert every accepted request still resolves token-
identical or typed; ``fabric`` rules (export error / fetch latency /
corrupt-after-checksum) do the same for the migration paths.

``fleet.tp > 1`` (each replica a tensor-parallel group) is not in the
port: a replica of the port is one process on one card, and a TP
replica needs a group of ``torch.distributed`` processes behind it.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch import faults as faults_mod
from deepspeed_tpu_torch.config import (FabricConfig, FaultsConfig,
                                        FleetConfig, HistoryConfig,
                                        IncidentsConfig, TelemetryConfig,
                                        TracingConfig)
from deepspeed_tpu_torch.faults import FaultPlan, InjectedFault
from deepspeed_tpu_torch.history import (NULL_HISTORY, MetricHistory,
                                         history_rollup)
from deepspeed_tpu_torch.incidents import NULL_INCIDENTS, IncidentManager
from deepspeed_tpu_torch.kv_fabric import KVFabric
from deepspeed_tpu_torch.inference.prefix_cache import (matchable_pages,
                                                        page_keys)
from deepspeed_tpu_torch.inference.serving import (EngineClosed,
                                                   RequestFailed,
                                                   RequestResult,
                                                   RequestShed)
from deepspeed_tpu_torch.obs_wire import (WireSchemaError,
                                          wire_stamp as obs_wire_stamp)
from deepspeed_tpu_torch.request_trace import NULL_TRACER, RequestTracer
from deepspeed_tpu_torch.slo import fleet_rollup
from deepspeed_tpu_torch.telemetry import MetricsRegistry, TelemetryExporter
from deepspeed_tpu_torch.utils.logging import logger

# ------------------------------------------------------ replica states
HEALTHY = "healthy"          # full routing weight
DEGRADED = "degraded"        # still admits (deprioritized vs HEALTHY)
QUARANTINED = "quarantined"  # no new admissions; in-flight continues
DRAINING = "draining"        # planned drain: no admissions, finishing
DEAD = "dead"                # failed over; engine shut down

# states a new admission may route to (HEALTHY preferred on ties)
_ROUTABLE = (HEALTHY, DEGRADED)
# forced-degrade fault rules with no explicit window last this long
_FORCED_DEGRADE_DEFAULT_S = 30.0


@dataclasses.dataclass
class _FleetReq:
    """Router-side ledger entry: everything needed to re-submit the
    request to a survivor (failover/drain) plus the retry budget that
    bounds how often that may happen."""

    req_id: Any
    tokens: List[int]
    max_new_tokens: int
    temperature: float
    tier: Optional[str]
    t_arrival: float
    retries_left: int
    keys: Optional[List[bytes]] = None   # chained page keys (affinity)
    replica: Optional[str] = None        # current assignment
    resubmits: int = 0
    # disaggregated prefill/decode leg (fleet.roles): None = classic;
    # "prefill" = running to first-token-ready on a prefill replica
    # (engine-side max_new_tokens clamps to 1, completion triggers the
    # KV handoff instead of finishing); "decode" = the post-handoff
    # leg, whose tokens list carries the prefill leg's boundary token
    phase: Optional[str] = None


class Replica:
    """One engine plus its router-side state machine and digest."""

    def __init__(self, rid: str, engine):
        self.id = rid
        self.engine = engine
        self.state = HEALTHY
        # key -> tier location ("hbm"/"host"/"nvme"): the located form
        # (engine.warm_digest) lets affinity prefer an HBM-warm
        # replica over an NVMe-warm one on warm-length ties
        self.digest: Dict[bytes, str] = {}
        self.assigned: set = set()       # req_ids routed here, live
        self.degraded_streak = 0
        self.healthy_streak = 0
        # digest keys inherited from a drained predecessor: a routing
        # hint the periodic refresh must not wipe (the successor does
        # not hold these pages yet — they drop out one by one as the
        # real warm pool catches up, or wholesale on rejoin/death)
        self.inherited: Dict[bytes, str] = {}
        # a DRAINING replica leaves the routing digest but still
        # physically holds its pages until rejoin/death: migration's
        # owner search reads this so drained warmth can still export
        # through the fabric instead of dying with the drain
        self.exportable: Dict[bytes, str] = {}
        # disaggregation pool ("prefill"/"decode"; None = symmetric)
        self.role: Optional[str] = None
        self.health_reasons: List[str] = []
        self.stall_started = 0.0
        self.stall_until = 0.0
        self.forced_degrade_until = 0.0
        self.affinity_hits = 0
        self.completed = 0           # token-list results harvested here
        self.state_since = time.perf_counter()

    @property
    def version(self):
        """The weight version this replica is serving (rolling updates
        move replicas between versions one drain→swap→rejoin at a
        time; the per-version SLO rollup groups on this)."""
        return self.engine.weights_version

    @property
    def routable(self) -> bool:
        return self.state in _ROUTABLE

    def load(self) -> int:
        """Routing load signal: queued + active slots."""
        e = self.engine
        return len(e.queue) + sum(1 for s in e.slots if s is not None)

    def set_state(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self.state_since = time.perf_counter()

    # ------------------------------------------------- ReplicaSource
    # (the duck-typed contract shared with obs_wire.RemoteReplica, so
    # the router's statusz/SLO/history rollups aggregate an in-process
    # engine and a scraped child through the same calls)
    def statusz_row(self, now: float) -> Dict[str, Any]:
        """This replica's row in the fleet ``/statusz`` table."""
        e = self.engine
        row = {
            "replica": self.id,
            "state": self.state,
            "role": self.role,
            "version": str(self.version),
            "state_age_s": round(now - self.state_since, 3),
            "queue_depth": len(e.queue),
            "active_slots": sum(1 for s in e.slots
                                if s is not None),
            "assigned": len(self.assigned),
            "shed": e._n_shed,
            "failed": e._n_failed,
            "shed_rate": round(
                e._n_shed / e._n_submitted, 4)
            if e._n_submitted else 0.0,
            "affinity_hits": self.affinity_hits,
            "digest_pages": len(self.digest),
            "mesh": (e.mesh_info() if hasattr(e, "mesh_info")
                     else {"sharded": False, "devices": 1,
                           "axes": {}, "tp": 1, "ep": 1}),
            "reasons": self.health_reasons,
        }
        if self.stall_until > now:
            row["stalled_for_s"] = round(self.stall_until - now, 3)
        return row

    def slo_snapshot(self, now: Optional[float] = None
                     ) -> Dict[str, Any]:
        return self.engine.slo_tracker.snapshot(now=now)

    def history_snapshot(self) -> Optional[Dict[str, Any]]:
        h = self.engine.history
        return h.snapshot() if h.enabled else None


class FleetRouter:
    """Route open-loop traffic across N in-process serving replicas.

    ``engines``: homogeneous :class:`~deepspeed_tpu_torch.inference.serving.
    ServingEngine` replicas (same model, same page_size/max_seq — the
    router re-submits requests between them, so a request valid on one
    must be valid on all).  Build them with ``replica_id=`` so their
    trace streams are attributable; :func:`fleet_router` does all of
    this from a model config.

    Surface mirrors the engine: :meth:`submit` → :meth:`step`/
    :meth:`run` → ``finished`` (token lists or typed
    ``RequestShed``/``RequestFailed``), plus the fleet verbs
    :meth:`drain`, :meth:`rejoin`, :meth:`kill`, and the introspection
    providers :meth:`statusz`/:meth:`healthz`.
    """

    def __init__(self, engines, *, fleet=None, telemetry=None,
                 faults=None, tracer=None, fabric=None,
                 history=None, incidents=None):
        self.cfg = FleetConfig.coerce(fleet)
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        self.replicas: "collections.OrderedDict[str, Replica]" = \
            collections.OrderedDict()
        for i, eng in enumerate(engines):
            rid = eng.replica_id or f"r{i}"
            if eng.replica_id is None:
                # late tag: statusz/healthz attribution still works
                # (trace binding needs replica_id at engine build)
                eng.replica_id = rid
            if rid in self.replicas:
                raise ValueError(f"duplicate replica id {rid!r}")
            self.replicas[rid] = Replica(rid, eng)
        # out-of-process replicas attached by scrape URL
        # (attach_remote); observability-plane only — never routed to
        self.remotes: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        r0 = engines[0]
        self.page_size = r0.page_size
        self._affinity = self.cfg.affinity and \
            any(rep.engine._pc_on for rep in self.replicas.values())

        # ---- disaggregated prefill/decode pools (fleet.roles): ring
        # order assigns the first roles["prefill"] replicas to the
        # prefill pool, the rest to decode; routing prefers the
        # matching pool and degrades to the other when it empties
        self._roles_on = self.cfg.roles is not None
        if self._roles_on:
            if sum(self.cfg.roles.values()) != len(self.replicas):
                raise ValueError(
                    f"fleet.roles {self.cfg.roles} does not cover the "
                    f"{len(self.replicas)} engines handed to the "
                    "router — every replica needs exactly one role")
            n_pre = self.cfg.roles["prefill"]
            for i, rep in enumerate(self.replicas.values()):
                rep.role = "prefill" if i < n_pre else "decode"

        # ---- KV fabric: the shared content-addressed exchange the
        # migration and handoff paths move serialized page chains
        # through.  Built against the ROUTER registry (kv_fabric_*
        # family rides the fleet /metrics); every replica attaches —
        # which requires its kv_tier block, the admission side of the
        # transport.
        if isinstance(fabric, KVFabric):
            self._fabric: Optional[KVFabric] = fabric
        else:
            fab_cfg = FabricConfig.coerce(fabric)
            self._fabric = None if not fab_cfg.enabled else fab_cfg
        # (deferred: the fabric needs the registry built below)

        # ---- fault plan: the router owns the process-wide install for
        # `replica` rules (engines passed the SAME plan instance see it
        # already active and do not re-own it)
        if isinstance(faults, FaultPlan):
            self._fault_plan: Optional[FaultPlan] = faults
        else:
            fcfg = FaultsConfig.coerce(faults)
            self._fault_plan = (FaultPlan.from_config(fcfg)
                                if fcfg.enabled else None)
        self._owns_fault_plan = faults_mod.ensure_installed(
            self._fault_plan)

        # ---- fleet rollup registry (per-replica registries stay on
        # the engines; this one carries only fleet-level aggregates)
        if isinstance(telemetry, MetricsRegistry):
            self.registry = telemetry
            tcfg = None
        else:
            tcfg = TelemetryConfig.coerce(telemetry)
            self.registry = MetricsRegistry(enabled=tcfg.enabled)
        r = self.registry
        self._c_submitted = r.counter(
            "fleet_submitted_requests", "requests offered to the fleet")
        self._c_completed = r.counter(
            "fleet_completed_requests",
            "requests that finished with tokens on some replica")
        self._c_failed = r.counter(
            "fleet_failed_requests",
            "requests surfaced as typed RequestFailed at the fleet "
            "(replica death mid-generation, retry budget exhausted, "
            "or an unretried per-replica failure)")
        self._c_shed = r.counter(
            "fleet_shed_requests",
            "requests surfaced as typed RequestShed at the fleet "
            "(fleet queue-depth admission shed, no routable replica, "
            "or an unretried per-replica shed)")
        self._c_affinity = r.counter(
            "fleet_affinity_routed",
            "admissions routed by a warm prefix-digest match")
        self._c_least_loaded = r.counter(
            "fleet_least_loaded_routed",
            "admissions routed by least-loaded fallback (no warm "
            "match, or affinity off)")
        self._c_resubmits = r.counter(
            "fleet_resubmitted_requests",
            "re-submissions to a survivor (failover salvage or a "
            "retried per-replica shed/failure; each charges the "
            "request's retry budget)")
        self._c_drain_reroutes = r.counter(
            "fleet_drain_rerouted_requests",
            "queued requests re-routed off a draining replica "
            "(planned movement — does NOT charge retry budget)")
        self._c_failovers = r.counter(
            "fleet_failovers", "replica deaths failed over")
        self._c_drains = r.counter(
            "fleet_drains", "planned drains started")
        self._c_rejoins = r.counter(
            "fleet_rejoins", "replicas rejoined after drain/death")
        self._c_spawns = r.counter(
            "fleet_spawns",
            "replicas added to the ring after construction "
            "(autoscaler scale-up or an operator's spawn())")
        self._c_retires = r.counter(
            "fleet_retires",
            "replicas removed from the ring (autoscaler scale-down "
            "retire after drain, or a dead slot reclaimed)")
        self._c_replica_sheds = r.counter(
            "fleet_replica_shed_returns",
            "typed sheds returned by a replica to the router "
            "(retried elsewhere when budget allows)")
        self._g_queue = r.gauge(
            "fleet_queue_depth",
            "aggregate queued requests across routable replicas")
        self._g_active = r.gauge(
            "fleet_active_slots",
            "aggregate active slots across live replicas")
        self._g_routable = r.gauge(
            "fleet_routable_replicas",
            "replicas currently accepting new admissions")
        self._c_migrations = r.counter(
            "fleet_kv_migrations",
            "cross-replica KV migrations completed (an affinity miss "
            "served by the fabric instead of a re-prefill)")
        self._c_migration_pages = r.counter(
            "fleet_kv_migration_pages",
            "pages made locally matchable by migrations")
        self._c_migration_fallbacks = r.counter(
            "fleet_kv_migration_fallbacks",
            "migrations abandoned (export failure, fetch failure, or "
            "migrate_timeout_s) — the span re-prefilled instead")
        self._c_migration_routed = r.counter(
            "fleet_migration_routed",
            "admissions with no warm replica that the fabric could "
            "cover (a migratable hit weighed above a cold re-prefill)")
        self._c_handoffs = r.counter(
            "fleet_kv_handoffs",
            "prefill->decode handoffs (disaggregated fleets: the "
            "prefill leg finished first-token-ready and the request "
            "moved to a decode replica as a migrated admission)")

        # ---- finalize the fabric against this registry
        if self._fabric is not None and not isinstance(self._fabric,
                                                       KVFabric):
            self._fabric = KVFabric(self._fabric, registry=r)
        if self._fabric is not None:
            for rep in self.replicas.values():
                # raises for a replica without kv_tier — fabric
                # participation is all-or-nothing per fleet
                rep.engine.attach_fabric(self._fabric)

        # host-side accounting (works with telemetry disabled; a chaos
        # run reconciles these against typed results and the registry)
        self._n_submitted = 0
        self._n_completed = 0
        self._n_failed = 0
        self._n_shed = 0
        self._shed_by_reason: Dict[str, int] = {}
        self._n_resubmits = 0
        self._n_migrations = 0
        self._n_migration_fallbacks = 0
        self._n_handoffs = 0

        self.requests: Dict[Any, _FleetReq] = {}    # live ledger
        self.finished: Dict[Any, RequestResult] = {}
        # final SLO snapshots (with their weight version) of replicas
        # retired from the ring: the fleet rollup folds these in so
        # lifetime counters never shrink at a scale-down (the same
        # contract failover keeps for DEAD replicas, which stay in the
        # ring)
        self._retired_slo: List[Tuple[Dict[str, Any], Any]] = []
        # fleet-level event tracer (the autoscaler and the scale verbs
        # emit through it; per-replica engines keep their own bound
        # tracers) — NULL unless the builder passed the shared one
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._autoscaler = None
        self._spawn_seq = len(self.replicas)
        # ledger of the most recent failover: which requests the
        # salvage re-placed vs failed typed — a chaos run measures
        # recovery against exactly this set (inferring it from
        # resubmit counts would also catch unrelated shed retries)
        self.last_failover: Optional[Dict[str, Any]] = None
        self._newly_finished: List[Any] = []
        self._steps = 0
        self._t_start = time.perf_counter()

        # ---- fleet-level history + incidents: rings over the
        # ROUTER registry (fleet_* aggregates), and an IncidentManager
        # on the SHARED flight recorder — replica engines built by
        # fleet_router emit into one ring, so replica burn alerts,
        # kv-tier faults, failovers and rollout rollbacks all trip
        # here without per-replica wiring.  Both ride the exporter's
        # tick-hook pass (inline in step() when no exporter exists).
        hcfg = HistoryConfig.coerce(history)
        icfg = IncidentsConfig.coerce(incidents)
        if hcfg.enabled and not self.registry.enabled:
            raise ValueError(
                "fleet history needs an enabled telemetry registry — "
                "the rings sample the router's fleet_* metrics")
        self.history = (MetricHistory(hcfg, self.registry)
                        if hcfg.enabled else NULL_HISTORY)
        if icfg.enabled:
            if not self.tracer.enabled:
                raise ValueError(
                    "fleet incidents needs the shared tracing block — "
                    "the trigger events (replica_dead, rollout_halt, "
                    "slo_burn_alert) live in the fleet flight recorder")
            self.incident_mgr = IncidentManager(
                icfg, registry=self.registry, tracer=self.tracer,
                history=self.history if self.history.enabled else None,
                statusz_fn=self.statusz, source="fleet")
        else:
            self.incident_mgr = NULL_INCIDENTS

        self._tel_exporter = None
        self._tick_inline = (self.history.enabled
                             or self.incident_mgr.enabled)
        if tcfg is not None and self.registry.enabled and (
                tcfg.prometheus_path or tcfg.http_port is not None
                or hcfg.enabled or icfg.enabled):
            self._tel_exporter = TelemetryExporter(
                self.registry, prometheus_path=tcfg.prometheus_path,
                interval_s=tcfg.interval_s, http_port=tcfg.http_port)
            self._tel_exporter.register_provider("statusz", self.statusz)
            self._tel_exporter.register_provider("healthz", self.healthz)
            if self._tick_inline:
                self._tel_exporter.register_provider("historyz",
                                                     self.historyz)
                # shared timed pass: history sampling feeds the
                # incident detectors evaluated right after it
                if self.history.enabled:
                    self._tel_exporter.register_tick_hook(
                        self.history.maybe_sample,
                        interval_s=hcfg.sample_interval_s,
                        name="fleet_history_sample")
                if self.incident_mgr.enabled:
                    self._tel_exporter.register_tick_hook(
                        self.incident_mgr.maybe_evaluate,
                        interval_s=icfg.eval_interval_s,
                        name="fleet_incident_evaluate")
                self._tick_inline = False
            # one scrape = rollup + every replica's family (collision-
            # free when replicas carry per-id namespaces, as
            # fleet_router builds them)
            for rep in self.replicas.values():
                self._tel_exporter.add_source(rep.engine.registry)
        self._closed = False

    # ------------------------------------------------------- submission
    def submit(self, req_id, tokens, max_new_tokens: int = 32,
               temperature: float = 0.0,
               tier: Optional[str] = None) -> Optional[RequestShed]:
        """Route one request into the fleet.  Returns None when placed
        on a replica, or a typed :class:`RequestShed` (also recorded in
        ``finished``) when fleet-level admission shedding rejected it.
        ``req_id`` must be fleet-unique — the id is the idempotency key
        failover re-submission relies on, so reusing a live or finished
        id raises."""
        if self._closed:
            raise EngineClosed(
                f"request {req_id!r} submitted after fleet shutdown")
        if req_id in self.requests or req_id in self.finished:
            raise ValueError(
                f"request {req_id!r} already known to the fleet — "
                "req_ids are the idempotency keys of failover "
                "re-submission and must be unique")
        freq = _FleetReq(
            req_id, list(map(int, tokens)), int(max_new_tokens),
            float(temperature), tier, time.perf_counter(),
            retries_left=self.cfg.retry_budget)
        if self._roles_on and freq.max_new_tokens > 1:
            # disaggregation: the request starts as a prefill leg (a
            # 1-token request IS pure prefill work — it routes to the
            # prefill pool but finishes there, no handoff)
            freq.phase = "prefill"
        if self.cfg.shed_queue_depth:
            depth = sum(len(rep.engine.queue)
                        for rep in self.replicas.values()
                        if rep.routable)
            if depth >= self.cfg.shed_queue_depth:
                self._c_submitted.inc()
                self._n_submitted += 1
                return self._finish_shed(freq, "fleet_queue_depth")
        self.requests[req_id] = freq
        try:
            res = self._place(freq)
        except BaseException:
            # a validation error out of engine.submit (empty prompt,
            # too long for the pool) is the CALLER's error, not a
            # fleet outcome — surface it without leaving a ledger
            # entry (or a submitted count no outcome will ever match)
            self.requests.pop(req_id, None)
            raise
        # counted only once the request has a real disposition (placed
        # or typed-shed): the accounting invariant is submitted ==
        # completed + failed + shed + live, and a caller error above
        # must not break it
        self._c_submitted.inc()
        self._n_submitted += 1
        return res

    def _ensure_keys(self, freq: _FleetReq) -> List[bytes]:
        if freq.keys is None:
            freq.keys = page_keys(freq.tokens, self.page_size)[
                :matchable_pages(len(freq.tokens), self.page_size)]
        return freq.keys

    def _route(self, freq: _FleetReq,
               exclude: frozenset = frozenset()
               ) -> Tuple[Optional[Replica], bool]:
        """Pick a replica for ``freq``: warm-digest affinity first
        (longest matched page-key prefix wins; on length ties the
        replica holding more of the match in HBM beats one whose copy
        sits on host/NVMe — a promotion costs a DMA the HBM share does
        not — then load breaks ties), then least-loaded.  HEALTHY
        replicas are preferred over DEGRADED ones; under
        ``fleet.roles`` the phase-matching pool is preferred over the
        other (falling back when it has no routable member).  Returns
        ``(replica_or_None, was_affinity_hit)``."""
        cands = [rep for rep in self.replicas.values()
                 if rep.routable and rep.id not in exclude]
        if not cands:
            return None, False
        if self._roles_on:
            want = "decode" if freq.phase == "decode" else "prefill"
            role_pool = [rep for rep in cands if rep.role == want]
            if role_pool:
                cands = role_pool
        healthy = [rep for rep in cands if rep.state == HEALTHY]
        pool = healthy or cands
        if self._affinity:
            keys = self._ensure_keys(freq)
            best, best_rank = None, (0, 0)
            for rep in pool:
                n = hbm = 0
                for k in keys:
                    loc = rep.digest.get(k)
                    if loc is None:
                        break
                    n += 1
                    if loc == "hbm":
                        hbm += 1
                rank = (n, hbm)
                if n > 0 and (
                        best is None or rank > best_rank or
                        (rank == best_rank and
                         rep.load() < best.load())):
                    best, best_rank = rep, rank
            if best is not None:
                return best, True
            if self._fabric is not None and \
                    self._fabric.covers(keys) > 0:
                # no replica is warm but the fabric holds the chain: a
                # migratable hit weighs above a cold re-prefill — the
                # least-loaded target admits it through _maybe_migrate
                self._c_migration_routed.inc()
        return min(pool, key=lambda rep: rep.load()), False

    def _place(self, freq: _FleetReq,
               exclude: frozenset = frozenset()
               ) -> Optional[RequestShed]:
        """Submit ``freq`` to a routable replica, absorbing replica-
        level sheds (retry elsewhere while budget allows) and replicas
        that die under our feet.  Terminal outcomes land in
        ``finished``; returns the typed shed when that was the
        outcome, else None."""
        while True:
            rep, hit = self._route(freq, exclude)
            if rep is None:
                return self._finish_shed(freq, "no_replica")
            if self._fabric is not None:
                self._maybe_migrate(freq, rep)
            # a prefill leg runs to first-token-ready only: the engine
            # generates ONE token (sampled from the last prompt
            # position — prefill's own output) and the harvest hands
            # the request to the decode pool
            mnt = 1 if freq.phase == "prefill" \
                else freq.max_new_tokens
            try:
                res = rep.engine.submit(
                    freq.req_id, freq.tokens, mnt,
                    freq.temperature, tier=freq.tier,
                    arrival=freq.t_arrival)
            except EngineClosed as e:
                # raced a death the health poll has not seen yet
                self._fail_replica(rep, e)
                exclude = exclude | {rep.id}
                continue
            if res is None:
                freq.replica = rep.id
                rep.assigned.add(freq.req_id)
                if hit:
                    rep.affinity_hits += 1
                    self._c_affinity.inc()
                else:
                    self._c_least_loaded.inc()
                return None
            # replica-level shed (queue depth): the router's
            # retry-elsewhere signal — exactly what RequestShed is for
            rep.engine.finished.pop(freq.req_id, None)
            self._c_replica_sheds.inc()
            if freq.retries_left <= 0:
                return self._finish_shed(freq, res.reason)
            freq.retries_left -= 1
            freq.resubmits += 1
            self._c_resubmits.inc()
            self._n_resubmits += 1
            exclude = exclude | {rep.id}

    # -------------------------------------------------- typed outcomes
    def _finish(self, req_id, result: RequestResult) -> None:
        self.finished[req_id] = result
        self._newly_finished.append(req_id)
        freq = self.requests.pop(req_id, None)
        if freq is not None and freq.replica is not None:
            rep = self.replicas.get(freq.replica)
            if rep is not None:
                rep.assigned.discard(req_id)

    def _finish_shed(self, freq: _FleetReq, reason: str) -> RequestShed:
        res = RequestShed(freq.req_id, reason, freq.tier)
        self._c_shed.inc()
        self._n_shed += 1
        self._shed_by_reason[reason] = \
            self._shed_by_reason.get(reason, 0) + 1
        self._finish(freq.req_id, res)
        return res

    def _finish_failed(self, freq: _FleetReq, reason: str,
                       error: str = "", generated: int = 0) -> None:
        self._c_failed.inc()
        self._n_failed += 1
        self._finish(freq.req_id, RequestFailed(
            freq.req_id, reason, error, freq.tier, generated=generated))

    def _retry_or_fail(self, freq: _FleetReq, reason: str,
                       error: str = "", generated: int = 0,
                       exclude: frozenset = frozenset(),
                       charge: bool = True) -> None:
        """Failover disposition for one salvaged/failed request: a
        request that already emitted tokens fails typed (never
        double-generate); otherwise re-place on a survivor while the
        retry budget lasts."""
        if generated and freq.phase == "prefill":
            # the prefill leg's boundary token is never surfaced to
            # the caller (only the decode leg's completion is), so a
            # replica dying mid-prefill-leg re-runs the leg from the
            # prompt instead of failing a request the user saw
            # nothing from
            generated = 0
        if generated > 0:
            self._finish_failed(freq, reason, error, generated)
            return
        if charge:
            if freq.retries_left <= 0:
                self._finish_failed(freq, "retry_exhausted", error)
                return
            freq.retries_left -= 1
            freq.resubmits += 1
            self._c_resubmits.inc()
            self._n_resubmits += 1
        freq.replica = None
        self._place(freq, exclude)

    # -------------------------------------------------- KV migration
    def _maybe_migrate(self, freq: _FleetReq, target: Replica) -> None:
        """Affinity-miss migration: when the routing target does not
        locally cover ``freq``'s prompt chain but the fabric (or
        another replica's warmth, exported on demand) does, pull the
        chain into the target's spill pool BEFORE the submit — its
        admission then matches the span as tier hits and promotes
        through the existing checksum-verified path instead of
        re-prefilling.  Every failure mode degrades to re-prefill:
        export errors stop the chain where they hit, fetch latency
        past ``migrate_timeout_s`` abandons the remainder (the
        admitted prefix is still chain-valid), and in-transit
        corruption is caught by the admitting engine's promotion-time
        crc32 and falls back like any failed tier promotion."""
        eng = target.engine
        if not getattr(eng, "_kvt_on", False) or eng._fabric is None:
            return
        keys = self._ensure_keys(freq)
        if not keys:
            return
        # the target's ACTUAL local coverage (its routing digest may
        # carry inherited drain hints for pages it never materialized)
        n_local = 0
        for k in keys:
            if k in eng.allocator.index or eng._kv_pool.has(k):
                n_local += 1
            else:
                break
        if n_local >= len(keys):
            return
        fab = self._fabric
        t0 = time.perf_counter()
        deadline = t0 + fab.cfg.migrate_timeout_s
        n_fab = fab.covers(keys)
        if n_fab <= n_local:
            # find an owner whose digest (or drained-but-held pages)
            # covers more of the chain and export on demand
            owner, cov = None, max(n_local, n_fab)
            for rep in self.replicas.values():
                if rep.state == DEAD or rep.id == target.id:
                    continue
                n = 0
                for k in keys:
                    if k not in rep.digest and k not in rep.exportable:
                        break
                    n += 1
                if n > cov:
                    owner, cov = rep, n
            if owner is None:
                return
            try:
                n_exp = owner.engine.export_pages(keys[:cov],
                                                  fabric=fab)
            except Exception as e:
                logger.warning("fleet: fabric export from %s failed "
                               "(%s) — re-prefilling", owner.id, e)
                self._c_migration_fallbacks.inc()
                self._n_migration_fallbacks += 1
                return
            if time.perf_counter() > deadline:
                # export timeout: fall back to re-prefill exactly like
                # a failed promotion — the published pages stay in the
                # fabric for a later (faster) migration
                self._c_migration_fallbacks.inc()
                self._n_migration_fallbacks += 1
                return
            if n_exp <= n_local:
                # the export was attempted but delivered nothing new
                # (an injected export error on the first page, or the
                # owner's digest went stale): a degraded migration
                self._c_migration_fallbacks.inc()
                self._n_migration_fallbacks += 1
                return
            n_fab = n_exp
        if n_fab - n_local < fab.cfg.min_pages:
            return
        n_adm = eng.admit_fabric(keys[:n_fab], deadline=deadline)
        if n_adm > n_local:
            self._c_migrations.inc()
            self._n_migrations += 1
            self._c_migration_pages.inc(n_adm - n_local)
            fab.h_migrate.observe(time.perf_counter() - t0)
            # the target is tier-warm for the MIGRATED span now —
            # reflect it in the routing digest before the next refresh
            # tick.  Only the newly admitted tail is stamped (the
            # locally-covered prefix may be HBM-resident, and "host"
            # would downgrade its affinity tie-break rank), with the
            # tier the admit actually landed each key in.
            pool = eng._kv_pool
            target.digest = {
                **target.digest,
                **{k: (pool.location(k) or "host")
                   for k in keys[n_local:n_adm]}}
            tracer = eng.tracer
            if tracer.enabled:
                tracer.event("kv_migrate", freq.req_id, attrs={
                    "pages": n_adm - n_local,
                    "target": target.id,
                    "wait_s": round(time.perf_counter() - t0, 6)})
        else:
            self._c_migration_fallbacks.inc()
            self._n_migration_fallbacks += 1

    # ------------------------------------------- prefill->decode handoff
    def _refresh_one(self, rep: Replica) -> None:
        warm = rep.engine.warm_digest()
        rep.inherited = {k: v for k, v in rep.inherited.items()
                         if k not in warm}
        rep.digest = {**warm, **rep.inherited}

    def _handoff(self, freq: _FleetReq, src: Replica,
                 result: List[int]) -> None:
        """The disaggregation seam: the prefill leg finished
        first-token-ready on ``src`` — move the request to the decode
        pool as a migrated admission.  The boundary token joins the
        prompt (the decode replica's admission treats it as prompt
        history; its KV chain migrates through the fabric, so the
        decode leg prefills only the unmigrated tail), the remaining
        token budget carries over, and like a drain re-route this is
        scheduled movement: no retry-budget charge."""
        self._c_handoffs.inc()
        self._n_handoffs += 1
        freq.phase = "decode"
        freq.tokens = [int(t) for t in result]
        freq.max_new_tokens -= 1
        freq.keys = None
        freq.replica = None
        # the source just published the prompt's pages at finish: make
        # its digest current NOW so _maybe_migrate's owner search sees
        # the warmth without waiting for the periodic refresh tick
        self._refresh_one(src)
        tracer = src.engine.tracer
        if tracer.enabled:
            tracer.event("kv_handoff", freq.req_id, attrs={
                "from": src.id,
                "prompt_tokens": len(freq.tokens),
                "remaining_tokens": freq.max_new_tokens})
        self._place(freq)

    # --------------------------------------------------------- failover
    def kill(self, replica_id: str, error: str = "killed") -> None:
        """Declare a replica dead NOW (a supervisor's hard-kill verb;
        the ``replica`` fault rules call this path too) and fail its
        work over to the survivors."""
        self._fail_replica(self.replicas[replica_id],
                           RuntimeError(error))

    def _fail_replica(self, rep: Replica, exc: BaseException) -> None:
        """Failover: salvage everything the dead replica held —
        completed results harvest, queued and zero-token in-flight
        requests re-submit to survivors under their retry budgets,
        token-bearing in-flight requests fail typed — then shut the
        engine down.  Anything salvage cannot reach still resolves
        typed: no request is silently dropped."""
        if rep.state == DEAD:
            return
        logger.warning(
            "fleet: replica %s failed (%s) — failing over %d assigned "
            "requests", rep.id, exc, len(rep.assigned))
        rep.set_state(DEAD)
        self._c_failovers.inc()
        tracer = rep.engine.tracer
        if tracer.enabled:
            tracer.event("replica_dead", attrs={
                "replica": rep.id, "error": repr(exc)[:200],
                "assigned": len(rep.assigned)})
        exclude = frozenset({rep.id})
        # completed work first: results that already exist must never
        # be re-generated or lost
        try:
            self._harvest(rep)
        except Exception:
            logger.exception("fleet: harvest during failover (%s)",
                             rep.id)
        # the salvage set, captured before any disposition: everything
        # this replica still held after its finished results harvested
        candidates = sorted(rep.assigned, key=str)
        try:
            queued = rep.engine.take_queued()
        except Exception:
            logger.exception("fleet: queue salvage failed (%s)", rep.id)
            queued = []
        try:
            inflight = rep.engine.abandon_inflight()
        except Exception:
            logger.exception("fleet: slot salvage failed (%s)", rep.id)
            inflight = []
        for q in queued:
            freq = self.requests.get(q.req_id)
            if freq is not None:
                rep.assigned.discard(q.req_id)
                self._retry_or_fail(freq, "replica_failed",
                                    repr(exc), 0, exclude)
        for q, generated in inflight:
            freq = self.requests.get(q.req_id)
            if freq is not None:
                rep.assigned.discard(q.req_id)
                self._retry_or_fail(freq, "replica_failed",
                                    repr(exc), generated, exclude)
        # anything still assigned was unreachable by salvage (the
        # engine is that broken): typed failure, never a silent drop
        for req_id in list(rep.assigned):
            freq = self.requests.get(req_id)
            rep.assigned.discard(req_id)
            if freq is not None and req_id not in self.finished:
                self._finish_failed(freq, "replica_failed", repr(exc))
        self.last_failover = {
            "replica": rep.id,
            "t": time.perf_counter(),
            "error": repr(exc)[:200],
            "resubmitted": [r for r in candidates
                            if r in self.requests
                            and r not in self.finished],
            "failed_typed": [r for r in candidates
                             if r in self.finished],
        }
        rep.digest, rep.inherited, rep.exportable = {}, {}, {}
        try:
            rep.engine.shutdown()
        except Exception:
            logger.exception("fleet: shutdown of dead replica %s",
                             rep.id)

    # ---------------------------------------------------- drain / rejoin
    def drain(self, replica_id: str,
              successor_exclude=()) -> None:
        """Planned drain: stop new admissions, re-route the replica's
        queued requests (no retry-budget charge — this is scheduled
        movement, not failure), let in-flight requests finish in
        place, and republish its warm prefix digest to its affinity
        successor so shared-prefix traffic follows the warmth.  The
        replica stays DRAINING (steppable, unroutable) until
        :meth:`rejoin` (or :meth:`retire`).

        The donated digest includes keys the replica itself INHERITED
        from an earlier drain — draining the current affinity
        successor must pass the whole hint chain along, not quietly
        drop the part it never materialized.  ``successor_exclude``:
        replica ids the handoff must skip (a rollout excludes its NEXT
        target, which is about to drain too)."""
        rep = self.replicas[replica_id]
        if rep.state in (DEAD, DRAINING):
            raise ValueError(
                f"replica {replica_id} is {rep.state} — drain needs a "
                "live replica")
        rep.set_state(DRAINING)
        self._c_drains.inc()
        succ = self._affinity_successor(
            rep, exclude=frozenset(successor_exclude))
        donated = {**rep.engine.warm_digest(), **rep.inherited}
        if succ is not None:
            # routing hint, deliberately optimistic: the successor does
            # not hold these pages yet, but same-prefix traffic landing
            # there warms them once and then hits — without the
            # handoff it would spray across the fleet and warm
            # nothing.  Recorded as `inherited` so the periodic digest
            # refresh keeps the hint alive until the successor's own
            # warm pool covers it.  With a fabric attached the hint is
            # better than optimistic: the first same-prefix admission
            # on the successor MIGRATES the chain out of the draining
            # replica (still holding its pages — see `exportable`)
            # instead of recomputing it.
            succ.inherited = {**succ.inherited, **donated}
            succ.digest = {**succ.digest, **donated}
        # the draining replica leaves the routing digest but keeps its
        # pages until rejoin/death: migration's owner search may still
        # export them through the fabric
        rep.exportable = donated
        tracer = rep.engine.tracer
        if tracer.enabled:
            tracer.event("replica_drain", attrs={
                "replica": rep.id,
                "successor": succ.id if succ is not None else None})
        for q in rep.engine.take_queued():
            freq = self.requests.get(q.req_id)
            if freq is not None:
                rep.assigned.discard(q.req_id)
                self._c_drain_reroutes.inc()
                self._retry_or_fail(freq, "replica_draining",
                                    exclude=frozenset({rep.id}),
                                    charge=False)
        rep.digest, rep.inherited = {}, {}

    def _affinity_successor(self, rep: Replica,
                            exclude: frozenset = frozenset()
                            ) -> Optional[Replica]:
        """Next ROUTABLE replica in ring order after ``rep`` (routable
        already excludes DRAINING/DEAD — a warm digest is never
        donated to a replica that could not serve the traffic it
        attracts).  ``exclude`` additionally skips ids the caller
        knows are ABOUT to drain (a rollout's next target), which
        routability cannot see yet."""
        ring = list(self.replicas.values())
        i = ring.index(rep)
        for j in range(1, len(ring)):
            cand = ring[(i + j) % len(ring)]
            if cand.routable and cand.id not in exclude:
                return cand
        return None

    def drained(self, replica_id: str) -> bool:
        """True once a DRAINING replica finished its in-flight work."""
        rep = self.replicas[replica_id]
        return rep.state == DRAINING and not rep.engine.has_work

    def rejoin(self, replica_id: str, engine=None) -> None:
        """Bring a drained (or dead, with a fresh ``engine``) replica
        back into rotation: state resets to HEALTHY with clean
        hysteresis streaks, and its digest refreshes from the engine's
        actual warm pool — a drained replica that kept its pages gets
        its affinity back immediately."""
        rep = self.replicas[replica_id]
        if rep.state == DEAD and engine is None:
            raise ValueError(
                f"replica {replica_id} is dead (engine shut down) — "
                "rejoin needs a replacement engine")
        if engine is not None:
            # a shut-down engine must be rejected HERE, not discovered
            # at the first submit: rejoining it would put a replica in
            # rotation whose every admission raises — the router would
            # read that as an instant re-death
            if getattr(engine, "_closed", False):
                raise EngineClosed(
                    f"rejoin of replica {replica_id} was handed a "
                    "shut-down engine — a replacement engine must be "
                    "freshly built (shutdown() already ran on this "
                    "one, so it can never serve again)")
            if engine.replica_id is None:
                engine.replica_id = replica_id
            rep.engine = engine
            if self._fabric is not None:
                engine.attach_fabric(self._fabric)
            if self._tel_exporter is not None:
                self._tel_exporter.add_source(engine.registry)
        rep.set_state(HEALTHY)
        rep.degraded_streak = rep.healthy_streak = 0
        rep.stall_until = rep.stall_started = 0.0
        rep.forced_degrade_until = 0.0
        rep.health_reasons = []
        rep.inherited = {}
        rep.exportable = {}
        rep.digest = dict(rep.engine.warm_digest())
        self._c_rejoins.inc()
        tracer = rep.engine.tracer
        if tracer.enabled:
            tracer.event("replica_rejoin", attrs={"replica": rep.id})

    # ---------------------------------------------------- spawn / retire
    # (the elastic verbs: the autoscaler adds replicas under load and
    # removes them — drain → retire — when load falls; both are also
    # operator verbs for manual fleet surgery)
    def spawn(self, engine, replica_id: Optional[str] = None,
              role: Optional[str] = None) -> str:
        """Add a NEW replica to the end of the ring (unlike
        :meth:`rejoin`, which refills an existing slot).  The engine
        must be live and fleet-compatible (same model/page geometry —
        the router re-submits requests between replicas).  Returns the
        replica id; the replica enters rotation HEALTHY with its
        digest read from its actual warm pool (empty for a cold
        engine; a ZeRO-Inference streamed engine serves immediately
        while its weights page in)."""
        if self._closed:
            raise EngineClosed("spawn after fleet shutdown")
        if getattr(engine, "_closed", False):
            raise EngineClosed(
                "spawn was handed a shut-down engine — build a fresh "
                "one (shutdown() already ran on it)")
        if replica_id is None and engine.replica_id is not None \
                and engine.replica_id not in self.replicas:
            replica_id = engine.replica_id
        if replica_id is None:
            while f"r{self._spawn_seq}" in self.replicas:
                self._spawn_seq += 1
            replica_id = f"r{self._spawn_seq}"
        if replica_id in self.replicas:
            raise ValueError(
                f"duplicate replica id {replica_id!r} — retire or "
                "rejoin the existing slot instead")
        if engine.replica_id is None:
            engine.replica_id = replica_id
        rep = Replica(replica_id, engine)
        if self._fabric is not None:
            engine.attach_fabric(self._fabric)
        rep.digest = dict(engine.warm_digest())
        if self._roles_on:
            if role is not None and role not in self.cfg.roles:
                raise ValueError(
                    f"spawn role {role!r} not in fleet.roles "
                    f"{sorted(self.cfg.roles)}")
            if role is None:
                # fill the pool furthest below its configured share
                # (the autoscaler passes the pressured role instead)
                live = [r for r in self.replicas.values()
                        if r.state != DEAD]
                total = sum(self.cfg.roles.values())

                def deficit(ro: str) -> float:
                    have = sum(1 for r in live if r.role == ro)
                    return have / max(len(live), 1) \
                        - self.cfg.roles[ro] / total

                role = min(sorted(self.cfg.roles), key=deficit)
            rep.role = role
        elif role is not None:
            rep.role = role
        self.replicas[replica_id] = rep
        self._c_spawns.inc()
        if self._tel_exporter is not None:
            self._tel_exporter.add_source(engine.registry)
        tracer = engine.tracer
        if tracer.enabled:
            tracer.event("replica_spawn", attrs={
                "replica": replica_id,
                "version": str(engine.weights_version)})
        return replica_id

    def retire(self, replica_id: str) -> None:
        """Remove a replica from the ring for good (scale-down: the
        counterpart of :meth:`spawn`).  Only a DEAD replica or a
        DRAINING one that finished its in-flight work may retire — a
        routable replica must :meth:`drain` first so its queued work
        re-routes and its warm digest hands off.  The replica's final
        per-version SLO snapshot is folded into the fleet rollup
        forever (lifetime counters never shrink at a scale-down)."""
        rep = self.replicas[replica_id]
        if rep.state == DRAINING:
            if rep.engine.has_work or rep.assigned:
                raise ValueError(
                    f"replica {replica_id} still has in-flight work — "
                    "retire only after drained() reports True")
            if not any(r.state != DEAD for r in self.replicas.values()
                       if r.id != replica_id):
                raise ValueError(
                    f"replica {replica_id} is the last live replica — "
                    "retiring it would kill the fleet (spawn a "
                    "replacement first)")
        elif rep.state != DEAD:
            raise ValueError(
                f"replica {replica_id} is {rep.state} — retire needs "
                "a drained (DRAINING + finished) or DEAD replica")
        try:
            self._retired_slo.append(
                (rep.engine.slo_tracker.snapshot(), rep.version))
            self._compact_retired()
        except Exception:
            logger.exception("fleet: retired-SLO capture (%s)",
                             replica_id)
        tracer = rep.engine.tracer
        if tracer.enabled:
            tracer.event("replica_retire", attrs={
                "replica": replica_id, "state": rep.state})
        del self.replicas[replica_id]
        self._c_retires.inc()
        if self._tel_exporter is not None:
            # the retired replica's metric families leave /metrics
            # with it (its SLO lifetime survives via _retired_slo)
            self._tel_exporter.remove_source(rep.engine.registry)
        try:
            rep.engine.shutdown()
        except Exception:
            logger.exception("fleet: retired replica %s shutdown",
                             replica_id)

    def _compact_retired(self) -> None:
        """Bound the retired-SLO ledger: a fleet breathing for weeks
        retires thousands of replicas, and statusz() re-aggregates the
        list on every poll.  Same-version snapshots merge through
        :func:`fleet_rollup` (whose output is itself a consumable
        snapshot — lifetime counters sum, so nothing ever shrinks);
        distinct versions stay separate for the by_version view."""
        if len(self._retired_slo) <= 8:
            return
        groups: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()
        for snap, v in self._retired_slo:
            groups.setdefault(str(v), []).append((snap, v))
        out = []
        for g in groups.values():
            if len(g) > 1:
                out.append((fleet_rollup([s for s, _ in g]), g[0][1]))
            else:
                out.extend(g)
        self._retired_slo = out

    # ------------------------------------------------------- role views
    # (the autoscaler's per-role scaling signals and victim guard)
    def role_pressure(self) -> Dict[str, float]:
        """Mean queue depth per routable replica, per role.  A role
        with NO routable member reads as infinite pressure — the
        autoscaler heals it before anything else."""
        out: Dict[str, float] = {}
        for ro in (self.cfg.roles or {}):
            members = [rep for rep in self.replicas.values()
                       if rep.role == ro and rep.routable]
            out[ro] = (sum(len(rep.engine.queue) for rep in members)
                       / len(members)) if members else float("inf")
        return out

    def last_of_role(self, rep: Replica) -> bool:
        """True when ``rep`` is the only live member of its role — a
        scale-down victim guard (routing degrades to the other pool,
        but a fleet that CONFIGURED both pools should not silently
        lose one to load troughs)."""
        if not self._roles_on or rep.role is None:
            return False
        # ROUTABLE peers only: a DRAINING/QUARANTINED peer cannot
        # absorb the role's traffic, so retiring this replica would
        # still empty the pool
        return not any(
            r.id != rep.id and r.routable and r.role == rep.role
            for r in self.replicas.values())

    def attach_autoscaler(self, autoscaler) -> None:
        """Register the :class:`~deepspeed_tpu_torch.autoscale.
        FleetAutoscaler` driving this fleet so ``/statusz`` carries its
        ``elastic`` block (the autoscaler calls this itself)."""
        self._autoscaler = autoscaler

    # ------------------------------------------------------------ health
    def _poll_faults(self, now: float) -> None:
        if self._fault_plan is None:
            return
        for rep in list(self.replicas.values()):
            if rep.state == DEAD:
                continue
            for rule in faults_mod.poll_replica(rep.id):
                if rule.mode == "error":
                    self._fail_replica(rep, InjectedFault(
                        f"injected replica kill ({rep.id})"))
                    break
                if rule.mode == "latency":
                    rep.stall_started = now
                    rep.stall_until = now + rule.latency_s
                    if rule.latency_s >= self.cfg.fatal_stall_s:
                        # a stall past the fatal bound IS a death: the
                        # router fails over now instead of letting the
                        # fleet's tail latency absorb the wait
                        self._fail_replica(rep, InjectedFault(
                            f"fatal stall {rule.latency_s:.1f}s >= "
                            f"{self.cfg.fatal_stall_s:.1f}s "
                            f"({rep.id})"))
                        break
                elif rule.mode == "degrade":
                    rep.forced_degrade_until = now + (
                        rule.latency_s or _FORCED_DEGRADE_DEFAULT_S)

    def _poll_health(self, now: float) -> None:
        """Pull each live replica's health into the state machine.
        DEAD is terminal; DRAINING keeps its state (only rejoin moves
        it) but still runs the DEATH checks — a draining replica that
        hangs or goes unready must fail over like any other, or its
        in-flight requests would never resolve.  Everything else walks
        HEALTHY ↔ DEGRADED ↔ QUARANTINED one step per threshold with
        hysteresis."""
        for rep in self.replicas.values():
            if rep.state == DEAD:
                continue
            # a stall that outlives the fatal bound is a hang, not a
            # blip — failover rather than waiting it out
            if rep.stall_until > now and \
                    now - rep.stall_started >= self.cfg.fatal_stall_s:
                self._fail_replica(rep, RuntimeError(
                    f"replica {rep.id} stalled past fatal_stall_s"))
                continue
            try:
                h = rep.engine.healthz()
            except Exception as e:
                self._fail_replica(rep, e)
                continue
            if not h.get("ready", False):
                # watchdog fired or engine closed: terminally unready
                self._fail_replica(rep, RuntimeError(
                    f"replica {rep.id} unready: "
                    f"watchdog={h.get('watchdog')}"))
                continue
            if rep.state == DRAINING:
                # alive and draining: no hysteresis transitions — the
                # only exits are the death checks above and rejoin()
                continue
            reasons = list(h.get("reasons", []))
            if now < rep.forced_degrade_until:
                reasons.append("forced_degrade")
            if now < rep.stall_until:
                reasons.append("stalled")
            rep.health_reasons = reasons
            if reasons or h.get("degraded"):
                rep.degraded_streak += 1
                rep.healthy_streak = 0
            else:
                rep.healthy_streak += 1
                rep.degraded_streak = 0
            if rep.state == HEALTHY and rep.degraded_streak >= 1:
                rep.set_state(DEGRADED)
            elif rep.state == DEGRADED:
                if rep.degraded_streak >= self.cfg.quarantine_after:
                    rep.set_state(QUARANTINED)
                elif rep.healthy_streak >= self.cfg.recover_after:
                    rep.set_state(HEALTHY)
            elif rep.state == QUARANTINED and \
                    rep.healthy_streak >= self.cfg.recover_after:
                # one step at a time: QUARANTINED recovers to DEGRADED
                # and must stay clean another recover_after polls for
                # HEALTHY — the hysteresis that stops flapping
                rep.set_state(DEGRADED)
                rep.healthy_streak = 0
        # out-of-process replicas: drive their scrape loops.  A dead
        # child is absorbed into the staleness machine (FRESH→STALE→
        # LOST) — never an exception out of the router step.  A
        # schema-major mismatch IS an exception inside poll(), but a
        # deployment bug must not wedge the poller either: log loudly
        # once and pin the remote LOST.
        for rem in self.remotes.values():
            try:
                rem.maybe_poll()
            except WireSchemaError as e:
                if rem.state != "LOST":
                    logger.error("fleet: remote %s speaks an "
                                 "incompatible wire schema: %s",
                                 rem.id, e)
                rem.force_lost(f"wire_schema: {e}")

    # -------------------------------------------------------------- step
    def _harvest(self, rep: Replica) -> List[Any]:
        """Move terminal results for our assigned requests off the
        replica: token lists complete, typed sheds/failures go through
        the retry-or-surface disposition."""
        done = [rid for rid in rep.assigned
                if rid in rep.engine.finished]
        out: List[Any] = []
        for rid in done:
            res = rep.engine.finished.pop(rid)
            rep.assigned.discard(rid)
            freq = self.requests.get(rid)
            if freq is None:
                continue
            if isinstance(res, RequestFailed):
                # per-request failure in isolation: the replica kept
                # serving — retry only a request that never emitted
                self._retry_or_fail(
                    freq, res.reason, res.error, res.generated,
                    exclude=frozenset({rep.id}))
            elif isinstance(res, RequestShed):
                # deadline sheds land here (queue-depth sheds return
                # at submit): the deadline is just as expired on every
                # other replica — surface, never bounce
                self._c_shed.inc()
                self._n_shed += 1
                self._shed_by_reason[res.reason] = \
                    self._shed_by_reason.get(res.reason, 0) + 1
                self._finish(rid, res)
            else:
                eos = getattr(rep.engine, "eos", None)
                if freq.phase == "prefill" and \
                        freq.max_new_tokens > 1 and \
                        len(res) > len(freq.tokens) and not (
                            eos is not None and res[-1] == eos):
                    # first-token-ready, not finished: hand the
                    # request (and its KV chain) to the decode pool.
                    # An EOS boundary token IS the whole answer — it
                    # completes here like any 1-token request.
                    self._handoff(freq, rep, res)
                    out.append(rid)
                    continue
                rep.completed += 1
                self._c_completed.inc()
                self._n_completed += 1
                self._finish(rid, res)
            out.append(rid)
        return out

    def refresh_digests(self) -> None:
        """Re-pull every routable replica's published-key digest (the
        affinity lookup's source of truth; also refreshed on the
        ``digest_refresh_steps`` cadence inside :meth:`step`).  Keys
        inherited from a drained predecessor survive the refresh —
        each drops out only once the replica's own warm pool holds it
        (the hint did its job) — so the drain handoff is not wiped by
        the very next refresh tick."""
        for rep in self.replicas.values():
            if rep.state not in (DEAD, DRAINING):
                self._refresh_one(rep)

    def step(self) -> List[Any]:
        """One fleet iteration: fault poll → health poll → step every
        steppable replica (failures here ARE replica deaths) → harvest
        terminal results.  Returns req_ids that reached a terminal
        result this step."""
        self._newly_finished = []
        self._steps += 1
        now = time.perf_counter()
        self._poll_faults(now)
        self._poll_health(now)
        for rep in list(self.replicas.values()):
            if rep.state == DEAD or rep.stall_until > now:
                continue
            if not rep.engine.has_work:
                continue
            try:
                rep.engine.step()
            except Exception as e:
                # an exception out of step() is engine-fatal by the
                # control plane's contract (per-request failures were
                # absorbed inside) — the fleet's answer is failover
                self._fail_replica(rep, e)
                continue
            self._harvest(rep)
        if self._steps % self.cfg.digest_refresh_steps == 0:
            self.refresh_digests()
        self._update_gauges()
        if self._tel_exporter is not None:
            # the exporter tick also drives the shared hook pass
            # (history sampling + incident evaluation)
            self._tel_exporter.maybe_export()
        elif self._tick_inline:
            now_m = time.monotonic()
            self.history.maybe_sample(now_m)
            self.incident_mgr.maybe_evaluate(now_m)
        return list(self._newly_finished)

    def _update_gauges(self) -> None:
        if not self.registry.enabled:
            return
        routable = [rep for rep in self.replicas.values()
                    if rep.routable]
        self._g_routable.set(len(routable))
        self._g_queue.set(sum(len(rep.engine.queue)
                              for rep in routable))
        self._g_active.set(sum(
            1 for rep in self.replicas.values()
            if rep.state != DEAD
            for s in rep.engine.slots if s is not None))

    @property
    def has_work(self) -> bool:
        return bool(self.requests) or any(
            rep.engine.has_work for rep in self.replicas.values()
            if rep.state != DEAD)

    def run(self, max_steps: int = 10_000) -> Dict[Any, RequestResult]:
        """Drive until every submitted request reached a terminal
        result (tokens, typed shed, or typed failure)."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("fleet loop did not converge")
        return dict(self.finished)

    def drain_finished(self) -> Dict[Any, RequestResult]:
        out, self.finished = self.finished, {}
        return out

    # ------------------------------------------------------- accounting
    def orphaned(self) -> List[Any]:
        """Requests that can never resolve: a ledger entry with no
        terminal result whose replica is gone (or never tracked it).
        Zero ALWAYS — failover and drain both guarantee every salvaged
        request either re-places or fails typed."""
        out = []
        for rid, freq in self.requests.items():
            if rid in self.finished:
                continue
            rep = (self.replicas.get(freq.replica)
                   if freq.replica is not None else None)
            if rep is None or rep.state == DEAD or \
                    rid not in rep.assigned:
                out.append(rid)
        return out

    def check_leaks(self) -> List[str]:
        """Union of every replica's page-accounting violations,
        replica-tagged; DEAD replicas are included — failover salvage
        must leave them leak-free too."""
        probs: List[str] = []
        for rep in self.replicas.values():
            for p in rep.engine.check_leaks():
                probs.append(f"{rep.id}: {p}")
        return probs

    # ---------------------------------------------------- introspection
    def statusz(self) -> Dict[str, Any]:
        """Fleet snapshot: per-replica state/queue/shed/affinity rows,
        fleet totals, and the cross-replica SLO rollup.  Host-side
        bookkeeping only — safe to poll (``dstpu_top`` renders it)."""
        now = time.perf_counter()
        reps = []
        states: Dict[str, int] = {}
        for rep in self.replicas.values():
            states[rep.state] = states.get(rep.state, 0) + 1
            reps.append(rep.statusz_row(now))
        # out-of-process replicas ride the same table: their rows come
        # from the last-known scrape plus the scrape-plane truth
        # (state/age/errors) — a LOST child stays visible, flagged
        for rem in self.remotes.values():
            row = rem.statusz_row()
            states[row["state"]] = states.get(row["state"], 0) + 1
            reps.append(row)
        routed = self._c_affinity.value + self._c_least_loaded.value
        fleet: Dict[str, Any] = {
            "replicas": reps,
            "states": states,
            "submitted": self._n_submitted,
            "completed": self._n_completed,
            "failed": self._n_failed,
            "shed": self._n_shed,
            "shed_by_reason": dict(self._shed_by_reason),
            "resubmits": self._n_resubmits,
            "failovers": int(self._c_failovers.value),
            "drains": int(self._c_drains.value),
            "rejoins": int(self._c_rejoins.value),
            "spawns": int(self._c_spawns.value),
            "retires": int(self._c_retires.value),
            "affinity": {
                "enabled": self._affinity,
                "affinity_routed": int(self._c_affinity.value),
                "least_loaded_routed": int(
                    self._c_least_loaded.value),
                "hit_rate": round(self._c_affinity.value / routed, 4)
                if routed else 0.0,
            },
            "queue_depth": sum(len(rep.engine.queue)
                               for rep in self.replicas.values()
                               if rep.state != DEAD),
            "in_flight": len(self.requests),
            "orphaned": len(self.orphaned()),
            # a TP-sharded fleet is visibly sharded: the configured
            # devices-per-replica plus how many live replicas actually
            # run on a multi-device mesh (rows carry the per-replica
            # axes; DEAD replicas excluded — their engines are down)
            "mesh": {
                "tp": self.cfg.tp,
                "sharded_replicas": sum(
                    1 for r in reps
                    if r["mesh"]["sharded"] and r["state"] != DEAD),
            },
        }
        if self._fabric is not None:
            fleet["fabric"] = {
                **self._fabric.occupancy(),
                "migrations": self._n_migrations,
                "migration_pages": int(
                    self._c_migration_pages.value),
                "migration_fallbacks": self._n_migration_fallbacks,
                "handoffs": self._n_handoffs,
            }
        if self._roles_on:
            roles: Dict[str, Any] = {}
            for ro in sorted(self.cfg.roles):
                members = [rep for rep in self.replicas.values()
                           if rep.role == ro]
                roles[ro] = {
                    "replicas": len(members),
                    "routable": sum(1 for rep in members
                                    if rep.routable),
                    "queue_depth": sum(
                        len(rep.engine.queue) for rep in members
                        if rep.state != DEAD),
                    "active_slots": sum(
                        1 for rep in members if rep.state != DEAD
                        for s in rep.engine.slots if s is not None),
                }
            fleet["roles"] = roles
            fleet["handoffs"] = self._n_handoffs
        # DEAD replicas included (their trackers are host-side and
        # outlive shutdown) and RETIRED replicas' final snapshots
        # folded in: the fleet "lifetime" counters never shrink at a
        # failover or a scale-down.  Versions ride along so the rollup
        # carries the per-version view a rolling update watches.
        snaps = [(rep.slo_snapshot(now=now), rep.version, rep.role)
                 for rep in self.replicas.values()]
        snaps.extend((s, v, None) for s, v in self._retired_slo)
        # remote replicas fold in through their last-known scraped
        # statusz["slo"] — exactly the SLOTracker.snapshot() shape, so
        # fleet_rollup consumes it unchanged (None while never scraped
        # is filtered by the rollup like a disabled tracker)
        for rem in self.remotes.values():
            snaps.append((rem.slo_snapshot(),
                          (rem.last_statusz or {}).get(
                              "weights_version"), None))
        status = {
            "schema_version": 1,
            **obs_wire_stamp(),
            "engine": "FleetRouter",
            "t": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "uptime_s": round(now - self._t_start, 3),
            "steps": self._steps,
            "fleet": fleet,
            "slo": fleet_rollup([s for s, _v, _r in snaps],
                                versions=[v for _s, v, _r in snaps],
                                roles=[r for _s, _v, r in snaps]
                                if self._roles_on else None),
            "metrics": self.registry.snapshot(),
        }
        status["history"] = {
            "enabled": self.history.enabled,
            "series": len(self.history.series_names()),
        }
        status["incidents"] = self.incident_mgr.snapshot()
        if self._autoscaler is not None:
            status["elastic"] = self._autoscaler.status()
        if self._fault_plan is not None:
            status["faults"] = self._fault_plan.snapshot()
        return status

    def healthz(self) -> Dict[str, Any]:
        """Fleet readiness: ready while ANY replica is routable;
        degraded while ready but not every replica is HEALTHY."""
        states = {rep.id: rep.state
                  for rep in self.replicas.values()}
        ready = any(rep.routable for rep in self.replicas.values())
        degraded = ready and any(
            rep.state != HEALTHY for rep in self.replicas.values())
        reasons = [f"{rep.id}:{rep.state}"
                   for rep in self.replicas.values()
                   if rep.state != HEALTHY]
        h = {**obs_wire_stamp(),
             "alive": True, "ready": ready, "degraded": degraded,
             "reasons": reasons, "replicas": states,
             "in_flight": len(self.requests)}
        if self.remotes:
            h["remotes"] = {rem.id: rem.state
                            for rem in self.remotes.values()}
        return h

    # ---------------------------------------------------- remote plane
    def attach_remote(self, remote=None, *, url: Optional[str] = None,
                      rid: Optional[str] = None, cfg=None):
        """Attach an out-of-process replica by scrape URL (or a
        pre-built :class:`~deepspeed_tpu_torch.obs_wire.RemoteReplica`).

        Observability-plane only: the remote's statusz/SLO/history
        snapshots fold into the fleet rollups and its staleness state
        rides the health poll, but no traffic is routed to it — the
        transport split is a later PR.  The router's tracer is shared
        so a LOST transition lands in the incident stream."""
        from deepspeed_tpu_torch.obs_wire import RemoteReplica
        if remote is None:
            if url is None:
                raise ValueError(
                    "attach_remote needs a RemoteReplica or url=")
            rid = rid or f"remote{len(self.remotes)}"
            remote = RemoteReplica(url, rid, cfg=cfg,
                                   registry=self.registry,
                                   tracer=self.tracer)
        if remote.id in self.remotes or remote.id in self.replicas:
            raise ValueError(f"duplicate replica id {remote.id!r}")
        if remote.tracer is None:
            remote.tracer = self.tracer
        self.remotes[remote.id] = remote
        return remote

    def detach_remote(self, rid: str):
        """Drop a remote from the rollups (no-op if absent)."""
        rem = self.remotes.pop(rid, None)
        if rem is not None:
            rem.close()
        return rem

    def historyz(self) -> Dict[str, Any]:
        """The fleet ``/historyz`` document: the router's own ring set
        (fleet_* aggregates + scale/rollout annotations), recent
        incident-bundle metadata, and the cross-replica rollup of every
        live replica's history (rate/gauge series SUM per aligned
        bucket, percentile series take the MAX — the same discipline
        :func:`~deepspeed_tpu_torch.slo.fleet_rollup` applies to SLO state).
        Host-side bookkeeping only, safe to poll."""
        rep_snaps = [rep.history_snapshot()
                     for rep in self.replicas.values()
                     if rep.state != DEAD]
        # remote last-known history snapshots ride the same rollup
        # (history_rollup filters the Nones a never-scraped or
        # history-disabled remote contributes)
        rep_snaps.extend(rem.history_snapshot()
                         for rem in self.remotes.values())
        return {
            **obs_wire_stamp(),
            "history": self.history.snapshot(),
            "incidents": self.incident_mgr.snapshot(),
            "replica_rollup": history_rollup(
                [s for s in rep_snaps if s]),
        }

    # --------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        """Idempotent teardown: every replica engine, the rollup
        exporter, and the fault plan (if this router installed it)."""
        if self._closed:
            return
        self._closed = True
        if self._owns_fault_plan:
            faults_mod.clear_fault_plan(self._fault_plan)
        for rep in self.replicas.values():
            try:
                rep.engine.shutdown()
            except Exception:
                logger.exception("fleet: replica %s shutdown", rep.id)
        for rem in self.remotes.values():
            rem.close()
        ex = self._tel_exporter
        if ex is not None:
            try:
                ex.maybe_export(force=True)
            except Exception:
                pass
            ex.close()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


def tp_replica_mesh(index: int, tp: int, devices=None):
    """The JAX package's model-axis mesh for a ``fleet.tp`` replica.  A
    tensor-parallel replica of the port is a group of ``torch.
    distributed`` processes, which the in-process fleet cannot build:
    this raises ``NotImplementedError``."""
    raise NotImplementedError(
        f"fleet.tp={tp}: tensor-parallel fleet replicas (each a group of "
        "torch.distributed processes) are not in the port yet — ROADMAP "
        "A10's remainder; serve with fleet.tp = 1")


def _shared_weights(params, engine_kw):
    """``params`` placed ONCE on the replicas' device, so every replica's
    builder finds its leaves already there and serves the same tensors:
    N replicas hold one weight tree, not N copies.  A weight-streamed
    (``zero_inference``) fleet keeps its host tree as given."""
    from deepspeed_tpu_torch._device import resolve_device
    from deepspeed_tpu_torch._tree import tree_map
    from deepspeed_tpu_torch.config import ZeroInferenceConfig

    if ZeroInferenceConfig.coerce(engine_kw.get("zero_inference")).enabled:
        return params
    dev = resolve_device(engine_kw.get("device"))
    return tree_map(lambda t: t.to(dev) if hasattr(t, "to") else t,
                    params)


def fleet_router(params, cfg, *, fleet=None, telemetry=None,
                 tracing=None, faults=None, fabric=None,
                 history=None, incidents=None,
                 engine_builder=None, **engine_kw) -> FleetRouter:
    """Build a fleet of homogeneous replicas over one model + config.

    Each replica is built through :func:`~deepspeed_tpu_torch.inference.
    serving.serving_engine` (or ``engine_builder(params, cfg,
    replica_id=..., tracing=..., faults=..., **engine_kw)`` when
    given) with ``replica_id="r{i}"``; all replicas share ONE flight
    recorder — their events carry the replica tag — and one fault
    plan, installed by the router for its lifetime.  ``telemetry``
    configures the ROUTER's rollup registry/exporter (give replicas
    their own telemetry via ``engine_kw``; avoid fixed http ports
    there — N replicas cannot share one).  ``fabric`` (a config
    block, ``True``, or a pre-built :class:`~deepspeed_tpu_torch.kv_fabric.
    KVFabric`) attaches the cross-replica KV exchange to every
    replica — each then needs the ``kv_tier`` block in
    ``engine_kw``.  A ``devprof`` block in ``engine_kw`` rides the
    same passthrough: every replica gets its own compile sentinel,
    device-time counters and MFU/MBU gauges under its
    ``dstpu_r{i}`` metric namespace — one scrape shows which replica
    is recompiling or underutilized.

    ``params`` move to the replicas' device once (``engine_kw``'s
    ``device``; None = CUDA) and every replica serves that one tree.
    ``fleet.tp > 1`` raises ``NotImplementedError``."""
    fc = FleetConfig.coerce(fleet)
    if fc.tp > 1:
        tp_replica_mesh(0, fc.tp)       # raises: not in the port yet
    tracer = RequestTracer.from_config(TracingConfig.coerce(tracing))
    if isinstance(faults, FaultPlan):
        plan: Optional[FaultPlan] = faults
    else:
        fcfg = FaultsConfig.coerce(faults)
        plan = FaultPlan.from_config(fcfg) if fcfg.enabled else None
    build = engine_builder
    if build is None:
        from deepspeed_tpu_torch.inference.serving import serving_engine
        build = serving_engine
        params = _shared_weights(params, engine_kw)
    # install the plan BEFORE any engine sees it: ownership must land
    # on the ROUTER, not on replica 0 — otherwise killing replica 0
    # (its shutdown clears owned plans) would silently disarm the
    # chaos schedule for the survivors
    installed_here = faults_mod.ensure_installed(plan)
    engines = []
    try:
        for i in range(fc.replicas):
            kw_i = dict(engine_kw)
            # per-replica metric namespace (dstpu_r0, dstpu_r1, …):
            # the fleet exporter serves every replica's family on one
            # /metrics scrape without name collisions
            kw_i.setdefault("telemetry", MetricsRegistry(
                namespace=f"dstpu_r{i}"))
            engines.append(build(
                params, cfg, replica_id=f"r{i}", tracing=tracer,
                faults=plan, **kw_i))
        router = FleetRouter(engines, fleet=fc, telemetry=telemetry,
                             faults=plan, tracer=tracer, fabric=fabric,
                             history=history, incidents=incidents)
    except Exception:
        for e in engines:
            try:
                e.shutdown()
            except Exception:
                pass
        if installed_here:
            faults_mod.clear_fault_plan(plan)
        raise
    if installed_here:
        router._owns_fault_plan = True
    return router
