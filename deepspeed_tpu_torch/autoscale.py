"""Elastic fleet: autoscaling on control-plane signals, zero-downtime
rolling weight updates, and streamed warm cold-start (port of
``deepspeed_tpu/autoscale.py``; host code over the port's engines).

:class:`~deepspeed_tpu_torch.fleet.FleetRouter` has the verbs —
``drain()`` with warm-digest handoff, ``rejoin()``, ``spawn()``/
``retire()``, health hysteresis — and the engines' control plane emits
the signals (rolling goodput, multiwindow burn rates, shed rate, queue
depth).  This module closes the loop: a :class:`FleetAutoscaler` polls
the fleet's own signals every ``eval_interval_steps`` router steps and
drives

- **scale-down**: sustained low pressure → ``drain()`` the least
  useful routable replica (its warm prefix digest hands to the
  affinity successor, its queued work re-routes uncharged), then
  ``retire()`` once the in-flight work finished — a replica leaves the
  ring without dropping a request;
- **scale-up**: sustained queue/shed/burn pressure → spawn a replica
  from the registered ``engine_factory``.  With
  ``cold_start="streamed"`` the factory builds a ZeRO-Inference
  weight-streamed engine (ZeRO-Infinity tiering, arXiv:2104.07857;
  ZeRO-Offload host staging, arXiv:2101.06840): the replica serves its
  FIRST request while its weight image still lives on host/NVMe, and
  the autoscaler promotes layers onto the card between scheduler steps
  (:meth:`~deepspeed_tpu_torch.inference.zero_inference.
  ZeroInferenceServingEngine.promote_resident_layers`) until the
  engine flips to fully resident — cold capacity in seconds, full
  speed shortly after;
- **hysteresis + cooldown**: pressure must persist ``up_after`` /
  ``down_after`` consecutive evaluations, and ``cooldown_s`` separates
  scale events, so a burn-rate blip never flaps the fleet; replica
  count stays inside ``[min_replicas, max_replicas]``, and a fleet
  that fell under the floor (failover deaths) heals back up to it.

On the same machinery, **rolling weight updates**
(:meth:`FleetAutoscaler.rollout`): the fleet walks one replica at a
time through drain → swap (:meth:`~deepspeed_tpu_torch.inference.serving.
ServingEngine.swap_params`, which also invalidates the now
version-poisoned warm prefix pages) → rejoin, old and new versions
serving side by side with per-version SLO rollups
(:func:`~deepspeed_tpu_torch.slo.fleet_rollup` ``versions=``).  Between
replicas the autoscaler soaks ``rollout_soak_steps`` ticks watching
the NEW version's burn rate; a trip past
``rollback_burn_threshold`` halts the rollout and walks the
already-updated replicas BACK (drain → swap old → rejoin) — an
upgrade never drops or double-generates a request, and a bad one
un-ships itself.

Chaos composes: the ``scale`` fault rules inject engine-factory
failures and slow cold-starts at the spawn path, and a ``replica``
kill rule with ``after=`` lands mid-rollout; a chaos run drives a
load wave through all of it and asserts token identity, zero
orphans/leaks, and an exactly-once scale/rollout event trace.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional

from deepspeed_tpu_torch import faults as faults_mod
from deepspeed_tpu_torch.config import AutoscaleConfig
from deepspeed_tpu_torch.fleet import (DEAD, DEGRADED, DRAINING, HEALTHY,
                                 QUARANTINED)
from deepspeed_tpu_torch.utils.logging import logger

# scale-down victim preference: retire the sickest routable-or-parked
# replica first (a QUARANTINED one serves nothing anyway)
_VICTIM_RANK = {QUARANTINED: 0, DEGRADED: 1, HEALTHY: 2}
_COLD_START_BUCKETS_S = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                         60.0, 120.0)


class FleetAutoscaler:
    """Drive a :class:`~deepspeed_tpu_torch.fleet.FleetRouter` elastically.

    ``engine_factory(replica_id, streamed=False)`` builds one fleet-
    compatible replica engine (same model and page geometry as the
    existing replicas; pass ``replica_id=`` through to the engine and
    share the fleet's tracer/fault plan, exactly like
    :func:`~deepspeed_tpu_torch.fleet.fleet_router` does at construction).
    ``streamed=True`` is only passed when ``cold_start="streamed"`` —
    the factory then builds the ZeRO-Inference engine whose weights
    page in from host/NVMe while it serves.

    Surface: :meth:`step` (router step + autoscaler tick — the drive
    loop's one call), :meth:`tick` (advance scaling/cold-start/rollout
    state without stepping the router), :meth:`rollout` (start a
    rolling weight update), :meth:`status` (the ``/statusz``
    ``elastic`` block).  The autoscaler is single-threaded with the
    router by design: everything happens between scheduler steps, so
    no engine is ever mutated mid-sweep.
    """

    def __init__(self, router, engine_factory: Callable[..., Any], *,
                 autoscale=None):
        self.cfg = AutoscaleConfig.coerce(autoscale)
        self.router = router
        self.factory = engine_factory
        live = sum(1 for rep in router.replicas.values()
                   if rep.state != DEAD)
        self.target = min(max(live, self.cfg.min_replicas),
                          self.cfg.max_replicas)
        self._tracer = router.tracer

        r = router.registry
        self._c_ups = r.counter(
            "autoscale_scale_ups", "replicas spawned by the autoscaler")
        self._c_downs = r.counter(
            "autoscale_scale_downs",
            "autoscaler drain→retire scale-downs completed")
        self._c_rollout_steps = r.counter(
            "autoscale_rollout_steps",
            "replicas walked through drain→swap→rejoin by a rollout "
            "(rollback steps count too — each is the same walk)")
        self._c_rollbacks = r.counter(
            "autoscale_rollbacks",
            "rollouts halted and rolled back by a new-version "
            "burn-rate trip")
        self._c_factory_failures = r.counter(
            "autoscale_factory_failures",
            "scale-ups aborted by an engine-factory failure (retried "
            "at a later evaluation)")
        self._c_flips = r.counter(
            "autoscale_cold_flips",
            "streamed cold-start replicas promoted to fully resident")
        self._g_replicas = r.gauge(
            "autoscale_replicas", "live (non-DEAD) replicas in the ring")
        self._g_target = r.gauge(
            "autoscale_target_replicas",
            "replica count the autoscaler is steering toward")
        self._h_cold = r.histogram(
            "autoscale_cold_start_seconds",
            "scale-up decision -> replica fully serving (streamed "
            "cold-starts: the resident flip; resident ones: the first "
            "completed request)", _COLD_START_BUCKETS_S)

        self._last_eval_step = router._steps
        self._last_scale_t: Optional[float] = None
        self._up_streak = 0
        self._down_streak = 0
        self._last_shed_seen = router._n_shed
        self._last_signals: Dict[str, Any] = {}
        # in-flight cold starts: rid -> {t0, streamed, first_token_s,
        # flip_s} — closed records move to cold_history (bounded: an
        # indefinitely breathing fleet must not grow host memory per
        # scale cycle)
        self._cold: Dict[str, Dict[str, Any]] = {}
        self.cold_history: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=256)
        self._retiring: set = set()
        self._rollout: Optional[Dict[str, Any]] = None
        self.last_rollout: Optional[Dict[str, Any]] = None
        # (swap_callable, version) once a rollout completed: replicas
        # spawned later swap onto the current version before serving
        self._current_weights = None
        # host-side ledger of every scale/rollout decision (the soak
        # reconciles it 1:1 against the trace ring; bounded like the
        # ring itself)
        self.events: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=4096)
        router.attach_autoscaler(self)
        self._update_gauges()

    # ------------------------------------------------------------ events
    def _event(self, kind: str, **attrs) -> None:
        self.events.append({"kind": kind,
                            "t": time.perf_counter(), **attrs})
        if self._tracer.enabled:
            self._tracer.event(kind, attrs=attrs)
        # scale/rollout decisions double as history annotations: the
        # /historyz timeline (and any incident bundle's pre-window)
        # shows WHEN the fleet breathed next to the series that made
        # it breathe
        h = getattr(self.router, "history", None)
        if h is not None:
            h.annotate(kind, attrs)

    # ------------------------------------------------------------- drive
    def step(self) -> List[Any]:
        """One elastic-fleet iteration: router step, then the
        autoscaler tick.  Returns the router's newly finished ids."""
        done = self.router.step()
        self.tick()
        return done

    def tick(self) -> None:
        """Advance autoscaler state WITHOUT stepping the router: cold
        starts promote toward residency, drained victims retire, an
        active rollout walks/soaks/rolls back, and — on the evaluation
        cadence — the control-plane signals are polled for scale
        pressure."""
        now = time.perf_counter()
        self._advance_cold(now)
        self._advance_retiring(now)
        due = self.cfg.enabled and (
            self.router._steps - self._last_eval_step
            >= self.cfg.eval_interval_steps)
        if due:
            self._last_eval_step = self.router._steps
        if self._rollout is not None:
            self._advance_rollout(now)
            # pressure-driven scaling pauses during a rollout (one
            # fleet mutation at a time) — but HEALING does not: a
            # mid-rollout replica death must not leave the fleet under
            # its floor for the rest of the walk (the spawn joins the
            # rollout plan and updates in turn)
            if due:
                self._evaluate(now, heal_only=True)
        elif due:
            self._evaluate(now)
        self._update_gauges()

    def _update_gauges(self) -> None:
        if not self.router.registry.enabled:
            return
        self._g_replicas.set(sum(
            1 for rep in self.router.replicas.values()
            if rep.state != DEAD))
        self._g_target.set(self.target)

    # ------------------------------------------------------------ signals
    def _max_burn(self, reps) -> float:
        worst = 0.0
        for rep in reps:
            snap = rep.engine.slo_tracker.snapshot()
            if not snap.get("enabled"):
                continue
            for t in snap.get("tiers", {}).values():
                for b in t.get("burn_rates", {}).values():
                    worst = max(worst, float(b))
        return worst

    def _evaluate(self, now: float, heal_only: bool = False) -> None:
        router = self.router
        live = [rep for rep in router.replicas.values()
                if rep.state != DEAD]
        if heal_only:
            effective = len(live) - len(self._retiring)
            if effective < self.cfg.min_replicas:
                self._scale_up(now, reason="heal")
                self._last_scale_t = now
            return
        pool = [rep for rep in live if rep.routable]
        # a saturation storm can quarantine EVERY replica (shed
        # activity reads as degraded until the shed window ages out):
        # that is maximal up-pressure, not a reason to stop looking —
        # a fresh replica is exactly what un-wedges the fleet
        wedged = not pool
        if wedged:
            pool = [rep for rep in live
                    if rep.state == QUARANTINED]
            if not pool:
                return      # only draining/dying: failover's problem
        qdepth = sum(len(rep.engine.queue)
                     for rep in pool) / len(pool)
        shed_now = router._n_shed
        sheds = shed_now - self._last_shed_seen
        self._last_shed_seen = shed_now
        burn = self._max_burn(pool)
        effective = len(live) - len(self._retiring)
        up = (wedged
              or qdepth >= self.cfg.scale_up_queue_depth
              or (self.cfg.scale_up_on_shed and sheds > 0)
              or burn > self.cfg.scale_up_burn)
        # under the floor (failover deaths): heal up regardless of load
        heal = effective < self.cfg.min_replicas
        down = (not up and qdepth <= self.cfg.scale_down_queue_depth
                and sheds == 0 and burn <= self.cfg.scale_up_burn)
        if up:
            self._up_streak += 1
            self._down_streak = 0
        elif down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        self._last_signals = {
            "queue_depth_per_replica": round(qdepth, 3),
            "sheds_since_last_eval": sheds,
            "max_burn": round(burn, 3),
            "effective_replicas": effective,
        }
        if getattr(router, "_roles_on", False):
            # disaggregated fleets scale per role: the pressured pool
            # gets the next spawn, and the per-role depths ride the
            # elastic statusz block
            self._last_signals["role_queue_depth"] = {
                ro: (round(v, 3) if v != float("inf") else "inf")
                for ro, v in router.role_pressure().items()}
        if not heal and self._last_scale_t is not None and \
                now - self._last_scale_t < self.cfg.cooldown_s:
            return          # cooling down: streaks keep accumulating
        if (heal or self._up_streak >= self.cfg.up_after) and \
                effective < self.cfg.max_replicas:
            self._scale_up(now, reason="heal" if heal else "pressure")
            self._up_streak = 0
            self._last_scale_t = now
        elif self._down_streak >= self.cfg.down_after and \
                effective > self.cfg.min_replicas and \
                not self._retiring:
            self._scale_down(now)
            self._down_streak = 0
            self._last_scale_t = now

    # ----------------------------------------------------------- scale up
    def _next_rid(self) -> str:
        router = self.router
        while f"r{router._spawn_seq}" in router.replicas:
            router._spawn_seq += 1
        return f"r{router._spawn_seq}"

    def _scale_up(self, now: float, reason: str = "pressure") -> None:
        rid = self._next_rid()
        streamed = self.cfg.cold_start == "streamed"
        t0 = time.perf_counter()
        try:
            # the `scale` fault hook: an error rule is a factory
            # failure, a latency rule a slow cold-start (the sleep
            # lands inside the cold_start_seconds histogram)
            faults_mod.inject("scale", key=rid)
            eng = (self.factory(rid, streamed=True) if streamed
                   else self.factory(rid))
        except Exception as e:
            self._c_factory_failures.inc()
            logger.warning(
                "autoscale: scale-up of %s aborted (factory: %s) — "
                "will retry at a later evaluation", rid, e)
            self._event("autoscale_up_failed", replica=rid,
                        error=repr(e)[:200])
            return
        cur = self._current_weights
        if cur is not None:
            swap, version = cur
            if str(eng.weights_version) != str(version):
                # the fleet already rolled to `version`: a replica the
                # factory built on the old image swaps before it ever
                # serves (it is drained by construction).  A failing
                # swap is a failed spawn — a wrong-version replica
                # must never enter rotation, and a crash here would
                # take down the whole serve loop
                try:
                    swap(eng)
                except Exception as e:
                    self._c_factory_failures.inc()
                    logger.warning(
                        "autoscale: scale-up of %s aborted (version "
                        "catch-up swap to %r: %s)", rid, version, e)
                    self._event("autoscale_up_failed", replica=rid,
                                error=repr(e)[:200])
                    try:
                        eng.shutdown()
                    except Exception:
                        pass
                    return
        role = None
        if getattr(self.router, "_roles_on", False):
            # spawn into the pressured pool (a role with no routable
            # member reads as infinite pressure and heals first)
            pressure = self.router.role_pressure()
            role = max(sorted(pressure), key=lambda ro: pressure[ro])
        self.router.spawn(eng, rid, role=role)
        if self._rollout is not None:
            # a replica added mid-rollout (heal after a rollout
            # casualty, or genuine pressure) comes up on the factory's
            # OLD image — appending it to the plan lets the normal
            # walk bring it to the target version, and keeps the
            # invariant that a completed rollout leaves every live
            # replica current (a rollback leaves it untouched: it was
            # never updated, so it is already on the old version)
            self._rollout["plan"].append(rid)
        self.target = max(self.target,
                          sum(1 for rep in self.router.replicas.values()
                              if rep.state != DEAD))
        self._c_ups.inc()
        streaming = streamed and \
            not getattr(eng, "fully_resident", True)
        if not streaming:
            # a resident engine is fully serving the moment the
            # factory returns — the histogram records build+spawn time
            self._h_cold.observe(time.perf_counter() - t0)
        self._cold[rid] = {
            "replica": rid, "t0": t0, "streamed": streaming,
            "first_token_s": None, "flip_s": None}
        self._event("autoscale_up", replica=rid, reason=reason,
                    streamed=streaming)

    def _pending_flip(self, rid: str) -> bool:
        """True while ``rid`` is a streamed cold-start whose resident
        flip has not landed — the only cold-start state that must
        block scale-down victim selection (an idle resident spawn is
        a perfectly good victim)."""
        rec = self._cold.get(rid)
        return rec is not None and rec["streamed"] \
            and rec["flip_s"] is None

    def _advance_cold(self, now: float) -> None:
        for rid in list(self._cold):
            rec = self._cold[rid]
            rep = self.router.replicas.get(rid)
            if rep is None or rep.state == DEAD:
                # died/retired before finishing its cold start
                self.cold_history.append(self._cold.pop(rid))
                continue
            if rep.state == DRAINING and not self._pending_flip(rid):
                # leaving rotation before its first token: record
                # what we have (a streamed spawn mid-flip keeps its
                # record — the promote loop below must finish even
                # through a rollout's drain)
                self.cold_history.append(self._cold.pop(rid))
                continue
            eng = rep.engine
            if rec["first_token_s"] is None and (
                    rep.completed > 0
                    or any(s is not None and len(s.generated)
                           for s in eng.slots)):
                rec["first_token_s"] = round(now - rec["t0"], 3)
            if rec["streamed"] and rec["flip_s"] is None:
                try:
                    eng.promote_resident_layers(
                        self.cfg.promote_layers_per_tick)
                except Exception:
                    logger.exception(
                        "autoscale: layer promotion on %s", rid)
                if eng.fully_resident:
                    rec["flip_s"] = round(now - rec["t0"], 3)
                    self._c_flips.inc()
                    self._h_cold.observe(now - rec["t0"])
                    self._event("autoscale_flip", replica=rid,
                                cold_start_s=rec["flip_s"])
                elif getattr(eng, "resident_flip_blocked", False):
                    # the HBM budget cannot hold another layer:
                    # streaming IS this replica's steady state (the
                    # >HBM operating point) — the cold start is done,
                    # there is no flip to wait for
                    rec["flip_s"] = round(now - rec["t0"], 3)
                    rec["budget_bound"] = True
                    self._h_cold.observe(now - rec["t0"])
                    self._event("autoscale_flip_budget_bound",
                                replica=rid,
                                cold_start_s=rec["flip_s"])
            # a record closes once the replica is fully serving AND
            # its first token was seen (the bench's scale_up-to-first-
            # token metric); only a pending streamed FLIP gates run()
            # — an idle resident spawn may simply never see traffic
            if rec["first_token_s"] is not None and (
                    not rec["streamed"] or rec["flip_s"] is not None):
                self.cold_history.append(self._cold.pop(rid))

    # --------------------------------------------------------- scale down
    def _scale_down(self, now: float) -> None:
        # (never reached while a rollout is active: tick() routes to
        # the heal-only evaluation then)
        cands = [rep for rep in self.router.replicas.values()
                 if rep.state in _VICTIM_RANK
                 and not self._pending_flip(rep.id)
                 # never scale a configured role's LAST replica away:
                 # routing would degrade to the other pool, silently
                 # un-disaggregating the fleet at every load trough
                 and not self.router.last_of_role(rep)]
        if not cands:
            return
        victim = min(cands, key=lambda rep: (_VICTIM_RANK[rep.state],
                                             rep.load()))
        self.router.drain(victim.id)
        self._retiring.add(victim.id)
        self.target = max(self.cfg.min_replicas, self.target - 1)
        self._event("autoscale_down", replica=victim.id,
                    state=victim.state)

    def _advance_retiring(self, now: float) -> None:
        for rid in list(self._retiring):
            rep = self.router.replicas.get(rid)
            if rep is None:
                self._retiring.discard(rid)
                continue
            if rep.state == DEAD or self.router.drained(rid):
                try:
                    # a victim that died mid-drain retires through
                    # the same verb: its work was already salvaged
                    self.router.retire(rid)
                except ValueError:
                    # the OTHER replicas died while this one drained:
                    # it is now the fleet's last live replica — the
                    # scale-down cancels and it goes back into
                    # rotation instead of crashing the loop
                    self._retiring.discard(rid)
                    self.router.rejoin(rid)
                    self._event("autoscale_down_cancelled",
                                replica=rid)
                    continue
                self._retiring.discard(rid)
                self._c_downs.inc()
                self._event("autoscale_down_done", replica=rid)

    # ------------------------------------------------------------ rollout
    def rollout(self, new_params=None, *, version,
                swap: Optional[Callable[[Any], None]] = None,
                rollback: Optional[Callable[[Any], None]] = None
                ) -> None:
        """Start a rolling weight update to ``version``.

        Default swap: ``engine.swap_params(new_params, version)`` (the
        resident engines).  For decomposed/streamed engines pass
        ``swap=`` (e.g. wrapping
        :meth:`~deepspeed_tpu_torch.inference.zero_inference.
        ZeroInferenceServingEngine.swap_weights`) and ``rollback=`` —
        without a rollback callable the autoscaler captures each
        engine's served param tree before swapping and restores it via
        ``swap_params``, which only works when the engine serves a
        plain tree.

        The walk advances inside :meth:`tick`: drain the next replica
        (warm digest handed PAST the upcoming rollout target — the
        drain-successor guard), swap once drained, rejoin, then soak
        ``rollout_soak_steps`` ticks watching the new version's burn
        rate before the next replica.  A trip halts and rolls back.
        A replica that dies mid-rollout is skipped (failover already
        salvaged its work) and the walk continues on the survivors."""
        if self._rollout is not None:
            raise RuntimeError(
                f"rollout to {self._rollout['version']!r} is still in "
                "progress — one rollout at a time")
        if swap is None:
            if new_params is None:
                raise ValueError(
                    "rollout needs new_params (for the default "
                    "swap_params path) or an explicit swap= callable")
            swap = lambda eng: eng.swap_params(new_params, version)  # noqa: E731
        plan = [rid for rid, rep in self.router.replicas.items()
                if rep.state != DEAD]
        if not plan:
            raise RuntimeError("rollout on a fleet with no live replicas")
        if rollback is None:
            for rid in plan:
                if self.router.replicas[rid].engine.params is None:
                    raise ValueError(
                        f"replica {rid} serves a decomposed weight "
                        "image (params tree is None) — pass rollback= "
                        "alongside swap= so a halted rollout can "
                        "restore it")
        self._rollout = {
            "version": version,
            "plan": plan, "i": 0,
            "state": "next",
            "target": None,
            "updated": [],
            "skipped": [],
            "old": {},          # rid -> (params, version) for rollback
            "swap": swap, "rollback": rollback,
            "soak_left": 0,
            "rb_queue": [],
            "halted": False, "rolled_back": False,
            "halt_burn": None,
            "t0": time.perf_counter(),
        }
        self._event("rollout_start", version=str(version),
                    replicas=len(plan))

    @property
    def rollout_active(self) -> bool:
        return self._rollout is not None

    def _version_burn(self, version):
        """(max burn, classified-request count) across live replicas
        serving ``version`` — the halt-and-rollback trigger reads the
        NEW version's burn only, so a sick old replica cannot veto its
        own replacement."""
        worst, n = 0.0, 0
        for rep in self.router.replicas.values():
            if rep.state == DEAD or str(rep.version) != str(version):
                continue
            snap = rep.engine.slo_tracker.snapshot()
            if not snap.get("enabled"):
                continue
            for t in snap.get("tiers", {}).values():
                n += int(t.get("window_finished", 0))
                for b in t.get("burn_rates", {}).values():
                    worst = max(worst, float(b))
        return worst, n

    def _swap_and_rejoin(self, rid: str, swap) -> bool:
        """Swap a drained replica's weights and put it back in
        rotation; False = the swap failed (the replica rejoins on its
        OLD weights so capacity is never stranded — the event's
        ``version`` records what it actually serves)."""
        rep = self.router.replicas[rid]
        try:
            swap(rep.engine)
            ok = True
        except Exception:
            logger.exception("autoscale: weight swap on %s", rid)
            ok = False
        self.router.rejoin(rid)
        self._c_rollout_steps.inc()
        self._event("rollout_step", replica=rid,
                    version=str(rep.version), ok=ok)
        return ok

    def _advance_rollout(self, now: float) -> None:
        ro = self._rollout
        router = self.router
        state = ro["state"]

        if state == "next":
            while ro["i"] < len(ro["plan"]):
                rid = ro["plan"][ro["i"]]
                rep = router.replicas.get(rid)
                if rep is None or rep.state == DEAD:
                    # died before its turn: failover salvaged it,
                    # the walk continues on the survivors
                    ro["skipped"].append(rid)
                    self._event("rollout_target_died", replica=rid)
                    ro["i"] += 1
                    continue
                if rid in self._retiring or rep.state == DRAINING:
                    # already leaving the ring (scale-down or an
                    # operator drain): not ours to update
                    ro["skipped"].append(rid)
                    ro["i"] += 1
                    continue
                if str(rep.version) == str(ro["version"]):
                    ro["i"] += 1    # already current (spawned mid-roll)
                    continue
                # drain-successor guard: the warm digest must skip the
                # NEXT rollout target — it is about to drain too, and
                # the hint would die there
                upcoming = {r for r in ro["plan"][ro["i"] + 1:]
                            if r in router.replicas
                            and router.replicas[r].state != DEAD}
                ro["target"] = rid
                router.drain(rid, successor_exclude=upcoming)
                ro["state"] = "draining"
                return
            # walked the whole plan: done
            self._finish_rollout(completed=True)
            return

        if state == "draining":
            rid = ro["target"]
            rep = router.replicas.get(rid)
            if rep is None or rep.state == DEAD:
                ro["skipped"].append(rid)
                self._event("rollout_target_died", replica=rid)
                ro["i"] += 1
                ro["state"] = "next"
                return
            if not router.drained(rid):
                return
            eng = rep.engine
            ro["old"][rid] = (eng.params, eng.weights_version)
            if self._swap_and_rejoin(rid, ro["swap"]):
                ro["updated"].append(rid)
            ro["i"] += 1
            ro["soak_left"] = self.cfg.rollout_soak_steps
            ro["state"] = "soaking"
            return

        if state == "soaking":
            burn, n = self._version_burn(ro["version"])
            if n >= self.cfg.rollback_min_finished and \
                    burn > self.cfg.rollback_burn_threshold:
                ro["halted"] = True
                ro["halt_burn"] = round(burn, 3)
                ro["rb_queue"] = [r for r in reversed(ro["updated"])
                                  if r in router.replicas]
                ro["state"] = "rolling_back"
                self._c_rollbacks.inc()
                self._event("rollout_halt", version=str(ro["version"]),
                            burn=ro["halt_burn"],
                            updated=len(ro["updated"]))
                return
            ro["soak_left"] -= 1
            if ro["soak_left"] <= 0:
                ro["state"] = "next"
            return

        if state == "rolling_back":
            rid = ro["target"]
            if rid is not None and ro.get("rb_draining"):
                rep = router.replicas.get(rid)
                if rep is None or rep.state == DEAD:
                    ro["rb_draining"] = False
                    ro["target"] = None
                elif router.drained(rid):
                    old_params, old_version = ro["old"][rid]
                    rb = ro["rollback"]
                    if rb is None:
                        rb = (lambda eng, _p=old_params, _v=old_version:
                              eng.swap_params(_p, _v))
                    self._swap_and_rejoin(rid, rb)
                    ro["rb_draining"] = False
                    ro["target"] = None
                else:
                    return
            while ro["rb_queue"]:
                rid = ro["rb_queue"].pop(0)
                rep = router.replicas.get(rid)
                if rep is None or rep.state == DEAD:
                    continue
                ro["target"] = rid
                router.drain(rid)
                ro["rb_draining"] = True
                return
            ro["rolled_back"] = True
            self._finish_rollout(completed=False)
            return

    def _finish_rollout(self, completed: bool) -> None:
        ro = self._rollout
        summary = {
            "version": str(ro["version"]),
            "completed": completed,
            "halted": ro["halted"],
            "rolled_back": ro["rolled_back"],
            "halt_burn": ro["halt_burn"],
            "updated": len(ro["updated"]),
            "skipped": list(ro["skipped"]),
            "total": len(ro["plan"]),
            "duration_s": round(time.perf_counter() - ro["t0"], 3),
        }
        if completed:
            # future scale-ups must serve the new version: remember how
            # to bring a factory-fresh engine onto it
            self._current_weights = (ro["swap"], ro["version"])
            self._event("rollout_done", version=str(ro["version"]),
                        updated=len(ro["updated"]))
        else:
            self._event("rollout_rolled_back",
                        version=str(ro["version"]),
                        restored=len(ro["updated"]))
        self.last_rollout = summary
        self._rollout = None

    # ------------------------------------------------------------- status
    def status(self) -> Dict[str, Any]:
        """The fleet ``/statusz`` ``elastic`` block (host-side
        bookkeeping only — safe to poll; ``dstpu_top`` renders it)."""
        now = time.perf_counter()
        cooldown = 0.0
        if self._last_scale_t is not None:
            cooldown = max(
                0.0, self.cfg.cooldown_s - (now - self._last_scale_t))
        ro = self._rollout
        rollout: Dict[str, Any] = {"active": ro is not None}
        if ro is not None:
            rollout.update({
                "version": str(ro["version"]),
                "state": ro["state"],
                "updated": len(ro["updated"]),
                "total": len(ro["plan"]),
                "halted": ro["halted"],
            })
        elif self.last_rollout is not None:
            rollout.update(self.last_rollout)
        return {
            "enabled": self.cfg.enabled,
            "target_replicas": self.target,
            "min_replicas": self.cfg.min_replicas,
            "max_replicas": self.cfg.max_replicas,
            "live_replicas": sum(
                1 for rep in self.router.replicas.values()
                if rep.state != DEAD),
            "scale_ups": int(self._c_ups.value),
            "scale_downs": int(self._c_downs.value),
            "factory_failures": int(self._c_factory_failures.value),
            "cold_flips": int(self._c_flips.value),
            "rollout_steps": int(self._c_rollout_steps.value),
            "rollbacks": int(self._c_rollbacks.value),
            "cold_starts_in_flight": len(self._cold),
            "retiring": sorted(self._retiring),
            "cooldown_remaining_s": round(cooldown, 3),
            "pressure": {
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                **self._last_signals,
            },
            "rollout": rollout,
            "events": [
                {k: v for k, v in e.items() if k != "t"}
                for e in list(self.events)[-16:]],
        }

    # ------------------------------------------------------------- drive
    def run(self, max_steps: int = 10_000) -> Dict[Any, Any]:
        """Drive router + autoscaler until the fleet is idle AND no
        elastic operation (cold start, retirement, rollout) is in
        flight."""
        steps = 0

        def flip_pending():
            return any(rec["streamed"] and rec["flip_s"] is None
                       for rec in self._cold.values())

        while self.router.has_work or self._rollout is not None \
                or self._retiring or flip_pending():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("elastic loop did not converge")
        return dict(self.router.finished)
