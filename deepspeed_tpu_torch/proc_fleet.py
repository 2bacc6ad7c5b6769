"""Out-of-process fleet: child replica processes behind the router (port
of ``deepspeed_tpu/proc_fleet.py``; the children run
``python -m deepspeed_tpu_torch.replica_child``).

The crossing of the process boundary is deliberately NOT a second
router.  :class:`ProcEngine` is a proxy that speaks the exact
engine surface :class:`~deepspeed_tpu_torch.fleet.FleetRouter` drives
(submit / step / take_queued / abandon_inflight / export_pages /
admit_fabric / healthz / check_leaks / warm_digest / shutdown), so
every fleet semantic — affinity routing, harvest-first failover, the
typed never-double-generate partition, drain, roles, statusz,
incidents — runs UNCHANGED over replicas that live in their own OS
processes.  The bytes move over :mod:`deepspeed_tpu_torch.transport`
(shared-memory ring same-host, length-prefixed TCP generally),
selected by the ``transport`` config block.

Correctness never depends on the wire:

- Results are ack-retained in the child's outbox — a lost or corrupt
  poll reply re-delivers on the next poll; a frame that fails crc is
  dropped and the RPC retried.
- Migrated pages hop child → router fabric → child carrying their
  demote-time per-buffer crc32s verbatim; a corruption that survives
  the frame crc still dies at the importer's promotion-time checksum
  and re-prefills (``_promotion_fallback`` stays the last line).
- A SIGKILLed child needs no cooperation to fail over: the proxy
  mirrors the child's queued/in-flight state from every poll reply,
  so the router's salvage (``take_queued`` / ``abandon_inflight``)
  synthesizes the partition from last-reported knowledge — zero
  reported tokens re-places on a survivor, any reported tokens fails
  typed, and tokens that never surfaced through a harvest were never
  delivered to anyone, so at-most-once delivery holds.
"""

from __future__ import annotations

import json
import os
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch import faults as faults_mod
from deepspeed_tpu_torch import transport as tx
from deepspeed_tpu_torch.config import (FaultsConfig, ProcFleetConfig,
                                        TracingConfig, TransportConfig)
from deepspeed_tpu_torch.faults import FaultPlan
from deepspeed_tpu_torch.fleet import FleetRouter
from deepspeed_tpu_torch.history import NULL_HISTORY
from deepspeed_tpu_torch.inference.serving import (EngineClosed,
                                                   RequestFailed,
                                                   RequestShed)
from deepspeed_tpu_torch.request_trace import RequestTracer
from deepspeed_tpu_torch.telemetry import MetricsRegistry
from deepspeed_tpu_torch.utils.logging import logger

# the directory that holds the package: the children's working directory,
# so ``-m deepspeed_tpu_torch.replica_child`` finds this checkout's code
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD_MODULE = "deepspeed_tpu_torch.replica_child"

# the default child: a tiny deterministic gpt2 on the card — (config, seed)
# is the whole weight image, so every process on this host rebuilds
# identical params and cross-process token identity is checkable
DEFAULT_CHILD_SPEC: Dict[str, Any] = {
    "model": {"family": "gpt2", "dim": 32, "n_layers": 2,
              "n_heads": 2, "max_seq_len": 64},
    "engine": {"max_batch": 2, "page_size": 8, "num_pages": 24,
               "max_seq": 32, "prefill_bucket": 8},
    "seed": 0,
}


class _ReqRef:
    """The shape the router's salvage verbs actually read: an object
    with a ``req_id`` (the fleet ledger carries everything else)."""

    __slots__ = ("req_id",)

    def __init__(self, req_id):
        self.req_id = req_id


class _ProxySlo:
    """Last-known child SLO snapshot behind the tracker surface the
    router reads (``snapshot``/``forget``)."""

    def __init__(self):
        self._snap: Dict[str, Any] = {"enabled": False}

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        return dict(self._snap)

    def forget(self, req_id) -> None:
        pass


class _ProxyPool:
    """Digest-backed stand-in for the child's spill-pool index: the
    router's migration planner asks ``has``/``location`` for LOCAL
    coverage, and the freshest truth this process holds is the
    digest mirrored off poll replies and admit acknowledgements.
    Staleness only costs an extra (idempotent, already-warm-is-free)
    page shipment — never correctness."""

    def __init__(self, owner: "ProcEngine"):
        self._owner = owner

    def has(self, key: bytes) -> bool:
        return key in self._owner._digest

    def location(self, key: bytes) -> Optional[str]:
        return self._owner._digest.get(key)


class _ProxyAllocator:
    __slots__ = ("index",)

    def __init__(self):
        self.index: Dict[bytes, int] = {}


class ProcEngine:
    """One child replica process behind the ServingEngine duck-surface
    the router drives.  ``step()`` is a poll RPC (the child's own
    serve loop does the actual engine stepping between replies);
    everything the router later needs after a SIGKILL — queued ids,
    per-request progress, health, digest — is mirrored out of every
    reply, because a dead child answers nothing."""

    def __init__(self, proc: subprocess.Popen, chan: tx.Channel,
                 caps: Dict[str, Any], *, rid: str,
                 pf: ProcFleetConfig, tracer=None,
                 registry: Optional[MetricsRegistry] = None,
                 http_port: Optional[int] = None,
                 ring_paths: Tuple[str, ...] = ()):
        self.proc = proc
        self.chan = chan
        self.cfg = pf
        self.replica_id = rid
        self.http_port = http_port
        self._ring_paths = ring_paths
        self.page_size = int(caps["page_size"])
        self.max_seq = int(caps["max_seq"])
        self.eos = caps.get("eos")
        self.weights_version = caps.get("weights_version")
        self._pc_on = bool(caps.get("pc_on", False))
        self._kvt_on = bool(caps.get("kvt_on", False))
        self.registry = registry if registry is not None \
            else MetricsRegistry(namespace=f"dstpu_{rid}")
        if tracer is not None and getattr(tracer, "enabled", False) \
                and hasattr(tracer, "bind"):
            self.tracer = tracer.bind(replica=rid)
        else:
            from deepspeed_tpu_torch.request_trace import NULL_TRACER
            self.tracer = tracer if tracer is not None else NULL_TRACER
        self.history = NULL_HISTORY
        self.slo_tracker = _ProxySlo()
        self.allocator = _ProxyAllocator()
        self._kv_pool = _ProxyPool(self)
        self._fabric = None
        self.finished: Dict[Any, Any] = {}
        # ---- the SIGKILL mirror: last-reported child state
        self.queue: List[Any] = []           # queued req_ids
        self._active: Dict[Any, int] = {}    # req_id -> generated
        self._digest: Dict[bytes, str] = {}
        self._digest_v = -1
        self._child_has_work = False
        self._health: Optional[Dict[str, Any]] = None
        self._health_t = -1e18
        self._counters = {"n_shed": 0, "n_failed": 0, "n_submitted": 0}
        self._ack = -1
        self._closed = False

    # --------------------------------------------------------- plumbing
    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def slots(self) -> List[Any]:
        # the router only counts non-None entries
        return list(self._active.keys())

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self._active or self._child_has_work)

    @property
    def _n_shed(self) -> int:
        return self._counters["n_shed"]

    @property
    def _n_failed(self) -> int:
        return self._counters["n_failed"]

    @property
    def _n_submitted(self) -> int:
        return self._counters["n_submitted"]

    def child_alive(self) -> bool:
        return not self._closed and self.proc.poll() is None

    def _rpc(self, msg: Dict[str, Any], blobs=(), *,
             timeout_s: Optional[float] = None,
             retries: int = 1) -> Tuple[Dict[str, Any], List[Any]]:
        """One RPC to the child; every op in the protocol is
        idempotent under retry, so a corrupt/lost frame costs one
        resend.  Any unrecoverable failure (dead process, exhausted
        retries) surfaces as :class:`EngineClosed` — the exact typed
        signal the router's placement and health paths already treat
        as 'this replica cannot serve'."""
        if self._closed:
            raise EngineClosed(
                f"proxy for replica {self.replica_id} is shut down")
        last: Optional[BaseException] = None
        for _ in range(retries + 1):
            rc = self.proc.poll()
            if rc is not None:
                raise EngineClosed(
                    f"replica {self.replica_id} child process died "
                    f"(rc={rc})")
            try:
                rep, rblobs = self.chan.request(
                    msg, blobs,
                    timeout_s=timeout_s or self.cfg.poll_timeout_s)
            except tx.TransportOversize:
                raise           # nothing was sent; a resend cannot fit
            except tx.TransportError as e:
                last = e
                continue
            if rep.get("closed"):
                raise EngineClosed(
                    f"replica {self.replica_id} engine is closed")
            return rep, rblobs
        raise EngineClosed(
            f"replica {self.replica_id} transport failed: {last}")

    # ------------------------------------------------------- submission
    def submit(self, req_id, tokens, max_new_tokens: int = 32,
               temperature: float = 0.0, tier: Optional[str] = None,
               arrival: Optional[float] = None):
        age = 0.0 if arrival is None \
            else max(0.0, time.perf_counter() - arrival)
        rep, _ = self._rpc({
            "op": "submit", "req_id": req_id,
            "tokens": [int(t) for t in tokens],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "tier": tier, "age_s": age,
        })
        if rep.get("error"):
            raise ValueError(rep["error"])
        if "shed" in rep:
            shed = RequestShed(req_id, rep["shed"]["reason"],
                               rep["shed"].get("tier"))
            # mirror the in-process contract: a shed is recorded in
            # finished AND returned (the router pops it on retry)
            self.finished[req_id] = shed
            self._counters["n_shed"] += 1
            self._counters["n_submitted"] += 1
            return shed
        self._counters["n_submitted"] += 1
        self.queue = list(self.queue) + [req_id]
        return None

    # ------------------------------------------------------------ step
    def step(self) -> List[Any]:
        rep, _ = self._rpc({"op": "poll", "ack": self._ack})
        self._absorb_poll(rep)
        return []

    def _absorb_poll(self, rep: Dict[str, Any]) -> None:
        for idx, enc in rep.get("results", []):
            self._ack = max(self._ack, int(idx))
            rid = enc["rid"]
            kind = enc.get("kind")
            if kind == "ok":
                self.finished[rid] = [int(t) for t in enc["tokens"]]
            elif kind == "shed":
                self.finished[rid] = RequestShed(
                    rid, enc["reason"], enc.get("tier"))
            else:
                self.finished[rid] = RequestFailed(
                    rid, enc["reason"], enc.get("error", ""),
                    enc.get("tier"),
                    generated=int(enc.get("generated", 0)))
            self._active.pop(rid, None)
        prog = rep.get("progress")
        if prog is not None:
            self.queue = list(prog.get("queued", []))
            self._active = {rid: int(g)
                            for rid, g in prog.get("active", [])}
        self._child_has_work = bool(rep.get("has_work", False))
        h = rep.get("healthz")
        if h is not None:
            self._health, self._health_t = h, time.monotonic()
        slo = rep.get("slo")
        if slo is not None:
            self.slo_tracker._snap = slo
        c = rep.get("counters")
        if c is not None:
            self._counters.update(c)
        d = rep.get("digest")
        if d is not None and rep.get("digest_v", 0) > self._digest_v:
            self._digest = {bytes.fromhex(k): v for k, v in d.items()}
            self._digest_v = int(rep.get("digest_v", 0))

    # ----------------------------------------------------------- health
    def healthz(self) -> Dict[str, Any]:
        rc = self.proc.poll()
        if rc is not None:
            # the SIGKILL detection path: the router's health poll
            # turns this into _fail_replica on the next step
            raise EngineClosed(
                f"replica {self.replica_id} child process died "
                f"(rc={rc})")
        now = time.monotonic()
        if self._health is not None and \
                now - self._health_t < self.cfg.health_cache_s:
            return self._health
        rep, _ = self._rpc({"op": "healthz"})
        self._health, self._health_t = rep, time.monotonic()
        return rep

    # -------------------------------------------------- fleet handoffs
    def take_queued(self) -> List[_ReqRef]:
        """Queue salvage.  Live child: a real RPC pops its queue.
        Dead child: synthesize from the mirror — these requests never
        reported progress, so re-placing them cannot double-generate."""
        rids = list(self.queue)
        if self.child_alive():
            try:
                rep, _ = self._rpc({"op": "take_queued"})
                rids = list(rep.get("queued", []))
            except EngineClosed:
                pass            # fall back to the mirror
        self.queue = []
        return [_ReqRef(r) for r in rids]

    def abandon_inflight(self) -> List[Tuple[_ReqRef, int]]:
        """Slot salvage.  Dead child: last-REPORTED token counts
        drive the router's partition — any harvested progress fails
        typed (re-running would double-generate), zero-progress work
        re-places.  Tokens generated after the last poll never
        surfaced to any caller, so at-most-once delivery holds."""
        pairs = [[rid, g] for rid, g in self._active.items()]
        if self.child_alive():
            try:
                rep, _ = self._rpc({"op": "abandon"})
                pairs = rep.get("inflight", pairs)
            except EngineClosed:
                pass
        self._active = {}
        return [(_ReqRef(r), int(g)) for r, g in pairs]

    # -------------------------------------------------------- fabric
    def attach_fabric(self, fabric) -> None:
        if fabric is not None and not self._kvt_on:
            raise ValueError(
                "attach_fabric needs the kv_tier block — the child's "
                "spill pool is the admission side of the transport")
        self._fabric = fabric

    def warm_digest(self) -> Dict[bytes, str]:
        return dict(self._digest)

    # dstpu: hot-path — page trains cross the process boundary here
    def export_pages(self, keys: List[bytes], fabric=None) -> int:
        """Owner-side migration leg: the child exports into its
        transit fabric and ships the serialized entries (crc32s
        riding verbatim); this proxy republishes them into the
        ROUTER's fabric, where the usual publish-side fault rules and
        kv_fabric_* metrics apply."""
        fab = fabric if fabric is not None else self._fabric
        if fab is None or not self._kvt_on:
            raise ValueError(
                "export_pages needs an attached fabric and the "
                "kv_tier block")
        rep, blobs = self._rpc(
            {"op": "export", "keys": [k.hex() for k in keys]},
            timeout_s=self.cfg.poll_timeout_s)
        if rep.get("error"):
            raise IOError(
                f"replica {self.replica_id} export failed: "
                f"{rep['error']}")
        for e in tx.entries_from_frame(rep, blobs):
            try:
                fab.publish(e.key, e)
            except Exception:
                break           # chain-prefix discipline: stop here
        return fab.covers(keys)

    # dstpu: hot-path — page trains cross the process boundary here
    def admit_fabric(self, keys: List[bytes],
                     deadline: Optional[float] = None) -> int:
        """Target-side migration leg: fetch the chain out of the
        ROUTER's fabric (its fetch-side fault rules and metrics fire
        here, same as in-process) and ship it to the child, whose own
        ``admit_fabric`` runs the checksum-verified promotion path."""
        fab = self._fabric
        if fab is None or not self._kvt_on:
            raise ValueError(
                "admit_fabric needs an attached fabric and the "
                "kv_tier block")
        entries = []
        for k in keys:
            if k in self._digest:
                continue        # child-warm already: nothing to ship
            if not fab.has(k):
                break
            try:
                entries.append(fab.fetch(k))
            except (KeyError, IOError, OSError):
                break
        budget = 5.0 if deadline is None \
            else max(0.05, deadline - time.perf_counter())
        msg, blobs = tx.entries_to_frame(entries, {
            "op": "admit", "keys": [k.hex() for k in keys],
            "budget_s": budget})
        try:
            rep, _ = self._rpc(
                msg, blobs, timeout_s=budget + self.cfg.poll_timeout_s)
        except tx.TransportOversize as e:
            # the chain does not fit the ring: admit nothing, the router
            # counts a migration fallback and the request re-prefills
            logger.warning("proc_fleet: admit to %s skipped (%s)",
                           self.replica_id, e)
            return 0
        for kh, loc in rep.get("locations", []):
            self._digest[bytes.fromhex(kh)] = loc
        return int(rep.get("admitted", 0))

    # ------------------------------------------------------- accounting
    def check_leaks(self) -> List[str]:
        if not self.child_alive():
            # a SIGKILLed child's pages died with its address space —
            # there is nothing left to leak in THIS process tree
            return []
        try:
            rep, _ = self._rpc({"op": "check_leaks"})
        except EngineClosed:
            return []
        return list(rep.get("leaks", []))

    # -------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        p = self.proc
        if p.poll() is None:
            try:
                self.chan.request({"op": "shutdown"}, timeout_s=1.0)
            except Exception:
                pass
            try:
                p.terminate()
                p.wait(timeout=self.cfg.shutdown_grace_s)
            except subprocess.TimeoutExpired:
                logger.warning(
                    "proc_fleet: replica %s ignored SIGTERM for %.1fs "
                    "— SIGKILL", self.replica_id,
                    self.cfg.shutdown_grace_s)
                p.kill()
                try:
                    p.wait(timeout=self.cfg.shutdown_grace_s)
                except subprocess.TimeoutExpired:
                    pass
            except Exception:
                pass
        else:
            try:
                p.wait(timeout=1.0)
            except Exception:
                pass
        self.chan.close()


# --------------------------------------------------------------------
# spawn + builder
# --------------------------------------------------------------------

def _read_handshake(p: subprocess.Popen,
                    timeout_s: float) -> Dict[str, Any]:
    deadline = time.monotonic() + timeout_s
    while True:
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise RuntimeError(
                f"replica child pid {p.pid} produced no handshake "
                f"within {timeout_s}s")
        r, _, _ = select.select([p.stdout], [], [], min(rem, 1.0))
        if r:
            line = p.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"replica child died before the handshake "
                    f"(rc={p.poll()})")
            try:
                hs = json.loads(line)
            except ValueError:
                continue            # not the handshake (a stray print)
            if isinstance(hs, dict) and "pid" in hs:
                return hs
        if p.poll() is not None:
            raise RuntimeError(
                f"replica child died before the handshake "
                f"(rc={p.poll()})")


def spawn_replica(rid: str, spec: Dict[str, Any], *,
                  transport: Optional[TransportConfig] = None,
                  proc_fleet: Optional[ProcFleetConfig] = None,
                  workdir: Optional[str] = None,
                  tracer=None) -> ProcEngine:
    """Spawn one child replica process and connect its transport.
    ``transport.kind`` ``"auto"`` resolves to shm — the children this
    builder spawns are same-host by construction; pin ``"tcp"`` to
    exercise the general path."""
    return _connect_child(_start_child(rid, spec, transport, proc_fleet,
                                       workdir), tracer)


def _start_child(rid, spec, transport, proc_fleet, workdir) -> Dict[str, Any]:
    """Start a child (its rings made first for shm); the ready handshake is
    :func:`_connect_child`'s, so a fleet starts every child before it waits
    for any."""
    tc = TransportConfig.coerce(transport)
    pf = ProcFleetConfig.coerce(proc_fleet)
    kind = "shm" if tc.kind == "auto" else tc.kind
    cmd = [sys.executable, "-m", _CHILD_MODULE, "--replica", rid,
           "--requests", "0",
           "--engine-json", json.dumps(spec),
           "--transport", kind,
           "--accept-timeout-s", str(pf.spawn_timeout_s)]
    rings: Tuple[str, ...] = ()
    wd = workdir or tempfile.mkdtemp(prefix="dstpu-shm-")
    if kind == "shm":
        c2s, s2c = tx.create_shm_pair(
            wd, rid, slot_bytes=tc.slot_bytes, n_slots=tc.ring_slots)
        rings = (c2s, s2c)
        cmd += ["--shm-c2s", c2s, "--shm-s2c", s2c]
    # the child's log: read back into the error when it dies early
    err_path = os.path.join(wd, f"{rid}.stderr")
    with open(err_path, "w") as err:
        p = subprocess.Popen(cmd, cwd=_ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=err)
    return {"rid": rid, "proc": p, "tc": tc, "pf": pf, "kind": kind,
            "rings": rings, "err_path": err_path}


def _connect_child(st: Dict[str, Any], tracer=None) -> ProcEngine:
    """Wait for a started child's handshake and connect its transport; a
    child that fails is killed and reaped."""
    rid, p, tc, pf = st["rid"], st["proc"], st["tc"], st["pf"]
    rings = st["rings"]
    try:
        try:
            hs = _read_handshake(p, pf.spawn_timeout_s)
        except RuntimeError as e:
            with open(st["err_path"]) as f:
                tail = f.read()[-2000:]
            raise RuntimeError(f"{e}; child stderr tail:\n{tail}") from None
        registry = MetricsRegistry(namespace=f"dstpu_{rid}")
        if st["kind"] == "shm":
            endpoint = tx.attach_shm_pair(rings[0], rings[1], "client")
            reconnect = None
        else:
            port = int(hs["tcp_port"])
            endpoint = tx.connect_tcp(
                "127.0.0.1", port, attempts=tc.connect_attempts,
                backoff_s=tc.backoff_s, timeout_s=tc.io_timeout_s)
            reconnect = lambda: tx.connect_tcp(        # noqa: E731
                "127.0.0.1", port, attempts=tc.connect_attempts,
                backoff_s=tc.backoff_s, timeout_s=tc.io_timeout_s)
        chan = tx.Channel(endpoint, peer=rid, registry=registry,
                          reconnect=reconnect,
                          io_timeout_s=tc.io_timeout_s)
        return ProcEngine(p, chan, hs["caps"], rid=rid, pf=pf,
                          tracer=tracer, registry=registry,
                          http_port=hs.get("port"),
                          ring_paths=rings)
    except Exception:
        _reap(p)
        raise


def _reap(p: subprocess.Popen) -> None:
    if p.poll() is None:
        p.kill()
        p.wait(timeout=10)


class ProcFleetRouter(FleetRouter):
    """A FleetRouter whose replicas are :class:`ProcEngine` proxies;
    teardown additionally reaps the children's shm ring files."""

    _proc_workdir: Optional[str] = None

    def kill_child(self, rid: str, sig: int = signal.SIGKILL) -> float:
        """Deliver a REAL signal to a child replica process (a
        mid-generation SIGKILL).  Returns the kill time
        (perf_counter) so recovery_s is measured from the actual
        signal, not from detection."""
        eng = self.replicas[rid].engine
        t = time.perf_counter()
        os.kill(eng.pid, sig)
        return t

    def shutdown(self) -> None:
        super().shutdown()
        wd = self._proc_workdir
        if wd is not None:
            shutil.rmtree(wd, ignore_errors=True)
            self._proc_workdir = None


def proc_fleet_router(spec: Optional[Dict[str, Any]] = None, *,
                      proc_fleet=None, transport=None, fleet=None,
                      telemetry=None, tracing=None, faults=None,
                      fabric=None, history=None,
                      incidents=None) -> ProcFleetRouter:
    """Build a fleet of OUT-OF-PROCESS replicas over one child spec.

    The shape mirrors :func:`~deepspeed_tpu_torch.fleet.fleet_router`: one
    shared tracer, one fault plan installed by the router (transport
    and fabric rules fire in THIS process, where the channels and the
    router fabric live), per-replica ``dstpu_r{i}`` metric namespaces
    (here carrying the proxy's ``transport_*`` channel family).  The
    children rebuild identical params from ``(spec.model,
    spec.seed)``; the router speaks the wire through
    :class:`ProcEngine` proxies and every FleetRouter behavior —
    routing, migration, failover, drain, statusz — applies verbatim.
    With ``proc_fleet.attach_scrape`` the children's HTTP wire
    surfaces additionally ride the scrape plane (:mod:`~deepspeed_tpu_torch.
    obs_wire`) as ``RemoteReplica`` rows.

    ``transport`` may also be a list of blocks, one per replica (replica
    ``i`` speaks ``transport[i]``): a shm child beside a TCP one."""
    pf = ProcFleetConfig.coerce(proc_fleet)
    tcs = ([TransportConfig.coerce(t) for t in transport]
           if isinstance(transport, (list, tuple))
           else [TransportConfig.coerce(transport)] * pf.replicas)
    if len(tcs) != pf.replicas:
        raise ValueError(f"{len(tcs)} transport blocks for "
                         f"{pf.replicas} replicas")
    spec = spec if spec is not None else DEFAULT_CHILD_SPEC
    tracer = RequestTracer.from_config(TracingConfig.coerce(tracing))
    if isinstance(faults, FaultPlan):
        plan: Optional[FaultPlan] = faults
    else:
        fcfg = FaultsConfig.coerce(faults)
        plan = FaultPlan.from_config(fcfg) if fcfg.enabled else None
    # install BEFORE any channel exists: ownership lands on the router
    installed_here = faults_mod.ensure_installed(plan)
    workdir = tempfile.mkdtemp(prefix="dstpu-procfleet-")
    engines: List[ProcEngine] = []
    started: List[Dict[str, Any]] = []
    try:
        # every child builds its engine at once; then each handshake
        for i in range(pf.replicas):
            started.append(_start_child(f"r{i}", spec, tcs[i], pf,
                                        workdir))
        for st in started:
            engines.append(_connect_child(st, tracer))
        router = ProcFleetRouter(
            engines, fleet=fleet, telemetry=telemetry, faults=plan,
            tracer=tracer, fabric=fabric, history=history,
            incidents=incidents)
    except Exception:
        for e in engines:
            try:
                e.shutdown()
            except Exception:
                pass
        for st in started[len(engines):]:
            _reap(st["proc"])
        shutil.rmtree(workdir, ignore_errors=True)
        if installed_here:
            faults_mod.clear_fault_plan(plan)
        raise
    if installed_here:
        router._owns_fault_plan = True
    router._proc_workdir = workdir
    if pf.attach_scrape:
        from deepspeed_tpu_torch.config import ObsWireConfig
        scfg = ObsWireConfig(enabled=True, poll_interval_s=0.2,
                             timeout_s=2.0, stale_after_s=2.0,
                             lost_after_s=6.0)
        for e in engines:
            if e.http_port:
                router.attach_remote(
                    url=f"http://127.0.0.1:{e.http_port}",
                    rid=f"scrape-{e.replica_id}", cfg=scfg)
    return router
