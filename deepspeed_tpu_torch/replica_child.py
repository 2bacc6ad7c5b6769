"""One serving replica in its own OS process: engine + wire plane +
transport endpoint (the port's twin of the JAX package's
``tools/replica_child.py``).  Run as::

    python -m deepspeed_tpu_torch.replica_child [--transport shm|tcp] \\
        [--engine-json SPEC] [--replica R] [--skew-ns N]

- **observability mode** (the default, ``--transport none``): build the
  engine behind a real ephemeral-port HTTP introspection server, run a
  small traced workload, print the ready handshake, serve until killed.
- **fleet mode** (``--transport shm|tcp``, what :mod:`~deepspeed_tpu_torch.
  proc_fleet` spawns): additionally serve the engine's submit / poll /
  migrate / handoff verbs over a :class:`~deepspeed_tpu_torch.transport.
  Channel`, so a router in another process drives it.

The engine spec arrives as a JSON blob (``--engine-json``)::

    {"model": {"family": "gpt2" | "llama", "preset": "llama3_8b",
               ...config fields},
     "engine": {...serving_engine keywords; "cache_dtype": "float32"},
     "seed": 0, "dtype": "bfloat16" | "float32",
     "device": "cuda" | "cpu", "weights": "path.npz" | null,
     "fabric": {...} | null}

``model.preset`` names a config classmethod (``LlamaConfig.llama3_8b``);
without it the family's ``tiny`` takes the fields; the remaining fields
override either (``n_layers`` cuts the depth).  The weights are the port's
seeded draw (:func:`~deepspeed_tpu_torch.weights.init_params` from a
``torch.Generator`` on the device seeded with ``seed``), so every process
on a host rebuilds the same tensors from ``(model config, seed)``; or, with
``weights``, an ``.npz`` of the JAX layout's leaves keyed by their
``/``-joined paths (:func:`save_weights_npz`), so a test hands the child
the JAX package's weights.  The replica runs on the card unless ``device``
says ``"cpu"``.

Protocol: prints ONE JSON line ``{"port": N, "pid": P, "replica": R,
"tcp_port": T|null, "caps": {...}}`` to stdout once the engine is up — the
parent's ready handshake.  SIGTERM drains cleanly (stop admitting, finish
in-flight, engine shutdown); SIGKILL is the failover path and needs no
cooperation from this process.  ``--skew-ns N`` shifts this process's
monotonic wire stamps (the clock-correlation probe).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time
from typing import Any, Dict

DEFAULT_SPEC: Dict[str, Any] = {
    "model": {"family": "gpt2", "dim": 32, "n_layers": 2,
              "n_heads": 2, "max_seq_len": 64},
    "engine": {"max_batch": 2, "page_size": 8, "num_pages": 24,
               "max_seq": 32, "prefill_bucket": 8,
               "slo": True, "history": True},
    "seed": 0,
}


def save_weights_npz(path: str, tree) -> None:
    """Write a JAX-layout weight tree (numpy leaves) as an ``.npz`` whose
    keys are the leaves' ``/``-joined paths: the ``weights`` of a child
    spec."""
    import numpy as np

    flat = {}

    def walk(x, prefix):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat[prefix] = np.asarray(x)

    walk(tree, "")
    np.savez(path, **flat)


def load_weights_npz(path: str) -> Dict[str, Any]:
    """Inverse of :func:`save_weights_npz`: the nested dict of numpy
    leaves."""
    import numpy as np

    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def model_config(m: Dict[str, Any]):
    """The spec's ``model`` block -> a config of the port's family."""
    m = dict(m)
    fam = m.pop("family", "gpt2")
    preset = m.pop("preset", None)
    if fam == "gpt2":
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config as C
    elif fam == "llama":
        from deepspeed_tpu_torch.models.llama import LlamaConfig as C
    else:
        raise SystemExit(f"replica_child: unsupported engine family "
                         f"{fam!r} (gpt2 or llama)")
    if preset is None:
        return C.tiny(**m)
    return dataclasses.replace(getattr(C, preset)(), **m)


def _torch_dtype(name):
    import torch

    return getattr(torch, name) if isinstance(name, str) else name


def build_engine(spec: Dict[str, Any], replica: str):
    """Deterministic engine construction from a JSON spec (see the module
    docstring): the same spec gives the same weights in every process."""
    import torch

    from deepspeed_tpu_torch.inference.serving import serving_engine
    from deepspeed_tpu_torch.weights import from_jax_params, init_params

    cfg = model_config(spec.get("model", {}))
    dev = torch.device(spec.get("device", "cuda"))
    dtype = _torch_dtype(spec.get("dtype", "bfloat16"))
    if spec.get("weights"):
        params = from_jax_params(load_weights_npz(spec["weights"]),
                                 device=dev, dtype=dtype)
    else:
        gen = torch.Generator(dev).manual_seed(int(spec.get("seed", 0)))
        params = init_params(cfg, gen, device=dev, dtype=dtype)
    kw = dict(spec.get("engine", {}))
    if "cache_dtype" in kw:
        kw["cache_dtype"] = _torch_dtype(kw["cache_dtype"])
    kw.setdefault("telemetry", {"http_port": 0})
    kw.setdefault("tracing", {"sample_rate": 1.0})
    eng = serving_engine(params, cfg, replica_id=replica, device=dev, **kw)
    fab = None
    if spec.get("fabric"):
        # a child-local TRANSIT fabric: export_pages stages entries here
        # before they cross the wire; admit publishes arrivals here so
        # admit_fabric's checksum-verified promotion path consumes them
        from deepspeed_tpu_torch.kv_fabric import KVFabric

        fab = KVFabric(spec["fabric"], registry=eng.registry)
        eng.attach_fabric(fab)
    return cfg, eng, fab


def kernel_wrappers() -> Dict[str, Any]:
    """Each hand-written kernel's wrapper by name; a wrapper's
    ``launches`` counts the launches of its kernel in this process."""
    from deepspeed_tpu_torch.env_report import env_probe
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_chunk_attention, paged_chunk_attention_quant,
        paged_chunk_attention_v1)
    from deepspeed_tpu_torch.ops.adam_cuda import adam_update
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_bwd_dkv,
                                                        flash_bwd_dq,
                                                        flash_fwd)
    from deepspeed_tpu_torch.ops.quant_cuda import quantize_rows
    from deepspeed_tpu_torch.ops.sampling_cuda import fused_greedy_rows

    return {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "fused_adam": adam_update,
            "paged_attention": paged_chunk_attention,
            "greedy_argmax": fused_greedy_rows,
            "paged_attention_quant": paged_chunk_attention_quant,
            "paged_attention_v1": paged_chunk_attention_v1,
            "quantize": quantize_rows, "env_probe": env_probe}


def kernel_launches() -> Dict[str, int]:
    """This process's launch count of each kernel (the ``launches`` verb:
    what a chip run reads to show which kernels a replica ran)."""
    return {name: int(f.launches) for name, f in kernel_wrappers().items()}


class ReplicaServer:
    """The child side of the proc-fleet protocol: a single-threaded serve
    loop that alternates transport handling with engine steps.  Finished
    results land in an ack-retained outbox — a lost or corrupted poll
    reply re-delivers them on the next poll."""

    def __init__(self, eng, fab, chan):
        self.eng, self.fab, self.chan = eng, fab, chan
        self.outbox = []            # [[idx, result dict], ...]
        self.next_idx = 0
        self.submitted = set()      # rpc dedup (retried submits)
        self.closing = False
        self._last_digest = None
        self._digest_v = 0

    # -------------------------------------------------------- encoding
    def _pump_finished(self):
        from deepspeed_tpu_torch.inference.serving import (RequestFailed,
                                                           RequestShed)
        eng = self.eng
        for rid in list(eng.finished.keys()):
            res = eng.finished.pop(rid)
            if isinstance(res, RequestShed):
                enc = {"rid": rid, "kind": "shed", "reason": res.reason,
                       "tier": res.tier}
            elif isinstance(res, RequestFailed):
                enc = {"rid": rid, "kind": "failed", "reason": res.reason,
                       "error": res.error, "tier": res.tier,
                       "generated": int(res.generated)}
            else:
                enc = {"rid": rid, "kind": "ok",
                       "tokens": [int(t) for t in res]}
            self.outbox.append([self.next_idx, enc])
            self.next_idx += 1

    def _progress(self):
        # req_ids ride as JSON VALUES (lists of pairs), never as object
        # keys — an int id must come back an int
        return {
            "queued": [r.req_id for r in self.eng.queue],
            "active": [[s.req.req_id, len(s.generated)]
                       for s in self.eng.slots if s is not None],
        }

    def _digest_delta(self):
        d = {k.hex(): v for k, v in self.eng.warm_digest().items()}
        if d == self._last_digest:
            return None
        self._last_digest = d
        self._digest_v += 1
        return d

    # -------------------------------------------------------- handlers
    def handle(self, msg, blobs):
        """Dispatch one request; returns (reply, reply blobs).  Every op is
        idempotent under RPC retry: duplicate submits dedup, a re-polled
        outbox re-delivers, a second take_queued / abandon finds
        nothing."""
        from deepspeed_tpu_torch import transport as tx
        from deepspeed_tpu_torch.inference.serving import EngineClosed

        eng = self.eng
        op = msg.get("op")
        if op == "submit":
            rid = msg["req_id"]
            key = repr(rid)
            if key in self.submitted:
                return {"ok": True, "dup": True}, ()
            arrival = time.perf_counter() - float(msg.get("age_s", 0.0))
            try:
                shed = eng.submit(
                    rid, msg["tokens"],
                    max_new_tokens=int(msg.get("max_new_tokens", 32)),
                    temperature=float(msg.get("temperature", 0.0)),
                    tier=msg.get("tier"), arrival=arrival)
            except EngineClosed:
                return {"closed": True}, ()
            except ValueError as e:
                return {"error": str(e)}, ()
            if shed is not None:
                eng.finished.pop(rid, None)
                return {"shed": {"reason": shed.reason,
                                 "tier": shed.tier}}, ()
            self.submitted.add(key)
            return {"ok": True}, ()
        if op == "poll":
            ack = int(msg.get("ack", -1))
            self.outbox = [e for e in self.outbox if e[0] > ack]
            self._pump_finished()
            rep = {
                "results": self.outbox,
                "progress": self._progress(),
                "has_work": bool(eng.has_work),
                "healthz": eng.healthz(),
                "slo": eng.slo_tracker.snapshot(),
                "counters": {"n_shed": eng._n_shed,
                             "n_failed": eng._n_failed,
                             "n_submitted": eng._n_submitted},
            }
            d = self._digest_delta()
            if d is not None:
                rep["digest"] = d
            rep["digest_v"] = self._digest_v
            return rep, ()
        if op == "take_queued":
            return {"queued": [r.req_id for r in eng.take_queued()]}, ()
        if op == "abandon":
            return {"inflight": [[r.req_id, int(g)]
                                 for r, g in eng.abandon_inflight()]}, ()
        if op == "export":
            keys = [bytes.fromhex(k) for k in msg["keys"]]
            if self.fab is None:
                return {"error": "no fabric on this child", "n": 0}, ()
            try:
                n = eng.export_pages(keys, fabric=self.fab)
            except Exception as e:
                return {"error": str(e), "n": 0}, ()
            entries = [self.fab.entries[k] for k in keys[:n]
                       if k in self.fab.entries]
            return tx.entries_to_frame(entries, {"n": n})
        if op == "admit":
            if self.fab is None:
                return {"error": "no fabric on this child",
                        "admitted": 0}, ()
            for e in tx.entries_from_frame(msg, blobs):
                try:
                    self.fab.publish(e.key, e)
                except Exception:
                    break
            keys = [bytes.fromhex(k) for k in msg["keys"]]
            deadline = time.perf_counter() + float(msg.get("budget_s", 5.0))
            n = eng.admit_fabric(keys, deadline=deadline)
            locs = [[k.hex(), "hbm" if k in eng.allocator.index
                     else (eng._kv_pool.location(k) or "host")]
                    for k in keys[:n]]
            return {"admitted": n, "locations": locs}, ()
        if op == "healthz":
            return eng.healthz(), ()
        if op == "launches":
            return {"launches": kernel_launches()}, ()
        if op == "check_leaks":
            return {"leaks": eng.check_leaks()}, ()
        if op == "warm_digest":
            return {"digest": {k.hex(): v for k, v in
                               eng.warm_digest().items()}}, ()
        if op == "shutdown":
            self.closing = True
            return {"ok": True}, ()
        return {"error": f"unknown op {op!r}"}, ()

    # ------------------------------------------------------ serve loop
    def serve(self, drain_grace_s: float = 10.0):
        from deepspeed_tpu_torch import transport as tx
        from deepspeed_tpu_torch.utils.logging import logger

        drain_deadline = None
        while True:
            if self.closing and drain_deadline is None:
                drain_deadline = time.monotonic() + drain_grace_s
            if self.closing and (not self.eng.has_work
                                 or time.monotonic() > drain_deadline):
                break
            timeout = 0.0 if self.eng.has_work else 0.02
            try:
                got = self.chan.recv(timeout_s=timeout)
            except tx.TransportCorrupt:
                continue        # drop the frame; the caller's RPC retry
                                # re-sends it
            except tx.TransportError:
                break           # the parent is gone
            if got is not None:
                msg, blobs = got
                try:
                    rep, rblobs = self.handle(msg, blobs)
                except Exception as e:
                    logger.exception("replica_child: op failed")
                    rep, rblobs = {"error": repr(e)}, ()
                if "_seq" in msg:
                    rep["_seq"] = msg["_seq"]
                try:
                    self.chan.send(rep, rblobs)
                except tx.TransportOversize as e:
                    # a reply past the ring (a long page train): answer
                    # the call with a typed error and keep serving; the
                    # router's migration falls back to re-prefill
                    err = {"error": f"reply too large for the transport: "
                                    f"{e}", "n": 0, "admitted": 0}
                    if "_seq" in msg:
                        err["_seq"] = msg["_seq"]
                    try:
                        self.chan.send(err)
                    except tx.TransportError:
                        break
                except tx.TransportError:
                    break
            if self.eng.has_work:
                try:
                    self.eng.step()
                except Exception:
                    logger.exception("replica_child: engine step")
                    break
                self._pump_finished()
            elif got is None and os.getppid() == 1:
                break           # orphaned by a dead parent: exit
        try:
            self.eng.shutdown()
        except Exception:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.replica_child")
    ap.add_argument("--replica", default="child0")
    ap.add_argument("--skew-ns", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4,
                    help="preload workload size (observability mode)")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--engine-json", default=None,
                    help="engine spec blob; default: a tiny gpt2 on the "
                         "card")
    ap.add_argument("--transport", default="none",
                    choices=("none", "tcp", "shm"))
    ap.add_argument("--shm-c2s", default=None)
    ap.add_argument("--shm-s2c", default=None)
    ap.add_argument("--accept-timeout-s", type=float, default=60.0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(int(os.environ.get("DSTPU_CHILD_THREADS", "1")))
    if args.skew_ns:
        # a foreign monotonic origin: every wire_stamp (and so every
        # /statusz, /healthz, /historyz, /tracez document this process
        # serves) reads skew_ns ahead of the true clock
        from deepspeed_tpu_torch import obs_wire
        from deepspeed_tpu_torch.inference import control_plane

        real_stamp = obs_wire.wire_stamp

        def skewed_stamp():
            d = real_stamp()
            d["t_mono_ns"] += args.skew_ns
            return d

        obs_wire.wire_stamp = skewed_stamp
        control_plane.wire_stamp = skewed_stamp

    spec = (json.loads(args.engine_json) if args.engine_json
            else DEFAULT_SPEC)
    cfg, eng, fab = build_engine(spec, args.replica)

    if args.requests:
        import numpy as np

        rng = np.random.default_rng(0)
        for i in range(args.requests):
            eng.submit(i, rng.integers(1, cfg.vocab_size, 6).tolist(),
                       max_new_tokens=args.new_tokens)
        eng.run()

    listener = None
    if args.transport == "tcp":
        from deepspeed_tpu_torch.transport import TcpListener

        listener = TcpListener()

    caps = {
        "kvt_on": bool(getattr(eng, "_kvt_on", False)),
        "pc_on": bool(getattr(eng, "_pc_on", False)),
        "eos": getattr(eng, "eos", None),
        "page_size": int(eng.page_size),
        "weights_version": getattr(eng, "weights_version", None),
        "max_seq": int(eng.max_seq),
        "vocab_size": int(cfg.vocab_size),
    }
    print(json.dumps({"port": eng._tel_exporter.port, "pid": os.getpid(),
                      "replica": args.replica,
                      "tcp_port": listener.port if listener else None,
                      "caps": caps}), flush=True)

    if args.transport == "none":
        # observability mode: HTTP is the only plane — serve until killed;
        # SIGTERM shuts the engine down cleanly
        def bye(signum, frame):
            eng.shutdown()
            sys.exit(0)

        signal.signal(signal.SIGTERM, bye)
        while True:
            time.sleep(0.2)

    from deepspeed_tpu_torch import transport as tx

    if args.transport == "tcp":
        endpoint = listener.accept(timeout_s=args.accept_timeout_s)
    else:
        if not (args.shm_c2s and args.shm_s2c):
            raise SystemExit("replica_child: --transport shm needs "
                             "--shm-c2s and --shm-s2c ring paths")
        endpoint = tx.attach_shm_pair(args.shm_c2s, args.shm_s2c, "server")
    chan = tx.Channel(endpoint, peer="parent", registry=eng.registry)
    server = ReplicaServer(eng, fab, chan)

    def drain(signum, frame):
        # SIGTERM = planned drain: stop admitting, let in-flight work
        # finish inside the serve loop's grace window, then shut down
        server.closing = True

    signal.signal(signal.SIGTERM, drain)
    server.serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
