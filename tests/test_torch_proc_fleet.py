"""The port's out-of-process fleet (``deepspeed_tpu_torch/proc_fleet.py``,
children ``python -m deepspeed_tpu_torch.replica_child``) and its scrape
plane (``obs_wire.py``) on the CPU.  The children load the JAX package's
tiny GPT-2 weights from an ``.npz`` (``replica_child.save_weights_npz``)
and serve in f32, one over the shm ring pair and one over TCP:

- a migration child -> router fabric -> child on an affinity miss, then a
  SIGKILL of one child mid-traffic: every request finishes with tokens
  identical to the JAX package's single in-process engine on the same
  weights, or fails typed (``replica_failed``); the survivor's
  ``check_leaks()`` is empty and no child is left running;
- ``RemoteReplica`` scrapes each child's ``/statusz`` / ``/healthz`` /
  ``/tracez`` to FRESH, and the merged trace is monotone;
- a child in observability mode with ``--skew-ns``: the clock-offset
  estimate recovers the skew within its error bound plus 20 ms, and the
  SIGKILLed child walks to LOST with its last snapshot kept.

Every spawn and wait is bounded (handshakes 60 s, polls 10 s)."""

import json
import os
import select
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.serving import serving_engine as jax_engine
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu_torch import faults
from deepspeed_tpu_torch.inference.serving import (RequestFailed,
                                                   RequestShed)
from deepspeed_tpu_torch.obs_wire import (FRESH, LOST, RemoteReplica,
                                          WireSchemaError,
                                          check_wire_schema,
                                          merge_trace_segments)
from deepspeed_tpu_torch.proc_fleet import proc_fleet_router
from deepspeed_tpu_torch.replica_child import DEFAULT_SPEC, save_weights_npz

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(dim=64, n_layers=2, n_heads=4, max_seq_len=128)
KW = dict(max_batch=2, page_size=8, num_pages=24, max_seq=64,
          prefill_bucket=8)
TIER = {"host_pool_bytes": 64 << 20}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_fault_plan()
    yield
    faults.clear_fault_plan()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg = jg.GPT2Config.tiny(**DIMS)
    jp = jax.device_get(jg.init_params(jax.random.PRNGKey(0), cfg))
    path = str(tmp_path_factory.mktemp("w") / "gpt2.npz")
    save_weights_npz(path, jp)
    return cfg, jp, path


def _scrape_fresh(rem, within_s=10.0):
    deadline = time.monotonic() + within_s
    while rem.state != FRESH and time.monotonic() < deadline:
        rem.poll()
        time.sleep(0.05)
    return rem.state


def test_shm_and_tcp_children_migrate_fail_over_and_scrape(weights):
    cfg, jp, path = weights
    rng = np.random.default_rng(5)
    pref = rng.integers(1, cfg.vocab_size, 24).tolist()
    warm = [pref + rng.integers(1, cfg.vocab_size, 3).tolist()
            for _ in range(3)]
    rest = [rng.integers(1, cfg.vocab_size, 6).tolist() for _ in range(8)]
    prompts = warm + rest
    # the tail generates long enough that the kill lands mid-generation
    new = [8] * len(warm) + [40] * len(rest)
    oracle = jax_engine(jp, cfg, cache_dtype=jnp.float32, **KW)
    for i, p in enumerate(prompts):
        oracle.submit(i, p, max_new_tokens=new[i])
    want = oracle.run()
    oracle.shutdown()

    spec = {"model": {"family": "gpt2", **DIMS},
            "engine": dict(KW, cache_dtype="float32", prefix_cache=True,
                           kv_tier=TIER),
            "seed": 0, "dtype": "float32", "device": "cpu",
            "weights": path, "fabric": True}
    router = proc_fleet_router(
        spec, proc_fleet={"replicas": 2, "spawn_timeout_s": 60,
                          "attach_scrape": True},
        transport=[{"kind": "shm"}, {"kind": "tcp"}],
        fleet={"replicas": 2, "affinity": False,
               "digest_refresh_steps": 1, "retry_budget": 2},
        fabric=True, tracing={"sample_rate": 1.0})
    procs = [rep.engine.proc for rep in router.replicas.values()]
    try:
        assert [rep.engine.chan.endpoint.kind
                for rep in router.replicas.values()] == ["shm", "tcp"]
        router.submit(0, warm[0], max_new_tokens=8)
        router.run()
        for i in (1, 2):                    # same prefix, spread by load
            router.submit(i, warm[i], max_new_tokens=8)
        router.run()
        assert router.statusz()["fleet"]["fabric"]["migrations"] >= 1
        for i in range(3, len(prompts)):
            router.submit(i, prompts[i], max_new_tokens=new[i])
        steps, killed = 0, False
        r1 = router.replicas["r1"].engine
        while router.has_work:
            router.step()
            steps += 1
            # the children step on their own between polls: SIGKILL r1
            # once a poll reply shows one of its requests past a token
            if not killed and any(g > 0 for g in r1._active.values()):
                router.kill_child("r1", signal.SIGKILL)
                killed = True
            assert steps < 100_000
        assert killed, "r1 finished before a poll saw it generating"
        res = router.finished
        assert set(res) == set(range(len(prompts)))
        for k, v in res.items():
            if isinstance(v, list):
                assert v == list(want[k])
            else:
                assert isinstance(v, (RequestFailed, RequestShed))
                if isinstance(v, RequestFailed):
                    assert v.reason == "replica_failed"
        assert router.orphaned() == []
        assert router.last_failover["replica"] == "r1"
        assert router.replicas["r0"].engine.check_leaks() == []
        assert sum(1 for e in router.tracer.recorder.events()
                   if e[3] == "replica_dead") == 1
        # the scrape plane: the survivor's wire surface to FRESH, its
        # trace drained and merged onto this process's clock
        rem = router.remotes["scrape-r0"]
        assert _scrape_fresh(rem) == FRESH
        assert rem.healthz()["ready"] is True
        check_wire_schema(rem.last_statusz, "/statusz")
        evs, meta = rem.fetch_trace(since=0)
        assert meta["replica"] == "r0" and evs
        off, err = rem.estimate_clock_offset()
        merged = merge_trace_segments([{"events": evs, "offset_ns": off,
                                        "err_ns": err, "replica": "r0"}])
        ts = [e["ts"] for e in merged["traceEvents"] if "ts" in e]
        assert ts and ts == sorted(ts)
        rows = router.statusz()["fleet"]["replicas"]
        assert any(r.get("replica") == "scrape-r0" or
                   r.get("id") == "scrape-r0" for r in rows)
    finally:
        router.shutdown()
    for p in procs:
        assert p.poll() is not None         # every child reaped


def test_observability_child_skew_and_loss():
    skew_ns = 120_000_000
    child = subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.replica_child",
         "--replica", "kid", "--skew-ns", str(skew_ns),
         "--engine-json", json.dumps(dict(DEFAULT_SPEC, device="cpu"))],
        cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    try:
        ready, _, _ = select.select([child.stdout], [], [], 60.0)
        assert ready, "no handshake within 60 s"
        line = child.stdout.readline()
        assert line, f"child died before its handshake ({child.poll()})"
        hs = json.loads(line)
        assert hs["replica"] == "kid" and hs["tcp_port"] is None
        from deepspeed_tpu_torch.config import ObsWireConfig

        rem = RemoteReplica(
            f"http://127.0.0.1:{hs['port']}", "kid",
            cfg=ObsWireConfig(enabled=True, poll_interval_s=0.05,
                              timeout_s=2.0, stale_after_s=0.5,
                              lost_after_s=1.0, offset_probes=8))
        assert _scrape_fresh(rem, 30.0) == FRESH
        assert rem.statusz_row()["state"] == "healthy"
        off, err = rem.estimate_clock_offset()
        assert abs(off - skew_ns) <= err + 20_000_000
        evs, meta = rem.fetch_trace(since=0)
        assert meta["replica"] == "kid" and len(evs) > 0
        assert rem.fetch_metrics()
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=10)
        deadline = time.monotonic() + 10
        while rem.state != LOST and time.monotonic() < deadline:
            rem.poll()
            time.sleep(0.05)
        assert rem.state == LOST and rem.last_statusz is not None
        assert rem.statusz_row()["scrape_state"] == LOST
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
    with pytest.raises(WireSchemaError):
        check_wire_schema({"wire_schema": "2.0"}, "/statusz")
    with pytest.raises(WireSchemaError):
        check_wire_schema({}, "/statusz")


class _LiveProc:
    """A stand-in child process that never exits (the serve loop runs on
    a thread of the test process)."""

    pid = 0

    def poll(self):
        return None


def test_oversized_reply_is_a_typed_error_and_the_child_serves_on(tmp_path):
    """A page train larger than the shm ring (4 slots of 4 KiB here): the
    child answers the export with a typed error and keeps serving, the
    proxy's export raises ``IOError`` and its admit of the same chain
    admits nothing (a migration fallback), and neither side is lost."""
    import threading

    from deepspeed_tpu_torch import transport as tx
    from deepspeed_tpu_torch.config import ProcFleetConfig
    from deepspeed_tpu_torch.inference.prefix_cache import (
        matchable_pages, page_keys)
    from deepspeed_tpu_torch.kv_fabric import KVFabric
    from deepspeed_tpu_torch.proc_fleet import ProcEngine
    from deepspeed_tpu_torch.replica_child import ReplicaServer, build_engine

    spec = {"model": {"family": "gpt2", **DIMS},
            "engine": dict(KW, cache_dtype="float32", prefix_cache=True,
                           kv_tier=TIER),
            "seed": 0, "dtype": "float32", "device": "cpu", "fabric": True}
    cfg, eng, fab = build_engine(spec, "c0")
    prompt = np.random.default_rng(7).integers(1, cfg.vocab_size,
                                               40).tolist()
    eng.submit(0, prompt, max_new_tokens=2)
    eng.run()
    keys = page_keys(prompt, eng.page_size)[
        :matchable_pages(len(prompt), eng.page_size)]
    # 4 pages of 2 layers x (K, V) x 8 rows x 64 f32 = 8 KiB each: the
    # chain is twice the ring
    router_fab = KVFabric(True)
    assert eng.export_pages(keys, fabric=router_fab) == len(keys) == 4
    c2s, s2c = tx.create_shm_pair(str(tmp_path), "c0", slot_bytes=4096,
                                  n_slots=4)
    server = ReplicaServer(eng, fab, tx.Channel(
        tx.attach_shm_pair(c2s, s2c, "server"), peer="parent"))
    th = threading.Thread(target=server.serve, daemon=True)
    th.start()
    proxy = ProcEngine(
        _LiveProc(), tx.Channel(tx.attach_shm_pair(c2s, s2c, "client"),
                                peer="c0"),
        {"page_size": eng.page_size, "max_seq": eng.max_seq,
         "kvt_on": True, "pc_on": True}, rid="c0",
        pf=ProcFleetConfig(poll_timeout_s=10.0))
    try:
        proxy.attach_fabric(KVFabric(True))
        with pytest.raises(IOError, match="too large for the transport"):
            proxy.export_pages(keys)
        assert th.is_alive()
        proxy.attach_fabric(router_fab)
        assert proxy.admit_fabric(keys) == 0
        assert proxy.check_leaks() == [] and th.is_alive()
    finally:
        server.closing = True
        th.join(timeout=20)
    assert not th.is_alive()
