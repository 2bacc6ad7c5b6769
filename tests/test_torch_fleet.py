"""The port's fleet router (``deepspeed_tpu_torch/fleet.py``) against the
JAX package's ``fleet_router`` on tiny GPT-2 (dim 64, 2 layers, 4 heads)
with the same weights (``weights.from_jax_params``), f32 on the CPU.  The
same script drives both packages and the comparison is exact: every
request's tokens or typed result, the replica each request was placed on
(``router.requests[rid].replica`` right after ``submit``), the routing and
failover counts of ``statusz()["fleet"]``, and the failover ledger —

- two waves over three shared prefixes on three replicas (the second
  wave's affinity hits);
- a seeded ``replica`` fault plan that kills ``r1`` mid-traffic and
  forces ``r0`` degraded: the re-placed / failed-typed partition, and
  finished + failed + shed = submitted;
- ``drain`` mid-traffic, ``rejoin``, and a second wave;
- fleet-level and per-replica shedding under a burst;

with ``check_leaks()`` and ``orphaned()`` empty on both after each.  And
``fleet.tp > 1`` raises ``NotImplementedError`` in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import faults as jfaults
from deepspeed_tpu import fleet as jfleet
from deepspeed_tpu.inference.serving import serving_engine as jax_engine
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu_torch import faults
from deepspeed_tpu_torch import fleet as tfleet
from deepspeed_tpu_torch.inference.serving import (RequestFailed,
                                                   RequestShed)
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

KW = dict(max_batch=2, page_size=8, num_pages=24, max_seq=64,
          prefill_bucket=8)


@pytest.fixture(scope="module")
def model():
    dims = dict(dim=64, n_layers=2, n_heads=4, max_seq_len=128)
    jc, tc = jg.GPT2Config.tiny(**dims), tg.GPT2Config.tiny(**dims)
    jp = jg.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_fault_plan()
    jfaults.clear_fault_plan()
    yield
    faults.clear_fault_plan()
    jfaults.clear_fault_plan()


def _typed(v):
    if isinstance(v, list):
        return ("ok", tuple(int(t) for t in v))
    if type(v).__name__ == "RequestShed":
        return ("shed", v.reason)
    return ("failed", v.reason, int(v.generated))


def _prompts(vocab, n, seed, prefixes=1, prefix_len=24, tail=4):
    rng = np.random.default_rng(seed)
    pre = [rng.integers(1, vocab, prefix_len).tolist()
           for _ in range(prefixes)]
    return [pre[i % prefixes] + rng.integers(1, vocab, tail).tolist()
            for i in range(n)]


class Run:
    """One package's fleet under a script; ``log`` collects what the
    script observes, in order."""

    def __init__(self, mod, model, fleet, faults_=None, **engine_kw):
        jc, tc, jp, tp = model
        port = mod is tfleet
        kw = dict(KW, prefix_cache=True, **engine_kw)
        kw.update(dict(device="cpu", cache_dtype=torch.float32) if port
                  else dict(cache_dtype=jnp.float32))
        self.r = mod.fleet_router(tp if port else jp, tc if port else jc,
                                  fleet=fleet, faults=faults_, **kw)
        self.log = []

    def submit(self, rid, p, new=4):
        shed = self.r.submit(rid, p, max_new_tokens=new)
        ledger = self.r.requests.get(rid)
        self.log.append(("submit", rid, None if shed is None
                         else _typed(shed),
                         ledger.replica if ledger is not None else None))

    def finish(self):
        out = self.r.run()
        st = self.r.statusz()["fleet"]
        self.log.append(("out", sorted((k, _typed(v))
                                       for k, v in out.items())))
        self.log.append(("fleet", {k: st[k] for k in (
            "submitted", "completed", "failed", "shed", "resubmits",
            "failovers", "drains", "rejoins", "states",
            "shed_by_reason")}, st["affinity"]))
        fo = self.r.last_failover
        if fo is not None:
            self.log.append(("failover", fo["replica"],
                             sorted(fo["resubmitted"]),
                             sorted(fo["failed_typed"])))
        assert self.r.check_leaks() == [] and self.r.orphaned() == []
        return out


def _both(model, script, fleet, faults_=None, **kw):
    logs = []
    for mod in (jfleet, tfleet):
        run = Run(mod, model, fleet, faults_, **kw)
        try:
            script(run)
        finally:
            run.r.shutdown()
        logs.append(run.log)
    assert logs[1] == logs[0]
    return logs[1]


def test_affinity_waves_identical_to_jax(model):
    ps = _prompts(model[0].vocab_size, 12, seed=2, prefixes=3)

    def script(run):
        for i in range(3):
            run.submit(f"w{i}", ps[i])
        run.finish()
        for i in range(3, 12):
            run.submit(f"q{i}", ps[i])
        run.finish()

    log = _both(model, script, {"replicas": 3, "digest_refresh_steps": 1})
    aff = log[-1][2]
    assert aff["affinity_routed"] >= 6
    # the one engine's tokens
    jc, _, jp, _ = model
    eng = jax_engine(jp, jc, cache_dtype=jnp.float32, prefix_cache=True,
                     **KW)
    for i, p in enumerate(ps):
        eng.submit(i, p, max_new_tokens=4)
    want = eng.run()
    eng.shutdown()
    got = dict(log[-2][1])
    for i in range(3, 12):
        assert got[f"q{i}"] == ("ok", tuple(want[i]))


def test_seeded_replica_kill_same_typed_outcomes(model):
    ps = _prompts(model[0].vocab_size, 9, seed=5, prefixes=3)
    rules = {"rules": [
        {"subsystem": "replica", "mode": "error", "match": "r1",
         "after": 3, "count": 1},
        {"subsystem": "replica", "mode": "degrade", "match": "r0",
         "latency_s": 1e6, "count": 1}]}

    def script(run):
        for i, p in enumerate(ps):
            run.submit(f"q{i}", p, new=6)
        out = run.finish()
        assert run.r.replicas["r1"].state == "dead"
        assert "forced_degrade" in run.r.replicas["r0"].health_reasons
        typed = [_typed(v)[0] for v in out.values()]
        assert len(out) == len(ps)
        assert typed.count("ok") + typed.count("failed") + \
            typed.count("shed") == len(ps)
        for v in out.values():
            assert isinstance(v, (list, RequestFailed, RequestShed,
                                  jfleet.RequestFailed,
                                  jfleet.RequestShed))

    log = _both(model, script, {"replicas": 3}, faults_=rules)
    fo = [e for e in log if e[0] == "failover"]
    assert fo and fo[0][1] == "r1"


def test_drain_rejoin_identical_to_jax(model):
    ps = _prompts(model[0].vocab_size, 8, seed=6, prefixes=2)

    def script(run):
        for i in range(4):
            run.submit(f"q{i}", ps[i])
        run.r.step()
        run.r.drain("r0")
        run.log.append(("drained_state", run.r.replicas["r0"].state,
                        len(run.r.replicas["r0"].engine.queue)))
        run.submit("post", ps[4])
        run.finish()
        run.log.append(("drained", run.r.drained("r0")))
        run.r.rejoin("r0")
        for i in range(5, 8):
            run.submit(f"q{i}", ps[i])
        run.finish()

    log = _both(model, script, {"replicas": 2, "digest_refresh_steps": 1})
    assert ("drained", True) in log
    assert ("drained_state", "draining", 0) in log


def test_shedding_identical_to_jax(model):
    ps = _prompts(model[0].vocab_size, 12, seed=10, prefix_len=4)

    def script(run):
        for i, p in enumerate(ps):
            run.submit(f"q{i}", p, new=2)
        out = run.finish()
        assert len(out) == len(ps)

    log = _both(model, script, {"replicas": 2, "shed_queue_depth": 3,
                                "retry_budget": 0},
                shed_queue_depth=2)
    assert any(e[0] == "submit" and e[2] is not None for e in log)


def test_fleet_tp_raises(model):
    _, tc, _, tp = model
    with pytest.raises(NotImplementedError, match="A10"):
        tfleet.fleet_router(tp, tc, fleet={"replicas": 2, "tp": 2},
                            device="cpu", **KW)
    with pytest.raises(NotImplementedError):
        tfleet.tp_replica_mesh(0, 2)


def test_one_weight_tree_for_every_replica(model):
    _, tc, _, tp = model
    r = tfleet.fleet_router(tp, tc, fleet={"replicas": 3}, device="cpu",
                            cache_dtype=torch.float32, **KW)
    try:
        trees = [rep.engine.params for rep in r.replicas.values()]
        for a, b in zip(trees, trees[1:]):
            assert a["wte"].data_ptr() == b["wte"].data_ptr()
            assert a["blocks"]["qkv_w"].data_ptr() == \
                b["blocks"]["qkv_w"].data_ptr()
    finally:
        r.shutdown()
