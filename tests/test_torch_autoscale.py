"""The port's autoscaler (``deepspeed_tpu_torch/autoscale.py``) and the
engines' weight swaps against the JAX package's, on tiny GPT-2 and tiny
Llama with the same weights (``weights.from_jax_params``), f32 on the
CPU.  Exact comparisons throughout:

- scale up from 1 to 3 replicas on a burst and back down to 1 when idle:
  the same sequence of scale events (kind and replica) and the same
  tokens as JAX's ``FleetAutoscaler`` on the same traffic;
- a rollout to a second weight version through drain -> ``swap_params``
  -> rejoin: the same event sequence, every request's tokens equal to
  JAX's, and each request's tokens those of one version's fresh engine;
- ``swap_params`` refusals (busy engine, another tree, a shut-down
  engine) and ``swap_weights`` refusals, with JAX's messages;
- a streamed cold start (a ZeRO-Inference replica on the host tier) that
  serves, promotes its layers and flips to fully resident, its tokens
  equal to JAX's resident engine; and a budget that blocks the flip."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import autoscale as jauto
from deepspeed_tpu import faults as jfaults
from deepspeed_tpu import fleet as jfleet
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.telemetry import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch import autoscale as tauto
from deepspeed_tpu_torch import faults
from deepspeed_tpu_torch import fleet as tfleet
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.inference.serving import EngineClosed
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.telemetry import MetricsRegistry
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

KW = dict(max_batch=2, page_size=8, num_pages=12, max_seq=64,
          prefill_bucket=8)
LKW = dict(max_batch=2, page_size=8, num_pages=32, max_seq=64,
           prefill_bucket=8)
# evaluate every router step, one pressured evaluation scales up, three
# idle ones scale down, no cooldown: decisions depend on the traffic only
FAST = dict(min_replicas=1, max_replicas=3, eval_interval_steps=1,
            scale_up_queue_depth=2.0, scale_down_queue_depth=0.5,
            up_after=1, down_after=3, cooldown_s=0.0)
PKG = {"jax": (jfleet, jauto, jserving, JaxRegistry,
               dict(cache_dtype=jnp.float32)),
       "port": (tfleet, tauto, tserving, MetricsRegistry,
                dict(cache_dtype=torch.float32, device="cpu"))}


@pytest.fixture(scope="module")
def gpt2():
    dims = dict(dim=64, n_layers=2, n_heads=4, max_seq_len=128)
    jc, tc = jg.GPT2Config.tiny(**dims), tg.GPT2Config.tiny(**dims)
    jps = [jg.init_params(jax.random.PRNGKey(s), jc) for s in (0, 1)]
    tps = [from_jax_params(jax.device_get(p), device="cpu") for p in jps]
    return {"jax": (jc, jps), "port": (tc, tps)}


@pytest.fixture(scope="module")
def llama():
    dims = dict(dim=64, n_layers=3, n_heads=4, n_kv_heads=2)
    jc, tc = jl.LlamaConfig.tiny(**dims), tl.LlamaConfig.tiny(**dims)
    jps = [jl.init_params(jax.random.PRNGKey(s), jc) for s in (0, 1)]
    tps = [from_jax_params(jax.device_get(p), device="cpu") for p in jps]
    return {"jax": (jc, jps), "port": (tc, tps)}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_fault_plan()
    jfaults.clear_fault_plan()
    yield
    faults.clear_fault_plan()
    jfaults.clear_fault_plan()


def prompts(vocab, n, seed, length=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).tolist() for _ in range(n)]


def oracle(model, pkg, version, ps, kw=KW, max_new=4):
    cfg, params = model[pkg][0], model[pkg][1][version]
    eng = PKG[pkg][2].serving_engine(params, cfg, **kw, **PKG[pkg][4])
    for i, p in enumerate(ps):
        eng.submit(i, p, max_new_tokens=max_new)
    out = eng.run()
    eng.shutdown()
    return [list(out[i]) for i in range(len(ps))]


def elastic(model, pkg, autoscale=None, n=1):
    fleet, auto, serving, Reg, extra = PKG[pkg]
    cfg, (p0, _) = model[pkg]
    router = fleet.fleet_router(
        p0, cfg, fleet={"replicas": n}, prefix_cache=True,
        tracing={"ring_capacity": 16384}, **KW, **extra)
    shared = router.replicas["r0"].engine.params

    def factory(rid, streamed=False):
        return serving.serving_engine(
            shared, cfg, replica_id=rid, prefix_cache=True,
            tracing=router.tracer,
            telemetry=Reg(namespace=f"dstpu_{rid}"), **KW, **extra)

    return router, auto.FleetAutoscaler(
        router, factory, autoscale={**FAST, **(autoscale or {})})


def _events(a):
    return [(e["kind"], e.get("replica")) for e in a.events]


def test_scale_up_and_down_identical_to_jax(gpt2):
    ps = prompts(gpt2["jax"][0].vocab_size, 20, seed=1)
    seen = {}
    for pkg in ("jax", "port"):
        router, a = elastic(gpt2, pkg)
        for i, p in enumerate(ps):
            router.submit(f"q{i}", p, max_new_tokens=4)
            a.step()
        out = a.run()
        for _ in range(30):
            a.step()
        st = a.status()
        live = [r for r, rep in router.replicas.items()
                if rep.state != "dead"]
        seen[pkg] = (_events(a), {k: list(v) for k, v in out.items()},
                     st["scale_ups"], st["scale_downs"], live)
        assert router.check_leaks() == [] and router.orphaned() == []
        router.shutdown()
    assert seen["port"] == seen["jax"]
    events, out, ups, downs, live = seen["port"]
    assert ups >= 2 and downs >= 2 and len(live) == 1
    assert [out[f"q{i}"] for i in range(len(ps))] == \
        oracle(gpt2, "jax", 0, ps)


def test_rollout_identical_to_jax(gpt2):
    ps = prompts(gpt2["jax"][0].vocab_size, 12, seed=7)
    seen = {}
    for pkg in ("jax", "port"):
        router, a = elastic(gpt2, pkg, {"rollout_soak_steps": 1}, n=2)
        a.rollout(gpt2[pkg][1][1], version="v1")
        with pytest.raises(RuntimeError, match="in progress"):
            a.rollout(gpt2[pkg][1][1], version="v2")
        for i, p in enumerate(ps):
            router.submit(f"q{i}", p, max_new_tokens=4)
            a.step()
        out = a.run()
        versions = sorted(str(rep.version) for rep in
                          router.replicas.values() if rep.state != "dead")
        seen[pkg] = (_events(a), {k: list(v) for k, v in out.items()},
                     versions, a.last_rollout["completed"],
                     a.last_rollout["rolled_back"])
        assert router.check_leaks() == [] and router.orphaned() == []
        router.shutdown()
    assert seen["port"] == seen["jax"]
    events, out, versions, done, back = seen["port"]
    assert done and not back and versions and set(versions) == {"v1"}
    kinds = Counter(k for k, _ in events)
    assert kinds["rollout_start"] == kinds["rollout_done"] == 1
    assert kinds["rollout_step"] == 2
    o0, o1 = oracle(gpt2, "jax", 0, ps), oracle(gpt2, "jax", 1, ps)
    for i in range(len(ps)):
        assert out[f"q{i}"] in (o0[i], o1[i])


def test_swap_params_refusals_and_identity(gpt2):
    tc, (p0, p1) = gpt2["port"]
    eng = tserving.serving_engine(p0, tc, prefix_cache=True, device="cpu",
                                  cache_dtype=torch.float32, **KW)
    eng.submit("a", list(range(2, 18)), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="drained"):
        eng.swap_params(p1)
    eng.run()
    with pytest.raises(ValueError, match="does not match"):
        eng.swap_params({k: v for k, v in p1.items() if k != "wpe"})
    with pytest.raises(ValueError, match="does not match"):
        eng.swap_params(dict(p1, wpe=p1["wpe"].double()))
    assert eng.allocator.pool
    eng.swap_params(p1, version="v1")
    assert not eng.allocator.pool and not eng.allocator.index
    assert eng.weights_version == "v1"
    assert eng.statusz()["weights_version"] == "v1"
    eng.submit("b", list(range(2, 18)), max_new_tokens=4)
    assert eng.run()["b"] == oracle(gpt2, "jax", 1,
                                    [list(range(2, 18))])[0]
    assert eng.check_leaks() == []
    eng.shutdown()
    with pytest.raises(EngineClosed):
        eng.swap_params(p0)


def test_streamed_cold_start_flips_and_matches_jax(llama):
    tc, (p0, p1) = llama["port"]
    router = tfleet.fleet_router(p0, tc, fleet={"replicas": 1},
                                 prefix_cache=True, device="cpu",
                                 cache_dtype=torch.float32,
                                 tracing={"ring_capacity": 16384}, **LKW)

    def factory(rid, streamed=False):
        zi = {"enabled": True, "tier": "host"} if streamed else None
        return tserving.serving_engine(
            p0, tc, replica_id=rid, prefix_cache=True, zero_inference=zi,
            tracing=router.tracer, device="cpu", cache_dtype=torch.float32,
            telemetry=MetricsRegistry(namespace=f"dstpu_{rid}"), **LKW)

    a = tauto.FleetAutoscaler(router, factory, autoscale={
        **FAST, "cold_start": "streamed", "promote_layers_per_tick": 1,
        "down_after": 9999})
    ps = prompts(llama["port"][0].vocab_size, 14, seed=6)
    for i, p in enumerate(ps):
        router.submit(f"q{i}", p, max_new_tokens=4)
        a.step()
    out = a.run()
    st = a.status()
    assert st["scale_ups"] >= 1 and st["cold_flips"] >= 1
    spawned = [rep for rid, rep in router.replicas.items()
               if rid != "r0" and rep.state != "dead"]
    assert spawned and all(rep.engine.fully_resident for rep in spawned)
    zi = spawned[0].engine.statusz()["zero_inference"]
    assert zi["fully_resident"] and zi["n_streamed_now"] == 0
    assert [out[f"q{i}"] for i in range(len(ps))] == \
        oracle(llama, "jax", 0, ps, kw=LKW)
    flips = [e for e in a.events if e["kind"] == "autoscale_flip"]
    assert flips and flips[0]["cold_start_s"] > 0
    assert a.cold_history
    assert router.check_leaks() == [] and router.orphaned() == []
    router.shutdown()


def test_swap_weights_and_a_blocked_flip(llama):
    tc, (p0, p1) = llama["port"]
    zi = tserving.llama_serving_engine(
        p0, tc, zero_inference={"enabled": True, "tier": "host"},
        device="cpu", cache_dtype=torch.float32, **LKW)
    zi.submit("a", [5, 9, 2], max_new_tokens=6)
    zi.run()
    with pytest.raises(NotImplementedError, match="swap_weights"):
        zi.swap_params(p1)
    stem = {"embed": p1["embed"]}
    head = {"final_norm": p1["final_norm"], "lm_head": p1["lm_head"]}
    with pytest.raises(ValueError, match="does not match"):
        zi.swap_weights(stem, p1["blocks"]["wq"], head)
    with pytest.raises(ValueError, match="does not match"):
        zi.swap_weights({"embed": p1["embed"].double()}, p1["blocks"], head)
    zi.promote_resident_layers(1)           # one resident, two streamed
    zi.swap_weights(stem, p1["blocks"], head, version="v1")
    assert zi.weights_version == "v1"
    zi.submit("b", [5, 9, 2], max_new_tokens=6)
    assert zi.run()["b"] == oracle(llama, "jax", 1, [[5, 9, 2]], kw=LKW,
                                   max_new=6)[0]
    plan = zi.plan
    zi.shutdown()
    budget = plan["weight_image_bytes"] + plan["cache_bytes"] - 1
    blocked = tserving.llama_serving_engine(
        p0, tc, zero_inference={"enabled": True, "tier": "host",
                                "hbm_budget_bytes": budget},
        device="cpu", cache_dtype=torch.float32, **LKW)
    assert not blocked.fully_resident
    blocked.promote_resident_layers(10)
    assert blocked.resident_flip_blocked and not blocked.fully_resident
    blocked.submit("a", [5, 9, 2], max_new_tokens=4)
    assert isinstance(blocked.run()["a"], list)
    blocked.shutdown()
