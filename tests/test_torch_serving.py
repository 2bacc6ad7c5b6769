"""Serving engine of the port against the JAX engine: greedy tokens must be
IDENTICAL on llama-tiny in f32 (cache_dtype float32 on both sides), with
``check_leaks() == []`` on both, across whole-prompt prefill, split-fuse
``prefill_chunk``, ``decode_chunk``, EOS and preemption; every block of
the JAX engine is ported and behaves as there (a block that needs another
raises its ValueError; the others serve)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.serving import llama_serving_engine as jax_engine
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch.inference.serving import (EngineClosed,
                                                   ServingEngine,
                                                   llama_serving_engine,
                                                   serving_engine)
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

BASE = dict(max_batch=3, page_size=8, num_pages=40, max_seq=64,
            prefill_bucket=8)


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    jp = jl.init_params(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    return cfg, tl.LlamaConfig.tiny(), jp, tp


def _prompts(n=5, seed=1, lo=3, hi=30):
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(1, 256, rng.integers(lo, hi)).tolist()
            for i in range(n)}


def _serve_both(model, prompts, new_tokens=10, **kw):
    cfg, tcfg, jp, tp = model
    opts = dict(BASE, **kw)
    je = jax_engine(jp, cfg, cache_dtype=jnp.float32, **opts)
    te = llama_serving_engine(tp, tcfg, cache_dtype=torch.float32,
                              device="cpu", **opts)
    for rid, p in prompts.items():
        je.submit(rid, p, max_new_tokens=new_tokens)
        te.submit(rid, p, max_new_tokens=new_tokens)
    want, got = je.run(), te.run()
    assert je.check_leaks() == [] and te.check_leaks() == []
    assert got == want
    return te, got


@pytest.mark.parametrize("mode", [
    "whole_prompt", "prefill_chunk", "decode_chunk", "chunk_and_decode"])
def test_greedy_tokens_identical_to_jax(model, mode):
    kw = {"whole_prompt": {},
          "prefill_chunk": {"prefill_chunk": 8},
          "decode_chunk": {"decode_chunk": 4},
          "chunk_and_decode": {"prefill_chunk": 8, "decode_chunk": 3}}[mode]
    te, got = _serve_both(model, _prompts(), **kw)
    assert len(got) == 5 and all(len(v) > 10 for v in got.values())
    if mode in ("prefill_chunk", "chunk_and_decode"):
        assert te.prefill_chunks > 0


def test_eos_stops_requests_like_jax(model):
    # pick an EOS that the greedy streams actually emit
    prompts = _prompts(seed=2)
    _, plain = _serve_both(model, prompts)
    first_gen = plain["r0"][len(prompts["r0"])]
    _, got = _serve_both(model, prompts, eos_token_id=first_gen)
    assert got["r0"][-1] == first_gen
    assert len(got["r0"]) == len(prompts["r0"]) + 1


def test_preemption_under_small_pool_matches_jax(model):
    prompts = _prompts(n=4, seed=3, lo=10, hi=20)
    te, got = _serve_both(model, prompts, new_tokens=24, num_pages=11)
    assert te.preempted > 0
    assert all(len(got[r]) == len(p) + 24 for r, p in prompts.items())


@pytest.mark.parametrize("block,value", [
    ("mesh", object()), ("telemetry", True), ("tracing", {}),
    ("speculative", {"draft_tokens": 2}), ("slo", {}), ("kv_tier", True),
    ("faults", {}), ("shed_queue_depth", 4), ("shed_expired_deadline", True),
    ("history", {}), ("incidents", {}), ("devprof", {}),
    ("comm", {"quantized_serving": True}), ("prefix_cache", True),
    ("zero_inference", {}), ("weight_dtype", "int8")])
def test_unported_blocks_raise(model, block, value):
    _, tcfg, _, tp = model
    if block == "kv_tier":
        # ported: as in the JAX package, the tier needs the prefix cache
        with pytest.raises(ValueError, match="prefix_cache"):
            serving_engine(tp, tcfg, device="cpu", **{block: value}, **BASE)
        return
    if block == "prefix_cache":
        # ported: the block serves
        eng = serving_engine(tp, tcfg, device="cpu", **{block: value},
                             **BASE)
        eng.submit("a", list(range(1, 20)), max_new_tokens=3)
        eng.submit("b", list(range(1, 22)), max_new_tokens=3)
        out = eng.run()
        assert [len(out[r]) for r in "ab"] == [22, 24]
        assert eng.prefix_cache_hits == 1 and eng.check_leaks() == []
        return
    if block in ("speculative", "zero_inference"):
        # ported: speculative decoding and weight streaming serve, token
        # for token as the plain engine (test_torch_speculative.py and
        # test_torch_zero_inference.py hold them to the JAX package)
        want = serving_engine(tp, tcfg, device="cpu", **BASE)
        eng = serving_engine(tp, tcfg, device="cpu", **{block: value},
                             **BASE)
        for e in (want, eng):
            e.submit("a", list(range(1, 20)), max_new_tokens=5)
        assert eng.run() == want.run() and eng.check_leaks() == []
        return
    if block in ("mesh", "comm"):
        # ported: a sharded replica over a MeshSpec
        # (test_torch_serving_tp.py); a mesh of one rank, and the int8
        # wire without a sharding mesh, serve as the plain engine, and a
        # mesh that is no MeshSpec raises
        from deepspeed_tpu_torch.topology import AXES, MeshSpec

        want = serving_engine(tp, tcfg, device="cpu", **BASE)
        one = MeshSpec(sizes={a: 1 for a in AXES})
        eng = serving_engine(tp, tcfg, device="cpu", **(
            {"mesh": one} if block == "mesh" else {block: value}), **BASE)
        for e in (want, eng):
            e.submit("a", list(range(1, 20)), max_new_tokens=5)
        assert eng.run() == want.run() and eng.check_leaks() == []
        if block == "mesh":
            with pytest.raises(TypeError, match="MeshSpec"):
                serving_engine(tp, tcfg, device="cpu", mesh=value, **BASE)
        return
    if block == "weight_dtype":
        # ported: int8 weights serve; another dtype raises, as in the JAX
        # package
        eng = serving_engine(tp, tcfg, device="cpu", **{block: value},
                             **BASE)
        eng.submit("a", list(range(1, 20)), max_new_tokens=3)
        assert len(eng.run()["a"]) == 22 and eng.check_leaks() == []
        with pytest.raises(NotImplementedError, match="int8"):
            serving_engine(tp, tcfg, device="cpu", weight_dtype="int4",
                           **BASE)
        return
    if block in NEEDS:
        # ported: without the block it needs it raises, as in the JAX
        # engine (telemetry is on by default there and here)
        off, match = NEEDS[block]
        with pytest.raises(ValueError, match=match):
            serving_engine(tp, tcfg, device="cpu", **{block: value}, **off,
                           **BASE)
        if off == {}:
            return
    # ported: a control-plane block serves token for token as the plain
    # engine (test_torch_serving_control_plane.py holds it to JAX's)
    want = serving_engine(tp, tcfg, device="cpu", **BASE)
    eng = serving_engine(tp, tcfg, device="cpu", **{block: value}, **BASE)
    try:
        for e in (want, eng):
            e.submit("a", list(range(1, 20)), max_new_tokens=5)
        assert eng.run() == want.run() and eng.check_leaks() == []
    finally:
        eng.shutdown()


# the control-plane blocks that need another block (the JAX engine's
# ValueErrors)
NEEDS = {"shed_expired_deadline": ({}, "slo"),
         "history": ({"telemetry": False}, "telemetry"),
         "incidents": ({"tracing": False}, "tracing"),
         "devprof": ({"telemetry": False}, "telemetry")}


def test_disabled_blocks_are_accepted(model):
    _, tcfg, _, tp = model
    eng = serving_engine(tp, tcfg, device="cpu", mesh=None, telemetry=False,
                         prefix_cache={"enabled": False}, kv_tier=None,
                         shed_queue_depth=0, **BASE)
    assert isinstance(eng, ServingEngine)
    with pytest.raises(TypeError):
        serving_engine(tp, tcfg, device="cpu", no_such_block=1, **BASE)


def test_submit_validation_and_shutdown(model):
    _, tcfg, _, tp = model
    eng = llama_serving_engine(tp, tcfg, device="cpu", **BASE)
    with pytest.raises(ValueError):
        eng.submit("empty", [])
    with pytest.raises(ValueError):
        eng.submit("long", [1] * 60, max_new_tokens=10)
    eng.submit("ok", [1, 2, 3], max_new_tokens=2)
    assert eng.run()["ok"][:3] == [1, 2, 3]
    assert eng.drain_finished() and eng.finished == {}
    eng.shutdown()
    with pytest.raises(EngineClosed):
        eng.submit("late", [1])


def test_kernel_arms_resolve_on_cpu(model):
    _, tcfg, _, tp = model
    eng = llama_serving_engine(tp, tcfg, device="cpu", **BASE)
    assert eng.kernels.as_dict() == {"paged_attention": "xla",
                                     "fused_sampling": "off"}
    forced = llama_serving_engine(
        tp, tcfg, device="cpu",
        kernels={"paged_attention": "pallas_v2", "fused_sampling": "on"},
        **BASE)
    for e in (eng, forced):
        e.submit("a", [4, 5, 6, 7], max_new_tokens=5)
    assert eng.run() == forced.run()
