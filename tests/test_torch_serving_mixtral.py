"""The port's Mixtral serving against the JAX package's
``mixtral_serving_engine`` and generators on ``MixtralConfig.tiny()``.

Greedy tokens are IDENTICAL in f32 (cache dtype f32 on both sides) with
whole-prompt prefill, ``prefill_chunk``, ``decode_chunk``, both, and
preemption, and ``check_leaks() == []`` on both; int8 weights keep the
JAX engine's ``skip_paths`` exact (the router and the norm gains) and
their tokens equal a bf16 engine over the dequantized tree, and JAX's
int8 engine's up to a bf16 near-tie; both generators against
JAX's; the engine against the paged generator (the offline oracle); the
registry dispatches ``MixtralConfig`` first, ``init_serving`` and
``init_inference(apply_fn=forward_eval, dtype="int8")`` reach the MoE
forwards; a ``mesh`` is refused and ``zero_inference`` routes to the
weight-streamed engine."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import generation as jgen
from deepspeed_tpu.inference import quantized as jqz
from deepspeed_tpu.inference.serving import mixtral_serving_engine as jax_engine
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu_torch import init_inference, init_serving
from deepspeed_tpu_torch.inference import generation as tgen
from deepspeed_tpu_torch.inference.quantized import (QuantizedTensor,
                                                     dequantize_params)
from deepspeed_tpu_torch.inference.serving import (MIXTRAL_INT8_SKIP,
                                                   ServingEngine,
                                                   mixtral_serving_engine,
                                                   serving_engine)
from deepspeed_tpu_torch.inference.zero_inference import (
    ZeroInferenceServingEngine)
from deepspeed_tpu_torch.models import mixtral as tm
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

BASE = dict(max_batch=3, page_size=8, num_pages=40, max_seq=64,
            prefill_bucket=8)
# test_torch_mixtral.py's bf16 logit bound
BF16_ATOL = 0.06


@pytest.fixture(scope="module")
def model():
    cfg = jm.MixtralConfig.tiny()
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    return cfg, tm.MixtralConfig.tiny(), jp, tp


def _prompts(n=5, seed=1, lo=3, hi=30):
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(1, 256, rng.integers(lo, hi)).tolist()
            for i in range(n)}


def _serve_both(model, prompts, new_tokens=10, **kw):
    cfg, tcfg, jp, tp = model
    opts = dict(BASE, **kw)
    je = jax_engine(jp, cfg, cache_dtype=jnp.float32, **opts)
    te = mixtral_serving_engine(tp, tcfg, cache_dtype=torch.float32,
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
    if "prefill_chunk" in kw:
        assert te.prefill_chunks > 0


def test_preemption_under_small_pool_matches_jax(model):
    prompts = _prompts(n=4, seed=3, lo=10, hi=20)
    te, got = _serve_both(model, prompts, new_tokens=24, num_pages=11)
    assert te.preempted > 0
    assert all(len(got[r]) == len(p) + 24 for r, p in prompts.items())


@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_int8_weights_keep_the_router_exact(model, prefill_chunk):
    """JAX's ``test_int8_serving_keeps_router_exact``: the gate stays the
    original, every other matrix leaf quantizes.  The int8 engine runs
    bf16 activations, so (as for Llama) its tokens are held IDENTICAL to
    a bf16 engine over the dequantized tree (the same values through the
    same operations), and against JAX's int8 engine every request agrees
    up to its first differing token, where JAX's two candidates lie within
    twice the bf16 logit bound of each other: a near-tie that bf16
    rounding decides (ROADMAP C-w2)."""
    cfg, tcfg, jp, tp = model
    prompts = _prompts(seed=5)
    opts = dict(BASE, prefill_chunk=prefill_chunk)
    te = mixtral_serving_engine(tp, tcfg, weight_dtype="int8",
                                cache_dtype=torch.float32, device="cpu",
                                **opts)
    blocks = te.params["blocks"]
    gate = blocks["gate"]
    assert not isinstance(gate, QuantizedTensor)
    np.testing.assert_array_equal(gate.numpy(),
                                  np.asarray(jp["blocks"]["gate"]))
    for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
        assert isinstance(blocks[name], QuantizedTensor), name
    assert isinstance(te.params["embed"], QuantizedTensor)
    assert isinstance(te.params["lm_head"], QuantizedTensor)
    for name in MIXTRAL_INT8_SKIP:
        leaf = blocks.get(name, te.params.get(name))
        assert torch.is_tensor(leaf), name
    oracle = mixtral_serving_engine(dequantize_params(te.params), tcfg,
                                    cache_dtype=torch.float32, device="cpu",
                                    **opts)
    je = jax_engine(jp, cfg, weight_dtype="int8", cache_dtype=jnp.float32,
                    **opts)
    for eng in (te, oracle, je):
        for rid, p in prompts.items():
            eng.submit(rid, p, max_new_tokens=10)
    got, want, jgot = te.run(), oracle.run(), je.run()
    assert te.check_leaks() == [] == oracle.check_leaks()
    assert got == want
    assert all(len(v) == len(prompts[r]) + 10 for r, v in got.items())
    jqp = jqz.quantize_params(jp, skip_paths=MIXTRAL_INT8_SKIP)
    jfwd = jqz.quantized_apply(lambda p, t: jm.forward_eval(p, t, cfg))
    for rid, toks in got.items():
        at = next((i for i, (a, b) in enumerate(zip(toks, jgot[rid]))
                   if a != b), None)
        if at is None:
            continue
        logits = np.asarray(jfwd(jqp, jnp.asarray([toks[:at]])))[0, -1]
        gap = logits[jgot[rid][at]] - logits[toks[at]]
        assert 0 <= gap <= 2 * BF16_ATOL, (rid, at, gap)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("eos", [None, 7])
def test_generators_identical_to_jax(model, paged, eos):
    cfg, tcfg, jp, tp = model
    kind = "mixtral_paged_generator" if paged else "mixtral_generator"
    extra = dict(page_size=8) if paged else {}
    jg_ = getattr(jgen, kind)(jp, cfg, eos_token_id=eos,
                              cache_dtype=jnp.float32, **extra)
    tg_ = getattr(tgen, kind)(tp, tcfg, eos_token_id=eos,
                              cache_dtype=torch.float32, device="cpu",
                              **extra)
    toks = np.random.default_rng(6).integers(1, 256, (3, 9)).astype(np.int32)
    want = np.asarray(jg_.generate(jnp.asarray(toks), max_new_tokens=12))
    got = tg_.generate(toks, max_new_tokens=12)
    assert got.dtype == torch.int32 and got.shape == (3, 21)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_equals_paged_generator(model):
    """Same-length prompts, so the offline generator's batch equals the
    engine's rows: identical greedy tokens."""
    _, tcfg, _, tp = model
    prompts = np.random.default_rng(7).integers(1, 256, (3, 11))
    gen = tgen.mixtral_paged_generator(tp, tcfg, page_size=8,
                                       cache_dtype=torch.float32,
                                       device="cpu")
    want = gen.generate(prompts, max_new_tokens=12).numpy()
    eng = mixtral_serving_engine(tp, tcfg, cache_dtype=torch.float32,
                                 device="cpu", **BASE)
    for i, p in enumerate(prompts):
        eng.submit(i, p.tolist(), max_new_tokens=12)
    got = eng.run()
    assert eng.check_leaks() == []
    for i in range(3):
        assert got[i] == want[i].tolist()


def test_registry_init_serving_and_refusals(model):
    _, tcfg, _, tp = model
    eng = serving_engine(tp, tcfg, device="cpu", **BASE)
    assert isinstance(eng, ServingEngine)
    eng.submit("a", [5, 6, 7], max_new_tokens=4)
    assert len(eng.run()["a"]) == 7
    eng = init_serving(tp, tcfg, config={"kernels": {
        "paged_attention": "xla"}}, device="cpu", weight_dtype="int8",
        **BASE)
    assert eng.kernels.paged_attention == "xla"
    assert isinstance(eng.params["blocks"]["w2"], QuantizedTensor)
    # expert-parallel serving is ported (test_torch_expert_parallel.py):
    # a mesh that is no MeshSpec, or experts that do not divide, raise
    from deepspeed_tpu_torch.topology import AXES, MeshSpec

    with pytest.raises(TypeError, match="MeshSpec"):
        serving_engine(tp, tcfg, device="cpu", mesh=object(), **BASE)
    with pytest.raises(ValueError, match="num_experts"):
        serving_engine(tp, tcfg, device="cpu", mesh=MeshSpec(sizes={
            a: 3 if a == "expert" else 1 for a in AXES}), **BASE)
    # weight streaming is ported: both entry points route to the streamed
    # engine (test_torch_zero_inference.py holds it to the resident one)
    for eng in (serving_engine(tp, tcfg, device="cpu",
                               zero_inference={"enabled": True}, **BASE),
                init_serving(tp, tcfg, device="cpu", config={
                    "zero_inference": {"enabled": True}}, **BASE)):
        assert isinstance(eng, ZeroInferenceServingEngine)
        assert eng.plan["n_streamed"] == tcfg.n_layers
    with pytest.raises(NotImplementedError, match="int8"):
        serving_engine(tp, tcfg, device="cpu", weight_dtype="int4", **BASE)


def test_init_inference_int8_takes_the_quantized_tree(model):
    """``init_inference(apply_fn=mixtral.forward_eval, dtype="int8")``: the
    forward is ``takes_quantized``, so it gets the int8 tree (every
    ndim >= 2 leaf, the router and the stacked norm gains too, as JAX's
    engine quantizes them) and dequantizes one layer at a time; logits
    equal a forward over the dequantized tree."""
    _, tcfg, _, tp = model
    eng = init_inference(apply_fn=functools.partial(tm.forward_eval,
                                                    cfg=tcfg),
                         params=tp, dtype="int8", device="cpu")
    for name in ("gate", "mlp_norm", "w1"):
        assert isinstance(eng.params["blocks"][name], QuantizedTensor)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 9)))
    got = eng(toks)
    want = tm.forward_eval(dequantize_params(eng.params), toks, tcfg)
    assert got.shape == (2, 9, 256) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
