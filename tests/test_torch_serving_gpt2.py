"""The port's GPT-2 serving engine against the JAX package's
``gpt2_serving_engine``: greedy tokens IDENTICAL on gpt2-tiny in f32
(cache dtype f32 on both sides) with whole-prompt prefill,
``prefill_chunk``, ``decode_chunk`` and preemption, and with int8 weights
(the JAX builder's ``skip_paths``: the stacked biases, LayerNorm vectors
and the position table stay exact, so the activations stay f32 and the
dequantized weights are the same bf16 values on both sides);
``check_leaks() == []`` on both; the engine equals the paged generator
(the offline oracle) on the same prompts; and the registry dispatches
``GPT2Config``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.serving import gpt2_serving_engine as jax_engine
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu_torch import init_inference, init_serving
from deepspeed_tpu_torch.inference.generation import gpt2_paged_generator
from deepspeed_tpu_torch.inference.quantized import (QuantizedTensor,
                                                     dequantize_params)
from deepspeed_tpu_torch.inference.serving import (GPT2_INT8_SKIP,
                                                   ServingEngine,
                                                   gpt2_serving_engine,
                                                   serving_engine)
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

BASE = dict(max_batch=3, page_size=8, num_pages=40, max_seq=64,
            prefill_bucket=8)


@pytest.fixture(scope="module")
def model():
    cfg = jg.GPT2Config.tiny()
    jp = jg.init_params(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    return cfg, tg.GPT2Config.tiny(), jp, tp


def _prompts(n=5, seed=1, lo=3, hi=30):
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(1, 256, rng.integers(lo, hi)).tolist()
            for i in range(n)}


def _serve_both(model, prompts, new_tokens=10, **kw):
    cfg, tcfg, jp, tp = model
    opts = dict(BASE, **kw)
    je = jax_engine(jp, cfg, cache_dtype=jnp.float32, **opts)
    te = gpt2_serving_engine(tp, tcfg, cache_dtype=torch.float32,
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
def test_int8_weights_identical_to_jax_int8_engine(model, prefill_chunk):
    te, _ = _serve_both(model, _prompts(seed=5), weight_dtype="int8",
                        prefill_chunk=prefill_chunk)
    blocks = te.params["blocks"]
    assert isinstance(te.params["wte"], QuantizedTensor)
    for name in ("qkv_w", "proj_w", "fc_w", "out_w"):
        assert isinstance(blocks[name], QuantizedTensor)
    for name in GPT2_INT8_SKIP:
        leaf = blocks.get(name, te.params.get(name))
        assert torch.is_tensor(leaf), name


def test_engine_equals_paged_generator(model):
    """Same-length prompts, so the offline generator's batch equals the
    engine's rows: identical greedy tokens."""
    _, tcfg, _, tp = model
    prompts = np.random.default_rng(7).integers(1, 256, (3, 11))
    gen = gpt2_paged_generator(tp, tcfg, page_size=8,
                               cache_dtype=torch.float32, device="cpu")
    want = gen.generate(prompts, max_new_tokens=12).numpy()
    eng = gpt2_serving_engine(tp, tcfg, cache_dtype=torch.float32,
                              device="cpu", **BASE)
    for i, p in enumerate(prompts):
        eng.submit(i, p.tolist(), max_new_tokens=12)
    got = eng.run()
    assert eng.check_leaks() == []
    for i in range(3):
        assert got[i] == want[i].tolist()


def test_registry_and_builder_checks(model):
    _, tcfg, _, tp = model
    eng = serving_engine(tp, tcfg, device="cpu", **BASE)
    assert isinstance(eng, ServingEngine)
    eng.submit("a", [5, 6, 7], max_new_tokens=4)
    assert len(eng.run()["a"]) == 7
    eng = init_serving(tp, tcfg, config={"kernels": {
        "paged_attention": "xla"}}, device="cpu", **BASE)
    assert eng.kernels.paged_attention == "xla"
    with pytest.raises(ValueError, match="position table"):
        serving_engine(tp, tcfg, device="cpu", **dict(BASE, max_seq=256))
    # a sharding mesh: a model axis places this rank's blocks under
    # gpt2.param_specs (served over ranks in test_torch_tp_gpt2_bert.py);
    # GPT-2 has no expert dimension (as in the JAX gpt2_serving_engine)
    from deepspeed_tpu_torch.topology import AXES, MeshSpec

    with pytest.raises(TypeError, match="MeshSpec"):
        serving_engine(tp, tcfg, device="cpu", mesh=object(), **BASE)
    eng = serving_engine(tp, tcfg, device="cpu", mesh=MeshSpec(sizes={
        a: 2 if a == "model" else 1 for a in AXES}), **BASE)
    d = tcfg.dim
    assert eng.cache.k.shape[1] == tcfg.n_heads // 2
    assert torch.equal(eng.params["blocks"]["qkv_w"], torch.cat(
        [tp["blocks"]["qkv_w"][..., p * d:p * d + d // 2]
         for p in range(3)], -1))
    with pytest.raises(ValueError, match="expert"):
        serving_engine(tp, tcfg, device="cpu", mesh=MeshSpec(sizes={
            a: 2 if a == "expert" else 1 for a in AXES}), **BASE)
    with pytest.raises(NotImplementedError, match="int8"):
        serving_engine(tp, tcfg, device="cpu", weight_dtype="int4", **BASE)
    with pytest.raises(TypeError, match="no serving path"):
        serving_engine(tp, object(), device="cpu", **BASE)


def test_init_inference_int8_takes_the_quantized_tree(model):
    """``init_inference(apply_fn=gpt2.forward, dtype="int8")``: the forward
    is ``takes_quantized``, so it gets the int8 tree (every ndim >= 2 leaf,
    ``wpe`` and the stacked LayerNorm vectors too) and dequantizes one
    layer at a time; logits match a forward over the dequantized tree."""
    _, tcfg, _, tp = model
    eng = init_inference(apply_fn=functools.partial(tg.forward, cfg=tcfg),
                         params=tp, dtype="int8", device="cpu")
    for name in ("ln1_w", "qkv_b"):
        assert isinstance(eng.params["blocks"][name], QuantizedTensor)
    assert isinstance(eng.params["wpe"], QuantizedTensor)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 9)))
    got = eng(toks)
    want = tg.forward(dequantize_params(eng.params), toks, tcfg)
    assert got.shape == (2, 9, 256) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
