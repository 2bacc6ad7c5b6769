"""The port's hybrid train+generate engine (``deepspeed_tpu_torch/
hybrid.py``, ``init_hybrid_engine``) against the JAX package's on a tiny
f32 Llama (f32 compute and cache, so greedy tokens are held to identity):
greedy rollouts equal the standalone ``llama_generator`` over the engine's
params and the JAX hybrid engine's tokens; rollout -> train -> rollout
against JAX (tokens identical, the step's loss at rtol 1e-5); a TP size
above 1, ``enabled: false``, a cache overrun and an engine without a train
state raise; sampled rollouts (the torch generator cannot reproduce
threefry's draws) are held to the model's own distribution: the first
sampled token's frequencies over 4000 rows within 0.05 total variation of
its top-4 softmax, the same rng gives the same rollout, eos stays eos."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import init_hybrid_engine, initialize
from deepspeed_tpu_torch.hybrid import HybridEngine
from deepspeed_tpu_torch.inference.generation import llama_generator
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
HYBRID = {"enabled": True, "max_out_tokens": 64, "pin_parameters": True}


def _config(**over):
    conf = {"train_batch_size": 8, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "hybrid_engine": dict(HYBRID)}
    conf.update(over)
    return conf


@pytest.fixture(scope="module")
def pair():
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je, _, _, _ = dstpu.initialize(loss_fn=jl.loss_fn(cfg),
                                   params=jax.tree.map(jnp.asarray, jp),
                                   config=_config(), mesh=mesh)
    jh = dstpu.init_hybrid_engine(je, cfg, cache_dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny()
    te, _, _, _ = initialize(loss_fn=tl.loss_fn(tcfg),
                             params=from_jax_params(jp, device="cpu"),
                             config=_config(), device="cpu")
    th = init_hybrid_engine(te, tcfg, cache_dtype=torch.float32)
    return cfg, tcfg, je, jh, te, th


def _prompts(b=8, t=8, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


def test_greedy_rollouts_match_generator_and_jax(pair):
    cfg, tcfg, je, jh, te, th = pair
    prompts = _prompts()
    got = th.generate(prompts, max_new_tokens=8, temperature=0.0)
    assert got.shape == (8, 16) and got.dtype == torch.int32
    ref = llama_generator(th.compute_params(), tcfg,
                          cache_dtype=torch.float32, device="cpu").generate(
        prompts, max_new_tokens=8)
    assert torch.equal(got, ref)
    want = jh.generate(jnp.asarray(prompts), max_new_tokens=8,
                       temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rollout_train_rollout_matches_jax(pair):
    cfg, tcfg, je, jh, te, th = pair
    prompts = _prompts(seed=1)
    r1 = th.generate(prompts, max_new_tokens=8, temperature=0.0)
    j1 = jh.generate(jnp.asarray(prompts), max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(r1.numpy(), np.asarray(j1))
    before = te.global_steps
    batch = {"tokens": r1[:, :9].numpy()}
    loss = th.train_batch(batch)
    jloss = jh.train_batch(batch)
    assert te.global_steps == before + 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # the second rollout reads the updated params
    r2 = th.generate(prompts, max_new_tokens=8, temperature=0.0)
    j2 = jh.generate(jnp.asarray(prompts), max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(r2.numpy(), np.asarray(j2))
    ref = llama_generator(th.compute_params(), tcfg,
                          cache_dtype=torch.float32, device="cpu").generate(
        prompts, max_new_tokens=8)
    assert torch.equal(r2, ref)
    # passthrough to the engine
    assert th.get_lr() == te.get_lr() and th.metrics is te.metrics


def test_sampled_rollouts_follow_the_model(pair):
    cfg, tcfg, je, jh, te, th = pair
    prompt = _prompts(1, 8, seed=2)
    n = 4000
    rows = np.repeat(prompt, n, axis=0)
    gen = torch.Generator().manual_seed(7)
    out = th.generate(rows, max_new_tokens=1, temperature=1.0, top_k=4,
                      rng=gen)[:, -1].numpy()
    logits = tl.forward(th.compute_params(), torch.from_numpy(prompt),
                        tcfg)[0, -1]
    top = torch.topk(logits, 4)
    probs = torch.softmax(top.values, -1).numpy()
    assert np.isin(out, top.indices.numpy()).all()  # only the top 4 drawn
    freq = np.array([(out == i).mean() for i in top.indices.numpy()])
    assert 0.5 * np.abs(freq - probs).sum() < 0.05
    a = th.generate(_prompts(), max_new_tokens=8, temperature=1.0,
                    rng=torch.Generator().manual_seed(3))
    b = th.generate(_prompts(), max_new_tokens=8, temperature=1.0,
                    rng=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_eos_stays_eos(pair):
    cfg, tcfg, je, jh, te, th = pair
    th.eos = 3
    try:
        out = th.generate(_prompts(), max_new_tokens=8, temperature=1.0,
                          rng=torch.Generator().manual_seed(5))
        assert out.shape == (8, 16)
        for row in out[:, 8:].numpy():
            hit = np.where(row == 3)[0]
            if hit.size:
                assert (row[hit[0]:] == 3).all()
    finally:
        th.eos = None


def test_cache_overrun_raises(pair):
    cfg, tcfg, je, jh, te, th = pair
    with pytest.raises(ValueError, match="KV cache budget"):
        th.generate(_prompts(t=60), max_new_tokens=8)


@pytest.mark.parametrize("block,match", [
    ({"enabled": True, "inference_tp_size": 4}, "inference_tp_size"),
    ({"enabled": False}, "enabled"),
])
def test_config_errors(block, match):
    tcfg = tl.LlamaConfig.tiny()
    params = {"embed": torch.zeros(2)}
    te, _, _, _ = initialize(loss_fn=lambda p, b: p["embed"].sum(),
                             params=params,
                             config=_config(hybrid_engine=block),
                             device="cpu")
    with pytest.raises(ValueError, match=match):
        init_hybrid_engine(te, tcfg)


def test_tp_size_one_and_non_engine():
    tcfg = tl.LlamaConfig.tiny()
    te, _, _, _ = initialize(loss_fn=lambda p, b: p["embed"].sum(),
                             params={"embed": torch.zeros(2)},
                             config=_config(hybrid_engine={
                                 "inference_tp_size": 1}),
                             device="cpu")
    assert isinstance(init_hybrid_engine(te, tcfg), HybridEngine)
    with pytest.raises(ValueError, match="TrainingEngine"):
        HybridEngine(object(), None, None, None)
