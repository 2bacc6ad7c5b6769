"""DeepSpeed's ``fp16`` mode (dynamic loss scaling) in the port against the
JAX package on the CPU.

- GPT-2 and BERT, the models of DeepSpeed's fp16 tutorials (tiny presets,
  the same weights through ``from_jax_params``): eight steps of
  ``initialize(...).train_batch`` under ``"fp16": {"enabled": true}`` with
  a scale that starts high enough to overflow; every step's overflow flag
  and loss scale equal the JAX engine's, the losses agree at 1e-2 relative
  (test_torch_train.py's fp16 bound: fp16 activations rounded at other
  places by the two frameworks), and the skipped steps are some but not all.
- The fp16 hybrid engine on a tiny Llama: greedy rollout -> train step ->
  rollout against JAX's hybrid engine under the same config, the hybrid's
  rollouts (over its paged cache, the path that reaches the flash kernel
  and the paged kernel with an fp16 q over the bf16 cache on the card)
  and the dense generator's over the same params.  In f32 (compute and
  cache) the hybrid's rollouts equal the dense generator's and JAX's token
  for token.  In fp16 the
  prefill logits agree with JAX's within 2e-2 (fp16 activations over two
  layers), and the rollouts agree with JAX's up to a row's first token
  whose top-2 logits JAX separates by less than that bound (a near-tie,
  ROADMAP C-w2); the step's loss within 1e-2 relative and its overflow flag
  and scale exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.models import bert as jb
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import init_hybrid_engine, initialize
from deepspeed_tpu_torch.inference.generation import llama_generator
from deepspeed_tpu_torch.models import bert as tb
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
LOSS_RTOL = 1e-2
LOGIT_ATOL = 2e-2


def _fp16(**over):
    fp16 = {"enabled": True, "initial_scale_power": 18,
            "loss_scale_window": 2}
    fp16.update(over)
    return fp16


def _config(**over):
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "fp16": _fp16(),
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}}}
    conf.update(over)
    return conf


def _gpt2_batch(seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32)}


def _bert_batch(seed, B=4, T=20):
    """Ragged rows (the last one all padding), token types and ~30 % of
    the positions labelled (test_torch_train_bert.py's batches)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    for b in range(B):
        mask[b, rng.integers(2, T + 1):] = 0
    mask[-1] = 0
    labels = np.where(rng.random((B, T)) < 0.3, tokens, -100)
    return {"tokens": tokens, "attention_mask": mask,
            "token_type_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
            "mlm_labels": labels.astype(np.int32)}


FAMILIES = {"gpt2": (jg, tg, "GPT2Config", _gpt2_batch),
            "bert": (jb, tb, "BertConfig", _bert_batch)}


def _engines(jmod, tmod, cfg_name, conf):
    """The JAX engine (one-device mesh) and the port's over the same tiny
    weights."""
    cfg, tcfg = getattr(jmod, cfg_name).tiny(), getattr(tmod, cfg_name).tiny()
    jp = jax.device_get(jmod.init_params(jax.random.PRNGKey(0), cfg))
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je = dstpu.initialize(loss_fn=jmod.loss_fn(cfg),
                          params=jax.tree.map(jnp.asarray, jp),
                          config=dict(conf), mesh=mesh)[0]
    te = initialize(loss_fn=tmod.loss_fn(tcfg),
                    params=from_jax_params(jp, device="cpu"),
                    config=dict(conf), device="cpu")[0]
    return cfg, tcfg, je, te


def _step_both(je, te, batch):
    jloss = float(je.train_batch(batch))
    tloss = float(te.train_batch(batch))
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    return ((int(je.metrics["overflow"]), float(je.metrics["loss_scale"])),
            (te.metrics["overflow"], te.metrics["loss_scale"]))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fp16_skip_steps_and_scale_match_jax_engine(family):
    jmod, tmod, cfg_name, batch_of = FAMILIES[family]
    _, _, je, te = _engines(jmod, tmod, cfg_name, _config())
    rows = [_step_both(je, te, batch_of(200 + step)) for step in range(8)]
    jrow, trow = zip(*rows)
    assert trow == jrow
    assert 0 < te.skipped_steps == je.skipped_steps < 8, trow
    assert te.state.step == int(je.state.step) == 8 - te.skipped_steps


def _hybrid_pair(fp16: bool):
    conf = _config(train_batch_size=8, gradient_accumulation_steps=1,
                   fp16=_fp16(initial_scale_power=16),
                   hybrid_engine={"enabled": True, "max_out_tokens": 64})
    if not fp16:
        conf.pop("fp16")
        conf["bf16"] = {"enabled": False}
    cfg, tcfg, je, te = _engines(jl, tl, "LlamaConfig", conf)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if fp16
                else (jnp.float32, torch.float32))
    jh = dstpu.init_hybrid_engine(je, cfg, cache_dtype=jdt)
    hyb = init_hybrid_engine(te, tcfg, cache_dtype=tdt)
    return cfg, tcfg, je, jh, te, hyb


def _rollouts(hyb, tcfg, prompts, cache_dtype):
    """(params, rollout) of the hybrid engine (its paged cache) and of
    the dense generator over the same params."""
    params = hyb.compute_params()
    dense = llama_generator(params, tcfg, cache_dtype=cache_dtype,
                            device="cpu")
    return [(params, hyb.generate(prompts, max_new_tokens=8,
                                  temperature=0.0)),
            (params, dense.generate(prompts, max_new_tokens=8))]


def _prompts(seed, b=8, t=8):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


def test_f32_paged_hybrid_rollouts_equal_dense_and_jax():
    _, tcfg, _, jh, te, hyb = _hybrid_pair(fp16=False)
    prompts = _prompts(3)
    want = np.asarray(jh.generate(jnp.asarray(prompts), max_new_tokens=8,
                                  temperature=0.0))
    for _, got in _rollouts(hyb, tcfg, prompts, torch.float32):
        np.testing.assert_array_equal(got.numpy(), want)


def _held_to_jax(got, want, logits, bound):
    """Rollouts equal up to each row's first token that JAX picks by a
    top-2 margin below ``bound`` in its own logits of ``want``; returns the
    number of generated tokens compared."""
    top = np.sort(logits.astype(np.float32), -1)
    margin = top[..., -1] - top[..., -2]                 # [B, T + n - 1]
    T = got.shape[1] - 8
    compared = 0
    for b in range(got.shape[0]):
        tie = np.flatnonzero(margin[b, T - 1:] < bound)
        upto = int(tie[0]) if len(tie) else 8
        np.testing.assert_array_equal(got[b, T:T + upto], want[b, T:T + upto])
        compared += upto
    return compared


def test_fp16_hybrid_rollout_train_rollout_matches_jax():
    """Before the step both engines hold the same weights: the port's fp16
    logits over JAX's rollout agree with JAX's within LOGIT_ATOL and the
    rollouts are held up to JAX's near-ties below it.  The fp16 step moves
    each master by Adam's normalised step, so an element whose gradient is
    near 0 may move by lr either way (C-f10): the masters agree within
    2 lr, the forward over JAX's own new weights within LOGIT_ATOL, and the
    rollouts over the port's are held up to JAX's near-ties below twice the
    largest gap between the two engines' logits."""
    cfg, tcfg, je, jh, te, hyb = _hybrid_pair(fp16=True)
    lr = te.get_lr()[0]
    prompts = _prompts(4)
    compared = 0
    for phase in range(2):
        want = np.asarray(jh.generate(jnp.asarray(prompts),
                                      max_new_tokens=8, temperature=0.0))
        j16 = jax.device_get(jax.tree.map(
            lambda x: x.astype(jnp.float16)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            je.state.params))
        ctx = jnp.asarray(want[:, :-1])
        jlogits = np.asarray(jl.forward(j16, ctx, cfg))
        same = tl.forward(from_jax_params(j16, device="cpu"),
                          torch.from_numpy(want[:, :-1]), tcfg)
        np.testing.assert_allclose(same.float().numpy(), jlogits, rtol=0,
                                   atol=LOGIT_ATOL)
        for params, got in _rollouts(hyb, tcfg, prompts, torch.bfloat16):
            assert all(p.dtype == torch.float16 for p in
                       jax.tree.leaves(params) if p.is_floating_point())
            own = tl.forward(params, torch.from_numpy(want[:, :-1]), tcfg)
            gap = float(np.abs(own.float().numpy() - jlogits).max())
            if phase == 0:
                assert gap <= LOGIT_ATOL, gap
            compared += _held_to_jax(got.numpy(), want, jlogits,
                                     max(LOGIT_ATOL, 2 * gap))
        if phase == 0:
            jrow, trow = _step_both(je, te, {"tokens": want})
            assert trow == jrow and trow[0] == 0, trow    # a step was taken
            for a, b in zip(jax.tree.leaves(te.state.params),
                            jax.tree.leaves(je.state.params)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=2 * lr + 1e-6)
    assert compared >= 2 * 2 * 8 * 8 // 2, compared
