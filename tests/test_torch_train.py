"""The port's training slice against the JAX package on the CPU: the Llama
loss and hidden states (with packed ``segment_ids`` and ``loss_mask``),
the chunked-vocab loss and its gradient, the lr schedules, ``accum_split``
and clipping, and whole train-step trajectories of ``initialize(...)
.train_batch`` in f32 (AdamW and ``fused_adam``, WarmupLR, clipping,
accumulation 2) and fp16 (the dynamic loss scaler's skip steps and scale).
Tolerances: f32 1e-4 relative on losses and logits (two frameworks' sums
in another order), fp16 losses 1e-2."""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu import engine as jeng
from deepspeed_tpu import lr_schedules as jls
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.ops import adam_pallas as jadam
from deepspeed_tpu.ops import losses as jloss
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import engine as teng
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch import lr_schedules as tls
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.ops import adam_cuda as tadam
from deepspeed_tpu_torch.ops import losses as tloss
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, tl.LlamaConfig.tiny(), jp


def _batch(seed, B=4, T=17, packed=True, masked=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 256, (B, T)).astype(np.int32)}
    if packed:
        seg = np.ones((B, T), np.int32)
        for b in range(B):
            cut = rng.integers(3, T - 3)
            seg[b, cut:] = 2
            seg[b, T - 1 - b:] = 0         # b padding positions
        out["segment_ids"] = seg
    if masked:
        out["loss_mask"] = (rng.random((B, T)) > 0.2).astype(np.int32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("packed,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_loss_and_grads_match_jax(model, packed, masked):
    cfg, tcfg, jp = model
    batch = _batch(3, packed=packed, masked=masked)
    jloss_, jgrad = jax.value_and_grad(jl.loss_fn(cfg))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    tp = from_jax_params(jp, device="cpu")
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    loss = tl.loss_fn(tcfg)(tp, _t(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss_), rtol=1e-5)
    for (path, g) in jax.tree_util.tree_flatten_with_path(jgrad)[0]:
        leaf = tp
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("attn_impl", ["auto", "reference"])
def test_forward_hidden_with_segments_matches_jax(model, attn_impl):
    cfg, tcfg, jp = model
    batch = _batch(4)
    toks, seg = batch["tokens"], batch["segment_ids"]
    want = jl.forward_hidden(jax.tree.map(jnp.asarray, jp),
                             jnp.asarray(toks), cfg,
                             segment_ids=jnp.asarray(seg))
    got = tl.forward_hidden(from_jax_params(jp, device="cpu"),
                            torch.from_numpy(toks),
                            dataclasses.replace(tcfg, attn_impl=attn_impl),
                            segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        tl.packed_doc_mask(torch.from_numpy(seg)).numpy(),
        np.asarray(jl.packed_doc_mask(jnp.asarray(seg))))


@pytest.mark.parametrize("chunk,masked", [(96, False), (64, True),
                                          (256, False)])
def test_chunked_lm_loss_and_grad_match_jax(chunk, masked):
    rng = np.random.default_rng(chunk)
    N, D, V = 24, 16, 256
    x = rng.standard_normal((N, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) / 4).astype(np.float32)
    tgt = rng.integers(0, V, (N,)).astype(np.int32)
    mask = (rng.random(N) > 0.3).astype(np.float32) if masked else None

    def jf(x_, h_):
        return jloss.chunked_lm_loss(
            x_, h_, jnp.asarray(tgt),
            mask=None if mask is None else jnp.asarray(mask), chunk=chunk)

    jval, (jdx, jdh) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    val = tloss.chunked_lm_loss(
        tx, th, torch.from_numpy(tgt),
        mask=None if mask is None else torch.from_numpy(mask), chunk=chunk)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-4,
                               atol=1e-6)
    dense = tloss.dense_lm_loss(torch.from_numpy(x), torch.from_numpy(head),
                                torch.from_numpy(tgt),
                                None if mask is None else
                                torch.from_numpy(mask))
    np.testing.assert_allclose(val.item(), dense.item(), rtol=1e-5)


def test_loss_chunk_config_takes_the_chunked_path(model):
    cfg, tcfg, jp = model
    batch = _batch(6)
    want = jl.loss_fn(dataclasses.replace(cfg, loss_chunk=100))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    got = tl.loss_fn(dataclasses.replace(tcfg, loss_chunk=100))(
        from_jax_params(jp, device="cpu"), _t(batch))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                      warmup_num_steps=7)),
    ("WarmupLR", dict(warmup_max_lr=2e-3, warmup_num_steps=5,
                      warmup_type="linear")),
    ("WarmupLR", dict(warmup_max_lr=2e-3, warmup_num_steps=0)),
    ("WarmupDecayLR", dict(total_num_steps=20, warmup_num_steps=5)),
    ("WarmupCosineLR", dict(total_num_steps=20, warmup_num_steps=4,
                            warmup_min_ratio=0.1)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                      cycle_first_step_size=5, decay_step_size=3,
                      decay_lr_rate=0.2)),
    ("LRRangeTest", dict(lr_range_test_step_size=3,
                         lr_range_test_staircase=True)),
    (None, {}),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_lr_schedules_match_jax(name, params):
    jf = jls.from_config(name, dict(params), fallback_lr=3e-4)
    tf = tls.from_config(name, dict(params), fallback_lr=3e-4)
    for step in range(0, 30):
        np.testing.assert_allclose(tf(step), float(jf(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12, err_msg=str(step))
    assert np.isfinite(tf(0))


@pytest.mark.parametrize("B,accum", [(8, 2), (6, 3), (5, 1)])
def test_accum_split_matches_jax(B, accum):
    x = np.arange(B * 3).reshape(B, 3).astype(np.float32)
    want = jeng.accum_split({"x": jnp.asarray(x)}, accum, 1)["x"]
    got = teng.accum_split({"x": torch.from_numpy(x)}, accum)["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    jc, jn = jeng.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                      max_norm)
    tc, tn = teng.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)
    bf = teng.clip_by_global_norm(
        {"a": torch.from_numpy(tree["a"]).to(torch.bfloat16)}, 0.5)[0]
    assert bf["a"].dtype == torch.bfloat16


def _config(**over):
    conf = {
        "train_batch_size": 4, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "bf16": {"enabled": False},
        "optimizer": {"type": "adamw",
                      "params": {"lr": 3e-3, "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0,
                                 "warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 5}},
    }
    conf.update(over)
    return conf


def _jax_engine(cfg, jp, conf, optimizer=None):
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    eng, _, _, _ = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg), params=jax.tree.map(jnp.asarray, jp),
        config=conf, mesh=mesh, optimizer=optimizer)
    return eng


def _torch_engine(tcfg, jp, conf, optimizer=None):
    eng, _, _, _ = initialize(loss_fn=tl.loss_fn(tcfg),
                              params=from_jax_params(jp, device="cpu"),
                              config=conf, optimizer=optimizer,
                              device="cpu")
    return eng


@pytest.mark.parametrize("opt", ["adamw", "fused_adam"])
def test_train_trajectory_matches_jax_engine(model, opt):
    cfg, tcfg, jp = model
    conf = _config()
    sched = dict(warmup_min_lr=0.0, warmup_max_lr=3e-3, warmup_num_steps=5)
    jo = to = None
    if opt == "fused_adam":
        jo = jadam.fused_adam(lr=jls.warmup_lr(**sched), weight_decay=0.1)
        to = tadam.fused_adam(lr=tls.warmup_lr(**sched), weight_decay=0.1)
    je = _jax_engine(cfg, jp, _config(), jo)
    te = _torch_engine(tcfg, jp, conf, to)
    # the f32 master starts as the JAX tree, bit for bit
    for a, b in zip(jax.tree.leaves(te.module_params()), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), b)
    jl_, tl_ = [], []
    for step in range(20):
        batch = _batch(100 + step)
        jl_.append(float(je.train_batch(batch)))
        tl_.append(float(te.train_batch(batch)))
    np.testing.assert_allclose(tl_, jl_, rtol=1e-4)
    assert tl_[-1] < tl_[0]
    assert te.state.step == int(je.state.step) == 20
    np.testing.assert_allclose(te.get_lr(), je.get_lr(), rtol=1e-6)
    np.testing.assert_allclose(te.get_global_grad_norm(),
                               je.get_global_grad_norm(), rtol=1e-3)
    for a, b in zip(jax.tree.leaves(te.module_params()),
                    jax.tree.leaves(je.module_params())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)


def test_fp16_skip_steps_and_scale_match_jax_engine(model):
    cfg, tcfg, jp = model
    conf = _config(fp16={"enabled": True, "initial_scale_power": 18,
                         "loss_scale_window": 2})
    je = _jax_engine(cfg, jp, dict(conf))
    te = _torch_engine(tcfg, jp, dict(conf))
    jrow, trow = [], []
    for step in range(8):
        batch = _batch(200 + step, packed=False)
        jloss_ = float(je.train_batch(batch))
        tloss_ = float(te.train_batch(batch))
        jrow.append((int(je.metrics["overflow"]),
                     float(je.metrics["loss_scale"])))
        trow.append((te.metrics["overflow"], te.metrics["loss_scale"]))
        np.testing.assert_allclose(tloss_, jloss_, rtol=1e-2)
    assert trow == jrow
    assert 0 < te.skipped_steps == je.skipped_steps < 8
    assert te.state.step == int(je.state.step) == 8 - te.skipped_steps


def test_train_step_leaves_no_reference_cycles(model):
    # with the cyclic collector off, a step that builds reference cycles
    # (closures that call themselves, holding lists of gradients) leaves
    # more live tensors behind after every step; at full width that was
    # ~20 GB a step on the card
    _, tcfg, jp = model
    te = _torch_engine(tcfg, jp, _config(),
                       tadam.fused_adam(weight_decay=0.1))
    batch = _batch(8)
    te.train_batch(batch)
    gc.collect()
    live = lambda: sum(torch.is_tensor(o) for o in gc.get_objects())
    gc.disable()
    try:
        before = live()
        for _ in range(3):
            te.train_batch(batch)
        after = live()
    finally:
        gc.enable()
    assert after == before


def test_torch_idiom_and_eval(model):
    _, tcfg, jp = model
    te = _torch_engine(tcfg, jp, _config())
    batch = _batch(7)
    loss = te(batch)
    te.backward(loss)
    te.step()
    assert te.global_steps == 1 and te.state.step == 1
    with pytest.raises(RuntimeError):
        te.step()
    assert np.isfinite(float(te.eval_batch(batch)))
    assert te.train_batch_size == 4 and te.gradient_accumulation_steps == 2


@pytest.mark.parametrize("over,match", [
    ({"zero_optimization": {"stage": 1}}, "ZeRO stage 1"),
    ({"zero_optimization": {"stage": 2,
                            "offload_optimizer": {"device": "cpu"}}},
     "offload"),
    ({"telemetry": {"enabled": True}}, "telemetry"),
    ({"tensorboard": {"enabled": True}}, "tensorboard"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
])
def test_unported_features_raise(model, over, match):
    _, tcfg, jp = model
    with pytest.raises(NotImplementedError, match=match):
        _torch_engine(tcfg, jp, _config(**over))


def test_unported_model_options_raise():
    # the offload remat policies are ported; an unknown policy still raises
    assert tl.LlamaConfig.tiny(remat="offload_attn").remat == "offload_attn"
    with pytest.raises(ValueError, match="remat"):
        tl.LlamaConfig.tiny(remat="offload_everything")
    with pytest.raises(NotImplementedError, match="n_micro"):
        tl.loss_fn(tl.LlamaConfig.tiny(), n_micro=2)
    with pytest.raises(NotImplementedError, match="init thunks"):
        initialize(loss_fn=lambda p, b: 0, params=lambda: {}, config={},
                   device="cpu")
