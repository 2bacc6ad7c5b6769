"""BERT of the port against the JAX model on ``BertConfig.tiny()`` with the
same weights, a JAX ``init_params`` tree carried across by
``from_jax_params``.

Tolerances: f32 hidden states, pooled vectors and MLM logits at 1e-5 (the
issue's gate; the CPU reads ~7e-7 at most: the same operations summed in
another order over two layers); f32 loss at 1e-5 relative and every
leaf's gradient at 1e-4 relative / 1e-6 absolute (test_torch_gpt2.py's);
bf16 MLM logits at 0.06 (the bf16 bound of test_torch_gpt2.py and
test_torch_llama.py: bf16 rounds at other places in the two frameworks).
Training (remat policies, trajectories against the JAX engine) is in
test_torch_train_bert.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jb
from deepspeed_tpu_torch._tree import tree_leaves_with_path
from deepspeed_tpu_torch.models import bert as tb
from deepspeed_tpu_torch.weights import from_jax_params, init_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def model():
    cfg = jb.BertConfig.tiny()
    jp = jax.device_get(jb.init_params(jax.random.PRNGKey(0), cfg))
    # non-zero biases and LayerNorm affines, so every leaf carries signal
    rng = np.random.default_rng(9)

    def jitter(tree):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                jitter(leaf)
            elif leaf.ndim < 3 and name not in ("embed", "pos_embed",
                                                 "type_embed", "w"):
                tree[name] = (leaf + rng.normal(0, 0.05, leaf.shape)
                              ).astype(np.float32)

    jitter(jp)
    tp = from_jax_params(jp, device="cpu")
    return cfg, tb.BertConfig.tiny(), jp, tp


def _batch(seed, B=3, T=20, ragged=True, types=True, labels=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 256, (B, T)).astype(np.int32)}
    if ragged:
        mask = np.ones((B, T), np.int32)
        for b in range(B):
            mask[b, rng.integers(2, T + 1):] = 0
        mask[-1] = 0                 # a filler row: every position padding
        out["attention_mask"] = mask
    if types:
        out["token_type_ids"] = rng.integers(0, 2, (B, T)).astype(np.int32)
    if labels:
        lab = np.where(rng.random((B, T)) < 0.3, out["tokens"], -100)
        out["mlm_labels"] = lab.astype(np.int32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jforward(cfg, jp, b):
    return jb.forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(b["tokens"]),
                      cfg, token_type_ids=b.get("token_type_ids"),
                      attention_mask=b.get("attention_mask"))


def _tforward(tcfg, tp, b):
    tb_ = _t(b)
    return tb.forward(tp, tb_["tokens"], tcfg,
                      token_type_ids=tb_.get("token_type_ids"),
                      attention_mask=tb_.get("attention_mask"))


def test_bridge_is_a_plain_copy(model):
    _, _, jp, tp = model
    for path, leaf in tree_leaves_with_path(tp):
        want = jp
        for key in path.split("/"):
            want = want[key]
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want)


def test_config_presets_layout_and_param_count():
    for preset in ("base", "large", "tiny"):
        a = dataclasses.asdict(getattr(jb.BertConfig, preset)())
        b = dataclasses.asdict(getattr(tb.BertConfig, preset)())
        assert b.pop("attn_impl") == "auto" and a == b
        jcfg, tcfg = getattr(jb.BertConfig, preset)(), getattr(
            tb.BertConfig, preset)()
        assert tcfg.head_dim == jcfg.head_dim
        if preset == "tiny":
            jp = jb.init_params(jax.random.PRNGKey(1), jcfg)
            tp = init_params(tcfg, torch.Generator().manual_seed(1),
                             device="cpu", dtype=torch.float32)
            jl = jax.tree_util.tree_leaves_with_path(jp)
            tl = tree_leaves_with_path(tp)
            assert [tuple(l.shape) for _, l in tl] == [l.shape for _, l in jl]
            assert tb.param_count(tcfg) == sum(l.size for _, l in jl)
    assert abs(tb.param_count(tb.BertConfig.large()) - 335e6) < 5e6
    # the tensor-parallel tree is JAX's, leaf for leaf
    from jax.sharding import PartitionSpec as P

    assert tb.param_specs(tb.BertConfig.tiny()) == jax.tree.map(
        tuple, jb.param_specs(jb.BertConfig.tiny()),
        is_leaf=lambda x: isinstance(x, P))
    with pytest.raises(NotImplementedError, match="ring"):
        tb.BertConfig.tiny(attn_impl="ring")


@pytest.mark.parametrize("ragged,types", [(False, False), (True, False),
                                          (True, True)])
def test_f32_heads_match_jax(model, ragged, types):
    cfg, tcfg, jp, tp = model
    b = _batch(1, ragged=ragged, types=types, labels=False)
    jh, th = _jforward(cfg, jp, b), _tforward(tcfg, tp, b)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(
        tb.pooled_output(tp, th).numpy(),
        np.asarray(jb.pooled_output(jax.tree.map(jnp.asarray, jp), jh)),
        **TOL)
    tlog = tb.mlm_logits(tp, th, tcfg)
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(
        tlog.numpy(), np.asarray(jb.mlm_logits(
            jax.tree.map(jnp.asarray, jp), jh, cfg)), **TOL)


def test_reference_attention_arm_equals_flash_arm(model):
    _, tcfg, _, tp = model
    b = _batch(2, labels=False)
    ref = dataclasses.replace(tcfg, attn_impl="reference")
    np.testing.assert_allclose(_tforward(ref, tp, b).numpy(),
                               _tforward(tcfg, tp, b).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_loss_and_every_gradient_match_jax(model):
    cfg, tcfg, jp, tp = model
    b = _batch(3)
    jl_, jg = jax.value_and_grad(jb.loss_fn(cfg))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b))
    params = {k: v for k, v in from_jax_params(jp, device="cpu").items()}
    leaves = [l for _, l in tree_leaves_with_path(params)]
    for l in leaves:
        l.requires_grad_(True)
    loss = tb.loss_fn(tcfg)(params, _t(b))
    np.testing.assert_allclose(loss.item(), float(jl_), rtol=1e-5)
    # the pooler does not reach the MLM loss: no gradient (JAX's zeros)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for (path, _), g in zip(tree_leaves_with_path(params), grads):
        want = jg
        for key in path.split("/"):
            want = want[key]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=path)


def test_no_label_gives_zero_loss(model):
    _, tcfg, _, tp = model
    b = _batch(4)
    b["mlm_labels"][:] = -100
    assert float(tb.loss_fn(tcfg)(tp, _t(b))) == 0.0


def test_bf16_mlm_logits_close_to_jax(model):
    cfg, tcfg, jp, _ = model
    b = _batch(5, labels=False)
    jbf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tbf = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    jh = jb.forward(jbf, jnp.asarray(b["tokens"]), cfg,
                    token_type_ids=jnp.asarray(b["token_type_ids"]),
                    attention_mask=jnp.asarray(b["attention_mask"]))
    want = np.asarray(jb.mlm_logits(jbf, jh, cfg))
    got = tb.mlm_logits(tbf, _tforward(tcfg, tbf, b), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.06)


@pytest.mark.parametrize("T", [32, 77])
def test_tiled_twins_take_pad_ids_non_causal(T):
    """The walks of the tensor-core bodies' tiles (what the card's bodies
    do) at BERT's mask: ids that descend (1 ... 1 0 ... 0), a filler row
    all 0, bidirectional, T within one tile (32) and across two (77);
    against the plain versions in f32, at f32 rounding (1e-5)."""
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd_reference, flash_bwd_tiled_reference, flash_fwd_reference,
        flash_fwd_tiled_reference)

    rng = np.random.default_rng(T)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(3, T, 2, 64)).astype(
        np.float32)) for _ in range(4))
    seg = torch.zeros((3, T), dtype=torch.int32)
    seg[0, :T - 5] = 1
    seg[1, :3] = 1
    o, lse = flash_fwd_reference(q, k, v, causal=False, seg=seg)
    to, tlse = flash_fwd_tiled_reference(q, k, v, causal=False, seg=seg)
    np.testing.assert_allclose(to.numpy(), o.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = flash_bwd_reference(q, k, v, o, lse, do, seg, False)
    got = flash_bwd_tiled_reference(q, k, v, o, lse, do, seg, False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
