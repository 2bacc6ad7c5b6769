"""Knowledge distillation in the port (``deepspeed_tpu_torch/distill.py``)
against the JAX package's ``distill.py``: the KL term's exact values (zero
on equal logits, a hand-rolled softmax KL, the JAX function's value at
1e-5), the alpha endpoints, no gradient into the teacher, validation and
the config block, the masked loss, and three engine steps of a 2-layer
student distilling a 4-layer tiny f32 Llama against the JAX
``Distiller`` (losses and the hard/kd terms rtol 1e-5; params rtol 1e-4
with atol 1e-2 of the lr per step: Adam moves an element whose gradient is near
zero by its normalised step whatever the gradient's size, so the two
frameworks' rounding-level gradient differences can shift such an element
by a fraction of the lr; the card-free run read 9.1e-6 = 3e-3 of it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu import distill as jd
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import distill as td
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch._tree import tree_leaves
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
LR = 3e-3


def _logits(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_kd_kl_exact_values():
    s, t = _logits(0, (4, 7, 11)), _logits(1, (4, 7, 11))
    assert td.kd_kl_loss(torch.from_numpy(s), torch.from_numpy(s),
                         temperature=3.0).item() == pytest.approx(0.0,
                                                                  abs=1e-6)
    T = 2.0
    sp = np.log(np.exp(s / T) / np.exp(s / T).sum(-1, keepdims=True))
    tp = np.exp(t / T) / np.exp(t / T).sum(-1, keepdims=True)
    want = float(np.mean(np.sum(tp * (np.log(tp) - sp), -1))) * T * T
    got = td.kd_kl_loss(torch.from_numpy(s), torch.from_numpy(t),
                        temperature=T).item()
    assert got == pytest.approx(want, rel=1e-4)
    jgot = float(jd.kd_kl_loss(jnp.asarray(s), jnp.asarray(t),
                               temperature=T))
    assert got == pytest.approx(jgot, rel=1e-5)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_distillation_loss_alpha_and_masks_match_jax(alpha):
    s, t = _logits(0, (3, 5, 13)), _logits(1, (3, 5, 13))
    tgt = np.random.default_rng(2).integers(0, 13, (3, 5)).astype(np.int32)
    mask = (np.random.default_rng(3).random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        loss, aux = td.distillation_loss(
            torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(tgt),
            alpha=alpha, temperature=2.0,
            mask=None if m is None else torch.from_numpy(m))
        jloss, jaux = jd.distillation_loss(
            jnp.asarray(s), jnp.asarray(t), jnp.asarray(tgt), alpha=alpha,
            temperature=2.0, mask=None if m is None else jnp.asarray(m))
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        for k in ("hard_loss", "kd_loss"):
            assert aux[k].item() == pytest.approx(float(jaux[k]), rel=1e-5)
        if alpha == 0.0:
            assert loss.item() == pytest.approx(aux["hard_loss"].item(),
                                                rel=1e-6)
        if alpha == 1.0:
            assert loss.item() == pytest.approx(aux["kd_loss"].item(),
                                                rel=1e-6)


def test_no_gradient_into_the_teacher():
    s = torch.from_numpy(_logits(0, (3, 5, 13))).requires_grad_(True)
    t = torch.from_numpy(_logits(1, (3, 5, 13))).requires_grad_(True)
    tgt = torch.zeros((3, 5), dtype=torch.int64)
    td.distillation_loss(s, t, tgt, alpha=0.7)[0].backward()
    assert t.grad is None and s.grad is not None


def test_validation_and_config_block():
    with pytest.raises(ValueError, match="alpha"):
        td.Distiller(lambda p, x: x, {}, alpha=1.5)
    with pytest.raises(ValueError, match="temperature"):
        td.Distiller(lambda p, x: x, {}, temperature=0.0)
    assert td.init_distillation({}, lambda p, x: x, {}) is None
    kd = td.init_distillation(
        {"compression_training": {"knowledge_distillation": {
            "enabled": True, "alpha": 0.25, "temperature": 4}}},
        lambda p, x: x, {})
    assert (kd.alpha, kd.temperature) == (0.25, 4.0)
    from deepspeed_tpu_torch.config import Config

    conf = Config.from_dict({"compression_training": {
        "knowledge_distillation": {"enabled": True}}})
    assert td.init_distillation(conf, lambda p, x: x, {}).alpha == 0.5


def test_engine_steps_match_jax():
    tcfg_j = jl.LlamaConfig.tiny(n_layers=4)
    scfg_j = jl.LlamaConfig.tiny(n_layers=2)
    teacher = jax.device_get(jl.init_params(jax.random.PRNGKey(0), tcfg_j))
    student = jax.device_get(jl.init_params(jax.random.PRNGKey(1), scfg_j))
    tcfg, scfg = tl.LlamaConfig.tiny(n_layers=4), tl.LlamaConfig.tiny(
        n_layers=2)
    conf = {"train_batch_size": 4, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": LR}}}
    jdist = jd.Distiller(lambda p, x: jl.forward(p, x, tcfg_j), teacher,
                         alpha=0.5, temperature=2.0)
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je, _, _, _ = dstpu.initialize(
        loss_fn=jdist.loss_fn(lambda p, x: jl.forward(p, x, scfg_j),
                              has_aux=True),
        params=jax.tree.map(jnp.asarray, student), config=dict(conf),
        mesh=mesh, has_aux=True)
    tteacher = from_jax_params(teacher, device="cpu")
    tdist = td.Distiller(lambda p, x: tl.forward(p, x, tcfg), tteacher,
                         alpha=0.5, temperature=2.0)
    te, _, _, _ = initialize(
        loss_fn=tdist.loss_fn(lambda p, x: tl.forward(p, x, scfg),
                              has_aux=True),
        params=from_jax_params(student, device="cpu"), config=dict(conf),
        has_aux=True, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32),
             "loss_mask": (rng.random((4, 17)) > 0.2).astype(np.float32)}
    losses = []
    for _ in range(3):
        jloss = float(je.train_batch(batch))
        tloss = float(te.train_batch(batch))
        assert tloss == pytest.approx(jloss, rel=1e-5)
        for k in ("hard_loss", "kd_loss"):
            assert float(te.metrics["aux"][k]) == pytest.approx(
                float(je.metrics["aux"][k]), rel=1e-5)
        losses.append(tloss)
    assert losses[-1] < losses[0]
    for a, b in zip(tree_leaves(te.module_params()),
                    jax.tree.leaves(je.module_params())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-2 * LR * len(losses))
    for a, b in zip(tree_leaves(tteacher), jax.tree.leaves(teacher)):
        np.testing.assert_array_equal(a.numpy(), b)     # teacher unchanged
        assert a.grad is None
