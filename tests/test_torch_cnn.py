"""The CIFAR CNN of the port against the JAX model on ``CNNConfig()`` with
the same weights, a JAX ``init_params`` tree carried across by
``from_jax_params``.

Tolerances: f32 logits at 1e-5 (the CPU reads ~6e-7: the same
convolutions summed in another order); the loss at 1e-5 relative and every
leaf's gradient at 1e-4 relative / 1e-6 absolute (test_torch_gpt2.py's);
three steps of the engine at 1e-4 relative on the losses
(test_torch_train.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.models import cnn as jc
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch._tree import tree_leaves_with_path
from deepspeed_tpu_torch.models import cnn as tc
from deepspeed_tpu_torch.weights import from_jax_params, init_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    cfg = jc.CNNConfig()
    jp = jax.device_get(jc.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(3)
    for name in ("b1", "b2", "fb1", "fb2"):
        jp[name] = rng.normal(0, 0.05, jp[name].shape).astype(np.float32)
    return cfg, tc.CNNConfig(), jp, from_jax_params(jp, device="cpu")


def _batch(seed, B=6):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, B).astype(np.int32)}


def test_layout_and_bridge(model):
    cfg, tcfg, jp, tp = model
    for path, leaf in tree_leaves_with_path(tp):
        np.testing.assert_array_equal(leaf.numpy(), jp[path])
    mine = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in jp.items()}
    # std 1/sqrt(fan_in) over an HWIO kernel's H * W * I
    assert abs(float(mine["conv2"].std()) * np.sqrt(9 * 32) - 1.0) < 0.05


def test_f32_logits_match_jax(model):
    _, _, jp, tp = model
    b = _batch(1)
    want = np.asarray(jc.forward(jp, jnp.asarray(b["images"])))
    got = tc.forward(tp, torch.from_numpy(b["images"]))
    assert got.dtype == torch.float32 and got.shape == (6, 10)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_loss_and_every_gradient_match_jax(model):
    _, _, jp, _ = model
    b = _batch(2)
    jl, jg = jax.value_and_grad(jc.loss_fn)(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b))
    params = from_jax_params(jp, device="cpu")
    for leaf in params.values():
        leaf.requires_grad_(True)
    loss = tc.loss_fn(params, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(params.values()))
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_train_trajectory_matches_jax_engine(model):
    _, _, jp, _ = model
    conf = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}}}
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je = dstpu.initialize(loss_fn=jc.loss_fn,
                          params=jax.tree.map(jnp.asarray, jp),
                          config=conf, mesh=mesh)[0]
    te = initialize(loss_fn=tc.loss_fn,
                    params=from_jax_params(jp, device="cpu"), config=conf,
                    device="cpu")[0]
    jl, tl = [], []
    for step in range(3):
        b = _batch(100 + step, B=8)
        jl.append(float(je.train_batch(b)))
        tl.append(float(te.train_batch(b)))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for name, leaf in te.module_params().items():
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(je.module_params()[name]),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
