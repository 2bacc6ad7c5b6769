"""BERT training in the port against the JAX package on
``BertConfig.tiny()`` (the same weights through ``from_jax_params``): every
remat policy gives the gradients of ``remat="none"`` exactly (the
recompute runs the same operations on the same inputs, and the offload
policies keep the same tensors: the identity on the CPU), and three steps
of ``initialize(...).train_batch`` in f32 (AdamW and ``fused_adam``,
WarmupLR, clipping, accumulation 2, so the attention mask goes through
``accum_split``) follow the JAX engine's losses at 1e-4 relative
(test_torch_train.py's tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu import lr_schedules as jls
from deepspeed_tpu.models import bert as jb
from deepspeed_tpu.ops import adam_pallas as jadam
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch import lr_schedules as tls
from deepspeed_tpu_torch import remat as tremat
from deepspeed_tpu_torch._tree import tree_leaves_with_path
from deepspeed_tpu_torch.models import bert as tb
from deepspeed_tpu_torch.ops import adam_cuda as tadam
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
ALL_POLICIES = tremat.POLICIES + tuple(tremat.OFFLOAD)


@pytest.fixture(scope="module")
def model():
    cfg = jb.BertConfig.tiny()
    jp = jax.device_get(jb.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, tb.BertConfig.tiny(), jp


def _batch(seed, B=4, T=20):
    """Ragged rows (the last one all padding), token types and ~30 % of
    the positions labelled."""
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


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(tcfg, jp, b):
    params = from_jax_params(jp, device="cpu")
    leaves = [l.requires_grad_(True) for _, l in tree_leaves_with_path(params)]
    loss = tb.loss_fn(tcfg)(params, _t(b))
    return loss.item(), torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)


def test_every_remat_policy_gives_the_same_gradients(model):
    _, tcfg, jp = model
    b = _batch(6)
    want_loss, want = _grads(tcfg, jp, b)
    for policy in ALL_POLICIES:
        loss, got = _grads(dataclasses.replace(tcfg, remat=policy), jp, b)
        assert loss == want_loss, policy
        for g, w in zip(got, want):
            assert torch.equal(g, w), policy


def _config():
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "bf16": {"enabled": False},
        "optimizer": {"type": "adamw",
                      "params": {"lr": 3e-3, "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0,
                                 "warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 5}},
    }


@pytest.mark.parametrize("opt", ["adamw", "fused_adam"])
def test_train_trajectory_matches_jax_engine(model, opt):
    """Against the JAX engine on a one-device mesh."""
    cfg, tcfg, jp = model
    sched = dict(warmup_min_lr=0.0, warmup_max_lr=3e-3, warmup_num_steps=5)
    jo = to = None
    if opt == "fused_adam":
        jo = jadam.fused_adam(lr=jls.warmup_lr(**sched), weight_decay=0.1)
        to = tadam.fused_adam(lr=tls.warmup_lr(**sched), weight_decay=0.1)
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je = dstpu.initialize(loss_fn=jb.loss_fn(cfg),
                          params=jax.tree.map(jnp.asarray, jp),
                          config=_config(), mesh=mesh, optimizer=jo)[0]
    te = initialize(loss_fn=tb.loss_fn(tcfg),
                    params=from_jax_params(jp, device="cpu"),
                    config=_config(), optimizer=to, device="cpu")[0]
    jl_, tl_ = [], []
    for step in range(3):
        b = _batch(100 + step)
        jl_.append(float(je.train_batch(b)))
        tl_.append(float(te.train_batch(b)))
    np.testing.assert_allclose(tl_, jl_, rtol=1e-4)
    assert te.state.step == int(je.state.step) == 3
    for a, b in zip(jax.tree.leaves(te.module_params()),
                    jax.tree.leaves(je.module_params())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)
