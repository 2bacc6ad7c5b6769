"""Training Mixtral with the port's engine against the JAX package's on the
CPU: ``initialize(loss_fn=mixtral.loss_fn(cfg), has_aux=True)`` on
``MixtralConfig.tiny()`` in f32 (AdamW and ``fused_adam``, WarmupLR,
clipping 1.0, accumulation 2), the same weights through
``from_jax_params``.  Losses at test_torch_train.py's f32 1e-4 relative;
``metrics["aux"]`` is the mean of the two microbatches' aux (the [E]
expert load too), as JAX's ``jnp.mean`` over the accumulation stack, at
1e-4 relative / 1e-6 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu import lr_schedules as jls
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu.ops import adam_pallas as jadam
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import MixtralConfig, initialize
from deepspeed_tpu_torch import lr_schedules as tls
from deepspeed_tpu_torch.models import mixtral as tm
from deepspeed_tpu_torch.ops import adam_cuda as tadam
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

CONF = {
    "train_batch_size": 4, "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0, "bf16": {"enabled": False},
    "optimizer": {"type": "adamw",
                  "params": {"lr": 3e-3, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3,
                             "warmup_num_steps": 3}},
}


def _batch(seed, B=4, T=13):
    rng = np.random.default_rng(seed)
    seg = np.ones((B, T), np.int32)
    seg[:, T // 2:] = 2
    seg[0, T - 2:] = 0
    return {"tokens": rng.integers(0, 256, (B, T)).astype(np.int32),
            "segment_ids": seg}


@pytest.mark.parametrize("opt", ["adamw", "fused_adam"])
def test_train_trajectory_and_aux_match_jax_engine(opt):
    assert MixtralConfig is tm.MixtralConfig
    cfg = jm.MixtralConfig.tiny()
    tcfg = tm.MixtralConfig.tiny()
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(1), cfg))
    jo = to = None
    if opt == "fused_adam":
        sched = dict(warmup_min_lr=0.0, warmup_max_lr=3e-3,
                     warmup_num_steps=3)
        jo = jadam.fused_adam(lr=jls.warmup_lr(**sched), weight_decay=0.1)
        to = tadam.fused_adam(lr=tls.warmup_lr(**sched), weight_decay=0.1)
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je, _, _, _ = dstpu.initialize(
        loss_fn=jm.loss_fn(cfg), params=jax.tree.map(jnp.asarray, jp),
        config=CONF, mesh=mesh, optimizer=jo, has_aux=True)
    te, _, _, _ = initialize(loss_fn=tm.loss_fn(tcfg),
                             params=from_jax_params(jp, device="cpu"),
                             config=CONF, optimizer=to, has_aux=True,
                             device="cpu")
    jl_, tl_ = [], []
    for step in range(6):
        batch = _batch(50 + step)
        jl_.append(float(je.train_batch(batch)))
        tl_.append(float(te.train_batch(batch)))
        want, got = je._last_metrics["aux"], te.metrics["aux"]
        assert set(got) == set(want) == {"lm_loss", "moe_aux_loss",
                                         "moe_z_loss", "moe_expert_load"}
        for name, w in want.items():
            g = got[name]
            assert not g.requires_grad
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        assert got["moe_expert_load"].shape == (4,)
    np.testing.assert_allclose(tl_, jl_, rtol=1e-4)
    assert tl_[-1] < tl_[0]
    assert te.state.step == int(je.state.step) == 6
