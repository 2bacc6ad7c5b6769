"""``parallel/moe.py`` of the port against the JAX package's.

``capacity`` is held equal.  ``top_k_gating`` for k = 1 and 2, with
planted ties and with capacities small enough to drop tokens: the
dispatch tensor EXACTLY equal (it is 0/1 and the positions are integers),
the combine weights, the load-balance and z losses and the expert load at
1e-6 (f32 softmax / logsumexp of two frameworks, a few ulps apart).
``MoELayer`` (router in f32, dispatch, experts batched over E, combine) in
f32 against JAX's at 1e-5 on its outputs and aux, at the training and the
eval capacity factor, and its gradients.  The noise arm draws from a
``torch.Generator`` (JAX's threefry bits have no PyTorch twin), so it is
held to distributional checks only.  A ``mesh`` raises: expert parallelism
comes with ROADMAP A9.
"""

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import numpy as np
import pytest
import torch

from deepspeed_tpu.config import MoEConfig as JMoEConfig
from deepspeed_tpu.ops.fused_ops import swiglu as jswiglu
from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu_torch.config import MoEConfig
from deepspeed_tpu_torch.ops.fused_ops import swiglu
from deepspeed_tpu_torch.parallel import moe as tmoe

torch.set_num_threads(1)


@pytest.mark.parametrize("n, e, k, factor, min_cap", [
    (1, 8, 2, 1.25, 4), (37, 4, 1, 1.0, 4), (37, 4, 2, 1.25, 4),
    (4096, 8, 2, 1.25, 4), (4096, 8, 2, 2.0, 4), (5, 8, 1, 0.5, 1),
    (100, 3, 2, 1.1, 2)])
def test_capacity_equal_to_jax(n, e, k, factor, min_cap):
    got = tmoe.capacity(n, e, k, factor, min_cap)
    assert got == jmoe.capacity(n, e, k, factor, min_cap)
    assert isinstance(got, int)


def _logits(N=37, E=4, seed=0):
    lg = np.random.default_rng(seed).normal(size=(N, E)).astype(np.float32)
    lg[3, 1] = lg[3, 2] = 9.0            # a tie: the lower index first
    lg[5, :] = 0.5                       # a row of ties
    lg[7, 0] = lg[7, 3] = -1.0
    return lg


@pytest.mark.parametrize("k, cap", [(1, 4), (1, 40), (2, 3), (2, 7),
                                    (2, 40)])
def test_top_k_gating_equal_to_jax(k, cap):
    lg = _logits()
    want = jmoe.top_k_gating(jnp.asarray(lg), k, cap)
    got = tmoe.top_k_gating(torch.from_numpy(lg), k, cap)
    assert isinstance(got, tmoe.GateOutput)
    assert got.dispatch.shape == (37, 4, cap)
    np.testing.assert_array_equal(got.dispatch.numpy(),
                                  np.asarray(want.dispatch))
    for name in ("combine", "aux_loss", "z_loss", "expert_load"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    kept = got.dispatch.sum().item()
    if cap < 37 * k / 4:
        assert kept < 37 * k             # overflow dropped some tokens
    else:
        assert kept == 37 * k
    # every kept slot holds one token; combine rows sum to 1 over the kept
    # choices when k > 1
    assert got.dispatch.sum(0).max().item() <= 1.0
    if k > 1:
        full = got.dispatch.sum((1, 2)) == k
        np.testing.assert_allclose(got.combine.sum((1, 2))[full].numpy(),
                                   1.0, rtol=1e-6)


def test_top_k_gating_gradients_equal_to_jax():
    lg = _logits(seed=1)
    w = np.random.default_rng(2).normal(size=(37, 4, 7)).astype(np.float32)

    def jloss(x):
        g = jmoe.top_k_gating(x, 2, 7)
        return jnp.sum(g.combine * w) + g.aux_loss + g.z_loss

    want = np.asarray(jax.grad(jloss)(jnp.asarray(lg)))
    x = torch.from_numpy(lg).requires_grad_(True)
    g = tmoe.top_k_gating(x, 2, 7)
    (torch.sum(g.combine * torch.from_numpy(w)) + g.aux_loss
     + g.z_loss).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def _layer_inputs(seed=0, B=2, T=11, d=16, f=24, E=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    gate = (rng.normal(size=(d, E)) * 0.5).astype(np.float32)
    ep = {"w1": rng.normal(size=(E, d, f)).astype(np.float32) / 4,
          "w3": rng.normal(size=(E, d, f)).astype(np.float32) / 4,
          "w2": rng.normal(size=(E, f, d)).astype(np.float32) / 5}
    return x, gate, ep


def _jax_expert(p, h):
    return jswiglu(h, p["w1"], p["w3"]) @ p["w2"]


def _expert(p, h):
    return swiglu(h, p["w1"], p["w3"]) @ p["w2"]


@pytest.mark.parametrize("k, factor, train", [
    (2, 1.25, True), (2, 0.5, True), (1, 1.0, True), (2, 1.25, False)])
def test_moe_layer_equal_to_jax(k, factor, train):
    x, gate, ep = _layer_inputs()
    kw = dict(enabled=True, num_experts=4, top_k=k, capacity_factor=factor,
              eval_capacity_factor=1.5, aux_loss_weight=0.01,
              z_loss_weight=0.001)
    jl = jmoe.MoELayer(cfg=JMoEConfig(**kw), expert_fn=_jax_expert)
    tl = tmoe.MoELayer(cfg=MoEConfig(**kw), expert_fn=_expert)
    wy, waux = jl(jnp.asarray(gate), jax.tree.map(jnp.asarray, ep),
                  jnp.asarray(x), train=train)
    gy, gaux = tl(torch.from_numpy(gate),
                  {n: torch.from_numpy(v) for n, v in ep.items()},
                  torch.from_numpy(x), train=train)
    assert gy.shape == x.shape and gy.dtype == torch.float32
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-5,
                               atol=1e-5)
    assert set(gaux) == set(waux)
    for name, v in waux.items():
        np.testing.assert_allclose(gaux[name].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_moe_layer_gradients_equal_to_jax():
    x, gate, ep = _layer_inputs(seed=3)
    kw = dict(enabled=True, num_experts=4, top_k=2, capacity_factor=1.0)
    jl = jmoe.MoELayer(cfg=JMoEConfig(**kw), expert_fn=_jax_expert)
    tl = tmoe.MoELayer(cfg=MoEConfig(**kw), expert_fn=_expert)

    def jloss(gate, ep, x):
        y, aux = jl(gate, ep, x)
        return jnp.sum(y * y) + aux["moe_aux_loss"] + aux["moe_z_loss"]

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(gate), jax.tree.map(jnp.asarray, ep), jnp.asarray(x))
    tg = torch.from_numpy(gate).requires_grad_(True)
    tep = {n: torch.from_numpy(v).requires_grad_(True) for n, v in ep.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tl(tg, tep, tx)
    (torch.sum(y * y) + aux["moe_aux_loss"] + aux["moe_z_loss"]).backward()
    got = (tg.grad, {n: t.grad for n, t in tep.items()}, tx.grad)
    for name, g, w in (("gate", got[0], want[0]), ("x", got[2], want[2]),
                       *((n, got[1][n], want[1][n]) for n in ep)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_moe_layer_dispatch_and_combine_are_2d_products():
    """Dispatch and combine are ``aten.mm`` (kept by
    ``save_dots_no_batch``), the experts ``aten.bmm`` (recomputed)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                self.seen.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    x, gate, ep = _layer_inputs()
    layer = tmoe.MoELayer(cfg=MoEConfig(num_experts=4, top_k=2),
                          expert_fn=_expert)
    with Ops() as ops:
        layer(torch.from_numpy(gate),
              {n: torch.from_numpy(v) for n, v in ep.items()},
              torch.from_numpy(x))
    # router, dispatch, the experts' w1 / w3 / w2, combine
    assert ops.seen == ["mm", "mm", "bmm", "bmm", "bmm", "mm"]


def test_noise_arm_is_distributional():
    """noise_std > 0 with a generator perturbs the choices only: with equal
    logits every expert is chosen about 1/E of the time, the same seed
    draws the same routing, the gate values stay the router's
    probabilities, and without a generator no noise is added (JAX's
    ``rng is None`` arm)."""
    N, E, cap = 2000, 4, 1000
    lg = torch.zeros((N, E))
    g = tmoe.top_k_gating(lg, 1, cap,
                          generator=torch.Generator().manual_seed(0),
                          noise_std=1.0)
    share = g.dispatch.sum((0, 2)) / N
    # 1/E within four standard deviations of a share of N draws (0.0097)
    np.testing.assert_allclose(share.numpy(), 1 / E, atol=0.04)
    again = tmoe.top_k_gating(lg, 1, cap,
                              generator=torch.Generator().manual_seed(0),
                              noise_std=1.0)
    assert torch.equal(again.dispatch, g.dispatch)
    np.testing.assert_allclose(g.combine.sum((1, 2)).numpy(), 1 / E,
                               rtol=1e-6)
    other = tmoe.top_k_gating(lg, 1, cap,
                              generator=torch.Generator().manual_seed(1),
                              noise_std=1.0)
    assert not torch.equal(other.dispatch, g.dispatch)
    quiet = tmoe.top_k_gating(lg, 1, N, noise_std=1.0)
    assert torch.equal(quiet.dispatch, tmoe.top_k_gating(lg, 1, N).dispatch)
    assert quiet.dispatch.sum((0, 2))[0].item() == N      # all ties -> 0
    # a small noise keeps a clear winner: logit gaps of 4 against std 0.1
    lg = torch.from_numpy(np.tile([4.0, 0.0, 0.0, 0.0], (N, 1)).astype(
        np.float32))
    g = tmoe.top_k_gating(lg, 1, N, generator=torch.Generator().manual_seed(2),
                          noise_std=0.1)
    assert g.dispatch.sum((0, 2))[0].item() == N


def test_mesh_and_expert_specs_raise():
    # expert parallelism is ported: experts that do not divide over the
    # expert axis raise; expert_param_specs prepends the axis as JAX's
    from deepspeed_tpu_torch.topology import AXES, MeshSpec

    ms = MeshSpec(sizes={a: 3 if a == "expert" else 1 for a in AXES})
    with pytest.raises(ValueError, match="expert"):
        tmoe.MoELayer(cfg=MoEConfig(num_experts=4), expert_fn=_expert,
                      mesh=ms)
    want = jmoe.expert_param_specs({"w1": None, "w2": P(None, "model")})
    assert tmoe.expert_param_specs({"w1": None, "w2": (None, "model")}) \
        == {k: tuple(v) for k, v in want.items()}
