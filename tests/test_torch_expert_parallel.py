"""Expert parallelism of the port (``parallel/moe.py`` over the
``expert`` axis, ``expert_param_specs``, ``mixtral.param_specs``, Mixtral
trained and served over the mesh) against the JAX package.

Gloo ranks are spawned once by ``tests/_torch_dist.py``: W = 2 (expert 2)
and W = 4 (data 2 x expert 2 for training; expert 2 x model 2 for
serving).  Each rank holds its rows of the batch (split over data x
expert) and its experts; the gate is the global one, as under JAX's GSPMD.
Oracles: the JAX MoE layer on the whole batch with one device (values and
the grads of one global loss), the JAX engine on the same mesh of its
virtual CPU devices for Mixtral training, and the JAX single-device
serving engine for exact tokens on the f32 tiny Mixtral
(tests/test_serving_moe.py:104-149), f32 caches on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu import topology as jtopo
from deepspeed_tpu.config import MoEConfig as JMoEConfig
from deepspeed_tpu.inference.serving import mixtral_serving_engine as jserve
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu.topology import MeshSpec as JMesh

torch.set_num_threads(1)
MOE_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3
PROMPTS = {"a": ([5, 9, 2], 6), "b": ([17, 3, 3, 8, 1], 5),
           "c": ([40, 2], 7)}
KW = dict(max_batch=2, page_size=8, num_pages=32, max_seq=64,
          prefill_bucket=8)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(9)
    d, h, E = 8, 16, 4
    moe = {"x": rng.normal(0, 1, (8, 4, d)).astype(np.float32),
           "gate": rng.normal(0, 1, (d, E)).astype(np.float32),
           "w1": (rng.normal(0, 1, (E, d, h)) / np.sqrt(d)).astype(
               np.float32),
           "w2": (rng.normal(0, 1, (E, h, d)) / np.sqrt(h)).astype(
               np.float32)}
    cfg = jm.MixtralConfig.tiny(attn_impl="reference")
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(0), cfg))
    tokens = rng.integers(0, cfg.vocab_size, (STEPS, 8, 17)).astype(
        np.int32)
    return {"moe": moe, "mixtral": jp, "tokens": tokens}, cfg


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures as cf

    arrays, _ = _inputs()
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {W: ex.submit(td.run_ranks, "ep", W,
                             {"prompts": PROMPTS, "kw": KW}, arrays)
                for W in (2, 4)}
        return {W: f.result() for W, f in futs.items()}


def _jax_moe(k):
    a, _ = _inputs()
    m = {n: jnp.asarray(v) for n, v in a["moe"].items()}
    layer = jmoe.MoELayer(
        cfg=JMoEConfig(enabled=True, num_experts=4, top_k=k,
                       capacity_factor=1.0, min_capacity=1),
        expert_fn=lambda p, h: jnp.tanh(h @ p["w1"]) @ p["w2"])

    def loss(x, gate, w1):
        y, aux = layer(gate, {"w1": w1, "w2": m["w2"]}, x)
        return jnp.mean(y ** 2) + aux["moe_aux_loss"], (y, aux)

    (_, (y, aux)), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        m["x"], m["gate"], m["w1"])
    return y, aux, g


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_over_the_expert_axis_matches_jax(runs, W, k):
    y, aux, (dx, dgate, dw1) = _jax_moe(k)
    res = runs[W]
    n = y.shape[0] // W              # the rows a rank holds, data-major
    ep = 2
    for r, o in enumerate(res):
        np.testing.assert_allclose(o[f"moe{k}/y"], y[r * n:(r + 1) * n],
                                   **MOE_TOL)
        np.testing.assert_allclose(o[f"moe{k}/dx"], dx[r * n:(r + 1) * n],
                                   **MOE_TOL)
        np.testing.assert_allclose(o[f"moe{k}/aux"],
                                   aux["moe_aux_loss"], **MOE_TOL)
        np.testing.assert_allclose(o[f"moe{k}/load"],
                                   aux["moe_expert_load"], **MOE_TOL)
    # the router's grads are partial a rank, the experts' partial over
    # data: summed, they are the one-array gradients
    np.testing.assert_allclose(sum(o[f"moe{k}/dgate"] for o in res), dgate,
                               **MOE_TOL)
    e = dw1.shape[0] // ep
    for j in range(ep):
        got = sum(o[f"moe{k}/dw1"] for r, o in enumerate(res)
                  if r % ep == j)
        np.testing.assert_allclose(got, dw1[j * e:(j + 1) * e], **MOE_TOL)


@functools.lru_cache(maxsize=None)
def _jax_train(sizes):
    a, cfg = _inputs()
    sizes = dict(sizes)
    n = int(np.prod(list(sizes.values())))
    jtopo.set_current_mesh(None)
    try:
        eng, _, _, _ = dstpu.initialize(
            loss_fn=jm.loss_fn(cfg),
            params=jax.tree.map(jnp.asarray, a["mixtral"]),
            mesh=JMesh.build(sizes, devices=jax.devices()[:n]),
            config={"train_batch_size": 8, "bf16": {"enabled": False},
                    "mesh": sizes, "zero_optimization": {"stage": 0},
                    "optimizer": {"type": "adamw", "params": {"lr": 3e-3}}},
            param_specs=jm.param_specs(cfg), has_aux=True)
        rows = [[float(eng.train_batch({"tokens": jnp.asarray(t)})),
                 eng.get_global_grad_norm()] for t in a["tokens"]]
        return np.asarray(rows), jax.device_get(eng.module_params())
    finally:
        jtopo.set_current_mesh(None)


@pytest.mark.parametrize("W", [2, 4])
def test_mixtral_expert_parallel_training_matches_jax(runs, W):
    sizes = (("expert", 2),) if W == 2 else (("data", 2), ("expert", 2))
    want, jp = _jax_train(sizes)
    got = runs[W][0]["train/trace"]
    for o in runs[W][1:]:
        np.testing.assert_array_equal(o["train/trace"], got)
    np.testing.assert_allclose(got[:, :2], want, **TRAIN_TOL)
    for k, v in td._flatten(jp).items():
        np.testing.assert_allclose(runs[W][0][f"train/params/{k}"], v,
                                   err_msg=k, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("W", [2, 4])
def test_mixtral_sharded_serving_tokens_match_jax(runs, W):
    a, cfg = _inputs()
    eng = jserve(jax.tree.map(jnp.asarray, a["mixtral"]), cfg,
                 cache_dtype=jnp.float32, **KW)
    for rid, (p, n) in PROMPTS.items():
        eng.submit(rid, p, max_new_tokens=n)
    res = eng.run()
    want = {rid: [int(t) for t in res[rid]] for rid in PROMPTS}
    for o in runs[W]:
        assert {rid: o[f"serve/{rid}"].tolist() for rid in PROMPTS} == want
        # a rank holds E / 2 experts (and, at W = 4, half their features)
        L, E = cfg.n_layers, cfg.num_experts
        f = cfg.ffn_dim // (2 if W == 4 else 1)
        assert o["serve/w1_shape"].tolist() == [L, E // 2, cfg.dim, f]
