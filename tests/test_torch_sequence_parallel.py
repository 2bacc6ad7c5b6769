"""Sequence parallelism of the port (``parallel/ring_attention.py``,
``parallel/sequence_parallel.py``, the ``seq`` layout of
``models/llama.py``) and the transposes of its collectives, against the
JAX package.

Gloo ranks (seq = 2 and seq = 4) are spawned once by
``tests/_torch_dist.py``; each holds its positions of q/k/v and
back-propagates its share of one global loss (the sum of the squared
outputs).  Oracles: JAX's plain attention on the whole sequence and its
gradients, at the JAX tests' tolerances (tests/test_parallel.py:39-84:
2e-5 for values, 5e-5 for grads), and the JAX engine on the same seq mesh
of its virtual CPU devices for tiny Llama trained with ``attn_impl`` ring
and ulysses.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.ops.attention import _reference as jref
from deepspeed_tpu.topology import MeshSpec as JMesh

torch.set_num_threads(1)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_parallel.py:39
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)      # tests/test_parallel.py:56
TRAIN_TOL = dict(rtol=2e-5, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_zero_engine.py
STEPS = 3
LR = 3e-3
B, T, D = 2, 16, 8


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)   # noqa: E731
    arrays = {"q": f(B, T, 4, D), "k": f(B, T, 2, D), "v": f(B, T, 2, D),
              "gqa_q": f(B, T, 8, D), "gqa_k": f(B, T, 2, D),
              "gqa_v": f(B, T, 2, D),
              "seg": np.repeat(np.asarray([[1] * 5 + [2] * 7 + [3] * 4,
                                           [1] * 9 + [2] * 7]), 1, 0
                               ).astype(np.int32)}
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    tokens = rng.integers(0, cfg.vocab_size, (STEPS, 4, 17)).astype(np.int32)
    return arrays, jp, tokens


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures as cf

    arrays, jp, tokens = _inputs()
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {W: ex.submit(td.run_ranks, "sp", W, {},
                             dict(arrays, llama=jp, tokens=tokens))
                for W in (2, 4)}
        return {W: f.result() for W, f in futs.items()}


def _gathered(res, key):
    return np.concatenate([o[key] for o in res], axis=1)


def _oracle(case):
    a, _, _ = _inputs()
    pre = "gqa_" if case == "gqa" else ""
    q, k, v = (jnp.asarray(a[pre + n]) for n in ("q", "k", "v"))
    seg = jnp.asarray(a["seg"]) if case == "seg" else None

    def loss(q, k, v):
        return jnp.sum(jref(q, k, v, causal=True, segment_ids=seg) ** 2)

    o = jref(q, k, v, causal=True, segment_ids=seg)
    return np.asarray(o), [np.asarray(g) for g in
                           jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("case", ["plain", "seg", "gqa"])
def test_attention_matches_reference(runs, W, impl, case):
    want_o, want_g = _oracle(case)
    np.testing.assert_allclose(_gathered(runs[W], f"{impl}/{case}/o"),
                               want_o, **ATTN_TOL)
    for n, g in zip("qkv", want_g):
        np.testing.assert_allclose(
            _gathered(runs[W], f"{impl}/{case}/d{n}"), g, err_msg=n,
            **GRAD_TOL)


@pytest.mark.parametrize("W", [2, 4])
def test_collectives_backward_by_their_transposes(runs, W):
    w = np.arange(8.0 * W).reshape(4 * W, 2) + 1
    rows = 4 // W
    c = np.arange(float(rows * 2 * W)).reshape(rows, 2 * W)
    for r, o in enumerate(runs[W]):
        x = [np.arange(8.0).reshape(4, 2) + 100 * j for j in range(W)]
        np.testing.assert_array_equal(o["coll/psum/y"], sum(x))
        np.testing.assert_array_equal(o["coll/psum/g"], W * w[:4])
        np.testing.assert_array_equal(o["coll/all_gather/y"],
                                      np.concatenate(x))
        np.testing.assert_array_equal(o["coll/all_gather/g"],
                                      W * w[4 * r:4 * r + 4])
        np.testing.assert_array_equal(o["coll/reduce_scatter/y"],
                                      sum(x)[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(
            o["coll/reduce_scatter/g"],
            np.concatenate([w[:rows] * (j + 1) for j in range(W)]))
        np.testing.assert_array_equal(
            o["coll/all_to_all/y"],
            np.concatenate([x[j][r * rows:(r + 1) * rows]
                            for j in range(W)], axis=1))
        np.testing.assert_array_equal(o["coll/all_to_all/g"],
                                      np.tile(c[:, 2 * r:2 * r + 2], (W, 1)))
        np.testing.assert_array_equal(o["coll/ppermute/y"], x[(r - 1) % W])
        np.testing.assert_array_equal(o["coll/ppermute/g"],
                                      np.full((4, 2), (r + 1) % W + 1.0))


@functools.lru_cache(maxsize=None)
def _jax_train(W, impl):
    _, jp, tokens = _inputs()
    cfg = jl.LlamaConfig.tiny(attn_impl=impl)
    conf = {"train_batch_size": 4, "bf16": {"enabled": False},
            "gradient_clipping": 1.0, "mesh": {"seq": W, "data": 1},
            "optimizer": {"type": "adamw",
                          "params": {"lr": LR, "weight_decay": 0.1}}}
    mesh = JMesh.build({"seq": W}, devices=jax.devices()[:W])
    eng, _, _, _ = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg), params=jax.tree.map(jnp.asarray, jp),
        config=conf, mesh=mesh)
    rows = [[float(eng.train_batch({"tokens": jnp.asarray(tokens[i])})),
             eng.get_global_grad_norm()] for i in range(STEPS)]
    return np.asarray(rows), jax.device_get(eng.module_params())


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_llama_seq_training_matches_jax_engine(runs, W, impl):
    want, jp = _jax_train(W, impl)
    got = runs[W][0][f"train_{impl}/trace"]
    for r in range(1, W):
        np.testing.assert_array_equal(runs[W][r][f"train_{impl}/trace"], got)
    np.testing.assert_allclose(got[:, :2], want, **TRAIN_TOL)
    for k, v in td._flatten(jp).items():
        _params_close(runs[W][0][f"train_{impl}/params/{k}"], v, k)


def _params_close(got, want, name):
    """Params at the ZeRO tests' tolerance, but for Adam's sign flips: an
    embedding row whose summed gradient cancels to ~0 takes a step of
    +-lr on either side of the cancellation, and the ranks sum their
    positions' partials in another order than the one-array scatter-add.
    Such elements are rare (< 0.1 % of the leaf) and off by at most two
    steps of lr each step."""
    bad = ~np.isclose(got, want, **PARAM_TOL)
    assert bad.mean() < 1e-3, (name, int(bad.sum()))
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * STEPS,
                               err_msg=name)
