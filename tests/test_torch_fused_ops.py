"""The port's ``ops/fused_ops.py`` leaves against the JAX package's on the
same numpy inputs: ``layer_norm``, ``gelu_mlp`` and ``fused_softmax`` in
f32 and bf16, and ``dropout``'s keep rate and scaling (its random bits come
from a ``torch.Generator``, JAX's from threefry, so only the distribution is
compared).

Tolerances: f32 at 1e-5 relative / 1e-6 absolute (the same operations,
summed in another order: a few f32 ulps); bf16 at one bf16 ulp of the
largest output (2^-8 relative), since ``layer_norm`` rounds y to bf16
before the affine part on both sides, in the same order, and the
products of ``gelu_mlp`` accumulate in f32 on both before one rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fused_ops as jf
from deepspeed_tpu_torch.ops import fused_ops as tf
from deepspeed_tpu_torch.weights import _tensor

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, name):
    """The same values as a JAX array and a torch tensor of dtype ``name``."""
    jd, td = DTYPES[name]
    j = jnp.asarray(a, jnp.float32).astype(jd)
    return j, _tensor(np.asarray(jax.device_get(j)), "cpu", td)


def _close(got, want, name):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if name == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        ulp = np.abs(want).max() * 2.0 ** -8
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_layer_norm_matches_jax(name):
    rng = np.random.default_rng(0)
    x, tx = _pair(rng.normal(2.0, 3.0, (3, 5, 96)), name)
    w, tw = _pair(rng.normal(1.0, 0.1, (96,)), name)
    b, tb = _pair(rng.normal(0.0, 0.1, (96,)), name)
    got = tf.layer_norm(tx, tw, tb, 1e-5)
    assert got.dtype == DTYPES[name][1]
    _close(got, jf.layer_norm(x, w, b, 1e-5), name)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_gelu_mlp_matches_jax(name):
    rng = np.random.default_rng(1)
    x, tx = _pair(rng.normal(size=(4, 7, 32)), name)
    w1, tw1 = _pair(rng.normal(0, 0.2, (32, 128)), name)
    b1, tb1 = _pair(rng.normal(0, 0.2, (128,)), name)
    w2, tw2 = _pair(rng.normal(0, 0.2, (128, 32)), name)
    b2, tb2 = _pair(rng.normal(0, 0.2, (32,)), name)
    got = tf.gelu_mlp(tx, tw1, tb1, tw2, tb2)
    assert got.dtype == DTYPES[name][1]
    _close(got, jf.gelu_mlp(x, w1, b1, w2, b2), name)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_softmax_matches_jax(name, masked):
    rng = np.random.default_rng(2)
    s, ts = _pair(rng.normal(0, 4.0, (2, 3, 9, 9)), name)
    mask = np.tril(np.ones((9, 9), bool)) if masked else None
    want = jf.fused_softmax(s, None if mask is None else jnp.asarray(mask),
                            scale=0.125)
    got = tf.fused_softmax(ts, None if mask is None
                           else torch.from_numpy(mask), scale=0.125)
    assert got.dtype == torch.float32           # f32 on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    if masked:
        assert (got.numpy()[..., ~mask] == 0).all()


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scaling(rate):
    """Kept elements are x / (1 - rate), dropped ones 0; the kept share is
    1 - rate within 5 binomial standard deviations (n = 2^16); the same
    generator seed gives the same mask; rate 0 and ``deterministic`` are
    the identity, as in JAX."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(1, 2, (256, 256))
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    y = tf.dropout(x, rate, gen)
    kept = y != 0
    np.testing.assert_allclose(y[kept].numpy(), (x[kept] / (1 - rate))
                               .numpy(), rtol=1e-6)
    n = x.numel()
    sd = np.sqrt(n * rate * (1 - rate))
    assert abs(int(kept.sum()) - n * (1 - rate)) < 5 * sd
    again = tf.dropout(x, rate, torch.Generator().manual_seed(7))
    assert torch.equal(again, y)
    for same in (tf.dropout(x, 0.0, gen), tf.dropout(x, rate, gen, True)):
        assert same is x
    # JAX: the same keep rate and scaling from its own bits
    jy = np.asarray(jf.dropout(jnp.asarray(x.numpy()), rate,
                               jax.random.PRNGKey(0)))
    jkept = jy != 0
    assert abs(int(jkept.sum()) - n * (1 - rate)) < 5 * sd
    np.testing.assert_allclose(jy[jkept], x.numpy()[jkept] / (1 - rate),
                               rtol=1e-6)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = tf.gelu(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
