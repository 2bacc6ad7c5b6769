"""Stochastic rounding f32 -> bf16 of the port against the JAX package.

JAX draws its bits from threefry, which PyTorch cannot reproduce (ROADMAP
C-w1), so the parity is distributional: only the two bf16 neighbours of x
appear, values bf16 holds come back as they are, NaN and +-inf take the
plain cast, and the mean over many draws is within 5 standard errors of x
(a false alarm at 5 sigma has odds of ~3e-7 a value).  Given the same bits
(JAX's ``jax.random.bits`` patched to hand them over), the two functions
agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import rounding as jr
from deepspeed_tpu_torch.ops import rounding as tr

torch.set_num_threads(1)


def _bits(t: torch.Tensor) -> np.ndarray:
    """bf16 -> its 16-bit pattern as int64."""
    return t.view(torch.int16).numpy().astype(np.int64) & 0xFFFF


def _f32(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n) * 10.0 ** rng.integers(-30, 30, n)
    return torch.from_numpy(x.astype(np.float32))


def test_only_the_two_bf16_neighbours_appear():
    x = _f32(0)
    u = x.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF
    lo, hi = u >> 16, (u >> 16) + 1
    gen = torch.Generator().manual_seed(1)
    for _ in range(4):
        got = _bits(tr.stochastic_round_bf16(x, gen))
        assert np.all((got == lo) | (got == hi))


def test_values_bf16_holds_are_unchanged():
    x = _f32(2).to(torch.bfloat16)
    got = tr.stochastic_round_bf16(x.float(), torch.Generator().manual_seed(3))
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))


def test_non_finite_take_the_plain_cast():
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 1.5],
                     dtype=torch.float32)
    got = tr.stochastic_round_bf16(x, torch.Generator().manual_seed(4))
    want = x.to(torch.bfloat16)
    assert torch.isnan(got[0]) and torch.equal(got[1:], want[1:])


@pytest.mark.parametrize("value", [1.0 + 2 ** -10, -3.14159, 1e-3, 7.77e5,
                                   2.5e-40])
def test_mean_is_unbiased(value):
    n = 20000
    x = torch.full((n,), value, dtype=torch.float32)
    got = tr.stochastic_round_bf16(x, torch.Generator().manual_seed(5))
    y = got.double().numpy()
    lo, hi = y.min(), y.max()
    if lo == hi:          # bf16 holds the value
        assert lo == np.float32(value)
        return
    p = (np.float64(np.float32(value)) - lo) / (hi - lo)
    se = (hi - lo) * np.sqrt(p * (1 - p) / n)
    assert abs(y.mean() - np.float64(np.float32(value))) <= 5 * se


def test_same_generator_state_same_result():
    x = _f32(6)
    a = tr.stochastic_round_bf16(x, torch.Generator().manual_seed(7))
    b = tr.stochastic_round_bf16(x, torch.Generator().manual_seed(7))
    c = tr.stochastic_round_bf16(x, torch.Generator().manual_seed(8))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert not torch.equal(a.view(torch.int16), c.view(torch.int16))


def test_same_bits_same_result_as_jax(monkeypatch):
    x = _f32(9, 2048).numpy()
    x[:4] = [np.nan, np.inf, -np.inf, 0.0]
    bits = np.random.default_rng(10).integers(0, 1 << 16, x.shape)
    monkeypatch.setattr(jax.random, "bits", lambda key, shape, dtype:
                        jnp.asarray(bits, jnp.uint32))
    want = np.asarray(jr.stochastic_round_bf16(jnp.asarray(x),
                                               jax.random.PRNGKey(0)))
    got = tr.round_with_bits(torch.from_numpy(x), torch.from_numpy(bits))
    np.testing.assert_array_equal(_bits(got)[4:],
                                  want.view(np.uint16)[4:].astype(np.int64))
    assert np.isnan(got[0].item())
    np.testing.assert_array_equal(got[1:4].float().numpy(), x[1:4])


def test_jax_and_port_round_up_alike():
    """The share of draws that round up, on the same values, agrees between
    the two frameworks within 5 standard errors of the difference."""
    x = np.full(20000, 1.0 + 3 * 2 ** -9, np.float32)      # p = 0.75 up
    j = np.asarray(jr.stochastic_round_bf16(jnp.asarray(x),
                                            jax.random.PRNGKey(1)),
                   np.float32)
    t = tr.stochastic_round_bf16(torch.from_numpy(x),
                                 torch.Generator().manual_seed(11)).float()
    pj, pt = (j > x).mean(), (t.numpy() > x).mean()
    se = np.sqrt(2 * 0.75 * 0.25 / x.size)
    assert abs(pj - 0.75) <= 5 * se and abs(pt - pj) <= 5 * se


def test_tree_casts_f32_leaves_with_a_stream_each():
    same = torch.full((512,), 1.0 + 2 ** -9, dtype=torch.float32)
    tree = {"a": same.clone(), "b": {"c": same.clone()},
            "i": torch.arange(4), "h": same.to(torch.bfloat16)}
    out = tr.stochastic_round_tree(tree, torch.Generator().manual_seed(12))
    again = tr.stochastic_round_tree(tree, torch.Generator().manual_seed(12))
    assert out["a"].dtype == out["b"]["c"].dtype == torch.bfloat16
    assert out["i"] is tree["i"] and out["h"] is tree["h"]
    assert torch.equal(out["a"], again["a"])
    # one child generator per leaf: equal leaves round differently
    assert not torch.equal(out["a"], out["b"]["c"])
    jt = jr.stochastic_round_tree({"a": jnp.asarray(same.numpy())},
                                  jax.random.PRNGKey(2))
    assert jt["a"].dtype == jnp.bfloat16
