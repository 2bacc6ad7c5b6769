"""The tiled twin of the flash forward's tensor-core body
(``attention_cuda.flash_fwd_tiled_reference``, plain PyTorch walking the
kernel's tiles in its order, with its exp2 and its masks) against the JAX
Pallas kernel in interpret mode and the plain ``flash_fwd_reference``, on
the same numpy-seeded inputs, at f32: rtol = atol = 1e-5.

``flash_attention_tpu`` takes T and S in multiples of 128 only.  A ragged
case is padded to the next multiple with zero rows, and the padded keys are
kept out of every real row's view: causal rows never see keys past
themselves, and otherwise the padding gets a segment id of its own.  The
real rows of the padded result are the ragged result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import _reference as jax_reference
from deepspeed_tpu.ops.attention_pallas import flash_attention_tpu
from deepspeed_tpu_torch.ops.attention_cuda import (flash_fwd_reference,
                                                    flash_fwd_tiled_reference)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
# (block_q, block_k): the kernel's own tiles, and tiles of unequal size
# whose edges fall on both sides of the diagonal
BLOCKS = [(128, 128), (64, 32), (32, 96)]


def _inputs(T, S, G, seed, D=16, KV=2, B=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, KV * G, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    return q, k, v


def _segments(T, bounds, B=1):
    seg = np.zeros((B, T), np.int32)
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[:, a:b] = i + 1
    return seg


def _pallas(q, k, v, causal, seg=None):
    """flash_attention_tpu in interpret mode on inputs padded to multiples
    of 128 (T <= S when not causal), cut back to the real rows."""
    T, S = q.shape[1], k.shape[1]
    L = -(-max(T, S) // 128) * 128

    def pad(x):
        return np.pad(x, ((0, 0), (0, L - x.shape[1]), (0, 0), (0, 0)))

    if seg is None and not causal:
        seg = np.ones((q.shape[0], S), np.int32)
    if seg is not None:
        seg = np.pad(seg, ((0, 0), (0, L - seg.shape[1])),
                     constant_values=int(seg.max()) + 1)
        seg = jnp.asarray(seg)
    out = flash_attention_tpu(jnp.asarray(pad(q)), jnp.asarray(pad(k)),
                              jnp.asarray(pad(v)), causal=causal,
                              segment_ids=seg, interpret=True)
    return np.asarray(out)[:, :T]


def _check_twin(q, k, v, causal, seg, want):
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tseg = None if seg is None else torch.from_numpy(seg)
    ro, rlse = flash_fwd_reference(tq, tk, tv, causal, tseg)
    np.testing.assert_allclose(ro.numpy(), want, **TOL)
    for bq, bk in BLOCKS:
        o, lse = flash_fwd_tiled_reference(tq, tk, tv, causal, tseg, bq, bk)
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
        np.testing.assert_allclose(o.numpy(), want, **TOL)
        np.testing.assert_allclose(lse.numpy(), rlse.numpy(), **TOL)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 129, 300])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_twin_matches_pallas_interpret(T, G, causal):
    q, k, v = _inputs(T, T, G, seed=T * 10 + G)
    _check_twin(q, k, v, causal, None, _pallas(q, k, v, causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4])
def test_twin_segments_with_whole_tiles_outside_a_row(causal, G):
    # rows 200..299 (segment 3) see none of keys 0..199: for them whole key
    # tiles are masked, and without the causal mask the first tiles of their
    # sweep are, so m stays -inf across those tiles and p must be 0
    T = 300
    q, k, v = _inputs(T, T, G, seed=40 + G)
    seg = _segments(T, [0, 100, 200, 300])
    _check_twin(q, k, v, causal, seg, _pallas(q, k, v, causal, seg))


def test_twin_rows_without_live_keys_in_early_tiles():
    # a one-row segment at the end, non-causal: its row's first two key
    # tiles (block_k 128) hold no key of its segment; in the kernel's
    # contract every row sees at least itself (segments) or key 0, so a
    # row that sees no key at all cannot be built through this interface
    T = 257
    q, k, v = _inputs(T, T, 4, seed=7)
    seg = _segments(T, [0, 256, 257])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = flash_fwd_tiled_reference(tq, tk, tv, False,
                                       torch.from_numpy(seg))
    # the lone row attends only to itself: o is its own v, lse its score
    vrow = np.repeat(v[0, -1], 4, axis=0)
    np.testing.assert_allclose(o[0, -1].numpy(), vrow, **TOL)
    s = (q[0, -1] * np.repeat(k[0, -1], 4, axis=0)).sum(-1) / 4.0
    np.testing.assert_allclose(lse[0, :, -1].numpy(), s, **TOL)
    _check_twin(q, k, v, False, seg, _pallas(q, k, v, False, seg))


@pytest.mark.parametrize("T,S", [(100, 300), (63, 129), (300, 100),
                                 (129, 64)])
def test_twin_t_ne_s_noncausal(T, S):
    q, k, v = _inputs(T, S, 4, seed=T + S)
    if T <= S:
        want = _pallas(q, k, v, False)
    else:   # the padding cannot hide keys from rows past S
        want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False))
    _check_twin(q, k, v, False, None, want)


def test_twin_bf16_close_to_plain():
    # in bf16 the twin rounds p against each tile's running max where the
    # plain version rounds it against the row's final max: they differ by
    # about one bf16 ulp of |o| (the card's tolerance is 1e-2)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(300, 300, 4, seed=3))
    o, lse = flash_fwd_tiled_reference(q, k, v, True)
    ro, rlse = flash_fwd_reference(q, k, v, True)
    assert o.dtype == torch.bfloat16
    assert (o.float() - ro.float()).abs().max().item() <= 1e-2
    assert (lse - rlse).abs().max().item() <= 1e-5
