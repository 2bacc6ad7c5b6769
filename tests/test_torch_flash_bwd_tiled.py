"""The tiled twin of the flash backward's tensor-core bodies
(``attention_cuda.flash_bwd_tiled_reference``: plain PyTorch walking the dQ
and dK/dV kernels' tiles in their order, with their exp2, masks, tile
skips, the two warpgroups' partial sums and the hi/lo split of P and dS)
against ``jax.vjp`` of the JAX Pallas kernel in interpret mode, on the same
numpy-seeded inputs, at f32: rtol = atol = 1e-5.  At bf16 it is held to the
plain ``flash_bwd_reference`` under the card's metric and bound (the
largest |error| over the largest |plain value|, ``chip_smoke.py``'s
``FLASH_BWD_REL_TOL``).

``flash_attention_tpu`` takes T and S in multiples of 128 only.  A ragged
case is padded as ``test_torch_flash_tiled.py`` pads it: zero rows, padded
keys kept out of every real row's view (causal rows never see keys past
themselves, and otherwise the padding gets a segment id of its own); the
padded rows carry dO = 0, so they add nothing to dK and dV.  The real rows
and keys of the padded gradients are the ragged gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import _reference as jax_reference
from deepspeed_tpu.ops.attention_pallas import flash_attention_tpu
from deepspeed_tpu_torch.ops.attention_cuda import (flash_bwd_reference,
                                                    flash_bwd_tiled_reference,
                                                    flash_delta,
                                                    flash_delta_sliced,
                                                    flash_fwd_reference)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
# (block_q, block_k, dkv_block_q): the kernels' own tiles, and tiles of
# unequal size whose edges fall on both sides of the diagonal
BLOCKS = [(128, 64, 64), (64, 32, 32), (32, 96, 48)]
FLASH_BWD_REL_TOL = 4e-3          # chip_smoke.py's gate for B2/B3
# delta in the dQ kernels' order against a plain sum: both sum the same f32
# products, each order within a few ulps of the row's sum of |O * dO|
# (read at most 3 over D 16-128, f32 and bf16 inputs): 8 such ulps
DELTA_ULPS = 8


def _inputs(T, S, G, seed, D=16, KV=2, B=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, KV * G, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    do = rng.standard_normal((B, T, KV * G, D), dtype=np.float32)
    return q, k, v, do


def _segments(T, bounds, B=1):
    seg = np.zeros((B, T), np.int32)
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[:, a:b] = i + 1
    return seg


def _pallas_vjp(q, k, v, do, causal, seg=None):
    """(dq, dk, dv) of flash_attention_tpu in interpret mode on inputs
    padded to multiples of 128 (T <= S when not causal), cut back."""
    T, S = q.shape[1], k.shape[1]
    L = -(-max(T, S) // 128) * 128

    def pad(x):
        return jnp.asarray(np.pad(x, ((0, 0), (0, L - x.shape[1]), (0, 0),
                                      (0, 0))))

    if seg is None and not causal:
        seg = np.ones((q.shape[0], S), np.int32)
    if seg is not None:
        seg = jnp.asarray(np.pad(seg, ((0, 0), (0, L - seg.shape[1])),
                                 constant_values=int(seg.max()) + 1))

    def f(q_, k_, v_):
        return flash_attention_tpu(q_, k_, v_, causal=causal, segment_ids=seg,
                                   interpret=True)

    _, vjp = jax.vjp(f, pad(q), pad(k), pad(v))
    dq, dk, dv = vjp(pad(do))
    return np.asarray(dq)[:, :T], np.asarray(dk)[:, :S], np.asarray(dv)[:, :S]


def _check_twin(q, k, v, do, causal, seg, want):
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = flash_fwd_reference(tq, tk, tv, causal, tseg)
    plain = flash_bwd_reference(tq, tk, tv, o, lse, tdo, tseg, causal)
    for name, p, w in zip(("dq", "dk", "dv"), plain, want):
        np.testing.assert_allclose(p.numpy(), w, err_msg=name, **TOL)
    for bq, bk, bm in BLOCKS:
        got = flash_bwd_tiled_reference(tq, tk, tv, o, lse, tdo, tseg, causal,
                                        bq, bk, bm)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(g).all(), name
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


# T around the 64- and 128-row tiles and ragged past both, GQA 1, 2 and 4
@pytest.mark.parametrize("T,G", [(1, 1), (65, 4), (129, 2), (300, 1),
                                 (300, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_twin_matches_pallas_vjp(T, G, causal):
    q, k, v, do = _inputs(T, T, G, seed=T * 10 + G)
    _check_twin(q, k, v, do, causal, None, _pallas_vjp(q, k, v, do, causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4])
def test_twin_segments_skip_whole_tiles(causal, G):
    # rows 200..299 (segment 3) see none of keys 0..199 and keys 0..99 are
    # seen only by rows 0..99: whole tiles of both sweeps are skipped, and
    # the tiles across segment edges take the id mask
    T = 300
    q, k, v, do = _inputs(T, T, G, seed=40 + G)
    seg = _segments(T, [0, 100, 200, 300])
    _check_twin(q, k, v, do, causal, seg,
                _pallas_vjp(q, k, v, do, causal, seg))


@pytest.mark.parametrize("T,S", [(100, 300), (300, 100)])
def test_twin_t_ne_s_noncausal(T, S):
    q, k, v, do = _inputs(T, S, 2, seed=T + S)
    if T <= S:
        want = _pallas_vjp(q, k, v, do, False)
    else:   # the padding cannot hide keys from rows past S
        _, vjp = jax.vjp(lambda q_, k_, v_: jax_reference(
            q_, k_, v_, causal=False), *map(jnp.asarray, (q, k, v)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    _check_twin(q, k, v, do, False, None, want)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_twin_bf16_within_the_card_gate(D, causal):
    # the card's metric at bf16: dq differs from the plain version only by
    # exp2 and the order of the sums; dk and dv by the hi/lo split of P and
    # dS too (bf16 alone would leave about a bf16 ulp of the largest value)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(300, 300, 4, seed=D + causal, D=D))
    o, lse = flash_fwd_reference(q, k, v, causal)
    want = flash_bwd_reference(q, k, v, o, lse, do, None, causal)
    got = flash_bwd_tiled_reference(q, k, v, o, lse, do, None, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max()).item()
        assert rel <= FLASH_BWD_REL_TOL, (name, rel)


@pytest.mark.parametrize("T", [1, 300])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_delta_matches_plain_and_jax(dtype, D, T):
    # the kernels' four D/4-column slices met as (s0 + s1) + (s2 + s3),
    # against flash_delta and the JAX package's own delta
    # (attention_pallas._flash_bwd_impl: jnp.sum of f32 out * f32 do)
    rng = np.random.default_rng(D + T)
    o, do = (torch.from_numpy(rng.standard_normal((2, T, 4, D),
                                                  dtype=np.float32)).to(dtype)
             for _ in range(2))
    got = flash_delta_sliced(o, do)
    assert got.shape == (2, 4, T) and got.dtype == torch.float32
    of, dof = o.float().numpy(), do.float().numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jo, jdo = (jnp.asarray(x).astype(jdt) for x in (of, dof))
    jax_delta = np.asarray(jnp.sum(jo.astype(jnp.float32)
                                   * jdo.astype(jnp.float32), axis=-1))
    ulp = np.spacing(np.abs(of * dof).sum(-1)).transpose(0, 2, 1)
    for name, want in (("flash_delta", flash_delta(o, do).numpy()),
                       ("jax", jax_delta.transpose(0, 2, 1))):
        err = np.abs(got.numpy() - want)
        assert (err <= DELTA_ULPS * ulp).all(), (name, (err / ulp).max())
