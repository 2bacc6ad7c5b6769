"""The CPU twin of B5's and B7's Hopper body
(``paged_chunk_attention_tiled_reference``: decode spans and their merge,
row items over key tiles, B7's scales on S's columns and folded into P)
against the JAX package's Pallas kernels in interpret mode
(``paged_chunk_attention_v2`` and ``paged_chunk_attention_v2_quant``), in
f32 at rtol = atol = 1e-5.  Lengths sit on and around page and span edges,
one decode row is empty, and every table slot past a row's frontier points
at a page of NaN, so any read past the frontier shows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kernels as jk
from deepspeed_tpu_torch.inference import kernels as tk
from deepspeed_tpu_torch.inference import paged_attention_cuda as pac

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
KV, DH, SMALL_SPAN = 2, 16, 2      # SMALL_SPAN: pages per decode span


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(C, G, ps, seed):
    """q, pages, table and starts: B = 7 rows whose frontiers sit on and
    around page edges and both span sizes' edges, the first decode row
    empty, the last at the table's capacity; live pages distinct, stale
    slots past each frontier on pages of NaN."""
    mp = -(-(pac.DECODE_SPAN_KEYS + ps + 2 + C) // ps)
    span = pac.decode_span_pages(ps, mp) * ps
    small = SMALL_SPAN * ps
    cap = mp * ps
    # decode lengths 0, 1, ps - 1, ps, a small span + 1, a span + 1 and
    # the capacity; chunks start on and past page edges and end (start + C)
    # around both span sizes and at the capacity
    if C == 1:
        starts = [-1, 0, ps - 2, ps - 1, small, span, cap - 1]
    else:
        starts = [0, 1, ps - 1, ps, max(2, small + 1 - C),
                  max(3, span - 1 - C), cap - C]
    starts = np.array(starts, np.int32)
    B = len(starts)
    rng = np.random.default_rng(seed)
    used = -(-np.maximum(starts + C, 0) // ps)
    n_live, n_nan = int(used.sum()), 6
    P = n_live + n_nan
    k = rng.standard_normal((KV, P, ps, DH), dtype=np.float32)
    v = rng.standard_normal((KV, P, ps, DH), dtype=np.float32)
    k[:, n_live:] = np.nan
    v[:, n_live:] = np.nan
    perm = rng.permutation(n_live)
    table = rng.integers(n_live, P, (B, mp)).astype(np.int32)
    off = 0
    for b, u in enumerate(used):
        table[b, :u] = perm[off:off + u]
        off += u
    q = rng.standard_normal((B, C, KV * G, DH), dtype=np.float32)
    return q, k, v, table, starts


def _twins(q, pages, table, starts, scales=()):
    """The twin at the kernel's sizes and at small ones (spans of
    SMALL_SPAN pages, items of 16 rows, key tiles of 8)."""
    args = (_t(q), *(_t(p) for p in pages), _t(table), _t(starts),
            *(_t(s) for s in scales))
    return [pac.paged_chunk_attention_tiled_reference(*args, **kw).numpy()
            for kw in ({}, dict(span_pages=SMALL_SPAN, item_rows=16,
                                key_tile=8))]


CASES = [(C, G, ps) for C in (1, 7, 64) for G in (1, 4) for ps in (4, 16)]


@pytest.mark.parametrize("C,G,ps", CASES)
def test_tiled_twin_matches_pallas_v2_interpret(C, G, ps):
    q, k, v, table, starts = _case(C, G, ps, seed=C + G + ps)
    want = np.asarray(jk.paged_chunk_attention_v2(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(starts), pages_per_block=2, interpret=True))
    assert np.isfinite(want).all()
    for got in _twins(q, (k, v), table, starts):
        np.testing.assert_allclose(got, want, **TOL)
        if C == 1:
            assert not got[0].any(), "an empty row must give zeros"


@pytest.mark.parametrize("C,G,ps", CASES)
def test_tiled_twin_quant_matches_pallas_v2_quant_interpret(C, G, ps):
    q, k, v, table, starts = _case(C, G, ps, seed=2 * C + G + ps)
    k[:, ::3, 1] = 0.0                  # zero-amax rows: scale 1.0
    kq, ks = (x.numpy() for x in tk.quantize_kv_rows(_t(k)))
    vq, vs = (x.numpy() for x in tk.quantize_kv_rows(_t(v)))
    want = np.asarray(jk.paged_chunk_attention_v2_quant(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(table), jnp.asarray(starts),
        pages_per_block=2, interpret=True))
    assert np.isfinite(want).all()
    for got in _twins(q, (kq, vq), table, starts, scales=(ks, vs)):
        np.testing.assert_allclose(got, want, **TOL)
        if C == 1:
            assert not got[0].any(), "an empty row must give zeros"


def test_tiled_twin_bf16_splits_p_within_its_rounding():
    """A bf16 q: the chunk twin's P·V takes P as bf16 hi + lo (~2^-16 of
    P), so before the output's rounding it stays within a bf16 ulp of the
    plain version; an f32 P would be no closer after the rounding."""
    q, k, v, table, starts = _case(64, 4, 16, seed=5)
    k[np.isnan(k)] = 0.0
    v[np.isnan(v)] = 0.0
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = pac.paged_chunk_attention_tiled_reference(
        qb, kb, vb, _t(table), _t(starts))
    want = pac.paged_chunk_attention_reference(qb, kb, vb, _t(table),
                                               _t(starts))
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert (err <= 2.0 ** -7 * want.float().abs().clamp(min=1.0)).all()


@pytest.mark.parametrize("dtype,D,body", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 32, "scalar"), (torch.bfloat16, 16, "scalar"),
    (torch.float32, 128, "scalar"), (torch.float32, 64, "scalar")])
def test_paged_body_names_the_hopper_body_by_dtype_and_head_dim(dtype, D,
                                                                 body):
    assert pac.paged_body(torch.zeros((1, 1, 4, D), dtype=dtype)) == body


@pytest.mark.parametrize("ps,mp,pages", [
    (1, 2048, 128), (4, 512, 32), (8, 256, 16), (16, 128, 8), (16, 64, 8),
    (32, 64, 4), (48, 43, 3), (128, 16, 1), (256, 8, 1),
    (16, 4096, 64), (4, 8192, 128), (1, 16384, 256)])
def test_decode_spans_are_whole_pages_of_128_keys_or_more(ps, mp, pages):
    """At least DECODE_SPAN_KEYS keys a span, at most DECODE_MAX_SPANS
    spans a row: long tables take longer spans."""
    assert pac.decode_span_pages(ps, mp) == pages
    assert pages * ps >= pac.DECODE_SPAN_KEYS
    assert -(-mp // pages) <= pac.DECODE_MAX_SPANS
