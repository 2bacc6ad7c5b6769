"""The float16 plain versions of B1, B2, B3 and B5 against the JAX package's
Pallas kernels in fp16 on the CPU, and the bodies the CUDA wrappers name for
fp16.

- B1-B3: ``FlashAttention`` on the CPU (the plain versions the wrappers
  take for CPU tensors) and the tiled twins of the tensor-core bodies
  against ``jax.vjp`` of ``flash_attention_tpu(..., interpret=True)`` in
  fp16: G 1 and 4, causal or not, packed segment ids, D 64 and 128.  Both
  sides compute the scores and softmax in f32 and round P (forward) and dS
  (dQ) to fp16, which can land one fp16 ulp apart when their f32 sums
  differ in the last bits: outputs are held to 2 fp16 ulps of 1 (2^-9)
  absolute plus 2^-9 relative, gradients, summed over 256 keys and the
  group, to 2^-7 absolute plus 2^-8 relative.
- The tiled twin of B3 rounds P and dS to fp16 once, as the Pallas kernel
  does: it overflows on the same loss scales as the plain version, and its
  dQ and dV turn no finite value into NaN.
- B5: an fp16 q over bf16 pages (the fp16 model's paged generator) through
  the plain version and the Hopper body's twin against
  ``paged_chunk_attention_v2(..., interpret=True)``, which reads both in
  f32 and writes the output in q's dtype: decode and a chunk, at 2^-9.
- ``flash_fwd_body`` / ``flash_bwd_body`` / ``paged_body`` name the
  tensor-core bodies for fp16 at D 64 / 128 and the scalar ones elsewhere;
  the wrappers refuse float64 with the dtypes they take, and B7 / B8 an
  fp16 q.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kernels as jk
from deepspeed_tpu.ops.attention_pallas import flash_attention_tpu
from deepspeed_tpu_torch.inference import paged_attention_cuda as pac
from deepspeed_tpu_torch.ops import attention as tatt
from deepspeed_tpu_torch.ops import attention_cuda as tcuda

torch.set_num_threads(1)
OUT_TOL = dict(rtol=2 ** -9, atol=2 ** -9)
GRAD_TOL = dict(rtol=2 ** -8, atol=2 ** -7)


def _inputs(B, T, H, KV, D, seed, do_scale=1.0):
    rng = np.random.default_rng(seed)
    f16 = lambda *s: rng.standard_normal(s, dtype=np.float32).astype(
        np.float16)
    q, k, v = f16(B, T, H, D), f16(B, T, KV, D), f16(B, T, KV, D)
    do = (rng.standard_normal((B, T, H, D), dtype=np.float32)
          * do_scale).astype(np.float16)
    return q, k, v, do


def _segments(B, T, cuts):
    seg = np.zeros((B, T), np.int32)
    for i, c in enumerate(cuts):
        seg[:, c:] = i + 1
    return seg


def _jax_grads(q, k, v, do, causal, seg):
    def f(q_, k_, v_):
        return flash_attention_tpu(
            q_, k_, v_, causal=causal, interpret=True,
            segment_ids=None if seg is None else jnp.asarray(seg))

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, causal, seg):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    segt = None if seg is None else torch.from_numpy(seg)
    out = tatt.flash_attention(*ts, causal=causal, segment_ids=segt)
    out.backward(torch.from_numpy(do))
    return [out.detach()] + [t.grad for t in ts]


def _close(got, want, names=("out", "dq", "dk", "dv")):
    for name, g, w in zip(names, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.float16, (name, g.dtype)
        tol = OUT_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), err_msg=name, **tol)


# (G, causal, segments, D)
CASES = [(1, True, False, 64), (4, False, True, 128), (4, True, True, 64),
         (1, False, False, 128)]


@pytest.mark.parametrize("G,causal,with_seg,D", CASES)
def test_fp16_flash_matches_pallas_vjp(G, causal, with_seg, D):
    """The plain versions (FlashAttention's CPU path) and the tiled twins of
    the tensor-core bodies against the Pallas kernels in fp16."""
    B, T, KV = 1, 256, 2
    q, k, v, do = _inputs(B, T, KV * G, KV, D, seed=G + 2 * D + causal)
    seg = _segments(B, T, [0, 70, 181]) if with_seg else None
    want = _jax_grads(q, k, v, do, causal, seg)
    _close(_port_grads(q, k, v, do, causal, seg), want)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = tcuda.flash_fwd_tiled_reference(tq, tk, tv, causal, tseg)
    _close([o], want[:1])
    assert lse.dtype == torch.float32
    _close(tcuda.flash_bwd_tiled_reference(tq, tk, tv, o, lse, tdo, tseg,
                                           causal), want[1:],
           names=("dq", "dk", "dv"))


def test_fp16_tiled_twin_overflows_where_the_plain_version_does():
    """Under growing loss scales dO, and with it dS, passes fp16's 65504:
    the tiled twin (P and dS rounded to fp16 once) and the plain version
    agree on whether the gradients are finite, and the twin's dQ and dV
    turn no element NaN where the plain version's are finite (its dK may,
    where two overflowed dS elements of opposite signs meet, as in the
    Pallas kernel; the step overflows then on both sides through dQ)."""
    q, k, v, do = _inputs(1, 128, 4, 2, 64, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tcuda.flash_fwd_reference(tq, tk, tv, True)
    seen = []
    for log_scale in (0, 8, 12, 14, 16):
        tdo = torch.from_numpy(do).float().mul(2.0 ** log_scale).clamp(
            -65504, 65504).half()
        plain = tcuda.flash_bwd_reference(tq, tk, tv, o, lse, tdo)
        tiled = tcuda.flash_bwd_tiled_reference(tq, tk, tv, o, lse, tdo)
        finite = [bool(torch.isfinite(g).all()) for g in plain]
        assert all(finite) == all(bool(torch.isfinite(g).all())
                                  for g in tiled), log_scale
        for p, t in zip(plain[::2], tiled[::2]):        # dq, dv
            assert not bool((torch.isnan(t) & torch.isfinite(p)).any())
        seen.append(all(finite))
    assert seen[0] and not seen[-1], seen     # both regimes were reached


def _paged_case(C, seed, ps=8, KV=2, G=4, D=64):
    """An fp16 q at positions start + 0..C-1 over bf16 pages of 3 rows."""
    rng = np.random.default_rng(seed)
    starts = np.array([0, 13, 37], np.int32) if C > 1 else \
        np.array([0, 20, 45], np.int32)
    B = len(starts)
    mp = -(-int((starts + C).max()) // ps)
    P = B * mp + 1
    k = rng.standard_normal((KV, P, ps, D), dtype=np.float32)
    v = rng.standard_normal((KV, P, ps, D), dtype=np.float32)
    table = rng.permutation(B * mp).reshape(B, mp).astype(np.int32)
    q = rng.standard_normal((B, C, KV * G, D), dtype=np.float32).astype(
        np.float16)
    return q, k, v, table, starts


@pytest.mark.parametrize("C", [1, 40])
def test_fp16_q_over_bf16_pages_matches_pallas(C):
    q, k, v, table, starts = _paged_case(C, seed=C)
    jkp, jvp = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
    want = np.asarray(jk.paged_chunk_attention_v2(
        jnp.asarray(q), jkp, jvp, jnp.asarray(table), jnp.asarray(starts),
        interpret=True))
    assert want.dtype == np.float16
    tq = torch.from_numpy(q)
    tkp, tvp = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    args = (tkp, tvp, torch.from_numpy(table), torch.from_numpy(starts))
    for got in (pac.paged_chunk_attention(tq, *args),
                pac.paged_chunk_attention_tiled_reference(tq, *args)):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), **OUT_TOL)
    if C == 1:
        lens = torch.from_numpy(starts + 1)
        got = pac.paged_decode_attention(tq[:, 0], tkp, tvp, args[2], lens)
        np.testing.assert_allclose(got.float().numpy(),
                                   want[:, 0].astype(np.float32), **OUT_TOL)


@pytest.mark.parametrize("D,body", [(16, "scalar"), (32, "scalar"),
                                    (64, "tensor"), (128, "tensor")])
def test_fp16_bodies_by_head_dim(D, body):
    q = torch.zeros((1, 4, 2, D), dtype=torch.float16)
    want = "wgmma" if body == "tensor" else "scalar"
    assert tcuda.flash_fwd_body(q) == tcuda.flash_bwd_body(q) == want
    assert pac.paged_body(q) == ("sm90" if body == "tensor" else "scalar")
    # f32 stays on the scalar bodies at every head dim
    assert tcuda.flash_fwd_body(q.float()) == "scalar"
    assert pac.paged_body(q.float()) == "scalar"


def test_refusals_name_the_dtypes_taken():
    """A CUDA call checks its inputs before any launch: float64 is refused
    with the three dtypes B1-B3 take, and B7 / B8 refuse an fp16 q (their
    fp16 bodies are still to be ported).  The checks run on a tensor of
    the meta device, which no wrapper sends to its plain version."""
    q = torch.empty((1, 4, 2, 64), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="float32/bfloat16/float16"):
        tcuda._check("flash_fwd", q, q, q, None)
    q16 = torch.empty((1, 1, 2, 64), dtype=torch.float16, device="meta")
    pages = torch.empty((2, 3, 8, 64), dtype=torch.bfloat16, device="meta")
    table = torch.empty((1, 3), dtype=torch.int32, device="meta")
    start = torch.empty((1,), dtype=torch.int32, device="meta")
    pac._check("paged_chunk_attention", q16, (pages, pages), table, start,
               pac._page_dtype(q16))
    with pytest.raises(ValueError, match="want q in float32/bfloat16 "):
        pac._check("paged_chunk_attention_v1", q16, (pages, pages), table,
                   start, q16.dtype, q_dtypes=(torch.float32, torch.bfloat16))
    with pytest.raises(ValueError, match="pages torch.bfloat16"):
        pac._check("paged_chunk_attention", q16, (pages.half(), pages.half()),
                   table, start, pac._page_dtype(q16))
