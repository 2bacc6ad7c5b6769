"""Flash attention backward of the port: ``FlashAttention`` on the CPU (the
plain versions of the three kernels) against ``jax.vjp`` of the Pallas
kernel in interpret mode and against autograd of the port's own
``_reference``.  f32 throughout; tolerance 1e-5 absolute and relative (the
two sides sum the same products in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention_pallas import flash_attention_tpu
from deepspeed_tpu_torch.ops import attention as tatt
from deepspeed_tpu_torch.ops import attention_cuda as tcuda

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, T, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    do = rng.standard_normal((B, T, H, D), dtype=np.float32)
    return q, k, v, do


def _segments(B, T, cuts):
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        for i, c in enumerate(cuts):
            seg[b, c:] = i + 1
    return seg


def _port_grads(q, k, v, do, causal, seg, fn=tatt.flash_attention):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    segt = None if seg is None else torch.from_numpy(seg)
    out = fn(*ts, causal=causal, segment_ids=segt)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_pallas_vjp(causal, with_seg):
    B, T, H, KV, D = 2, 256, 4, 2, 64
    q, k, v, do = _inputs(B, T, H, KV, D, seed=int(causal) + 2 * with_seg)
    seg = _segments(B, T, [0, 70, 181]) if with_seg else None

    def f(q_, k_, v_):
        return flash_attention_tpu(
            q_, k_, v_, causal=causal, interpret=True,
            segment_ids=None if seg is None else jnp.asarray(seg))

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _port_grads(q, k, v, do, causal, seg)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    # the port's autograd oracle agrees too
    ref = _port_grads(q, k, v, do, causal, seg, fn=tatt._reference)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("T,G,with_seg", [(37, 2, False), (37, 4, True),
                                          (1, 1, False), (70, 1, True)])
def test_ragged_grads_match_autograd_of_reference(T, G, with_seg):
    q, k, v, do = _inputs(2, T, 2 * G, 2, 16, seed=T + G)
    seg = _segments(2, T, [0, T // 3]) if with_seg else None
    got = _port_grads(q, k, v, do, True, seg)
    ref = _port_grads(q, k, v, do, True, seg, fn=tatt._reference)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_bwd_reference_rounds_ds_to_k_dtype():
    # bf16 inputs: dq takes ds rounded to bf16 (attention_pallas.py:137),
    # dk/dv stay f32 until their final cast; all land near the f32 grads
    q, k, v, do = _inputs(1, 40, 4, 2, 16, seed=5)
    t32 = [torch.from_numpy(x) for x in (q, k, v, do)]
    t16 = [x.to(torch.bfloat16) for x in t32]
    o, lse = tcuda.flash_fwd_reference(*t16[:3])
    dq, dk, dv = tcuda.flash_bwd_reference(*t16[:3], o, lse, t16[3])
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    o32, lse32 = tcuda.flash_fwd_reference(*t32[:3])
    want = tcuda.flash_bwd_reference(*t32[:3], o32, lse32, t32[3])
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=0.1,
                                   atol=0.1)


def test_no_graph_under_no_grad_and_kernels_refuse_the_cpu():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 1, 16, 1))
    with torch.no_grad():
        out = tatt.flash_attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        tcuda.flash_bwd_dq(q, k, v, q, q, lse)
    with pytest.raises(ValueError, match="unsupported device"):
        tcuda.flash_bwd_dkv(q, k, v, q, lse, lse)
