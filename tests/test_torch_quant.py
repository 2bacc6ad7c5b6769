"""Group quantization of the port (``deepspeed_tpu_torch/ops/quant.py``,
the plain version of kernel B9, the K/V row codec) against the JAX package:
the same inputs, made with numpy, through both.  Codes, scales and
zero-points are held EXACTLY equal (both sides divide in f32 and round half
to even); dequantized values and fp8 bits too.  Only the Pallas kernel in
interpret mode is held to rtol 1e-6 on its scales (see that test)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import kernels as jk
from deepspeed_tpu.inference import kv_tier as jkv
from deepspeed_tpu.ops import quant as jq
from deepspeed_tpu_torch.inference import kernels as tk
from deepspeed_tpu_torch.ops import quant as tq
from deepspeed_tpu_torch.ops.quant_cuda import (quantize_rows,
                                                quantize_rows_reference)

torch.set_num_threads(1)


def _x(shape, seed=0, scale=3.0, zero_groups=0, num_groups=1):
    """Normal values, with the first ``zero_groups`` groups all zero and a
    few exact .5 quotients planted (amax 127 gives scale 1.0)."""
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    flat = x.reshape(num_groups, -1)
    flat[:zero_groups] = 0.0
    if num_groups > zero_groups and flat.shape[1] >= 8:
        g = flat[zero_groups]
        g[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
        g[8:] = np.clip(g[8:], -127.0, 127.0)
    return x


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("shape,num_groups,zero_groups", [
    ((16, 64), 16, 0), ((16, 64), 4, 1), ((3, 5, 8), 15, 2),
    ((1024,), 1, 0), ((12, 10), 6, 6)])
def test_quantize_dequantize_equal_to_jax(bits, symmetric, shape,
                                          num_groups, zero_groups):
    x = _x(shape, seed=bits, zero_groups=zero_groups, num_groups=num_groups)
    tqv, ts, tz = tq.quantize(torch.from_numpy(x), bits=bits,
                              num_groups=num_groups, symmetric=symmetric)
    jqv, js, jz = jq.quantize(jnp.asarray(x), bits=bits,
                              num_groups=num_groups, symmetric=symmetric)
    assert tqv.dtype == torch.int8 and tuple(tqv.shape) == shape
    _eq(tqv, jqv)
    _eq(ts, js)
    assert (tz is None) == (jz is None)
    if tz is not None:
        _eq(tz, jz)
    _eq(tq.dequantize(tqv, ts, tz, bits=bits),
        jq.dequantize(jqv, js, jz, bits=bits))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bf16_input_and_nd_scales(dtype):
    x = _x((4, 6, 32), seed=5, zero_groups=1, num_groups=24)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tqv, ts, _ = tq.quantize(tx, num_groups=48)
    jqv, js, _ = jq.quantize(jx, num_groups=48)
    _eq(tqv, jqv)
    _eq(ts, js)
    # the inference layout: scale [..., groups_per_row]
    out = tq.dequantize(tqv, ts.reshape(4, 6, 2), dtype=torch.bfloat16)
    want = jq.dequantize(jqv, js.reshape(4, 6, 2), dtype=jnp.bfloat16)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(16, 1024), (8, 512), (24, 1536)])
def test_blockwise_2d_grid_equal_to_jax(shape):
    x = _x(shape, seed=shape[0])
    tqv, ts = tq.quantize_blockwise(torch.from_numpy(x))
    jqv, js = jq.quantize_blockwise(jnp.asarray(x))
    assert tuple(ts.shape) == (shape[0] // 8, shape[1] // 512)
    _eq(tqv, jqv)
    _eq(ts, js)
    _eq(tq.dequantize_blockwise(tqv, ts), jq.dequantize_blockwise(jqv, js))


@pytest.mark.parametrize("n", [4096, 3 * 4096, 5000])
def test_blockwise_flat_and_block_pad_equal_to_jax(n):
    x = _x((n,), seed=n)
    tp = tq.block_pad(torch.from_numpy(x))
    jp = jq.block_pad(jnp.asarray(x))
    _eq(tp, jp)
    assert tp.numel() % tq.BLOCK_ELEMS == 0
    tqv, ts = tq.quantize_blockwise(tp)
    jqv, js = jq.quantize_blockwise(jp)
    _eq(tqv, jqv)
    _eq(ts, js)
    _eq(tq.dequantize_blockwise(tqv, ts), jq.dequantize_blockwise(jqv, js))
    if n % tq.BLOCK_ELEMS:
        with pytest.raises(ValueError, match="block_pad"):
            tq.quantize_blockwise(torch.from_numpy(x))


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_fp8_equal_to_jax(kind):
    x = _x((4, 33), seed=9)
    x[0, :4] = [0.5, -2.0, 100.0, 1e-3]
    t8, ts = tq.to_fp8(torch.from_numpy(x), kind)
    j8, js = jq.to_fp8(jnp.asarray(x), kind)
    np.testing.assert_array_equal(t8.view(torch.uint8).numpy(),
                                  np.asarray(j8).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tq.from_fp8(t8, ts, dtype=torch.bfloat16)
    want = jq.from_fp8(j8, js, dtype=jnp.bfloat16)
    assert back.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    zero, s0 = tq.to_fp8(torch.zeros(3), kind)
    assert s0.item() == 1.0 and not zero.float().any()


@pytest.mark.parametrize("groups", [8, 64])
def test_plain_b9_equal_to_pallas_interpret(groups):
    """B9's plain version against the Pallas kernel in interpret mode, at
    the kernel's own tile shapes (8, 128) and (64, 128): equal codes, and
    scales within 1e-6 relative.  The interpret-mode lowering rounds
    amax / 127 one ulp off the jnp ``quantize`` on some rows (the JAX
    package's own test holds the two at the same rtol); against ``quantize``
    itself the scales are equal."""
    x = _x((groups, 128), seed=groups, zero_groups=1, num_groups=groups)
    jqv, js = jq.quantize_pallas(jnp.asarray(x), num_groups=groups,
                                 interpret=True)
    tqv, ts = quantize_rows_reference(torch.from_numpy(x))
    _eq(tqv, jqv)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    _eq(ts, jq.quantize(jnp.asarray(x), num_groups=groups)[1])
    wq, ws = quantize_rows(torch.from_numpy(x))    # the CPU wrapper
    assert torch.equal(wq, tqv) and torch.equal(ws, ts)
    assert ts[0].item() == 1.0 and not tqv[0].any()


def test_blockwise_kernel_route_equal_to_pallas_interpret():
    """``quantize_blockwise`` of a flat buffer is the port's route of
    ``quantize_blockwise_pallas`` (B9 on CUDA, its plain version here)."""
    x = _x((8 * 4096,), seed=11)
    jqv, js = jq.quantize_blockwise_pallas(jnp.asarray(x), interpret=True)
    tqv, ts = tq.quantize_blockwise(torch.from_numpy(x))
    _eq(tqv, jqv)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_plain_b9_nan_and_inf_groups():
    """A NaN in a group gives a NaN scale and codes 0; an inf gives scale
    inf, finite elements 0 and the inf itself 0 (inf / inf); the kernel
    is held to the same on the card."""
    x = _x((4, 32), seed=3)
    x[0, 5] = np.nan
    x[1, 7] = np.inf
    x[2, 0] = -np.inf
    q, s = quantize_rows_reference(torch.from_numpy(x))
    assert np.isnan(s[0].item()) and not q[0].any()
    assert s[1].item() == np.inf and not q[1].any()
    assert s[2].item() == np.inf and not q[2].any()
    ref_q, ref_s = quantize_rows_reference(torch.from_numpy(x[3:]))
    assert torch.equal(q[3:], ref_q) and torch.equal(s[3:], ref_s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gsz,offset,body", [
    (128, 0, "vec"), (8, 0, "vec"), (24, 0, "vec"), (4096, 0, "vec"),
    (128, 8, "vec"), (7, 0, "scalar"), (33, 0, "scalar"), (1, 0, "scalar"),
    (128, 1, "scalar"), (128, 3, "scalar")])
def test_quant_body_is_a_function_of_group_size_and_alignment(dtype, gsz,
                                                               offset, body):
    """B9's vector body takes groups whose size is a multiple of 8 on a
    16-byte boundary; a view that starts off one (``offset`` elements into
    a fresh buffer, which is aligned) or any other group size takes the
    scalar body."""
    from deepspeed_tpu_torch.ops.quant_cuda import quant_body

    buf = torch.zeros(offset + 4 * gsz, dtype=dtype)
    x = buf[offset:].view(4, gsz)
    assert quant_body(x) == body


def test_quantize_rows_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match=r"\[G, gsz\]"):
        quantize_rows(torch.zeros(4))
    with pytest.raises(ValueError, match="groups"):
        tq.quantize(torch.zeros(10), num_groups=3)


def _kv_codec_input():
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((4, 3, 16))).astype(np.float32)
    x[0, 0] = 0.0                               # a zero row: scale 1.0
    x[1, 0] = 0.0
    x[1, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_through_b9_equals_codecs(dtype):
    """The K/V row codec now runs through B9: still bit-equal to the
    kv_tier numpy codec and to the JAX package's device codec."""
    x = _kv_codec_input()
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    codes, scale = tk.quantize_kv_rows(t)
    assert tuple(codes.shape) == x.shape and tuple(scale.shape) == \
        x.shape[:-1] + (1,)
    hc, hs = jkv.quantize_page(x)
    jc, js = jk.quantize_kv_rows(jnp.asarray(x))
    for c, sc in ((hc, hs), (np.asarray(jc), np.asarray(js))):
        np.testing.assert_array_equal(codes.numpy(), c)
        np.testing.assert_array_equal(scale.numpy(), sc)
    assert codes[1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    rq, rs = tk.quantize_kv_rows(t, force_reference=True)
    assert torch.equal(rq, codes) and torch.equal(rs, scale)
    # a strided view (the decode writer hands it new_k[:, None])
    view = t[:, :1]
    vq, vs = tk.quantize_kv_rows(view)
    assert torch.equal(vq, codes[:, :1]) and torch.equal(vs, scale[:, :1])


def test_kernel_policy_quantize_field():
    """The ``kernels`` block has the JAX package's fields and no
    ``quantize`` switch: B9 has no plain arm on CUDA (it is bit-equal to
    its plain version, which the card tests hold it to), and a ``quantize``
    key is dropped like any key the block does not know."""
    import dataclasses

    from deepspeed_tpu.config import KernelsConfig as JKernels

    assert ({f.name for f in dataclasses.fields(tk.KernelsConfig)}
            == {f.name for f in dataclasses.fields(JKernels)})
    for dev, want in (("cpu", {"paged_attention": "xla",
                               "fused_sampling": "off"}),
                      ("cuda", {"paged_attention": "pallas_v2",
                                "fused_sampling": "on"})):
        pol = tk.resolve_serving_kernels({"quantize": "off"}, device=dev)
        assert pol.as_dict() == want
        assert not hasattr(pol, "quantize")
