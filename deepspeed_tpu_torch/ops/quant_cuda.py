"""Symmetric int8 group quantization on Hopper: the wrapper of
``csrc/quant.cu`` and its plain PyTorch version.

Replaces ``deepspeed_tpu/ops/quant.py::_quant_kernel`` (with
``quantize_pallas`` and ``quantize_blockwise_pallas``).  Each row of x
``[G, gsz]`` gets scale = amax / 127 (1.0 where that is 0) and codes
clamp(round_half_even(x / scale), ±127).  It runs where the port quantizes:
every matrix leaf of an int8 engine at build, and the K/V rows an
int8-resident cache writes at every forward (through the fused write of
``inference/kernels.py::write_kv_quant``, the kernel's second entry).  The
work is bound by bytes (read x once, write one byte per element and 4 per
row).  There is no shape gate: the TPU kernel's ``num_groups % 8`` / ``gsz
% 128`` tiling has no counterpart here, so every shape launches the kernel
on CUDA, through the body :func:`quant_body` names.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops import _build


def quantize_rows_reference(x):
    """Plain version of the kernel: x [G, gsz] f32/bf16 -> (codes int8
    [G, gsz], scales f32 [G]).  The operations of ``ops/quant.py::
    quantize`` (bits 8, symmetric) in their order; a NaN quotient (a NaN,
    or inf / inf in a row whose max is inf) gives code 0, the value a
    float-to-int conversion of NaN has on the card and in XLA."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off the IEEE quotient the host
    # codec and the JAX package compute
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.round(xf / scale[:, None]).clamp(-127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


# the vector body's chunk: 8 elements a thread, one 16-byte load (bf16)
VEC_ELEMS = 8


def quant_body(x) -> str:
    """The body of B9 that a CUDA call on the contiguous rows x [G, gsz]
    launches: ``"vec"`` (8 elements a thread in 16-byte loads) for groups
    whose size is a multiple of 8 with x on a 16-byte boundary, ``"scalar"``
    (a warp a group, an element a lane) otherwise."""
    return ("vec" if x.shape[-1] % VEC_ELEMS == 0 and x.data_ptr() % 16 == 0
            else "scalar")


def quantize_rows(x):
    """B9: int8 codes and f32 scales of each row of x [G, gsz] (float32 or
    bfloat16; made contiguous).  CPU tensors take
    :func:`quantize_rows_reference`; CUDA tensors launch the body that
    :func:`quant_body` names, or raise.  ``launches`` counts the launches of
    B9's kernel (this entry's and the fused K/V write's), ``body_launches``
    each body's."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows: want x [G, gsz], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_rows_reference(x)
    if not x.is_cuda:
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    if x.dtype not in _build.F32_BF16:
        raise ValueError(f"quantize_rows: dtype {x.dtype} not in "
                         "float32/bfloat16")
    x = x.contiguous()
    G, gsz = x.shape
    q = torch.empty((G, gsz), dtype=torch.int8, device=x.device)
    scale = torch.empty((G,), dtype=torch.float32, device=x.device)
    if x.numel():
        body = quant_body(x)
        err = _build.lib().dstt_quantize_int8(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), G, gsz,
            _build.DTYPE_CODES[x.dtype], int(body == "vec"),
            _build.stream_of(x))
        _build.check("dstt_quantize_int8", err)
        quantize_rows.launches += 1
        quantize_rows.body_launches[body] += 1
    return q, scale


quantize_rows.launches = 0
quantize_rows.body_launches = {"vec": 0, "scalar": 0}
