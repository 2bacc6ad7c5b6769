"""Group-wise int quantization and fp8 casts (port of the torch-only parts
of ``deepspeed_tpu/ops/quant.py``; ref: deepspeed/ops/quantizer).

Symmetric and asymmetric quantization at 8, 4, 2 or 1 bits with one scale
per contiguous group, the blockwise wire codec (``[R/8, C/512]`` scale grid
or flat ``BLOCK_ELEMS`` blocks) and scaled fp8 casts.  Symmetric int8 on a
CUDA tensor runs the hand-written kernel B9 (:mod:`~deepspeed_tpu_torch.
ops.quant_cuda`) at every shape; the other bit widths and the asymmetric
codec are plain PyTorch on both devices, as the JAX package has no kernel
for them either; they divide by tensors, never by a Python scalar, which
PyTorch's CUDA division would turn into a multiply by its reciprocal (one
ulp off the IEEE quotient on some groups).  ``quantize_blockwise_pallas``
has no separate counterpart: :func:`quantize_blockwise` of a flat buffer
is its route, B9 at every block count.  The ZeRO++ collectives
(:func:`quantized_all_gather`, :func:`quantized_reduce_scatter`) put those
int8 codes and f32 scales on the wire between ranks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.quant_cuda import quantize_rows

INT_BOUNDS = {8: 127.0, 4: 7.0, 2: 1.0, 1: 1.0}


def _group(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    n = x.numel()
    if n % num_groups:
        raise ValueError(f"size {n} not divisible into {num_groups} groups")
    return x.reshape(num_groups, n // num_groups)


def quantize(x: torch.Tensor, bits: int = 8, num_groups: int = 1,
             symmetric: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Group-wise quantize -> (q int8, scale f32 [num_groups], zero-point
    f32 [num_groups] or None).

    With ``bound = INT_BOUNDS[bits]``: symmetric q = round(x / scale),
    scale = amax / bound; asymmetric q = round((x - min) / scale) - bound,
    scale = (max - min) / (2 bound).  Rounding is half to even.  Symmetric
    int8 is B9 (:func:`~deepspeed_tpu_torch.ops.quant_cuda.quantize_rows`:
    the kernel on a CUDA tensor, its plain version on the CPU)."""
    shape = x.shape
    bound = INT_BOUNDS[bits]
    if symmetric and bits == 8:
        q, scale = quantize_rows(_group(x, num_groups))
        return q.reshape(shape), scale, None
    g = _group(x.float(), num_groups)
    if symmetric:
        amax = g.abs().amax(1, keepdim=True)
        scale = amax / torch.full_like(amax, bound)
        scale = torch.where(scale == 0, 1.0, scale)
        q = torch.round(g / scale).clamp(-bound, bound).to(torch.int8)
        return q.reshape(shape), scale[:, 0], None
    lo = g.amin(1, keepdim=True)
    hi = g.amax(1, keepdim=True)
    span = hi - lo
    scale = span / torch.full_like(span, 2.0 * bound)
    scale = torch.where(scale == 0, 1.0, scale)
    q = (torch.round((g - lo) / scale) - bound).clamp(-bound, bound)
    return q.to(torch.int8).reshape(shape), scale[:, 0], lo[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero: Optional[torch.Tensor] = None, bits: int = 8,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`.  ``scale`` may be flat or ND (the
    inference per-row layout ``q.shape[:-1] + (groups,)``): groups are
    raveled-contiguous either way."""
    shape = q.shape
    scale = scale.reshape(-1)
    g = _group(q.float(), scale.shape[0])
    if zero is None:
        out = g * scale[:, None]
    else:
        out = (g + INT_BOUNDS[bits]) * scale[:, None] \
            + zero.reshape(-1)[:, None]
    return out.reshape(shape).to(dtype)


# ------------------------------------------------------- blockwise codec v2
# Wire-codec block: 8 rows x 512 columns = 4096 elements per scale (the
# JAX package's TPU tile grid; kept so payloads are interchangeable).
BLOCK_ROWS = 8
BLOCK_COLS = 512
BLOCK_ELEMS = BLOCK_ROWS * BLOCK_COLS


def _blocks_2d(x: torch.Tensor) -> bool:
    return (x.dim() == 2 and x.shape[0] % BLOCK_ROWS == 0
            and x.shape[1] % BLOCK_COLS == 0)


def quantize_blockwise(x: torch.Tensor, bits: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int quantize (the v2 wire codec).  A 2-D input
    whose shape divides the ``(BLOCK_ROWS, BLOCK_COLS)`` tile gets true 2-D
    blocks with a ``[R/8, C/512]`` scale grid; any other input is a flat
    buffer of ``BLOCK_ELEMS`` blocks (pad with :func:`block_pad`).  Error
    per element at most ``amax_b / (2 (2^(b-1) - 1))`` of its block."""
    if _blocks_2d(x):
        R, C = x.shape
        nbr, nbc = R // BLOCK_ROWS, C // BLOCK_COLS
        t = x.float().reshape(nbr, BLOCK_ROWS, nbc, BLOCK_COLS) \
            .permute(0, 2, 1, 3)
        q, s, _ = quantize(t, bits=bits, num_groups=nbr * nbc)
        q = q.permute(0, 2, 1, 3).reshape(R, C)
        return q, s.reshape(nbr, nbc)
    if x.numel() % BLOCK_ELEMS:
        raise ValueError(
            f"quantize_blockwise: size {x.numel()} is not a multiple of "
            f"the {BLOCK_ELEMS}-element block (pad with block_pad)")
    q, s, _ = quantize(x, bits=bits, num_groups=x.numel() // BLOCK_ELEMS)
    return q, s


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         bits: int = 8, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (either scale layout)."""
    if _blocks_2d(q) and scale.dim() == 2 and tuple(scale.shape) == (
            q.shape[0] // BLOCK_ROWS, q.shape[1] // BLOCK_COLS):
        R, C = q.shape
        nbr, nbc = scale.shape
        t = q.float().reshape(nbr, BLOCK_ROWS, nbc, BLOCK_COLS) \
            .permute(0, 2, 1, 3)
        out = t * scale.reshape(nbr, nbc, 1, 1)
        return out.permute(0, 2, 1, 3).reshape(R, C).to(dtype)
    return dequantize(q, scale, bits=bits, dtype=dtype)


def block_pad(flat: torch.Tensor, unit: int = BLOCK_ELEMS) -> torch.Tensor:
    """Zero-pad a 1-D buffer up to a multiple of ``unit`` (a zero tail
    block quantizes to scale 1.0, error 0)."""
    n = flat.shape[0]
    pn = -(-n // unit) * unit
    if pn == n:
        return flat
    return torch.cat([flat, flat.new_zeros(pn - n)])


# ------------------------------------------------- quantized collectives
def quantized_all_gather(x: torch.Tensor, axis_name: str = "data",
                         bits: int = 8, num_groups: int = 1,
                         group=None) -> torch.Tensor:
    """ZeRO++ qwZ: all-gather int8 codes and f32 scales instead of x.
    Returns every rank's dequantized x stacked on a leading dim of the
    group's size, in rank order (``group``: a sub-group, the counterpart of
    JAX's ``axis_index_groups``)."""
    q, s, _ = quantize(x, bits=bits, num_groups=num_groups)
    qg = comm.all_gather(q, axis_name, tiled=False, group=group)
    sg = comm.all_gather(s, axis_name, tiled=False, group=group)
    return dequantize(qg, sg, bits=bits)


def quantized_reduce_scatter(x: torch.Tensor, axis_name: str = "data",
                             bits: int = 8, groups_per_shard: int = 1,
                             group=None,
                             group_size: Optional[int] = None
                             ) -> torch.Tensor:
    """ZeRO++ qgZ gradient reduce-scatter: x ``[world * shard, ...]`` is
    cut into one slice a peer, each slice quantized in ``groups_per_shard``
    groups (one quantize call for all of them: the groups are contiguous),
    codes and scales exchanged by one all-to-all each, and this rank's
    slices from every peer dequantized and averaged -> ``[shard, ...]``.
    With ``group`` the exchange stays in that sub-group of ``group_size``
    ranks."""
    _, n = comm._resolve(axis_name, group)
    world = group_size if group_size is not None else n
    shard = x.shape[0] // world
    flat = x.reshape(world, -1)
    q, s, _ = quantize(flat, bits=bits, num_groups=world * groups_per_shard)
    q = comm.all_to_all(q, axis_name, group=group)
    s = comm.all_to_all(s.reshape(world, groups_per_shard), axis_name,
                        group=group)
    deq = dequantize(q, s, bits=bits)
    return deq.mean(0).reshape((shard,) + tuple(x.shape[1:]))


# ------------------------------------------------------------------- fp8
def to_fp8(x: torch.Tensor, kind: str = "e4m3"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled fp8 cast: returns (fp8 tensor, per-tensor f32 scale)."""
    dt = torch.float8_e4m3fn if kind == "e4m3" else torch.float8_e5m2
    fmax = 448.0 if kind == "e4m3" else 57344.0
    amax = x.float().abs().amax()
    scale = torch.where(amax == 0, 1.0, amax / torch.full_like(amax, fmax))
    return (x.float() / scale).to(dt), scale


def from_fp8(x: torch.Tensor, scale: torch.Tensor,
             dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`to_fp8`, in the dtype JAX promotes ``dtype`` and
    the f32 scale to (a 0-d tensor does not promote in PyTorch)."""
    out = torch.promote_types(dtype, scale.dtype)
    return x.float().to(dtype).to(out) * scale
