"""Greedy argmax on Hopper: the wrapper of ``csrc/greedy_argmax.cu``, its
plain PyTorch version, and the serving sampler built on it.

Replaces ``deepspeed_tpu/ops/sampling_pallas.py::_greedy_kernel`` (with
``fused_greedy_rows`` / ``fused_sample_rows``).  The work is one read of
[B, V] logits, bound by bytes on the H100 (B·V·4 / 3.35 TB/s in f32); the
kernel reads each row in place (no (8, 128) padding, any row stride, f32,
bf16 or fp16 widened exactly to f32), splits it over S blocks of one
thread-block cluster (:func:`greedy_split_plan`) so that a small batch
fills the card, and reduces (value, index) pairs so that ties go to the
smaller index: bit-exact with ``torch.argmax`` and ``jnp.argmax``.
Temperature rows draw from an explicit ``torch.Generator`` (JAX's threefry
streams have no PyTorch twin, so only greedy rows are held to identity).
"""

from __future__ import annotations

import functools
import numpy as np
import torch

from deepspeed_tpu_torch.ops import _build


def greedy_rows_reference(logits: torch.Tensor) -> torch.Tensor:
    """Plain version: the row max, then the smallest index attaining it.
    NaN counts as the max, as in ``torch.argmax`` and ``jnp.argmax`` (amax
    propagates it), so a row holding NaN gives its first NaN.
    [B, V] -> [B] int32."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    hit = (x == m) | (x.isnan() & m.isnan())
    iota = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.where(hit, iota, x.shape[-1]).amin(-1).to(torch.int32)


# the kernel's storage types (its `dtype` argument)
GREEDY_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the largest thread-block cluster Hopper launches (above 8, non-portable)
MAX_SPANS = 16


def greedy_split_plan(B: int, V: int, sms: int = 132, width: int = 4,
                      head: int = 0):
    """How the kernel splits each of B rows of V elements: S spans a row
    and their S + 1 edges.  S is as many as fill ``sms`` SMs with two
    blocks each (S = 1 once B rows alone do), at most 8, and at
    most :data:`MAX_SPANS` while B·16 blocks take no more than half the SMs:
    clusters above 8 are non-portable, and the H100 read 8 rows of 16 spans
    slower than 8 rows of 8 (PERF.md §6, ``tools/torch_greedy_bench.py
    --spans``).  The row's first ``head`` elements (up to its first 16-byte
    boundary) go to rank 0, its last partial vector of ``width`` elements to
    rank S - 1, and the whole vectors between are split evenly (the first
    ``nvec % S`` ranks take one more); ranks hold ascending indices, and a
    span may be empty.  Returns (S, edges)."""
    cap = MAX_SPANS if 2 * MAX_SPANS * B <= sms else 8
    S = max(1, min(cap, 2 * sms // B))
    head = min(head, V)
    q, rem = divmod((V - head) // width, S)
    edges = [0] + [head + (r * q + min(r, rem)) * width
                   for r in range(1, S)] + [V]
    return S, edges


def greedy_rows_split_reference(logits: torch.Tensor, sms: int = 132,
                                head: int = 0) -> torch.Tensor:
    """Plain twin of the kernel's split: each span's (max, first index) by
    :func:`greedy_rows_reference`, an empty span the pair (-inf, V), merged
    in rank order with the kernel's rule (the larger value, NaN above all,
    then the smaller index).  [B, V] -> [B] int32."""
    x = logits.float()
    B, V = x.shape
    S, edges = greedy_split_plan(B, V, sms, 16 // logits.element_size(),
                                 head)
    rows = torch.arange(B, device=x.device)
    best_v = torch.full((B,), float("-inf"), device=x.device)
    best_i = torch.full((B,), V, device=x.device)
    for lo, hi in zip(edges[:-1], edges[1:]):
        if hi == lo:
            continue
        i = greedy_rows_reference(x[:, lo:hi]).long() + lo
        v = x[rows, i]
        win = ((v > best_v) | ((v == best_v) & (i < best_i))
               | (v.isnan() & (~best_v.isnan() | (i < best_i))))
        best_v = torch.where(win, v, best_v)
        best_i = torch.where(win, i, best_i)
    return best_i.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_greedy_rows(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] float logits -> [B] int32 first-occurrence argmax.  CPU
    tensors take :func:`greedy_rows_reference`; CUDA tensors (f32, bf16 or
    fp16, each row contiguous, rows any stride apart) launch the kernel,
    each row split over the blocks of :func:`greedy_split_plan`, or raise."""
    if logits.device.type == "cpu":
        return greedy_rows_reference(logits)
    if not logits.is_cuda:
        raise ValueError(
            f"fused_greedy_rows: unsupported device {logits.device}")
    if logits.dim() != 2 or logits.dtype not in GREEDY_DTYPES:
        raise ValueError(f"fused_greedy_rows: want [B, V] float32, bfloat16 "
                         f"or float16, got {tuple(logits.shape)} "
                         f"{logits.dtype}")
    B, V = logits.shape
    if V > 1 and logits.stride(1) != 1:
        raise ValueError("fused_greedy_rows: rows are not contiguous")
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    if B == 0:
        return out
    S, _ = greedy_split_plan(B, V, _sms(logits.device.index))
    err = _build.lib().dstt_greedy_argmax(
        logits.data_ptr(), out.data_ptr(), B, V, logits.stride(0),
        GREEDY_DTYPES[logits.dtype], S, _build.stream_of(logits))
    _build.check("dstt_greedy_argmax", err)
    fused_greedy_rows.launches += 1
    fused_greedy_rows.body_launches["cluster" if S > 1 else "row"] += 1
    return out


fused_greedy_rows.launches = 0
fused_greedy_rows.body_launches = {"cluster": 0, "row": 0}


def with_temperature(logits: torch.Tensor, greedy: torch.Tensor, temps,
                     generator=None) -> torch.Tensor:
    """Replace the greedy token of every row whose temperature (host
    ``temps`` [B]) is > 0 by a categorical draw at that temperature.  An
    all-greedy batch returns ``greedy`` untouched and draws nothing."""
    temps = np.asarray(temps, np.float32)
    if not (temps > 0.0).any():
        return greedy
    t = torch.from_numpy(temps).to(logits.device)
    probs = torch.softmax(logits.float() / t.clamp(min=1e-6)[:, None], -1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(t == 0.0, greedy, sampled.to(torch.int32))


def fused_sample_rows(logits: torch.Tensor, temps,
                      generator=None) -> torch.Tensor:
    """Drop-in twin of the serving sampler with the greedy path through
    the kernel: [B, V] logits + host temps [B] -> [B] int32 tokens."""
    return with_temperature(logits, fused_greedy_rows(logits), temps,
                            generator)
