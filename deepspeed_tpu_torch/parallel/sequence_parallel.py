"""DeepSpeed-Ulysses sequence parallelism over the ``seq`` axis (port of
``deepspeed_tpu/parallel/sequence_parallel.py``; ref:
deepspeed/sequence/layer.py DistributedAttention).

Each rank of the axis holds ``T / sp`` positions of every sequence.
Before attention one all-to-all swaps the split from the sequence dim to
the head dim (each rank gets the whole sequence for ``H / sp`` heads),
the flash kernels (B1 forward, B2/B3 backward) run there unchanged, and a
second all-to-all swaps back.  Both all-to-alls go through autograd as the
inverse all-to-all (JAX's transpose), so the backward needs no schedule of
its own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deepspeed_tpu_torch import comm

SEQ_AXIS = "seq"


def _default_attn(q, k, v, causal, segment_ids=None):
    from deepspeed_tpu_torch.ops.attention import flash_attention

    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)


def _axis_size(axis_name: str) -> int:
    return comm._resolve(axis_name)[1]


def ulysses_attention(q, k, v, axis_name: str = SEQ_AXIS,
                      causal: bool = True,
                      attn_fn: Optional[Callable] = None,
                      segment_ids=None):
    """Head/sequence all-to-all attention over this rank's shards.

    q: [B, T_local, H, Dh]; k/v: [B, T_local, KV, Dh].  The head count
    must divide over the axis; KV heads are repeated up to H when KV does
    not (a GQA group smaller than the axis).  ``segment_ids``: this rank's
    [B, T_local] int ids of a packed layout, all-gathered (every rank
    holds the whole sequence after the swap)."""
    attn_fn = attn_fn or _default_attn
    sp = _axis_size(axis_name)
    H, KV = q.shape[2], k.shape[2]
    if H % sp:
        raise ValueError(f"n_heads {H} not divisible by seq parallelism "
                         f"{sp}")
    if KV % sp:
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    def swap(x):  # [B, T/sp, H, Dh] -> [B, T, H/sp, Dh]
        return comm.all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    qh, kh, vh = swap(q), swap(k), swap(v)
    seg_full = None
    if segment_ids is not None:
        seg_full = comm.all_gather(segment_ids.to(torch.int32).contiguous(),
                                   axis_name, axis=1)
    out = (attn_fn(qh, kh, vh, causal) if seg_full is None
           else attn_fn(qh, kh, vh, causal, segment_ids=seg_full))
    return comm.all_to_all(out, axis_name, split_axis=1, concat_axis=2)


def ulysses_attention_sharded(q, k, v, mesh=None, causal: bool = True,
                              axis_name: str = SEQ_AXIS,
                              attn_fn: Optional[Callable] = None,
                              segment_ids=None):
    """The model-facing entry: plain attention when the axis has one rank,
    :func:`ulysses_attention` otherwise (the inputs are already this
    rank's sequence shards; JAX's ``shard_map`` makes them so)."""
    from deepspeed_tpu_torch.topology import current_mesh

    ms = mesh if mesh is not None else current_mesh()
    if ms is None or ms.size(axis_name) <= 1:
        fn = attn_fn or _default_attn
        return (fn(q, k, v, causal) if segment_ids is None
                else fn(q, k, v, causal, segment_ids=segment_ids))
    return ulysses_attention(q, k, v, axis_name=axis_name, causal=causal,
                             attn_fn=attn_fn, segment_ids=segment_ids)
