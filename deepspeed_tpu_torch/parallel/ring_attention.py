"""Ring attention over the ``seq`` axis (port of ``deepspeed_tpu/parallel/
ring_attention.py``; ref: DeepSpeed's long-sequence path and the ring
attention literature).

Each rank holds a sequence shard.  K/V blocks travel the ring while each
rank accumulates its queries' attention with the online (m, l, o) softmax
in f32, JAX's plain einsums step for step (the JAX package calls no Pallas
kernel here, so neither does the port).  Causality comes from ring
positions: after ``s`` hops rank ``i`` holds block ``i - s``.  The K and V
blocks ride one :func:`~deepspeed_tpu_torch.comm.ppermute` a hop (stacked,
so both ranks of a pair exchange them in one call), whose backward is the
inverse permutation: autograd gives the reverse ring.  Packed
``segment_ids`` ride with their block.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch import comm

SEQ_AXIS = "seq"


def _repeat_kv(k, v, n_heads):
    kv = k.shape[2]
    if kv != n_heads:
        rep = n_heads // kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def ring_attention(q, k, v, axis_name: str = SEQ_AXIS, causal: bool = True,
                   scale: Optional[float] = None, segment_ids=None):
    """Blockwise ring attention over this rank's shards.

    q: [B, Tq, H, Dh], k/v: [B, Tk, KV, Dh]; ``segment_ids``: this rank's
    [B, Tq] int ids.  Returns [B, Tq, H, Dh] in q's dtype."""
    g, n = comm._resolve(axis_name)
    idx = comm.rank_in(axis_name)
    B, Tq, H, Dh = q.shape
    k, v = _repeat_kv(k, v, H)
    Tk = k.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    dev = q.device

    qf = q.float() * scale
    o = torch.zeros((B, Tq, H, Dh), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    q_pos = idx * Tq + torch.arange(Tq, device=dev)
    seg0 = None if segment_ids is None else segment_ids.to(torch.int32)
    kv_cur = torch.stack([k, v])
    seg_cur = seg0
    for s in range(n):
        src = (idx - s) % n
        k_cur, v_cur = kv_cur[0], kv_cur[1]
        scores = torch.einsum("bthd,bshd->bhts", qf, k_cur.float())
        mask = None
        if causal:
            k_pos = src * Tk + torch.arange(Tk, device=dev)
            mask = (q_pos[:, None] >= k_pos[None, :])[None]   # [1, Tq, Tk]
        if seg_cur is not None:
            same = seg0[:, :, None] == seg_cur[:, None, :]    # [B, Tq, Tk]
            mask = same if mask is None else mask & same
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None], float("-inf"))
        m_new = torch.maximum(m, scores.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(scores - m_safe[..., None])
        if mask is not None:
            p = p.masked_fill(~mask[:, None], 0.0)
        alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                      torch.full_like(m, float("-inf"))))
        l = l * alpha + p.sum(-1)
        o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhts,bshd->bthd", p, v_cur.float())
        m = m_new
        if s + 1 < n:               # the last block travels no further
            kv_cur = comm.ppermute(kv_cur, axis_name, perm)
            if seg_cur is not None:
                seg_cur = comm.ppermute(seg_cur, axis_name, perm)
    l = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / l).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh=None, causal: bool = True,
                           axis_name: str = SEQ_AXIS, segment_ids=None):
    """The model-facing entry: the flash kernels when the axis has one
    rank (as the JAX entry calls ``flash_attention`` there),
    :func:`ring_attention` otherwise."""
    from deepspeed_tpu_torch.topology import current_mesh

    ms = mesh if mesh is not None else current_mesh()
    if ms is None or ms.size(axis_name) <= 1:
        from deepspeed_tpu_torch.ops.attention import flash_attention

        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    return ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                          segment_ids=segment_ids)
