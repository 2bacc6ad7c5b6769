"""Paged attention on Hopper: the wrappers of the three paged kernels,
their plain PyTorch versions, and the CPU twin of B5's and B7's Hopper body.

- ``csrc/paged_attention.cu`` (B5) replaces
  ``deepspeed_tpu/inference/kernels.py::_chunk_v2_kernel`` (with
  ``paged_chunk_attention_v2`` and ``paged_decode_attention_v2``, decode
  being its C = 1 case at ``start = seq_lens - 1``): dense pages.
- ``csrc/paged_attention_quant.cu`` (B7) replaces
  ``_chunk_v2_quant_kernel`` (``paged_chunk_attention_v2_quant``): int8
  codes with one f32 scale per token row, dequantised on chip.
- B8 replaces the v1 ``_chunk_kernel`` (``paged_chunk_attention``, the
  ``pallas_v1`` arm), which computes v2's function over dense pages: for a
  bf16 q with head dim 64 or 128 it launches B5's Hopper body through
  ``csrc/paged_attention.cu``; otherwise ``csrc/paged_attention_split.cu``,
  the key axis split over blocks and a second kernel combining the
  partials.

B5, B7 and B8 have two bodies, named by :func:`paged_body` from q's dtype
and head dim.  The Hopper body (``csrc/paged_attention_sm90.cuh``; bf16 q,
or for B5 an fp16 q over bf16 pages, head dim 64 or 128) splits decode (at
most :data:`DECODE_ROWS` flattened query rows) over spans of whole pages,
:data:`DECODE_SPAN_KEYS` keys or
more, stages them with ``cp.async`` and merges the spans' partials in the
same launch; chunked prefill runs items of :data:`ITEM_ROWS` flattened rows
over key tiles of :data:`KEY_TILE` on wgmma, P split into bf16 hi + lo (and
an fp16 q split so, once per item, for Q·K^T over bf16 pages).
The scalar block (f32, head dim 16 / 32; B8's split pair) gathers K/V into
f32 shared memory over a grid of (b·kv_head, row tile[, key split]).  Every
body walks only the key positions up to its rows' frontier, so stale or
trash table entries past it are never dereferenced, and keeps the online
softmax in f32.  Decode is bound by bytes on the H100 (live KV bytes / 3.35
TB/s; B7 reads D + 4 bytes per row where B5 reads 2·D at bf16).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops import _build

NEG_INF = -1e30
# B8: key positions per split of the v1 arm's split-key grid
SPLIT_KEYS = 256
# B5 / B7 Hopper body (csrc/paged_attention_sm90.cuh): the head dims it
# takes; decode takes at most DECODE_ROWS flattened rows (C·G), in spans of
# whole pages of at least DECODE_SPAN_KEYS keys (DECODE_MAX_SPANS spans at
# most), each walked in tiles of DECODE_TILE keys; chunked prefill takes
# items of ITEM_ROWS flattened rows over key tiles of KEY_TILE
SM90_HEAD_DIMS = (64, 128)
SM90_DTYPES = (torch.bfloat16, torch.float16)
DECODE_ROWS = 16
DECODE_SPAN_KEYS = 128
DECODE_MAX_SPANS = 64
DECODE_TILE = 32
ITEM_ROWS = 128
KEY_TILE = 64


def _gather(pages, table, scales=None):
    """[KV, P, ps, Dh] pages through table [B, mp] -> [B, KV, mp*ps, Dh] in
    f32.  With ``scales`` [KV, P, ps, 1] the pages are int8 codes, read as
    f32(code) * scale."""
    KV, _, ps, Dh = pages.shape
    B, mp = table.shape
    idx = table.long()
    g = pages[:, idx].float()                          # [KV, B, mp, ps, Dh]
    if scales is not None:
        g = g * scales[:, idx]
    return g.permute(1, 0, 2, 3, 4).reshape(B, KV, mp * ps, Dh)


def _chunk_scores(q, kg, start, scale):
    """Masked scores [B, C, KV, G, S] of q [B, C, H, Dh] at positions
    ``start + 0..C-1`` against gathered keys [B, KV, S, Dh]."""
    B, C, H, Dh = q.shape
    KV = kg.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.reshape(B, C, KV, H // KV, Dh).float()
    s = torch.einsum("bckgd,bksd->bckgs", qg, kg) * scale
    kpos = torch.arange(kg.shape[2], device=q.device)[None, None]
    qpos = (start.long()[:, None]
            + torch.arange(C, device=q.device)[None])[:, :, None]
    return s.masked_fill(~(kpos <= qpos)[:, :, None, None], NEG_INF)


def _chunk(q, kg, vg, start, scale):
    p = torch.softmax(_chunk_scores(q, kg, start, scale), dim=-1)
    out = torch.einsum("bckgs,bksd->bckgd", p, vg)
    return out.reshape(q.shape).to(q.dtype)


def _decode(q, kg, vg, seq_lens, scale):
    B, H, Dh = q.shape
    KV = kg.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.reshape(B, KV, H // KV, Dh).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, kg) * scale
    valid = torch.arange(kg.shape[2], device=q.device)[None] \
        < seq_lens.long()[:, None]
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, vg)
    # empty sequences (continuous batching admits them): zero, not mean-of-V
    out = torch.where((seq_lens > 0)[:, None, None, None], out, 0.0)
    return out.reshape(B, H, Dh).to(q.dtype)


# ------------------------------------------------------- plain versions
def paged_chunk_attention_reference(q, k_pages, v_pages, table, start,
                                    scale: Optional[float] = None):
    """Plain chunked-prefill attention (B5's plain version): q [B, C, H,
    Dh] at positions ``start + 0..C-1`` attends causally over the gathered
    pages (which already hold the chunk's own K/V) -> [B, C, H, Dh]."""
    return _chunk(q, _gather(k_pages, table), _gather(v_pages, table), start,
                  scale)


def paged_attention_reference(q, k_pages, v_pages, table, seq_lens,
                              scale: Optional[float] = None):
    """Plain decode attention: q [B, H, Dh] over each row's first
    ``seq_lens`` positions -> [B, H, Dh]; empty rows give zeros."""
    return _decode(q, _gather(k_pages, table), _gather(v_pages, table),
                   seq_lens, scale)


def paged_chunk_attention_quant_reference(q, kq_pages, ks_pages, vq_pages,
                                          vs_pages, table, start,
                                          scale: Optional[float] = None):
    """B7's plain version: :func:`paged_chunk_attention_reference` over
    pages dequantised in f32 (``f32(code) * scale``), as the kernel
    dequantises on chip.  ``kq/vq_pages`` int8 [KV, P, ps, Dh];
    ``ks/vs_pages`` f32 [KV, P, ps, 1]."""
    return _chunk(q, _gather(kq_pages, table, ks_pages),
                  _gather(vq_pages, table, vs_pages), start, scale)


def paged_attention_quant_reference(q, kq_pages, ks_pages, vq_pages,
                                    vs_pages, table, seq_lens,
                                    scale: Optional[float] = None):
    """Decode form of :func:`paged_chunk_attention_quant_reference`:
    q [B, H, Dh] over each row's first ``seq_lens`` positions; empty rows
    give zeros."""
    return _decode(q, _gather(kq_pages, table, ks_pages),
                   _gather(vq_pages, table, vs_pages), seq_lens, scale)


def paged_chunk_attention_split_reference(q, k_pages, v_pages, table, start,
                                          scale: Optional[float] = None,
                                          split_keys: int = SPLIT_KEYS):
    """B8's plain version, the kernel's arithmetic in PyTorch: per split of
    ``split_keys`` key positions an unnormalised partial (m, l, acc) over
    the causally visible keys, then m* = max m_i, l = Σ l_i·e^(m_i − m*),
    o = Σ acc_i·e^(m_i − m*) / l, and l = 0 (an empty row, start −1) gives
    zeros.  Same contract as :func:`paged_chunk_attention_reference`."""
    B, C, H, Dh = q.shape
    kg, vg = _gather(k_pages, table), _gather(v_pages, table)
    s = _chunk_scores(q, kg, start, scale)                  # [B,C,KV,G,S]
    S = s.shape[-1]
    n = -(-S // split_keys)
    pad = n * split_keys - S
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    vg = torch.nn.functional.pad(vg, (0, 0, 0, pad))
    s = s.reshape(*s.shape[:-1], n, split_keys)             # [..., n, sk]
    m = s.amax(-1)                                          # [B,C,KV,G,n]
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bckgns,bknsd->bckgnd", p,
                       vg.reshape(B, vg.shape[1], n, split_keys, Dh))
    w = torch.exp(m - m.amax(-1, keepdim=True))
    l = (l * w).sum(-1)
    acc = (acc * w[..., None]).sum(-2)
    out = torch.where(l[..., None] == 0, 0.0,
                      acc / torch.where(l == 0, 1.0, l)[..., None])
    return out.reshape(B, C, H, Dh).to(q.dtype)


def decode_span_pages(ps: int, mp: int) -> int:
    """Pages per decode span of the Hopper body for pages of ``ps`` keys and
    tables of ``mp`` slots: the fewest whole pages that hold
    :data:`DECODE_SPAN_KEYS` keys, or more where a row would otherwise
    split into more than :data:`DECODE_MAX_SPANS` spans."""
    return max(1, -(-DECODE_SPAN_KEYS // ps), -(-mp // DECODE_MAX_SPANS))


def _tiled_decode(qf, kg, vg, ks, vs, st, C, G, mp, ps, scale, span_pages):
    """One row b of the Hopper decode body: qf [KV, C·G, Dh] f32; kg / vg
    [KV, S, Dh] f32 (codes for B7), ks / vs [KV, S] (ones for B5)."""
    KV, CG, Dh = qf.shape
    dev = qf.device
    live = min(st + C, mp * ps)
    sk = span_pages * ps
    qpos = st + torch.arange(CG, device=dev) // G
    parts = []
    for lo in range(0, live, sk):            # the spans that hold keys
        hi = min(live, lo + sk)
        m = torch.full((KV, CG), NEG_INF, device=dev)
        l = torch.zeros((KV, CG), device=dev)
        acc = torch.zeros((KV, CG, Dh), device=dev)
        for n0 in range(lo, hi, DECODE_TILE):
            n1 = min(n0 + DECODE_TILE, hi)
            valid = torch.arange(n0, n1, device=dev)[None] <= qpos[:, None]
            sc = torch.einsum("krd,knd->krn", qf, kg[:, n0:n1]) \
                * ks[:, None, n0:n1] * scale
            sc = torch.where(valid, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            v = vg[:, n0:n1] * vs[:, n0:n1, None]
            acc = acc * alpha[..., None] + torch.einsum("krn,knd->krd", p, v)
            m = m_new
        parts.append((m, l, acc))
    if not parts:                            # an empty row: zeros
        return torch.zeros((KV, CG, Dh), device=dev)
    m = torch.stack([x[0] for x in parts])   # merged in span order
    w = torch.exp(m - m.amax(0))
    l = (torch.stack([x[1] for x in parts]) * w).sum(0)
    acc = (torch.stack([x[2] for x in parts]) * w[..., None]).sum(0)
    return torch.where(l[..., None] == 0, 0.0,
                       acc / torch.where(l == 0, 1.0, l)[..., None])


def _tiled_chunk(qf, kg, vg, ks, vs, st, G, mp, ps, scale, split_p, item_rows,
                 key_tile):
    """One row b of the Hopper chunk body (operands as
    :func:`_tiled_decode`): items of ``item_rows`` flattened rows, each over
    key tiles up to its last row's frontier; S = (q·k)·ks, P' = P·vs, and
    with ``split_p`` P' as bf16 hi + lo in the P'·V product."""
    KV, CG, Dh = qf.shape
    dev = qf.device
    out = torch.zeros((KV, CG, Dh), device=dev)
    for r0 in range(0, CG, item_rows):
        r1 = min(r0 + item_rows, CG)
        k_hi = min(st + (r1 - 1) // G + 1, mp * ps)
        qpos = st + torch.arange(r0, r1, device=dev) // G
        m = torch.full((KV, r1 - r0), float("-inf"), device=dev)
        l = torch.zeros((KV, r1 - r0), device=dev)
        acc = torch.zeros((KV, r1 - r0, Dh), device=dev)
        for n0 in range(0, max(k_hi, 0), key_tile):
            n1 = min(n0 + key_tile, k_hi)
            valid = torch.arange(n0, n1, device=dev)[None] <= qpos[:, None]
            sc = torch.einsum("krd,knd->krn", qf[:, r0:r1], kg[:, n0:n1]) \
                * ks[:, None, n0:n1] * scale
            sc = torch.where(valid, sc, float("-inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            ms = torch.where(m_new == float("-inf"), 0.0, m_new)
            p = torch.exp(sc - ms[..., None])
            alpha = torch.exp(m - ms)
            l = l * alpha + p.sum(-1)
            p = p * vs[:, None, n0:n1]
            v = vg[:, n0:n1]
            if split_p:
                hi = p.to(torch.bfloat16).float()
                pv = torch.einsum("krn,knd->krd", hi, v) + torch.einsum(
                    "krn,knd->krd", (p - hi).to(torch.bfloat16).float(), v)
            else:
                pv = torch.einsum("krn,knd->krd", p, v)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, r0:r1] = torch.where(
            l[..., None] == 0, 0.0, acc / torch.where(l == 0, 1.0, l)[..., None])
    return out


def paged_chunk_attention_tiled_reference(
        q, k_pages, v_pages, table, start, k_scales=None, v_scales=None,
        scale: Optional[float] = None, span_pages: Optional[int] = None,
        item_rows: int = ITEM_ROWS, key_tile: int = KEY_TILE):
    """The CPU twin of B5's and B7's Hopper body: the contract of
    :func:`paged_chunk_attention_reference` (with ``k_scales`` /
    ``v_scales`` [KV, P, ps, 1], that of
    :func:`paged_chunk_attention_quant_reference` over int8 codes) computed
    in the body's order, in f32.  At most :data:`DECODE_ROWS` flattened rows
    (C·G): per span of ``span_pages`` pages (default
    :func:`decode_span_pages`) an online softmax over tiles of
    :data:`DECODE_TILE` keys, K and V dequantised in f32, then the spans'
    partials merged in order.  More rows: items of ``item_rows`` rows over
    key tiles of ``key_tile`` up to each item's frontier, the scales on S's
    columns and folded into P, and for a bf16 or fp16 q P split into bf16
    hi + lo for the P·V product, as the tensor cores take it (an fp16 q's
    own split into bf16 hi + lo is exact: its f32 value here)."""
    B, C, H, Dh = q.shape
    KV, _, ps, _ = k_pages.shape
    mp = table.shape[1]
    G = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    kg, vg = _gather(k_pages, table), _gather(v_pages, table)
    if k_scales is None:
        ks = vs = torch.ones(kg.shape[:3], device=q.device)
    else:
        ks = _gather(k_scales, table)[..., 0]
        vs = _gather(v_scales, table)[..., 0]
    qf = q.reshape(B, C, KV, G, Dh).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, C * G, Dh).float()
    sp = span_pages or decode_span_pages(ps, mp)
    out = torch.stack([
        _tiled_decode(qf[b], kg[b], vg[b], ks[b], vs[b], int(start[b]), C, G,
                      mp, ps, scale, sp)
        if C * G <= DECODE_ROWS else
        _tiled_chunk(qf[b], kg[b], vg[b], ks[b], vs[b], int(start[b]), G, mp,
                     ps, scale, q.dtype in SM90_DTYPES, item_rows,
                     key_tile)
        for b in range(B)])
    return out.reshape(B, KV, C, G, Dh).permute(0, 2, 1, 3, 4) \
        .reshape(B, C, H, Dh).to(q.dtype)


# ------------------------------------------------------------- wrappers
def _page_dtype(q):
    """The pages B5 takes under ``q``: q's own dtype, and bfloat16 under a
    float16 q (an fp16 model's bf16 cache, as the JAX kernel reads it)."""
    return torch.bfloat16 if q.dtype == torch.float16 else q.dtype


def _check(name, q, pages, table, start, page_dtype, scales=(),
           q_dtypes=tuple(_build.DTYPE_CODES)):
    """Raise on what the paged kernels do not take."""
    B, C, H, Dh = q.shape
    k_pages, v_pages = pages
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != Dh:
        raise ValueError(
            f"{name}: pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do "
            f"not match q {tuple(q.shape)}")
    KV = k_pages.shape[0]
    if H % KV:
        raise ValueError(f"{name}: heads {H} not a multiple of kv heads {KV}")
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {Dh} not in {_build.HEAD_DIMS}")
    if table.dim() != 2 or table.shape[0] != B or table.dtype != torch.int32 \
            or start.shape != (B,) or start.dtype != torch.int32:
        raise ValueError(
            f"{name}: want table [B, mp] and start [B] int32, got "
            f"{tuple(table.shape)} {table.dtype} / {tuple(start.shape)} "
            f"{start.dtype}")
    for s in scales:
        if s.shape != k_pages.shape[:3] + (1,) or s.dtype != torch.float32:
            raise ValueError(
                f"{name}: scales {tuple(s.shape)} {s.dtype}; want "
                f"{tuple(k_pages.shape[:3]) + (1,)} float32")
    for i, t in enumerate((q, k_pages, v_pages, table, start, *scales)):
        if t.device != q.device:
            raise ValueError(f"{name}: input {i} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input {i} is not contiguous")
    if q.dtype not in q_dtypes or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        names = "/".join(str(d).replace("torch.", "") for d in q_dtypes)
        raise ValueError(
            f"{name}: q/pages dtypes {q.dtype}/{k_pages.dtype}/"
            f"{v_pages.dtype}; want q in {names} and pages {page_dtype}")


def _device_ok(name, q) -> bool:
    """True for a CUDA tensor, False for a CPU one (plain version)."""
    if q.device.type == "cpu":
        return False
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def paged_body(q) -> str:
    """The body of B5, B7 and B8 that a CUDA call on ``q`` launches:
    ``"sm90"`` (``csrc/paged_attention_sm90.cuh``) for bfloat16 or float16
    with head_dim 64 or 128, ``"scalar"`` otherwise.  (B7 and B8 take no
    float16 q: they raise on one.)"""
    return ("sm90" if q.dtype in SM90_DTYPES
            and q.shape[-1] in SM90_HEAD_DIMS else "scalar")


# per CUDA stream: decode counters [B·KV] int32 and f32 partials, grown as
# needed (a cache of scratch memory, as PyTorch's allocator is one)
_WORKSPACE = {}


def _sm90_args(q, KV, ps, mp, stream):
    """(counters, part, span_pages) of one launch of the Hopper body on
    ``stream``.  A decode launch over more than one span needs counters
    (zeros; the kernel leaves them zeros) and room for the spans' partials
    (m, l, acc).  Both are kept per stream and serve every launch on it,
    since a stream runs its launches one after another; allocating them per
    call would cost a zeroing launch each time."""
    B, C, H, Dh = q.shape
    sp = decode_span_pages(ps, mp)
    nspan = -(-mp // sp)
    if C * (H // KV) > DECODE_ROWS or nspan == 1:
        return None, None, sp
    n_bk, n_part = B * KV, B * KV * nspan * DECODE_ROWS * (2 + Dh)
    key = (q.device, stream.value)
    counters, part = _WORKSPACE.get(key, (None, None))
    if counters is None or counters.numel() < n_bk:
        counters = torch.zeros((n_bk,), dtype=torch.int32, device=q.device)
    if part is None or part.numel() < n_part:
        part = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    _WORKSPACE[key] = (counters, part)
    return counters.data_ptr(), part.data_ptr(), sp


def paged_chunk_attention(q, k_pages, v_pages, table, start):
    """B5: paged attention for chunk queries q [B, C, H, Dh] at positions
    ``start + 0..C-1`` over one layer's pages [KV, P, ps, Dh] -> [B, C, H,
    Dh] in q's dtype.  Pages are of q's dtype, or bfloat16 under a float16 q
    (:func:`_page_dtype`).  CPU tensors take
    :func:`paged_chunk_attention_reference`; CUDA tensors launch the body
    that :func:`paged_body` names, or raise.  ``launches`` counts every
    launch, ``body_launches`` each body's and ``dtype_launches`` each q
    dtype's."""
    if not _device_ok("paged_chunk_attention", q):
        return paged_chunk_attention_reference(q, k_pages, v_pages, table,
                                               start)
    _check("paged_chunk_attention", q, (k_pages, v_pages), table, start,
           _page_dtype(q))
    body = paged_body(q)
    out = _dense_launch(q, k_pages, v_pages, table, start, body)
    paged_chunk_attention.launches += 1
    paged_chunk_attention.body_launches[body] += 1
    paged_chunk_attention.dtype_launches[q.dtype] += 1
    return out


def _dense_launch(q, k_pages, v_pages, table, start, body):
    """One launch of ``csrc/paged_attention.cu`` over dense pages through
    ``body`` (checked inputs) -> out [B, C, H, Dh]."""
    B, C, H, Dh = q.shape
    KV, P, ps, _ = k_pages.shape
    mp = table.shape[1]
    stream = _build.stream_of(q)
    counters, part, sp = (_sm90_args(q, KV, ps, mp, stream)
                          if body == "sm90" else (None, None, 1))
    out = torch.empty_like(q)
    err = _build.lib().dstt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), start.data_ptr(), out.data_ptr(), B, C, H, KV, Dh,
        P, ps, mp, Dh ** -0.5, _build.DTYPE_CODES[q.dtype],
        int(body == "sm90"), counters, part, sp, stream)
    _build.check("dstt_paged_attention", err)
    return out


paged_chunk_attention.launches = 0
paged_chunk_attention.body_launches = {"sm90": 0, "scalar": 0}
paged_chunk_attention.dtype_launches = dict.fromkeys(_build.DTYPE_CODES, 0)


def paged_decode_attention(q, k_pages, v_pages, table, seq_lens):
    """Decode: q [B, H, Dh] over each row's first ``seq_lens`` positions,
    the C = 1 case of :func:`paged_chunk_attention` at ``start = seq_lens -
    1`` (an empty row's start -1 masks every key: zeros)."""
    if not _device_ok("paged_decode_attention", q):
        return paged_attention_reference(q, k_pages, v_pages, table, seq_lens)
    return paged_chunk_attention(q[:, None], k_pages, v_pages, table,
                                 (seq_lens - 1).to(torch.int32))[:, 0]


def paged_chunk_attention_quant(q, kq_pages, ks_pages, vq_pages, vs_pages,
                                table, start):
    """B7: :func:`paged_chunk_attention` over int8-resident pages (codes
    int8 [KV, P, ps, Dh], per-token-row scales f32 [KV, P, ps, 1]),
    dequantised on chip.  CPU tensors take
    :func:`paged_chunk_attention_quant_reference`; CUDA tensors launch the
    body that :func:`paged_body` names, or raise; counts as
    :func:`paged_chunk_attention`."""
    name = "paged_chunk_attention_quant"
    if not _device_ok(name, q):
        return paged_chunk_attention_quant_reference(
            q, kq_pages, ks_pages, vq_pages, vs_pages, table, start)
    _check(name, q, (kq_pages, vq_pages), table, start, torch.int8,
           scales=(ks_pages, vs_pages), q_dtypes=_build.F32_BF16)
    B, C, H, Dh = q.shape
    KV, P, ps, _ = kq_pages.shape
    mp = table.shape[1]
    body, stream = paged_body(q), _build.stream_of(q)
    counters, part, sp = (_sm90_args(q, KV, ps, mp, stream)
                          if body == "sm90" else (None, None, 1))
    out = torch.empty_like(q)
    err = _build.lib().dstt_paged_attention_quant(
        q.data_ptr(), kq_pages.data_ptr(), ks_pages.data_ptr(),
        vq_pages.data_ptr(), vs_pages.data_ptr(), table.data_ptr(),
        start.data_ptr(), out.data_ptr(), B, C, H, KV, Dh, P, ps, mp,
        Dh ** -0.5, _build.DTYPE_CODES[q.dtype], int(body == "sm90"),
        counters, part, sp, stream)
    _build.check("dstt_paged_attention_quant", err)
    paged_chunk_attention_quant.launches += 1
    paged_chunk_attention_quant.body_launches[body] += 1
    return out


paged_chunk_attention_quant.launches = 0
paged_chunk_attention_quant.body_launches = {"sm90": 0, "scalar": 0}


def paged_decode_attention_quant(q, kq_pages, ks_pages, vq_pages, vs_pages,
                                 table, seq_lens):
    """Decode over int8-resident pages, the C = 1 case of
    :func:`paged_chunk_attention_quant` at ``start = seq_lens - 1``."""
    if not _device_ok("paged_decode_attention_quant", q):
        return paged_attention_quant_reference(
            q, kq_pages, ks_pages, vq_pages, vs_pages, table, seq_lens)
    return paged_chunk_attention_quant(
        q[:, None], kq_pages, ks_pages, vq_pages, vs_pages, table,
        (seq_lens - 1).to(torch.int32))[:, 0]


def paged_chunk_attention_v1(q, k_pages, v_pages, table, start):
    """B8, the ``pallas_v1`` arm: the contract of
    :func:`paged_chunk_attention` (the JAX v1 kernel computes v2's function;
    only its page walk differs).  CUDA tensors launch the body that
    :func:`paged_body` names, or raise: ``"sm90"`` is B5's Hopper body on
    dense pages (one launch, the decode merge inside it, scratch from the
    per-stream workspace); ``"scalar"`` (f32, head_dim 16 / 32) the
    split-key pair (kernel 1: one partial per :data:`SPLIT_KEYS` key
    positions; kernel 2: their combine), two launches.  ``launches`` counts
    every launch, ``body_launches`` each body's.  CPU tensors take
    :func:`paged_chunk_attention_split_reference`."""
    name = "paged_chunk_attention_v1"
    if not _device_ok(name, q):
        return paged_chunk_attention_split_reference(q, k_pages, v_pages,
                                                     table, start)
    _check(name, q, (k_pages, v_pages), table, start, q.dtype,
           q_dtypes=_build.F32_BF16)
    if paged_body(q) == "sm90":
        out = _dense_launch(q, k_pages, v_pages, table, start, "sm90")
        paged_chunk_attention_v1.launches += 1
        paged_chunk_attention_v1.body_launches["sm90"] += 1
        return out
    B, C, H, Dh = q.shape
    KV, P, ps, _ = k_pages.shape
    mp = table.shape[1]
    lib, dt, stream = _build.lib(), _build.DTYPE_CODES[q.dtype], \
        _build.stream_of(q)
    out = torch.empty_like(q)
    nsplit = -(-(mp * ps) // SPLIT_KEYS)
    rows = B * KV * nsplit * C * (H // KV)
    part_m = torch.empty((rows,), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((rows, Dh), dtype=torch.float32, device=q.device)
    err = lib.dstt_paged_split(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), start.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), B, C, H, KV, Dh, P, ps, mp,
        SPLIT_KEYS, nsplit, Dh ** -0.5, dt, stream)
    _build.check("dstt_paged_split", err)
    paged_chunk_attention_v1.launches += 1
    paged_chunk_attention_v1.body_launches["scalar"] += 1
    err = lib.dstt_paged_combine(
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, C, H, KV, Dh, nsplit, dt, stream)
    _build.check("dstt_paged_combine", err)
    paged_chunk_attention_v1.launches += 1
    paged_chunk_attention_v1.body_launches["scalar"] += 1
    return out


paged_chunk_attention_v1.launches = 0
paged_chunk_attention_v1.body_launches = {"sm90": 0, "scalar": 0}


def paged_decode_attention_v1(q, k_pages, v_pages, table, seq_lens):
    """Decode through B8: the C = 1 case of :func:`paged_chunk_attention_v1`
    at ``start = seq_lens - 1`` (an empty row combines to l = 0: zeros)."""
    return paged_chunk_attention_v1(q[:, None], k_pages, v_pages, table,
                                    (seq_lens - 1).to(torch.int32))[:, 0]
