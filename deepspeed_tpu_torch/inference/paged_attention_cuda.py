"""Paged attention on Hopper: the wrappers of the three paged kernels and
their plain PyTorch versions.

- ``csrc/paged_attention.cu`` (B5) replaces
  ``deepspeed_tpu/inference/kernels.py::_chunk_v2_kernel`` (with
  ``paged_chunk_attention_v2`` and ``paged_decode_attention_v2``, decode
  being its C = 1 case at ``start = seq_lens - 1``): dense pages.
- ``csrc/paged_attention_quant.cu`` (B7) replaces
  ``_chunk_v2_quant_kernel`` (``paged_chunk_attention_v2_quant``): int8
  codes with one f32 scale per token row, dequantised on chip in f32.
- ``csrc/paged_attention_split.cu`` (B8) replaces the v1 ``_chunk_kernel``
  (``paged_chunk_attention``, the ``pallas_v1`` arm): dense pages, the key
  axis split over blocks and a second kernel combining the partials.

Decode is bound by bytes on the H100: every live K/V byte is read once
(live KV bytes / 3.35 TB/s; B7 reads D + 4 bytes per row where B5 reads
2·D at bf16).  The kernels' grid is (b·kv_head, tile of the C·G flattened
query rows[, key split]); each block reads the page table itself and walks
only the key positions up to its last row's frontier, so stale or trash
table entries past it are never dereferenced; K/V land in f32 and the
online softmax is f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops import _build

NEG_INF = -1e30
# B8: key positions per split of the v1 arm's split-key grid
SPLIT_KEYS = 256


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


# ------------------------------------------------------------- wrappers
def _check(name, q, pages, table, start, page_dtype, scales=()):
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
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise ValueError(
            f"{name}: q/pages dtypes {q.dtype}/{k_pages.dtype}/"
            f"{v_pages.dtype}; want q float32 or bfloat16 and pages "
            f"{page_dtype}")


def _device_ok(name, q) -> bool:
    """True for a CUDA tensor, False for a CPU one (plain version)."""
    if q.device.type == "cpu":
        return False
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def paged_chunk_attention(q, k_pages, v_pages, table, start):
    """B5: paged attention for chunk queries q [B, C, H, Dh] at positions
    ``start + 0..C-1`` over one layer's pages [KV, P, ps, Dh] -> [B, C, H,
    Dh].  CPU tensors take :func:`paged_chunk_attention_reference`; CUDA
    tensors launch the kernel or raise."""
    if not _device_ok("paged_chunk_attention", q):
        return paged_chunk_attention_reference(q, k_pages, v_pages, table,
                                               start)
    _check("paged_chunk_attention", q, (k_pages, v_pages), table, start,
           q.dtype)
    B, C, H, Dh = q.shape
    KV, P, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _build.lib().dstt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), start.data_ptr(), out.data_ptr(), B, C, H, KV, Dh,
        P, ps, table.shape[1], Dh ** -0.5, _build.DTYPE_CODES[q.dtype],
        _build.stream_of(q))
    _build.check("dstt_paged_attention", err)
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0


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
    kernel or raise."""
    name = "paged_chunk_attention_quant"
    if not _device_ok(name, q):
        return paged_chunk_attention_quant_reference(
            q, kq_pages, ks_pages, vq_pages, vs_pages, table, start)
    _check(name, q, (kq_pages, vq_pages), table, start, torch.int8,
           scales=(ks_pages, vs_pages))
    B, C, H, Dh = q.shape
    KV, P, ps, _ = kq_pages.shape
    out = torch.empty_like(q)
    err = _build.lib().dstt_paged_attention_quant(
        q.data_ptr(), kq_pages.data_ptr(), ks_pages.data_ptr(),
        vq_pages.data_ptr(), vs_pages.data_ptr(), table.data_ptr(),
        start.data_ptr(), out.data_ptr(), B, C, H, KV, Dh, P, ps,
        table.shape[1], Dh ** -0.5, _build.DTYPE_CODES[q.dtype],
        _build.stream_of(q))
    _build.check("dstt_paged_attention_quant", err)
    paged_chunk_attention_quant.launches += 1
    return out


paged_chunk_attention_quant.launches = 0


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
    :func:`paged_chunk_attention` computed over a split key axis (kernel 1:
    one partial per :data:`SPLIT_KEYS` key positions; kernel 2: their
    combine).  ``launches`` counts both kernels, two per call.  CPU tensors
    take :func:`paged_chunk_attention_split_reference`; CUDA tensors launch
    the kernels or raise."""
    name = "paged_chunk_attention_v1"
    if not _device_ok(name, q):
        return paged_chunk_attention_split_reference(q, k_pages, v_pages,
                                                     table, start)
    _check(name, q, (k_pages, v_pages), table, start, q.dtype)
    B, C, H, Dh = q.shape
    KV, P, ps, _ = k_pages.shape
    mp = table.shape[1]
    nsplit = -(-(mp * ps) // SPLIT_KEYS)
    rows = B * KV * nsplit * C * (H // KV)
    part_m = torch.empty((rows,), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((rows, Dh), dtype=torch.float32, device=q.device)
    lib, dt, stream = _build.lib(), _build.DTYPE_CODES[q.dtype], \
        _build.stream_of(q)
    err = lib.dstt_paged_split(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), start.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), B, C, H, KV, Dh, P, ps, mp,
        SPLIT_KEYS, nsplit, Dh ** -0.5, dt, stream)
    _build.check("dstt_paged_split", err)
    paged_chunk_attention_v1.launches += 1
    out = torch.empty_like(q)
    err = lib.dstt_paged_combine(
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, C, H, KV, Dh, nsplit, dt, stream)
    _build.check("dstt_paged_combine", err)
    paged_chunk_attention_v1.launches += 1
    return out


paged_chunk_attention_v1.launches = 0


def paged_decode_attention_v1(q, k_pages, v_pages, table, seq_lens):
    """Decode through B8: the C = 1 case of :func:`paged_chunk_attention_v1`
    at ``start = seq_lens - 1`` (an empty row combines to l = 0: zeros)."""
    return paged_chunk_attention_v1(q[:, None], k_pages, v_pages, table,
                                    (seq_lens - 1).to(torch.int32))[:, 0]
