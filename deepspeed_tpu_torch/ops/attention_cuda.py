"""Flash attention on Hopper: the wrappers of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` and their plain PyTorch versions.

Replaces ``deepspeed_tpu/ops/attention_pallas.py::_fwd_kernel``,
``::_bwd_dq_kernel`` and ``::_bwd_dkv_kernel`` (with ``_flash_fwd_impl`` /
``_flash_bwd_impl`` / ``flash_attention_tpu``).  On the H100 the prefill and
training shapes are bound by operations (~4·T²·H·D/2 flops forward, ~2.5x
that backward, over O(T·H·D) bytes), which only the tensor cores deliver at
the card's rate.  Every kernel reads q/k/v in their model layout, maps query
head h to kv head h // (H/KV) without repeating K/V, skips key tiles above
the diagonal and masks ragged tails and packed segments itself.

Each kernel has two bodies, picked before the launch by
:func:`flash_fwd_body` and :func:`flash_bwd_body`: for bfloat16 or float16
with head_dim 64 or 128 (the Llama paths; fp16 for DeepSpeed's ``fp16``
mode) the tensor-core bodies (``csrc/flash_fwd_sm90.cuh``,
``csrc/flash_bwd_sm90.cuh``: TMA-fed stages
on mbarriers, a producer warp, two consumer warpgroups running ``wgmma``,
the softmax or the backward's p and ds on the accumulator fragment); for
float32, and bf16 or fp16 at head_dim 16 or 32, the scalar bodies (f32 FMA
from shared memory).  Both 16-bit types run the same arithmetic: f32 scores
and softmax, P rounded to the operand dtype before P·V, ds rounded to it
before dS·K, lse and delta f32, outputs in the operand dtype.  The dQ
kernel forms the backward's delta = rowsum(O * dO) itself
(:func:`flash_delta_sliced` is its order in plain PyTorch) and hands it to
the dK/dV kernel.  :func:`flash_fwd_tiled_reference` and
:func:`flash_bwd_tiled_reference` walk the tensor-core bodies' tiles in
plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from deepspeed_tpu_torch.ops import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# head dims and dtypes of the tensor-core bodies
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_DTYPES = (torch.bfloat16, torch.float16)
# the forward's tiles: query rows per block, keys per stage
WGMMA_BLOCK_Q = 128
WGMMA_BLOCK_K = 128
# the backward's: dQ's query rows per item and keys per stage; dK/dV's keys
# per item and query rows per stage
WGMMA_BWD_DQ_ROWS = 128
WGMMA_BWD_KEYS = 64
WGMMA_BWD_DKV_ROWS = 64


def _live_mask(B, T, S, causal, seg, device):
    """[B, 1, T, S] (or [1, 1, T, S]) bool: key s is visible from row t."""
    mask = torch.ones((1, 1, T, S), dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril()
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    return mask


def _scores(q, k, causal, seg):
    """f32 scores [B, H, T, S] scaled after the dot, -1e30 where masked."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * (1.0 / math.sqrt(D))
    return s.masked_fill(~_live_mask(B, T, S, causal, seg, q.device), NEG_INF)


def flash_fwd_reference(q, k, v, causal: bool = True, seg=None):
    """Plain version of the kernel: (o [B,T,H,D] in q's dtype, lse [B,H,T]
    f32), with the kernel's arithmetic — f32 scores scaled after the dot,
    masked entries out of the softmax, p cast through v's dtype before
    P.V, zeros for a row that sees no key."""
    H, KV = q.shape[2], k.shape[2]
    s = _scores(q, k, causal, seg)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    lsum = p.sum(-1, keepdim=True)
    vf = v.repeat_interleave(H // KV, dim=2)
    pv = torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).float(), vf.float())
    o = torch.where(lsum == 0, 0.0, pv / lsum)
    lse = (m + torch.log(torch.where(lsum == 0, 1.0, lsum)))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def flash_fwd_tiled_reference(q, k, v, causal: bool = True, seg=None,
                              block_q: int = WGMMA_BLOCK_Q,
                              block_k: int = WGMMA_BLOCK_K):
    """Plain walk of the tensor-core body's tiles -> (o, lse), in its order
    and with its arithmetic: query blocks of ``block_q`` rows, key tiles of
    ``block_k`` ascending; a causal block stops at its last row; keys past S
    read as zeros (the TMA fill) and are masked; with segment ids a tile
    whose keys' ids all lie outside the range of the block's rows' ids is
    skipped (it would add nothing); the element mask (-inf) only on a tile
    that crosses the diagonal or S, or whose rows and keys do not all share
    one segment id; unscaled f32 scores, the scale folded into exp2; a row
    with no live key yet keeps m = -inf and p = 0; per-tile rescale of l and
    the accumulator; p rounded to v's dtype before P·V; natural-log lse.
    Not on any main path: the CPU tests hold it to the JAX kernel."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    f32 = dict(dtype=torch.float32, device=q.device)
    scale = torch.tensor(1.0 / math.sqrt(D), **f32)
    scale_log2 = scale * torch.tensor(LOG2E, **f32)
    s_pad = -(-S // block_k) * block_k
    qf = q.float().transpose(1, 2)                       # [B, H, T, D]
    kf = torch.zeros((B, H, s_pad, D), **f32)
    vf = torch.zeros((B, H, s_pad, D), **f32)
    kf[:, :, :S] = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf[:, :, :S] = v.repeat_interleave(G, dim=2).transpose(1, 2).float()
    o = torch.empty((B, H, T, D), **f32)
    lse = torch.empty((B, H, T), **f32)
    cols_all = torch.arange(s_pad, device=q.device)
    for q0 in range(0, T, block_q):
        rows = torch.arange(q0, min(q0 + block_q, T), device=q.device)
        m = torch.full((B, H, len(rows)), float("-inf"), **f32)
        l = torch.zeros((B, H, len(rows)), **f32)
        acc = torch.zeros((B, H, len(rows), D), **f32)
        kv_end = min(S, q0 + block_q) if causal else S
        for n0 in range(0, kv_end, block_k):
            cols = cols_all[n0:n0 + block_k]
            one_id = False
            if seg is not None:
                qs, ks = seg[:, rows], seg[:, n0:min(n0 + block_k, S)]
                if ks.max() < qs.min() or ks.min() > qs.max():
                    continue
                one_id = bool((qs == ks[:, :1]).all()
                              and (ks == ks[:, :1]).all())
            s = torch.einsum("bhtd,bhsd->bhts", qf[:, :, rows],
                             kf[:, :, n0:n0 + block_k])
            if n0 + block_k > S or (causal and n0 + block_k - 1 > q0) \
                    or (seg is not None and not one_id):
                dead = (cols >= S)[None, None, None, :]
                if causal:
                    dead = dead | (cols[None, :] > rows[:, None])
                if seg is not None:
                    kseg = seg[:, cols.clamp(max=S - 1)]
                    dead = dead | (seg[:, rows, None] != kseg[:, None, :])[
                        :, None]
                s = s.masked_fill(dead, float("-inf"))
            mx = torch.maximum(m, s.amax(-1))
            ms = torch.where(mx == float("-inf"), 0.0, mx * scale_log2)
            alpha = torch.exp2(m * scale_log2 - ms)
            p = torch.exp2(s * scale_log2 - ms[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhts,bhsd->bhtd", p.to(v.dtype).float(),
                vf[:, :, n0:n0 + block_k])
            m = mx
        o[:, :, rows] = torch.where(l[..., None] == 0, 0.0,
                                    acc / l[..., None])
        lse[:, :, rows] = torch.where(l == 0, NEG_INF,
                                      m * scale + torch.log(l))
    return o.transpose(1, 2).to(q.dtype), lse


def flash_delta(o, do):
    """delta [B, H, T] f32 = rowsum(O * dO), the backward's per-row term
    (a plain reduction here, as in the JAX package)."""
    # do is upcast inside the product (exact, as its own .float() would be)
    return (o.float() * do).sum(-1).transpose(1, 2).contiguous()


# threads of a row that split its D columns when the dQ kernels form delta
DELTA_LANES = 4


def flash_delta_sliced(o, do):
    """delta in the dQ kernels' order -> [B, H, T] f32: each row's D
    columns in ``DELTA_LANES`` slices of D/4, each slice's f32 products
    summed on its own, then the slices' sums met as (s0 + s1) + (s2 + s3),
    as the xor shuffles over lane bits 0 and 1 meet them.  Within a slice
    the kernels add in column order and this sum in its own: they agree to
    a few f32 ulps."""
    B, T, H, D = o.shape
    part = (o.float() * do).reshape(B, T, H, DELTA_LANES,
                                    D // DELTA_LANES).sum(-1)
    delta = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    return delta.transpose(1, 2).contiguous()


def flash_bwd_reference(q, k, v, o, lse, do, seg=None, causal: bool = True):
    """Plain version of the two backward kernels -> (dq, dk, dv) in the
    inputs' dtypes: p = exp(s - lse) recomputed from the forward's lse,
    ds = p * (dO.V^T - delta) * scale; dQ = ds (rounded to K's dtype) . K;
    dV = p^T . dO and dK = ds^T . Q in f32, summed over each kv head's
    group of query heads."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    p = torch.exp(_scores(q, k, causal, seg) - lse[..., None])
    dof = do.float()
    vf = v.float().repeat_interleave(G, dim=2)
    dov = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dov - flash_delta(o, do)[..., None]) * scale
    kf = k.float().repeat_interleave(G, dim=2)
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(), kf)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    dk = dk.reshape(B, S, KV, G, D).sum(3)
    dv = dv.reshape(B, S, KV, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tile_ids(seg, rows, keys):
    """(skip, one_id) of a tile with segment ids: its keys' ids all outside
    the range of its rows' ids (it adds nothing), or rows and keys all of
    one id (no id mask needed)."""
    qs, ks = seg[:, rows], seg[:, keys]
    skip = bool(ks.max() < qs.min() or ks.min() > qs.max())
    one = bool((qs == ks[:, :1]).all() and (ks == ks[:, :1]).all())
    return skip, one


def flash_bwd_tiled_reference(q, k, v, o, lse, do, seg=None,
                              causal: bool = True,
                              block_q: int = WGMMA_BWD_DQ_ROWS,
                              block_k: int = WGMMA_BWD_KEYS,
                              dkv_block_q: int = WGMMA_BWD_DKV_ROWS):
    """Plain walk of the tensor-core backward bodies' tiles -> (dq, dk, dv),
    in their order and with their arithmetic.  dQ: query blocks of
    ``block_q`` rows sweep key tiles of ``block_k`` up to the causal
    frontier.  dK/dV: key blocks of ``block_k`` sweep each group head's
    query tiles of ``dkv_block_q`` rows from the block's first key (causal),
    head by head, tile t adding into partial sum t % 2 (the two consumer
    warpgroups), the two partials added at the end.  Both: with segment ids
    a tile whose ids fall outside the range of the block's ids is skipped;
    the element mask (-inf) only on a tile that crosses the diagonal or S,
    or whose ids are mixed; unscaled f32 scores, p = exp2(s * scale *
    log2(e) - lse * log2(e)); delta in the dQ kernel's order
    (:func:`flash_delta_sliced`); ds = p (dO.V^T - delta) scale; ds rounded to
    K's dtype before dQ += ds.K; into dV += P^T.dO and dK += dS^T.Q, P and
    dS in bfloat16 each split into hi = bf16(x) and lo = bf16(x - hi), both
    multiplied, and in float16 rounded once (the JAX kernel's arithmetic).
    Not on any main path: the CPU tests hold it to the JAX kernel."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    scale = torch.tensor(1.0 / math.sqrt(D), **f32)
    log2e = torch.tensor(LOG2E, **f32)
    scale_log2 = scale * log2e
    lse2 = lse * log2e                                   # [B, H, T]
    delta = flash_delta_sliced(o, do)                    # [B, H, T]
    qf, dof = (x.float().transpose(1, 2) for x in (q, do))   # [B, H, T, D]
    kf, vf = (x.float().transpose(1, 2) for x in (k, v))     # [B, KV, S, D]
    kh = kf.repeat_interleave(G, dim=1)                  # [B, H, S, D]
    vh = vf.repeat_interleave(G, dim=1)
    trow = torch.arange(T, device=dev)
    tkey = torch.arange(S, device=dev)

    def dead_mask(rows, keys, masked):
        """[B, 1, len(rows), len(keys)] dead entries, or None."""
        if not masked:
            return None
        dead = torch.zeros((1, 1, len(rows), len(keys)), dtype=torch.bool,
                           device=dev)
        if causal:
            dead = dead | (keys[None, :] > rows[:, None])
        if seg is not None:
            dead = dead | (seg[:, rows, None] != seg[:, None, keys])[:, None]
        return dead

    dq = torch.zeros((B, H, T, D), **f32)
    for q0 in range(0, T, block_q):
        rows = trow[q0:q0 + block_q]
        kv_end = min(S, q0 + block_q) if causal else S
        for n0 in range(0, kv_end, block_k):
            keys = tkey[n0:n0 + block_k]
            one_id = True
            if seg is not None:
                skip, one_id = _tile_ids(seg, rows, keys)
                if skip:
                    continue
            s = qf[:, :, rows] @ kh[:, :, keys].transpose(-1, -2)
            dead = dead_mask(rows, keys, n0 + block_k > S or (
                causal and n0 + block_k - 1 > q0) or not one_id)
            if dead is not None:
                s = s.masked_fill(dead, float("-inf"))
            p = torch.exp2(s * scale_log2 - lse2[:, :, rows, None])
            dp = dof[:, :, rows] @ vh[:, :, keys].transpose(-1, -2)
            ds = p * (dp - delta[:, :, rows, None]) * scale
            dq[:, :, rows] += ds.to(k.dtype).float() @ kh[:, :, keys]

    dk = torch.zeros((B, KV, S, D), **f32)
    dv = torch.zeros((B, KV, S, D), **f32)
    for k0 in range(0, S, block_k):
        keys = tkey[k0:k0 + block_k]
        m_start = (k0 // dkv_block_q) * dkv_block_q if causal else 0
        part_k = [torch.zeros((B, KV, len(keys), D), **f32) for _ in range(2)]
        part_v = [torch.zeros((B, KV, len(keys), D), **f32) for _ in range(2)]
        t = -1
        for g in range(G):
            heads = torch.arange(KV, device=dev) * G + g
            for m0 in range(m_start, T, dkv_block_q):
                t += 1
                rows = trow[m0:m0 + dkv_block_q]
                one_id = True
                if seg is not None:
                    skip, one_id = _tile_ids(seg, rows, keys)
                    if skip:
                        continue
                qt, dot = qf[:, heads][:, :, rows], dof[:, heads][:, :, rows]
                st = kf[:, :, keys] @ qt.transpose(-1, -2)    # [B, KV, n, m]
                dead = dead_mask(rows, keys, (
                    causal and m0 < k0 + block_k - 1) or not one_id)
                if dead is not None:
                    st = st.masked_fill(dead.transpose(-1, -2),
                                        float("-inf"))
                pt = torch.exp2(st * scale_log2
                                - lse2[:, heads][:, :, None, rows])
                dpt = vf[:, :, keys] @ dot.transpose(-1, -2)
                dst = pt * (dpt - delta[:, heads][:, :, None, rows]) * scale
                for x, acc, b in ((pt, part_v, dot), (dst, part_k, qt)):
                    hi = x.to(q.dtype).float()
                    acc[t % 2] += hi @ b
                    if q.dtype == torch.bfloat16:
                        acc[t % 2] += (x - hi).to(q.dtype).float() @ b
        dk[:, :, keys] = part_k[0] + part_k[1]
        dv[:, :, keys] = part_v[0] + part_v[1]
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _check(name, q, k, v, seg, *more):
    """Shapes, dtypes, devices and contiguity the kernels take; returns
    (B, T, S, H, KV, D)."""
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not in "
                         "float32/bfloat16/float16")
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, T, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    S, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{name}: heads {H} not a multiple of kv heads {KV}")
    if D not in _build.HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {_build.HEAD_DIMS}")
    for tname, t in (("q", q), ("k", k), ("v", v)) + more:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} is not contiguous")
    if seg is not None:
        if T != S:
            raise ValueError(f"{name}: segment_ids need T == S (self-"
                             f"attention over one packed layout), got T={T} "
                             f"S={S}")
        if seg.shape != (B, T) or seg.dtype != torch.int32 \
                or seg.device != q.device or not seg.is_contiguous():
            raise ValueError(f"{name}: segment_ids must be a contiguous "
                             f"[{B}, {T}] int32 tensor on {q.device}, got "
                             f"{tuple(seg.shape)} {seg.dtype} on {seg.device}")
    return B, T, S, H, KV, D


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tma_aligned(*ts):
    """TMA needs 16-byte aligned bases; a view that starts off that (no
    caller makes one) is copied into a fresh allocation."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def flash_fwd_body(q) -> str:
    """The body of ``csrc/flash_fwd.cu`` that a CUDA call on ``q`` launches:
    ``"wgmma"`` (tensor cores, TMA) for bfloat16 or float16 with head_dim 64
    or 128, ``"scalar"`` otherwise."""
    return ("wgmma" if q.dtype in WGMMA_DTYPES
            and q.shape[-1] in WGMMA_HEAD_DIMS else "scalar")


def flash_fwd(q, k, v, causal: bool = True, seg=None):
    """Flash attention forward: q [B,T,H,D], k/v [B,S,KV,D] (contiguous,
    float32, bfloat16 or float16, D in 16/32/64/128), optional packed
    segment ids seg [B,T] int32 (T == S) -> (o, lse [B,H,T] f32).  CPU
    tensors take :func:`flash_fwd_reference`; CUDA tensors launch the body that
    :func:`flash_fwd_body` names, or raise.  ``flash_fwd.launches`` counts
    every launch, ``flash_fwd.body_launches`` each body's and
    ``flash_fwd.dtype_launches`` each dtype's."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, seg)
    B, T, S, H, KV, D = _check("flash_fwd", q, k, v, seg)
    body = flash_fwd_body(q)
    if body == "wgmma":
        q, k, v = _tma_aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = _build.lib().dstt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), o.data_ptr(),
        lse.data_ptr(), B, T, S, H, KV, D, 1.0 / math.sqrt(D), int(causal),
        _build.DTYPE_CODES[q.dtype], int(body == "wgmma"),
        _build.stream_of(q))
    _build.check("dstt_flash_fwd", err)
    flash_fwd.launches += 1
    flash_fwd.body_launches[body] += 1
    flash_fwd.dtype_launches[q.dtype] += 1
    return o, lse


flash_fwd.launches = 0
flash_fwd.body_launches = {"wgmma": 0, "scalar": 0}
flash_fwd.dtype_launches = dict.fromkeys(_build.DTYPE_CODES, 0)


def flash_bwd_body(q) -> str:
    """The body of ``csrc/flash_bwd.cu`` that a CUDA call on ``q`` launches
    (both kernels): ``"wgmma"`` (tensor cores, TMA) for bfloat16 or float16
    with head_dim 64 or 128, ``"scalar"`` otherwise."""
    return flash_fwd_body(q)


def flash_bwd_dq(q, k, v, o, do, lse, seg=None, causal: bool = True):
    """dQ kernel (CUDA tensors only): q/o/do [B,T,H,D], k/v [B,S,KV,D],
    lse [B,H,T] f32 -> (dq [B,T,H,D] in q's dtype, delta [B,H,T] f32 =
    rowsum(O * dO), which the kernel forms in :func:`flash_delta_sliced`'s
    order and writes for every row, for :func:`flash_bwd_dkv`).  Launches
    the body that :func:`flash_bwd_body` names; ``flash_bwd_dq.launches``
    counts every launch, ``flash_bwd_dq.body_launches`` each body's and
    ``flash_bwd_dq.dtype_launches`` each dtype's."""
    B, T, S, H, KV, D = _check("flash_bwd_dq", q, k, v, seg, ("o", o),
                               ("do", do))
    _rows_f32("flash_bwd_dq", (B, H, T), q.device, lse=lse)
    body = flash_bwd_body(q)
    if body == "wgmma":
        q, k, v, o, do = _tma_aligned(q, k, v, o, do)
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = _build.lib().dstt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg), dq.data_ptr(), B, T, S,
        H, KV, D, 1.0 / math.sqrt(D), int(causal),
        _build.DTYPE_CODES[q.dtype], int(body == "wgmma"),
        _build.stream_of(q))
    _build.check("dstt_flash_bwd_dq", err)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.body_launches[body] += 1
    flash_bwd_dq.dtype_launches[q.dtype] += 1
    return dq, delta


flash_bwd_dq.launches = 0
flash_bwd_dq.body_launches = {"wgmma": 0, "scalar": 0}
flash_bwd_dq.dtype_launches = dict.fromkeys(_build.DTYPE_CODES, 0)


def flash_bwd_dkv(q, k, v, do, lse, delta, seg=None, causal: bool = True):
    """dK/dV kernel (CUDA tensors only), with delta as
    :func:`flash_bwd_dq` returns it -> (dk, dv) [B,S,KV,D] in k's dtype,
    each summed over the kv head's group of query heads.  Bodies and counts
    as :func:`flash_bwd_dq`."""
    B, T, S, H, KV, D = _check("flash_bwd_dkv", q, k, v, seg, ("do", do))
    _rows_f32("flash_bwd_dkv", (B, H, T), q.device, lse=lse, delta=delta)
    body = flash_bwd_body(q)
    if body == "wgmma":
        q, k, v, do = _tma_aligned(q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _build.lib().dstt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg), dk.data_ptr(),
        dv.data_ptr(), B, T, S, H, KV, D, 1.0 / math.sqrt(D), int(causal),
        _build.DTYPE_CODES[q.dtype], int(body == "wgmma"),
        _build.stream_of(q))
    _build.check("dstt_flash_bwd_dkv", err)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.body_launches[body] += 1
    flash_bwd_dkv.dtype_launches[q.dtype] += 1
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.body_launches = {"wgmma": 0, "scalar": 0}
flash_bwd_dkv.dtype_launches = dict.fromkeys(_build.DTYPE_CODES, 0)


def _rows_f32(name, shape, device, **rows):
    for tname, t in rows.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be a contiguous {shape} "
                             f"float32 tensor on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def flash_bwd(q, k, v, o, lse, do, seg=None, causal: bool = True):
    """Flash attention backward -> (dq, dk, dv).  CPU tensors take
    :func:`flash_bwd_reference`; CUDA tensors launch the dQ kernel, which
    forms delta = rowsum(O * dO) too, then the dK/dV kernel on the same
    stream, or raise.  ``o`` may be a strided view (the plain forward's
    is); the kernel's own is contiguous and is not copied."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, seg, causal)
    dq, delta = flash_bwd_dq(q, k, v, o.contiguous(), do, lse, seg, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seg, causal)
    return dq, dk, dv
