"""Llama (port of ``deepspeed_tpu/models/llama.py``).

Parameters keep the JAX pytree layout: a dict with ``embed`` [V, d],
``blocks`` of stacked ``[L, in, out]`` leaves (``x @ W``), ``final_norm``
and ``lm_head`` [d, V], under the same key names, so the weight bridge
(:mod:`deepspeed_tpu_torch.weights`) is a plain array copy.  ``lax.scan``
over the stacked layers becomes a Python loop.  Logits are f32, as the
reference computes them (``preferred_element_type=float32``): a bf16 model
multiplies its final hidden state and head in f32, so a 128k vocab does not
grow argmax ties the reference lacks.  :func:`loss_fn` is the training
objective: next-token cross entropy over ``{tokens, loss_mask,
segment_ids}``, with packed-document attention through the flash kernels'
``segment_ids``.

Int8 weights: any matrix leaf may be an int8
:class:`~deepspeed_tpu_torch.inference.quantized.QuantizedTensor`
(``init_inference(dtype="int8")``, ``llama_serving_engine(weight_dtype=
"int8")``).  :func:`forward`, :func:`forward_hidden`,
:func:`forward_with_cache` and :func:`forward_paged` dequantize such leaves
where they are read: one layer
of a stacked leaf at a time, the embedding's gathered rows, the LM head once
per forward, each to bfloat16 as the JAX package's ``quantized_apply`` does
(they carry the ``takes_quantized`` mark, so ``init_inference`` hands them
the int8 tree as it is).
A quantized embedding makes the residual stream bfloat16 whatever the
norm gains' dtype, as it does there (``rms_norm`` keeps x's dtype).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from deepspeed_tpu_torch.inference.quantized import take, takes_quantized
from deepspeed_tpu_torch.ops.attention import _reference, flash_attention
from deepspeed_tpu_torch.ops.fused_ops import rms_norm, swiglu
from deepspeed_tpu_torch.ops.losses import chunked_lm_loss, f32_matmul
from deepspeed_tpu_torch.remat import (check as check_remat,
                                       checkpoint_block, checkpoint_named)

ATTN_IMPLS = ("auto", "flash", "reference")


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    ffn_dim: Optional[int] = None          # default 8/3 * dim rounded to 128
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "none"                    # none | full | save_dots | ...
    loss_chunk: int = 0                    # >0: chunked-vocab CE
    attn_impl: str = "auto"                # auto | flash | reference

    def __post_init__(self):
        if self.ffn_dim is None:
            self.ffn_dim = int(math.ceil(self.dim * 8 / 3 / 128) * 128)
        if self.n_heads % self.n_kv_heads or self.dim % self.n_heads:
            raise ValueError(
                f"dim {self.dim} / n_heads {self.n_heads} / n_kv_heads "
                f"{self.n_kv_heads} do not divide")
        if self.attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: the port serves "
                f"{'|'.join(ATTN_IMPLS)}; ring/ulysses/sparse come with the "
                "distributed slice")
        check_remat(self.remat)      # remat.POLICIES or remat.OFFLOAD

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls, **kw):
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, ffn_dim=14336, rope_theta=500000.0, **kw)

    @classmethod
    def llama3_70b(cls, **kw):
        return cls(vocab_size=128256, dim=8192, n_layers=80, n_heads=64,
                   n_kv_heads=8, ffn_dim=28672, rope_theta=500000.0, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("dim", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("n_kv_heads", 2)
        kw.setdefault("max_seq_len", 128)
        return cls(**kw)


def param_count(cfg: LlamaConfig) -> int:
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    kvd = cfg.n_kv_heads * cfg.head_dim
    per_layer = (d * d) + (d * kvd) * 2 + (d * d) + (d * f) * 3 + 2 * d
    emb = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    return int(L * per_layer + emb + head + d)


# ------------------------------------------------------------------- forward
def rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """positions: [T] or [B, T] int -> (cos, sin) [..., head_dim/2] f32."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: [B, T, H, Dh]; rotate pairs (x[..., :half], x[..., half:]).
    cos/sin: [T, half] shared across the batch or [B, T, half] per row; they
    are cast to x's dtype first, as the reference does (bf16 matches)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, cfg: LlamaConfig, segment_ids=None):
    """q: [B,T,H,Dh], k/v: [B,T,KV,Dh] -> [B,T,H,Dh] (causal)."""
    if cfg.attn_impl == "reference":
        return _reference(q, k, v, causal=True, segment_ids=segment_ids)
    return flash_attention(q, k, v, causal=True, segment_ids=segment_ids)


def _qkv(cfg: LlamaConfig, lp, x, cos, sin):
    B, T, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = apply_rope((h @ lp["wq"]).reshape(B, T, nh, hd), cos, sin)
    k = apply_rope((h @ lp["wk"]).reshape(B, T, nkv, hd), cos, sin)
    v = (h @ lp["wv"]).reshape(B, T, nkv, hd)
    return q, k, v


def _attn_out(cfg: LlamaConfig, lp, x, cos, sin, segment_ids):
    """The block's attention context [B, T, H * Dh] (JAX's ``attn_out``)."""
    B, T, _ = x.shape
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    return _attention(q, k, v, cfg, segment_ids).reshape(
        B, T, cfg.n_heads * cfg.head_dim)


def _mlp_out(cfg: LlamaConfig, lp, x):
    """The FFN inner activation [B, T, ffn] (JAX's ``mlp_out``)."""
    return swiglu(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp["w1"],
                  lp["w3"])


def _block_tail(cfg: LlamaConfig, lp, x, attn, remat: str = "none",
                ffn=None):
    """The attention output's projection and residual, then the FFN and
    its residual; ``ffn``: an ``(lp, h) -> y`` override of the FFN over the
    ``mlp_norm``-normed residual (Mixtral's expert combine)."""
    B, T, _ = x.shape
    x = x + attn.reshape(B, T, cfg.n_heads * cfg.head_dim) @ lp["wo"]
    if ffn is not None:
        return x + ffn(lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    mlp = checkpoint_named(_mlp_out, remat)(cfg, lp, x)
    return x + mlp @ lp["w2"]


def _block(cfg: LlamaConfig, lp, x, cos, sin, segment_ids):
    """One transformer block; under ``remat="save_attn"`` its two named
    stages are checkpointed (:func:`~deepspeed_tpu_torch.remat.
    checkpoint_named`)."""
    attn = checkpoint_named(_attn_out, cfg.remat)(cfg, lp, x, cos, sin,
                                                  segment_ids)
    return _block_tail(cfg, lp, x, attn, cfg.remat)


def _layer(params, l: int):
    """Layer ``l`` of the stacked blocks, int8 leaves dequantized (only
    this layer's slice of them)."""
    return {name: take(w, l) for name, w in params["blocks"].items()}


def _embed(params, tokens):
    return take(params["embed"], tokens.long())


def lm_head(params, cfg: LlamaConfig):
    if cfg.tie_embeddings:
        return take(params["embed"]).T
    return take(params["lm_head"])


def _head_logits(params, cfg: LlamaConfig, h):
    return f32_matmul(h, lm_head(params, cfg))


def _logits(params, cfg: LlamaConfig, x):
    h = rms_norm(x, take(params["final_norm"]), cfg.norm_eps)
    return _head_logits(params, cfg, h)


@takes_quantized
def forward_hidden(params, tokens, cfg: LlamaConfig, positions=None,
                   segment_ids=None, n_micro: Optional[int] = None):
    """tokens: [B, T] int -> final-norm hidden states [B, T, d] (what the
    LM head and the loss consume).  ``segment_ids`` [B, T]: packed
    documents attend only within their own id.  Each block runs under
    ``cfg.remat`` (:mod:`deepspeed_tpu_torch.remat`), as the JAX model wraps
    its scanned block in ``jax.checkpoint``."""
    if n_micro:
        raise NotImplementedError(
            "n_micro: pipeline-parallel microbatching comes with the "
            "distributed slice (ROADMAP A9)")
    T = tokens.shape[1]
    x = _embed(params, tokens)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    cos, sin = rope_tables(cfg, positions)
    block = checkpoint_block(_block, cfg.remat)
    for l in range(cfg.n_layers):
        x = block(cfg, _layer(params, l), x, cos, sin, segment_ids)
    return rms_norm(x, take(params["final_norm"]), cfg.norm_eps)


@takes_quantized
def forward(params, tokens, cfg: LlamaConfig, positions=None,
            segment_ids=None, n_micro: Optional[int] = None):
    """tokens: [B, T] int -> logits [B, T, V] f32."""
    return _head_logits(params, cfg, forward_hidden(
        params, tokens, cfg, positions=positions, segment_ids=segment_ids,
        n_micro=n_micro))


@takes_quantized
def forward_with_cache(params, tokens, cfg: LlamaConfig, cache):
    """Incremental forward for generation over a dense
    :class:`~deepspeed_tpu_torch.inference.generation.KVCache` (written in
    place): attends to cache[:length] + tokens, writes the new K/V at
    ``cache.length``.  tokens [B, T] -> (logits [B, T, V] f32, cache with
    ``length + T``)."""
    from deepspeed_tpu_torch.inference.generation import cached_attention

    T = tokens.shape[1]
    start = cache.length
    x = _embed(params, tokens)
    cos, sin = rope_tables(cfg, start + torch.arange(
        T, dtype=torch.int32, device=tokens.device))
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        attn, _, _ = cached_attention(q, cache.k[l], cache.v[l], k, v, start)
        x = _block_tail(cfg, lp, x, attn)
    return _logits(params, cfg, x), dataclasses.replace(cache,
                                                        length=start + T)


def packed_doc_mask(seg):
    """CE mask for a packed layout's [B, T+1] token-aligned segment ids: a
    document's last token does not predict the next document's first, and
    padding (id 0) targets mask out."""
    return ((seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] > 0)).float()


def loss_fn(cfg: LlamaConfig, n_micro: Optional[int] = None):
    """Causal-LM next-token cross entropy over ``batch = {tokens,
    (loss_mask), (segment_ids)}``; ``segment_ids`` are [B, T+1], aligned
    with ``tokens`` (the forward takes the input slice, and the document
    boundaries fold into the loss mask).  ``cfg.loss_chunk`` > 0 takes the
    chunked-vocab loss, 0 the dense one."""
    if n_micro:
        raise NotImplementedError(
            "n_micro: pipeline-parallel microbatching comes with the "
            "distributed slice (ROADMAP A9)")

    def f(params, batch):
        tokens = batch["tokens"]
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:].float()
        seg = batch.get("segment_ids")
        if seg is not None:
            doc = packed_doc_mask(seg)
            mask = doc if mask is None else mask * doc
            seg = seg[:, :-1]
        x = forward_hidden(params, tokens[:, :-1], cfg, segment_ids=seg)
        return chunked_lm_loss(x, lm_head(params, cfg), tokens[:, 1:],
                               mask=mask,
                               chunk=cfg.loss_chunk or cfg.vocab_size)

    return f


def layered_model(cfg: LlamaConfig, params):
    """Factor a llama param tree for the layer-streaming engine (ref:
    ZeRO-Infinity parameter offload, partitioned_param_swapper.py): stem =
    the embedding, block = one transformer layer, head = the final norm and
    the LM head with the chunked loss.  ``params["blocks"]`` may be the
    stacked tree or a callable ``l -> layer tree`` (the lazy init of
    :func:`layered_model_lazy`).  See :class:`~deepspeed_tpu_torch.
    param_stream.LayeredModel`."""
    from deepspeed_tpu_torch.param_stream import LayeredModel

    if cfg.tie_embeddings:
        raise NotImplementedError(
            "layered streaming with tied embeddings would need the embed "
            "grad summed across stem and head — untie for now")

    def stem_fn(sp, batch):
        return sp["embed"][batch["tokens"][:, :-1].long()]

    def block_fn(lp, x):
        T = x.shape[1]
        cos, sin = rope_tables(cfg, torch.arange(T, dtype=torch.int32,
                                                 device=x.device))
        return _block(cfg, lp, x, cos, sin, None)

    def head_fn(hp, x, batch):
        tokens = batch["tokens"]
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:].float()
        x = rms_norm(x, hp["final_norm"], cfg.norm_eps)
        return chunked_lm_loss(x, hp["lm_head"], tokens[:, 1:], mask=mask,
                               chunk=cfg.loss_chunk or cfg.vocab_size)

    return LayeredModel(
        stem_fn=stem_fn, block_fn=block_fn, head_fn=head_fn,
        stem={"embed": params["embed"]}, blocks=params["blocks"],
        head={"final_norm": params["final_norm"],
              "lm_head": params["lm_head"]},
        n_layers=cfg.n_layers, assemble=_assemble)


def _assemble(stem, blocks, head):
    """(stem, stacked blocks, head) -> the :func:`init_params` layout."""
    return {"embed": stem["embed"], "blocks": blocks,
            "final_norm": head["final_norm"], "lm_head": head["lm_head"]}


# a lazy init's draws go chunk by chunk: a numpy Generator's stream does not
# depend on how a fill is cut, and each chunk is scaled and rounded on a
# second thread while the next one is drawn
_DRAW_CHUNK = 1 << 24


def _seeded_normal(rng, dtype: torch.dtype, *shape) -> torch.Tensor:
    """The JAX lazy builder's draw: f32 standard normals from ``rng``,
    scaled by 1/sqrt(fan-in) in numpy, then rounded to ``dtype`` by torch
    (round-to-nearest-even, as ``ml_dtypes`` rounds)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    scale = 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
    n = int(np.prod(shape))
    out = torch.empty(n, dtype=dtype)

    def rounded(o, a):
        out[o:o + a.size].copy_(torch.from_numpy(a * scale))

    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = None
        for o in range(0, n, _DRAW_CHUNK):
            a = rng.standard_normal(min(_DRAW_CHUNK, n - o),
                                    dtype=np.float32)
            if pending is not None:
                pending.result()
            pending = ex.submit(rounded, o, a)
        if pending is not None:
            pending.result()
    return out.view(shape)


def layered_model_lazy(cfg: LlamaConfig, seed: int = 0,
                       dtype: torch.dtype = torch.bfloat16):
    """:func:`layered_model` for models whose whole host image would not
    fit in RAM, the host-side analogue of ``zero.Init`` (ref:
    deepspeed.zero.Init): the blocks are a per-layer init callable plus
    the stacked shapes (``blocks_spec``, meta tensors with a leading
    ``[L]``), so the streaming engine materializes one layer at a time.
    Layer ``l`` draws from ``numpy.random.default_rng((seed, l))`` and the
    stem and head from ``default_rng((seed, 1 << 30))`` in the JAX
    builder's order, so the f32 draws are the JAX package's; the bf16
    rounding is torch's (the same round-to-nearest-even)."""
    import numpy as np

    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    shapes = {"attn_norm": (d,), "wq": (d, nh * hd), "wk": (d, nkv * hd),
              "wv": (d, nkv * hd), "wo": (nh * hd, d), "mlp_norm": (d,),
              "w1": (d, f), "w3": (d, f), "w2": (f, d)}

    def blocks(l):
        r = np.random.default_rng((seed, l))
        # the JAX builder's dict literal draws in this order
        out = {k: _seeded_normal(r, dtype, *shapes[k])
               for k in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")}
        out["attn_norm"] = torch.ones((d,), dtype=dtype)
        out["mlp_norm"] = torch.ones((d,), dtype=dtype)
        return out

    r0 = np.random.default_rng((seed, 1 << 30))
    embed = _seeded_normal(r0, dtype, cfg.vocab_size, d)
    lm = layered_model(cfg, {
        "embed": embed, "blocks": blocks,
        "final_norm": torch.ones((d,), dtype=dtype),
        "lm_head": _seeded_normal(r0, dtype, d, cfg.vocab_size)})
    return dataclasses.replace(lm, blocks_spec={
        k: torch.empty((L,) + s, dtype=dtype, device="meta")
        for k, s in shapes.items()})


def paged_layered_fns(cfg: LlamaConfig, ffn=None,
                      paged_kernel: Optional[str] = None):
    """Per-layer factoring of :func:`forward_paged` for weight-streamed
    (ZeRO-Inference) serving: stem (embedding + rope tables) and head
    (final norm + LM head) stay resident, and each transformer layer is
    its own call, so the streaming engine can upload layer ``l + 1``'s
    weights while layer ``l`` computes.  Returns ``(stem_fn, block_fn,
    head_fn)``::

        stem_fn(stem, tokens, start)               -> (x, cos, sin)
        block_fn(lp, x, cos, sin, kp, vp, table, start, *, continuation,
                 prefill, kps=None, vps=None)      -> x
        head_fn(head, x)                           -> logits [B, T, V] f32

    ``stem`` holds ``embed``; ``head`` ``final_norm`` and ``lm_head`` (or
    ``embed`` when tied).  ``lp`` is ONE layer's leaves (no layer axis), any
    of them an int8 :class:`~deepspeed_tpu_torch.inference.quantized.
    QuantizedTensor`, dequantized inside ``block_fn`` through
    :func:`~deepspeed_tpu_torch.inference.quantized.take`.  ``kp``/``vp``
    are one layer's pages ``[KV, P, ps, Dh]`` (a view of the stacked
    cache), written in place; ``kps``/``vps`` their int8-resident scale
    planes.  :func:`forward_paged` runs exactly these three functions, so
    streamed serving runs the same ops, in the same order, through the same
    kernels as resident serving.  ``paged_kernel``: the resolved dispatch
    (``"pallas_v2"`` / ``"pallas_v1"`` = a CUDA kernel, ``"xla"`` = the
    plain version; None / "auto" resolves from the cache's device per
    call).  ``ffn``: an ``(lp, h) -> y`` override of the FFN over the
    ``mlp_norm``-normed residual (Mixtral's expert combine)."""
    from deepspeed_tpu_torch.inference.kernels import (
        paged_attention_step, resolve_serving_kernels)

    def stem_fn(sp, tokens, start):
        T = tokens.shape[1]
        x = _embed(sp, tokens)
        # ragged frontiers under continuous batching: each row rotates by
        # ITS own start
        positions = start[:, None] + torch.arange(
            T, dtype=torch.int32, device=start.device)[None]
        cos, sin = rope_tables(cfg, positions)
        return x, cos, sin

    def block_fn(lp, x, cos, sin, kp, vp, table, start, *,
                 continuation: bool, prefill: bool, kps=None, vps=None):
        lp = {name: take(w) for name, w in lp.items()}
        pk = resolve_serving_kernels(
            {"paged_attention": paged_kernel or "auto"},
            device=kp.device).paged_attention
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        attn = paged_attention_step(
            q, k, v, kp, vp, table, start, kp.shape[2],
            continuation=continuation, prefill=prefill, paged_kernel=pk,
            flash_force_reference=cfg.attn_impl == "reference",
            kps=kps, vps=vps)
        return _block_tail(cfg, lp, x, attn, ffn=ffn)

    def head_fn(hp, x):
        return _logits(hp, cfg, x)

    return stem_fn, block_fn, head_fn


def _layer_leaves(params, l: int):
    """Layer ``l`` of the stacked blocks, int8 leaves still quantized (the
    codes and scales of that layer only)."""
    from deepspeed_tpu_torch._tree import tree_map

    return {name: tree_map(lambda a: a[l], w)
            for name, w in params["blocks"].items()}


@takes_quantized
def forward_paged(params, tokens, cfg: LlamaConfig, cache,
                  continuation: bool = False,
                  paged_kernel: Optional[str] = None, ffn=None):
    """Forward over a paged KV cache -> (logits [B, T, V] f32, cache).

    Prefill (T > 1, empty cache): causal attention over the prompt (the
    flash kernel on CUDA unless ``cfg.attn_impl == "reference"``), K/V
    bulk-written into pages.  Decode (T == 1): paged attention over the
    live pages.  ``continuation=True`` (T > 1, non-empty cache): chunked
    prefill — the chunk's K/V land at each row's frontier and attention
    runs over history + chunk; logits come back at every position.

    The page stores ``cache.k`` / ``cache.v`` are updated IN PLACE (the JAX
    engine donates them to the same effect); the returned cache shares
    them and carries ``seq_lens = start + T``.  The cache is int8-resident
    iff ``cache.k_scale`` is not None: k/v then hold int8 codes and the
    scale planes ride along per layer.  ``paged_kernel`` is the resolved
    dispatch (``"pallas_v2"`` / ``"pallas_v1"`` = a CUDA kernel, ``"xla"``
    = the plain version); None/"auto" takes the kernel on CUDA and the
    plain version on CPU.  ``ffn``: an ``(lp, h) -> y`` override of each
    block's FFN over the ``mlp_norm``-normed residual ``h``: the paged
    backbone is model-agnostic, and Mixtral swaps in its expert combine
    (None: the SwiGLU FFN).  The body is :func:`paged_layered_fns`'
    stem, one block per layer and head."""
    from deepspeed_tpu_torch.inference.kernels import paged_forward_prelude

    T = tokens.shape[1]
    _, start, prefill = paged_forward_prelude(cache, tokens, continuation)
    stem_fn, block_fn, head_fn = paged_layered_fns(cfg, ffn, paged_kernel)
    x, cos, sin = stem_fn(params, tokens, start)
    quant = cache.k_scale is not None
    for l in range(cfg.n_layers):
        x = block_fn(_layer_leaves(params, l), x, cos, sin, cache.k[l],
                     cache.v[l], cache.table, start,
                     continuation=continuation, prefill=prefill,
                     kps=cache.k_scale[l] if quant else None,
                     vps=cache.v_scale[l] if quant else None)
    return head_fn(params, x), dataclasses.replace(cache,
                                                   seq_lens=start + T)
