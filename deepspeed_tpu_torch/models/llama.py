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

Model parallelism (:func:`param_specs`): every forward takes a tree whose
leaves are this rank's blocks and decides from each leaf's shape what it
holds, so a whole tree runs beside a sharded one.  Under tensor
parallelism (``model``) q/k/v, ``w1``/``w3`` and the LM head hold this
rank's output columns (heads, FFN features, vocabulary) and ``wo``/``w2``
its input rows; the Megatron mappings of :mod:`~deepspeed_tpu_torch.
parallel.tensor_parallel` reduce the partial sums and gather the embedding
features and the logits.  Under sequence parallelism (``seq`` with
``attn_impl`` ring or ulysses) :func:`loss_fn` gives each rank ``T / sp``
consecutive positions through the whole block stack (DeepSpeed-Ulysses'
layout), its RoPE positions starting at ``rank * T / sp``, and the loss is
the global token mean.  With ``n_micro`` and a ``pipe`` axis the blocks
(this stage's ``L / S`` layers) run as a pipeline
(:func:`~deepspeed_tpu_torch.parallel.pipeline.pipelined_scan`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.quantized import take, takes_quantized
from deepspeed_tpu_torch.ops.attention import _reference, flash_attention
from deepspeed_tpu_torch.ops.fused_ops import rms_norm, swiglu
from deepspeed_tpu_torch.ops.losses import (chunked_lm_loss, f32_matmul,
                                            lm_loss_sum, mean_denominator)
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    col_input, row_output, vocab_parallel_nll_sum)
from deepspeed_tpu_torch.remat import (check as check_remat,
                                       checkpoint_block, checkpoint_named)
from deepspeed_tpu_torch.topology import current_mesh

ATTN_IMPLS = ("auto", "flash", "reference", "ring", "ulysses", "sparse")


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
    # attn_impl="sparse": block-sparse attention from this dict ({"mode":
    # ..., "block": ..., ...}; see ops/sparse_attention.
    # sparsity_config_from_dict)
    sparse_config: Optional[Dict[str, Any]] = None
    attn_impl: str = "auto"                # auto | flash | reference | ...

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
                f"{'|'.join(ATTN_IMPLS)}")
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


def param_specs(cfg: LlamaConfig, pipeline: bool = False):
    """Tensor-parallel placements over the ``model`` axis (Megatron's
    layout: q/k/v and ``w1``/``w3`` column-parallel, ``wo``/``w2``
    row-parallel, the embedding on its feature dim, the LM head on its
    vocabulary), the tree of JAX ``param_specs``.  Dim 0 of the block
    leaves is the stacked layer axis: ``pipeline=True`` splits it over
    ``pipe`` (stage partitioning)."""
    col, row = (None, None, "model"), (None, "model", None)
    specs = {
        "embed": (None, "model"),
        "blocks": {
            "attn_norm": (None, None),
            "wq": col, "wk": col, "wv": col, "wo": row,
            "mlp_norm": (None, None),
            "w1": col, "w3": col, "w2": row,
        },
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "model")
    if pipeline:
        from deepspeed_tpu_torch.parallel.pipeline import stage_spec

        specs["blocks"] = {k: stage_spec(v)
                           for k, v in specs["blocks"].items()}
    return specs


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


def _seq_parallel(cfg: LlamaConfig) -> int:
    """The ``seq`` axis size this config's attention splits the sequence
    over (1: none)."""
    ms = current_mesh()
    sp = 1 if ms is None else ms.size("seq")
    if sp > 1 and cfg.attn_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"a seq axis of {sp} needs attn_impl ring or ulysses, got "
            f"{cfg.attn_impl!r}")
    return sp if cfg.attn_impl in ("ring", "ulysses") else 1


_SPARSE_CACHE: dict = {}


def _sparse_self_attention(cfg: LlamaConfig):
    """The per-config :class:`~deepspeed_tpu_torch.ops.sparse_attention.
    SparseSelfAttention` (it caches each sequence length's layout, so the
    O(H nb^2) host-side build runs once)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        SparseSelfAttention, sparsity_config_from_dict)

    norm = tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in (cfg.sparse_config or {}).items()))
    key = (cfg.n_heads, norm)
    sa = _SPARSE_CACHE.get(key)
    if sa is None:
        sc = sparsity_config_from_dict(
            cfg.sparse_config or {}, cfg.n_heads,
            attention="unidirectional")               # causal LM default
        sa = _SPARSE_CACHE[key] = SparseSelfAttention(sc, causal=True)
    return sa


def _sparse(q, k, v, cfg: LlamaConfig, segment_ids=None):
    """Block-sparse causal attention, k/v heads repeated for GQA; under
    tensor parallelism q holds this rank's heads and reads their rows of
    the layout."""
    sa = _sparse_self_attention(cfg)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    h = q.shape[2]
    heads = None
    if h != cfg.n_heads:
        m = comm.rank_in("model")
        heads = slice(m * h, (m + 1) * h)
    out = sa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             segment_ids=segment_ids, heads=heads)
    return out.transpose(1, 2)


def _attention(q, k, v, cfg: LlamaConfig, segment_ids=None):
    """q: [B,T,H,Dh], k/v: [B,T,KV,Dh] -> [B,T,H,Dh] (causal).  Under
    ring / ulysses with a ``seq`` axis, q/k/v are this rank's positions."""
    impl = cfg.attn_impl
    if impl == "sparse":
        return _sparse(q, k, v, cfg, segment_ids)
    if impl in ("ring", "ulysses") and _seq_parallel(cfg) > 1:
        if impl == "ring":
            from deepspeed_tpu_torch.parallel.ring_attention import (
                ring_attention_sharded)

            return ring_attention_sharded(q, k, v, causal=True,
                                          segment_ids=segment_ids)
        from deepspeed_tpu_torch.parallel.sequence_parallel import (
            ulysses_attention_sharded)

        return ulysses_attention_sharded(q, k, v, causal=True,
                                         segment_ids=segment_ids)
    if impl == "reference":
        return _reference(q, k, v, causal=True, segment_ids=segment_ids)
    return flash_attention(q, k, v, causal=True, segment_ids=segment_ids)


def _qkv(cfg: LlamaConfig, lp, x, cos, sin):
    """q [B, T, h, Dh], k / v [B, T, kv, Dh]: h and kv are this rank's
    heads (all of them unless ``wq`` / ``wk`` hold a column block)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    h = col_input(h, lp["wq"], cfg.n_heads * hd)
    q = apply_rope((h @ lp["wq"]).reshape(B, T, -1, hd), cos, sin)
    k = apply_rope((h @ lp["wk"]).reshape(B, T, -1, hd), cos, sin)
    v = (h @ lp["wv"]).reshape(B, T, -1, hd)
    return q, k, v


def _attn_out(cfg: LlamaConfig, lp, x, cos, sin, segment_ids):
    """The block's attention context [B, T, h * Dh] (JAX's ``attn_out``)."""
    B, T, _ = x.shape
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    return _attention(q, k, v, cfg, segment_ids).reshape(B, T, -1)


def _mlp_out(cfg: LlamaConfig, lp, x):
    """The FFN inner activation [B, T, ffn] (JAX's ``mlp_out``; this
    rank's features when ``w1`` holds a column block)."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return swiglu(col_input(h, lp["w1"], cfg.ffn_dim), lp["w1"], lp["w3"])


def _block_tail(cfg: LlamaConfig, lp, x, attn, remat: str = "none",
                ffn=None):
    """The attention output's projection and residual, then the FFN and
    its residual; ``ffn``: an ``(lp, h) -> y`` override of the FFN over the
    ``mlp_norm``-normed residual (Mixtral's expert combine)."""
    B, T, _ = x.shape
    x = x + row_output(attn.reshape(B, T, -1) @ lp["wo"], lp["wo"],
                       cfg.n_heads * cfg.head_dim)
    if ffn is not None:
        return x + ffn(lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    mlp = checkpoint_named(_mlp_out, remat)(cfg, lp, x)
    return x + row_output(mlp @ lp["w2"], lp["w2"], cfg.ffn_dim)


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


def _n_layers(params) -> int:
    """The layers this rank's stacked blocks hold (``L / S`` on a pipeline
    stage)."""
    return int(params["blocks"]["attn_norm"].shape[0])


def _embed(params, tokens, cfg):
    """The token embeddings [B, T, d], the features gathered over
    ``model`` when the table holds this rank's feature block."""
    x = take(params["embed"], tokens.long())
    return comm.gather_from(x, "model", -1) if x.shape[-1] != cfg.dim else x


def lm_head(params, cfg: LlamaConfig):
    if cfg.tie_embeddings:
        return take(params["embed"]).T
    return take(params["lm_head"])


def _head_logits(params, cfg: LlamaConfig, h):
    """f32 logits [..., V], gathered over ``model`` when the head holds a
    vocabulary block (a tied head split on its features reduces the
    partial products instead)."""
    head = lm_head(params, cfg)
    if cfg.tie_embeddings and head.shape[0] != cfg.dim:
        return comm.reduce_from(f32_matmul(
            comm.scatter_to(h, "model", -1), head), "model")
    if head.shape[-1] != cfg.vocab_size:
        return comm.gather_from(f32_matmul(comm.copy_to(h, "model"), head),
                                "model", -1)
    return f32_matmul(h, head)


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
    its scanned block in ``jax.checkpoint``.  ``n_micro`` with a ``pipe``
    axis on the current mesh runs the blocks as a pipeline of ``n_micro``
    microbatches, the stage body under ``cfg.remat``; without one it is
    ignored, as in the JAX package."""
    T = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    cos, sin = rope_tables(cfg, positions)
    ms = current_mesh()
    if n_micro and ms is not None and ms.size("pipe") > 1:
        if segment_ids is not None:
            raise NotImplementedError(
                "packed segment_ids are not supported with pipeline-"
                "parallel microbatching (as in the JAX package): pipeline "
                "the batch without packing, or drop the pipe axis")
        from deepspeed_tpu_torch.parallel.pipeline import pipelined_scan

        def block_fn(x, lp):
            return _block(cfg, {k: take(w) for k, w in lp.items()}, x, cos,
                          sin, None)

        x = pipelined_scan(block_fn, params["blocks"], x, n_micro, ms,
                           remat=cfg.remat)
    else:
        block = checkpoint_block(_block, cfg.remat)
        for l in range(_n_layers(params)):
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
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(cfg, start + torch.arange(
        T, dtype=torch.int32, device=tokens.device))
    for l in range(_n_layers(params)):
        lp = _layer(params, l)
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        attn, _, _ = cached_attention(q, cache.k[l], cache.v[l], k, v, start)
        x = _block_tail(cfg, lp, x, attn)
    return _logits(params, cfg, x), dataclasses.replace(cache,
                                                        length=start + T)


def _loss_sum(params, cfg, x, targets, mask):
    """(NLL sum, count) over ``x``'s rows: a head holding this rank's
    vocabulary block takes the vocab-parallel loss (the logits never
    gathered), any other head the whole logits."""
    head = lm_head(params, cfg)
    if not cfg.tie_embeddings and head.shape[-1] != cfg.vocab_size:
        return vocab_parallel_nll_sum(
            f32_matmul(comm.copy_to(x, "model"), head), targets, mask)
    return lm_loss_sum(_head_logits(params, cfg, x), targets, mask)


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
    chunked-vocab loss, 0 the dense one; a head that holds this rank's
    vocabulary block takes the vocab-parallel loss (Megatron's: the
    logits are never gathered).

    ``n_micro``: pipeline microbatches (see :func:`forward_hidden`); set it
    to ``gradient_accumulation_steps`` with ``pipeline.stages`` > 1, and
    the engine feeds the whole batch in one call (DeepSpeed's
    PipelineEngine.train_batch contract).  Under sequence parallelism each
    rank of ``seq`` runs its ``T / sp`` positions and the loss is the mean
    over every rank's tokens (the sum all-reduced, whose backward leaves
    each rank its own share)."""

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
        inp, targets = tokens[:, :-1], tokens[:, 1:]
        sp = _seq_parallel(cfg)
        positions = None
        if sp > 1:
            T = inp.shape[1]
            if T % sp:
                raise ValueError(f"sequence length {T} does not split over "
                                 f"seq = {sp}")
            n = T // sp
            lo = comm.rank_in("seq") * n
            cut = slice(lo, lo + n)
            inp, targets = inp[:, cut], targets[:, cut]
            mask = None if mask is None else mask[:, cut]
            seg = None if seg is None else seg[:, cut]
            positions = torch.arange(lo, lo + n, dtype=torch.int32,
                                     device=tokens.device)
        x = forward_hidden(params, inp, cfg, positions=positions,
                           segment_ids=seg, n_micro=n_micro)
        head = lm_head(params, cfg)
        if sp == 1 and head.shape[-1] == cfg.vocab_size \
                and head.shape[0] == cfg.dim:
            return chunked_lm_loss(x, head, targets, mask=mask,
                                   chunk=cfg.loss_chunk or cfg.vocab_size)
        total, count = _loss_sum(params, cfg, x, targets, mask)
        if sp > 1:
            total = comm.reduce_from(total, "seq")
            count = comm.all_reduce(count, "seq")
        return total / mean_denominator(count)

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
        return _embed(sp, batch["tokens"][:, :-1], cfg)

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
        if hp["lm_head"].shape[-1] != cfg.vocab_size:
            # this rank's vocabulary block: the vocab-parallel loss
            total, count = vocab_parallel_nll_sum(
                f32_matmul(comm.copy_to(x, "model"), hp["lm_head"]),
                tokens[:, 1:], mask)
            return total / mean_denominator(count)
        return chunked_lm_loss(x, hp["lm_head"], tokens[:, 1:], mask=mask,
                               chunk=cfg.loss_chunk or cfg.vocab_size)

    return LayeredModel(
        stem_fn=stem_fn, block_fn=block_fn, head_fn=head_fn,
        stem={"embed": params["embed"]}, blocks=params["blocks"],
        head={"final_norm": params["final_norm"],
              "lm_head": params["lm_head"]},
        n_layers=cfg.n_layers, assemble=_assemble,
        # the param factoring's split: param_specs(cfg) ride into the
        # streaming engine per layer
        factor_specs=lambda specs: (
            {"embed": specs["embed"]}, specs["blocks"],
            {"final_norm": specs["final_norm"],
             "lm_head": specs["lm_head"]}))


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
        x = _embed(sp, tokens, cfg)
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
