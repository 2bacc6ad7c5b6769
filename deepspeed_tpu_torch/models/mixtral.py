"""Mixtral-style MoE transformer (port of ``deepspeed_tpu/models/
mixtral.py``; ref: DeepSpeed's MoE training path, a Llama block whose FFN
is deepspeed.moe.layer.MoE with top-2 of N experts, a capacity factor and
load-balance + z losses, as Mixtral-8x7B-class configs instantiate it).

The attention half of each block is :mod:`~deepspeed_tpu_torch.models.
llama`'s (through :meth:`MixtralConfig.llama_view`).  Parameters keep the
JAX pytree layout: Llama's leaves plus a router ``gate`` ``[L, d, E]`` and
the expert FFNs stacked ``[L, E, in, out]`` (``w1``, ``w3``, ``w2``), so
the weight bridge is a plain copy.

Two MoE FFNs, as in the reference:

- training (:func:`forward`, :func:`loss_fn`): the capacity-limited top-k
  dispatch of :mod:`~deepspeed_tpu_torch.parallel.moe`; each layer's
  load-balance and z losses are summed over the layers and
  ``moe_expert_load`` is averaged over them, as JAX's scan carries them;
- inference (:func:`forward_eval`, :func:`forward_with_cache`,
  :func:`forward_paged`): the capacity-free dense top-k combine
  (:func:`_moe_ffn_dense`), where every expert evaluates every token and
  no token is dropped, the reference's eval contract.

Under ``remat="save_attn"`` / ``"offload_attn"`` the two named stages are
the attention context (``attn_out``) and the MoE output ``y`` (JAX's
``mlp_out`` here).  ``attn_out`` is kept (on the card, or in host memory)
for the ``wo`` product's backward; ``y`` feeds only the residual add,
whose backward reads nothing, so nothing keeps it, as JAX's remat keeps
only the named values its backward reads.  The expert products run
batched over E, so ``save_dots_no_batch`` keeps the router, dispatch and
combine products and recomputes the experts, as JAX's
``dots_with_no_batch_dims`` policy does under ``jax.vmap``.

Int8 weights: the forwards carry ``takes_quantized`` and dequantize one
layer at a time (:func:`~deepspeed_tpu_torch.inference.quantized.take`);
serving keeps the router exact.  ``paged_layered_fns`` factors the paged
forward per layer for weight-streamed serving, ``layered_model`` the
training step for the layer-streaming engine.

Sharding (:func:`param_specs`): attention and the experts' FFN features
split over ``model`` as Llama's do, the expert stacks over ``expert``
(``[L, E / ep, ...]`` a rank).  Training runs the expert-parallel capacity
layer of :mod:`~deepspeed_tpu_torch.parallel.moe` over the batch axes;
serving's dense combine runs each rank's experts on every token and sums
the partial combines over ``expert``, as XLA places the JAX package's
psum at the weighted combine.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.config import MoEConfig
from deepspeed_tpu_torch.inference.quantized import take, takes_quantized
from deepspeed_tpu_torch.models import llama as _llama
from deepspeed_tpu_torch.ops.fused_ops import rms_norm, swiglu
from deepspeed_tpu_torch.ops.losses import (chunked_lm_loss, dense_lm_loss,
                                            mean_denominator)
from deepspeed_tpu_torch.parallel.moe import MoELayer
from deepspeed_tpu_torch.parallel.tensor_parallel import (col_input,
                                                          row_output)
from deepspeed_tpu_torch.remat import (check as check_remat,
                                       checkpoint_block, checkpoint_named)

@dataclasses.dataclass
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    ffn_dim: Optional[int] = None
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.001
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    remat: str = "none"
    attn_impl: str = "auto"                # what LlamaConfig takes
    loss_chunk: int = 0

    def __post_init__(self):
        if self.ffn_dim is None:
            self.ffn_dim = int(math.ceil(self.dim * 8 / 3 / 128) * 128)
        check_remat(self.remat)
        self.llama_view()            # dims and attn_impl, as Llama checks

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def moe_config(self) -> MoEConfig:
        return MoEConfig(enabled=True, num_experts=self.num_experts,
                         top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         aux_loss_weight=self.aux_loss_weight,
                         z_loss_weight=self.z_loss_weight)

    def llama_view(self) -> _llama.LlamaConfig:
        """Attention/embedding hyperparams in LlamaConfig form (the
        attention path is shared with models/llama.py)."""
        return _llama.LlamaConfig(
            vocab_size=self.vocab_size, dim=self.dim, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            ffn_dim=self.ffn_dim, max_seq_len=self.max_seq_len,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            attn_impl=self.attn_impl)

    @classmethod
    def mixtral_8x7b(cls, **kw):
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, ffn_dim=14336, num_experts=8, top_k=2,
                   rope_theta=1e6, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("dim", 32)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("n_kv_heads", 2)
        kw.setdefault("num_experts", 4)
        kw.setdefault("max_seq_len", 64)
        return cls(**kw)


def param_count(cfg: MixtralConfig) -> int:
    d, f, L, E = cfg.dim, cfg.ffn_dim, cfg.n_layers, cfg.num_experts
    kvd = cfg.n_kv_heads * cfg.head_dim
    attn = (d * d) + (d * kvd) * 2 + (d * d)
    moe = E * (d * f) * 3 + d * E          # experts + gate
    per_layer = attn + moe + 2 * d
    return int(L * per_layer + 2 * cfg.vocab_size * d + d)


def param_specs(cfg: MixtralConfig):
    """Tensor parallelism over ``model`` for attention and the experts'
    FFN features, the experts over ``expert`` (``[L, E, in, out]`` ->
    ``(None, "expert", ...)``): the JAX ``param_specs`` tree."""
    col, row = (None, None, "model"), (None, "model", None)
    return {
        "embed": (None, "model"),
        "blocks": {
            "attn_norm": (None, None),
            "wq": col, "wk": col, "wv": col, "wo": row,
            "mlp_norm": (None, None),
            "gate": (None, None, None),
            "w1": (None, "expert", None, "model"),
            "w3": (None, "expert", None, "model"),
            "w2": (None, "expert", "model", None),
        },
        "final_norm": (None,),
        "lm_head": (None, "model"),
    }


def layered_model(cfg: MixtralConfig, params):
    """Factor a Mixtral tree for the layer-streaming engine, MoE under
    parameter offload (ref: ZeRO-Infinity param swapping composed with
    deepspeed.moe; the expert stacks dominate MoE param bytes).  Each block
    returns ``(x, aux)``: the capacity MoE's load-balance + z losses, which
    the engine adds to the total loss and back-propagates with cotangent 1,
    the fused train step's router gradients."""
    from deepspeed_tpu_torch.param_stream import LayeredModel

    lcfg = cfg.llama_view()

    def stem_fn(sp, batch):
        return sp["embed"][batch["tokens"][:, :-1].long()]

    def block_fn(lp, x):
        T = x.shape[1]
        cos, sin = _llama.rope_tables(lcfg, torch.arange(
            T, dtype=torch.int32, device=x.device))
        x = _attn_block(cfg, lcfg, x, lp, cos, sin)
        y, aux = _moe_ffn(cfg, rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp)
        return x + y, (aux["moe_aux_loss"] + aux["moe_z_loss"]).float()

    def head_fn(hp, x, batch):
        x = rms_norm(x, hp["final_norm"], cfg.norm_eps)
        return chunked_lm_loss(x, hp["lm_head"], batch["tokens"][:, 1:],
                               chunk=cfg.loss_chunk or cfg.vocab_size)

    return LayeredModel(
        stem_fn=stem_fn, block_fn=block_fn, head_fn=head_fn,
        stem={"embed": params["embed"]}, blocks=params["blocks"],
        head={"final_norm": params["final_norm"],
              "lm_head": params["lm_head"]},
        n_layers=cfg.n_layers, block_has_aux=True,
        assemble=_llama._assemble)


def paged_layered_fns(cfg: MixtralConfig, paged_kernel=None):
    """Per-layer factoring of :func:`forward_paged` for weight-streamed
    (ZeRO-Inference) MoE serving: Llama's ``(stem_fn, block_fn, head_fn)``
    (:func:`~deepspeed_tpu_torch.models.llama.paged_layered_fns`) with the
    capacity-free dense top-k expert combine as the FFN, so the expert
    stacks (the dominant MoE weight bytes) stream through a two-layer
    working set.  The router stays f32 and exact (the int8 builders never
    quantize ``gate``)."""
    return _llama.paged_layered_fns(cfg.llama_view(),
                                    ffn=functools.partial(_dense_ffn, cfg),
                                    paged_kernel=paged_kernel)


# ------------------------------------------------------------------ blocks
def _attn_block(cfg: MixtralConfig, lcfg, x, lp, cos, sin,
                segment_ids=None, remat: str = "none"):
    """The attention half of a Mixtral block (pre-norm attention and its
    residual), Llama's: the context (``attn_out``) is checkpointed as a
    named stage under ``save_attn`` / ``offload_attn``."""
    B, T, _ = x.shape
    attn = checkpoint_named(_llama._attn_out, remat)(
        lcfg, lp, x, cos, sin, segment_ids)
    return x + row_output(attn.reshape(B, T, -1) @ lp["wo"], lp["wo"],
                          cfg.n_heads * cfg.head_dim)


def _expert_fn(cfg: MixtralConfig, p, h):
    """The experts' SwiGLU FFN over stacked ``[E, ...]`` leaves and
    dispatched tokens ``h`` [E, C, d]: three products batched over E, the
    partial sums reduced over ``model`` when the leaves hold a block of
    the FFN features."""
    y = swiglu(col_input(h, p["w1"], cfg.ffn_dim), p["w1"], p["w3"]) \
        @ p["w2"]
    return row_output(y, p["w2"], cfg.ffn_dim)


def _moe_ffn(cfg: MixtralConfig, x, lp):
    """x: [B, T, d] -> (y, aux) via the capacity-limited top-k dispatch
    (expert-parallel over the current mesh's batch axes)."""
    from deepspeed_tpu_torch.topology import current_mesh

    layer = MoELayer(cfg=cfg.moe_config(),
                     expert_fn=functools.partial(_expert_fn, cfg),
                     mesh=current_mesh())
    eparams = {"w1": lp["w1"], "w3": lp["w3"], "w2": lp["w2"]}
    return layer(lp["gate"], eparams, x)


def _moe_out(cfg: MixtralConfig, lp, x):
    """The MoE stage: ``mlp_norm``, then the capacity MoE -> (y [B, T, d]
    (JAX's ``mlp_out``), aux)."""
    return _moe_ffn(cfg, rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp)


def _block(cfg: MixtralConfig, lcfg, lp, x, cos, sin, segment_ids):
    """One training block -> (x, this layer's aux)."""
    x = _attn_block(cfg, lcfg, x, lp, cos, sin, segment_ids, cfg.remat)
    y, aux = checkpoint_named(_moe_out, cfg.remat)(cfg, lp, x)
    return x + y, aux


def _top_k(logits, k: int):
    """Indices [N, k] of the k largest logits, largest first and, among
    equal values, the lower index first (``jax.lax.top_k``'s order): k
    first-occurrence argmaxes, each earlier choice masked to -inf."""
    picks = []
    for _ in range(k):
        i = torch.argmax(logits, dim=-1)
        picks.append(i)
        logits = logits.scatter(-1, i[:, None], float("-inf"))
    return torch.stack(picks, dim=-1)


def _moe_ffn_dense(cfg: MixtralConfig, x, lp):
    """Capacity-free exact top-k MoE for the inference path (ref:
    DeepSpeed-MoE inference, deepspeed/moe/sharded_moe.py at eval): every
    expert evaluates every token and the outputs combine by the
    renormalised top-k router probabilities, so no token is dropped.  The
    router runs in f32; the expert outputs ``ys`` [E, N, d] stay in x's
    dtype, the combine runs in f32 and the result is cast back, JAX's
    dtype chain step for step.  Expert leaves that hold this rank's
    ``E / ep`` experts combine only theirs and the partial combines are
    summed over ``expert``; FFN features split over ``model`` reduce
    there."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    h = x.reshape(-1, d)
    # router math in f32 like the training gate: bf16 logits could flip a
    # near-tied top-k choice and diverge from the trained routing
    logits = h.float() @ lp["gate"].float()
    probs = torch.softmax(logits, dim=-1)
    topi = _top_k(logits, k)                                    # [N, k]
    w = probs.gather(-1, topi)
    if k > 1:
        # same renormalization as the training gate (top2gating)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    ys = _expert_fn(cfg, lp, h)                                 # [E, N, d]
    wfull = torch.zeros((h.shape[0], E), dtype=w.dtype,
                        device=w.device).scatter(-1, topi, w)   # [N, E]
    el = lp["w1"].shape[0]
    if el != E:
        e0 = comm.rank_in("expert") * el
        y = comm.reduce_from(torch.einsum(
            "ne,end->nd", wfull[:, e0:e0 + el], ys.to(w.dtype)), "expert")
    else:
        y = torch.einsum("ne,end->nd", wfull, ys.to(w.dtype))
    return y.reshape(B, T, d).to(x.dtype)


def _dense_ffn(cfg: MixtralConfig, lp, h):
    return _moe_ffn_dense(cfg, h, lp)


def _rope(cfg: MixtralConfig, lcfg, tokens, positions):
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    return _llama.rope_tables(lcfg, positions)


# ----------------------------------------------------------------- forwards
@takes_quantized
def forward_hidden(params, tokens, cfg: MixtralConfig, positions=None,
                   segment_ids=None):
    """tokens [B, T] int -> (final-norm hidden states [B, T, d], aux): the
    capacity MoE in every block (training semantics), each block under
    ``cfg.remat``.  aux: ``moe_aux_loss`` and ``moe_z_loss`` summed over
    the layers, ``moe_expert_load`` [E] averaged over them."""
    lcfg = cfg.llama_view()
    x = _llama._embed(params, tokens, cfg)
    cos, sin = _rope(cfg, lcfg, tokens, positions)
    dev = x.device
    aux = {"moe_aux_loss": torch.zeros((), dtype=torch.float32, device=dev),
           "moe_z_loss": torch.zeros((), dtype=torch.float32, device=dev),
           "moe_expert_load": torch.zeros((cfg.num_experts,),
                                          dtype=torch.float32, device=dev)}
    block = checkpoint_block(_block, cfg.remat)
    for l in range(_llama._n_layers(params)):
        x, a = block(cfg, lcfg, _llama._layer(params, l), x, cos, sin,
                     segment_ids)
        aux = {"moe_aux_loss": aux["moe_aux_loss"] + a["moe_aux_loss"],
               "moe_z_loss": aux["moe_z_loss"] + a["moe_z_loss"],
               "moe_expert_load": aux["moe_expert_load"]
               + a["moe_expert_load"] / cfg.n_layers}
    return rms_norm(x, take(params["final_norm"]), cfg.norm_eps), aux


@takes_quantized
def forward(params, tokens, cfg: MixtralConfig, positions=None,
            segment_ids=None):
    """tokens: [B, T] -> (logits [B, T, V] f32, aux_losses dict).
    segment_ids: optional [B, T] packed-document isolation (Llama's
    contract)."""
    h, aux = forward_hidden(params, tokens, cfg, positions=positions,
                            segment_ids=segment_ids)
    return _llama._head_logits(params, cfg.llama_view(), h), aux


@takes_quantized
def forward_eval(params, tokens, cfg: MixtralConfig, positions=None):
    """Cache-free inference forward: the training attention path with the
    capacity-free dense MoE combine (no token drops), the reference's
    eval-mode contract.  tokens [B, T] -> logits [B, T, V] f32."""
    lcfg = cfg.llama_view()
    x = _llama._embed(params, tokens, cfg)
    cos, sin = _rope(cfg, lcfg, tokens, positions)
    for l in range(cfg.n_layers):
        lp = _llama._layer(params, l)
        x = _attn_block(cfg, lcfg, x, lp, cos, sin)
        x = x + _moe_ffn_dense(cfg, rms_norm(x, lp["mlp_norm"], cfg.norm_eps),
                               lp)
    return _llama._logits(params, lcfg, x)


@takes_quantized
def forward_with_cache(params, tokens, cfg: MixtralConfig, cache):
    """Incremental MoE forward for generation over a dense
    :class:`~deepspeed_tpu_torch.inference.generation.KVCache` (written in
    place): Llama's cached attention and the dense top-k expert combine.
    tokens [B, T] -> (logits [B, T, V] f32, cache with ``length + T``)."""
    from deepspeed_tpu_torch.inference.generation import cached_attention

    lcfg = cfg.llama_view()
    T = tokens.shape[1]
    start = cache.length
    x = _llama._embed(params, tokens, cfg)
    cos, sin = _llama.rope_tables(lcfg, start + torch.arange(
        T, dtype=torch.int32, device=tokens.device))
    ffn = functools.partial(_dense_ffn, cfg)
    for l in range(cfg.n_layers):
        lp = _llama._layer(params, l)
        q, k, v = _llama._qkv(lcfg, lp, x, cos, sin)
        attn, _, _ = cached_attention(q, cache.k[l], cache.v[l], k, v, start)
        x = _llama._block_tail(lcfg, lp, x, attn, ffn=ffn)
    return _llama._logits(params, lcfg, x), dataclasses.replace(
        cache, length=start + T)


@takes_quantized
def forward_paged(params, tokens, cfg: MixtralConfig, cache,
                  continuation: bool = False,
                  paged_kernel: Optional[str] = None):
    """Paged-KV MoE forward for continuous-batching serving: Llama's
    paged-attention backbone (page writes, B1 prefill, B5 chunks and
    decode, ragged frontiers) with the dense top-k expert combine as the
    FFN, so every serving feature works for MoE unchanged.  tokens [B, T]
    -> (logits [B, T, V] f32, cache)."""
    return _llama.forward_paged(
        params, tokens, cfg.llama_view(), cache, continuation=continuation,
        paged_kernel=paged_kernel, ffn=functools.partial(_dense_ffn, cfg))


def loss_fn(cfg: MixtralConfig):
    """Next-token CE + MoE aux losses over ``batch = {tokens, (loss_mask),
    (segment_ids)}`` (Llama's contract: [B, T+1] segment ids aligned with
    the tokens) -> (lm + aux + z, {"lm_loss", "moe_aux_loss",
    "moe_z_loss", "moe_expert_load"}).  Padding tokens (segment id 0)
    still feed the router and use expert capacity, as in the reference."""

    def f(params, batch):
        tokens = batch["tokens"]
        seg = batch.get("segment_ids")
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:].float()
        if seg is not None:
            doc = _llama.packed_doc_mask(seg)
            mask = doc if mask is None else mask * doc
            seg = seg[:, :-1]
        h, aux = forward_hidden(params, tokens[:, :-1], cfg,
                                segment_ids=seg)
        lcfg = cfg.llama_view()
        head = _llama.lm_head(params, lcfg)
        if head.shape[-1] != cfg.vocab_size:
            # a vocabulary block a rank: the vocab-parallel loss
            total, count = _llama._loss_sum(params, lcfg, h, tokens[:, 1:],
                                            mask)
            lm = total / mean_denominator(count)
        else:
            lm = dense_lm_loss(h.reshape(-1, cfg.dim), head,
                               tokens[:, 1:].reshape(-1),
                               None if mask is None else mask.reshape(-1))
        total = lm + aux["moe_aux_loss"] + aux["moe_z_loss"]
        return total, {"lm_loss": lm, **aux}

    return f
