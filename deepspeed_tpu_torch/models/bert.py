"""BERT encoder family (port of ``deepspeed_tpu/models/bert.py``; ref:
DeepSpeed's BingBertSquad / bert_pretrain examples and the encoder kernels
of deepspeed/ops/transformer).

The layer stack of :mod:`deepspeed_tpu_torch.models.gpt2` with BERT's
parts: bidirectional attention, learned position and token-type
embeddings, post-LN blocks (LayerNorm after each residual add) with a fused
QKV projection with bias and a tanh-GELU MLP, a [CLS] pooler, and the MLM
head (dense, GELU, LayerNorm, the decoder tied to ``embed`` through
``f32_matmul(h, embed.T)``: bf16 operands on the card, f32 logits).
Parameters keep the JAX pytree layout (``embed``, ``pos_embed``,
``type_embed``, ``embed_norm``, stacked ``blocks`` leaves ``[L, in, out]``,
``pooler``, ``mlm_dense``, ``mlm_norm``, ``mlm_bias``), so the weight bridge
is a plain copy.

Padding is masked through segment ids: the JAX model passes its
``attention_mask`` (1 real, 0 pad) as ``segment_ids`` to the attention, so
a real token sees the real tokens of its row and a pad token the pads.
Here that is the flash kernels B1-B3 with ``causal=False`` (the JAX model
calls ``reference_attention``, the same function as B1), or the plain
attention with ``attn_impl="reference"``.  With no mask every token sees
every token.

Tensor parallelism (:func:`param_specs`, JAX's tree): every forward takes
a tree whose leaves are this rank's blocks and decides from each leaf's
shape what it holds.  The three embedding tables hold a block of their
features (their sum is gathered over ``model`` before the embedding
LayerNorm, which needs the whole vector), ``wqkv`` / ``w_in`` and their
biases hold output columns (the fused QKV leaf a
:class:`~deepspeed_tpu_torch.topology.FusedSpec`: its columns run
``[3][heads][head_dim]`` and a rank holds its heads of each of the three),
``wo`` / ``w_out`` input rows, and the tied MLM decoder gathers the
``embed`` block whole (or reduces its partial logits for a few rows).

Int8 weights: any leaf may be an int8
:class:`~deepspeed_tpu_torch.inference.quantized.QuantizedTensor`; the
forwards carry ``takes_quantized`` and dequantize one layer at a time
(``quantized.take``).  Products run in the promoted dtype of their
operands, as ``jnp`` promotes them.
"""

from __future__ import annotations

import dataclasses

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.quantized import take, takes_quantized
from deepspeed_tpu_torch.models.gpt2 import _mm
# the encoder attends over the whole sequence on one rank: the sequence-
# parallel impls of the decoder are not its
ATTN_IMPLS = ("auto", "flash", "reference")
from deepspeed_tpu_torch.ops.attention import _reference, flash_attention
from deepspeed_tpu_torch.ops.fused_ops import gelu, gelu_mlp, layer_norm
from deepspeed_tpu_torch.ops.losses import _masked_mean
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    col_input, row_output, tied_head_logits)
from deepspeed_tpu_torch.remat import (check as check_remat,
                                       checkpoint_block, checkpoint_named)
from deepspeed_tpu_torch.topology import FusedSpec


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    remat: str = "none"
    attn_impl: str = "auto"                # auto | flash | reference

    def __post_init__(self):
        if self.dim % self.n_heads:
            raise ValueError(f"dim {self.dim} / n_heads {self.n_heads} do "
                             "not divide")
        if self.attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: the port serves "
                f"{'|'.join(ATTN_IMPLS)}; ring/ulysses split a decoder's "
                "sequence, and the reference's BERT has no sparse "
                "attention (only its Llama reaches it)")
        check_remat(self.remat)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        return cls(dim=1024, n_layers=24, n_heads=16, ffn_dim=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("dim", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("ffn_dim", 128)
        kw.setdefault("max_seq_len", 64)
        return cls(**kw)


def param_count(cfg: BertConfig) -> int:
    d, f, L, V = cfg.dim, cfg.ffn_dim, cfg.n_layers, cfg.vocab_size
    per_layer = (d * 3 * d + 3 * d) + (d * d + d) + (d * f + f) + \
        (f * d + d) + 4 * d
    heads = (d * d + d) * 2 + 2 * d + V
    return int(L * per_layer + (V + cfg.max_seq_len + cfg.type_vocab_size) * d
               + 2 * d + heads)


def param_specs(cfg: BertConfig):
    """Tensor-parallel placements over ``model``, the tree of JAX
    ``param_specs``: the three embedding tables on their feature dim,
    ``wqkv`` / ``w_in`` and their biases column-parallel (the fused QKV
    leaves as :class:`~deepspeed_tpu_torch.topology.FusedSpec` of three
    parts), ``wo`` / ``w_out`` row-parallel, the rest replicated."""
    col, row = (None, None, "model"), (None, "model", None)
    rep1, rep2 = (None,), (None, None)
    return {
        "embed": (None, "model"),
        "pos_embed": (None, "model"),
        "type_embed": (None, "model"),
        "embed_norm": {"scale": rep1, "bias": rep1},
        "blocks": {
            "wqkv": FusedSpec(col, 3), "bqkv": FusedSpec((None, "model"), 3),
            "wo": row, "bo": rep2,
            "attn_norm_scale": rep2, "attn_norm_bias": rep2,
            "w_in": col, "b_in": (None, "model"),
            "w_out": row, "b_out": rep2,
            "mlp_norm_scale": rep2, "mlp_norm_bias": rep2,
        },
        "pooler": {"w": rep2, "b": rep1},
        "mlm_dense": {"w": rep2, "b": rep1},
        "mlm_norm": {"scale": rep1, "bias": rep1},
        "mlm_bias": rep1,
    }


# ------------------------------------------------------------------- blocks
def _attention(cfg: BertConfig, q, k, v, attention_mask):
    if cfg.attn_impl == "reference":
        return _reference(q, k, v, causal=False, segment_ids=attention_mask)
    return flash_attention(q, k, v, causal=False,
                           segment_ids=attention_mask)


def _attn_out(cfg: BertConfig, lp, x, attention_mask):
    """The block's attention context [B, T, h * Dh] (JAX's ``attn_out``):
    the fused QKV product, then bidirectional attention within each row's
    mask id (q, k, v each contiguous: the flash kernels read them so); h
    is this rank's heads."""
    B, T, d = x.shape
    x = col_input(x, lp["wqkv"], 3 * cfg.dim)
    qkv = (_mm(x, lp["wqkv"]) + lp["bqkv"]).reshape(
        B, T, 3, -1, cfg.head_dim)
    q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    return _attention(cfg, q, k, v, attention_mask).reshape(B, T, -1)


def _mlp_out(cfg: BertConfig, lp, x):
    """The MLP's output [B, T, d] (JAX's ``mlp_out``); with ``w_in`` a
    column block the partial sums are reduced over ``model`` before the
    whole ``b_out`` is added."""
    dt = torch.promote_types(x.dtype, lp["w_in"].dtype)
    if lp["w_in"].shape[-1] == cfg.ffn_dim:
        return gelu_mlp(x.to(dt), lp["w_in"].to(dt), lp["b_in"],
                        lp["w_out"].to(dt), lp["b_out"])
    h = gelu(col_input(x.to(dt), lp["w_in"], cfg.ffn_dim)
             @ lp["w_in"].to(dt) + lp["b_in"])
    return row_output(h @ lp["w_out"].to(dt), lp["w_out"],
                      cfg.ffn_dim) + lp["b_out"]


def _block(cfg: BertConfig, lp, x, attention_mask):
    """One post-LN encoder block; under ``save_attn`` / ``offload_attn``
    its two named stages are checkpointed."""
    attn = checkpoint_named(_attn_out, cfg.remat)(cfg, lp, x,
                                                  attention_mask)
    x = layer_norm(x + row_output(_mm(attn, lp["wo"]), lp["wo"], cfg.dim)
                   + lp["bo"], lp["attn_norm_scale"], lp["attn_norm_bias"],
                   cfg.norm_eps)
    h = checkpoint_named(_mlp_out, cfg.remat)(cfg, lp, x)
    return layer_norm(x + h, lp["mlp_norm_scale"], lp["mlp_norm_bias"],
                      cfg.norm_eps)


def _layer(params, l: int):
    return {name: take(w, l) for name, w in params["blocks"].items()}


# ----------------------------------------------------------------- forwards
@takes_quantized
def forward(params, tokens, cfg: BertConfig, token_type_ids=None,
            attention_mask=None):
    """tokens [B, T] int -> hidden states [B, T, d].  ``attention_mask``
    [B, T] (1 real, 0 pad) confines each token to the tokens of its own
    id; ``token_type_ids`` [B, T] adds the type embedding."""
    T = tokens.shape[1]
    x = take(params["embed"], tokens.long()) + take(params["pos_embed"],
                                                     slice(0, T))
    if token_type_ids is not None:
        x = x + take(params["type_embed"], token_type_ids.long())
    if x.shape[-1] != cfg.dim:
        # feature blocks of the embedding sum: the LayerNorm reads the
        # whole vector
        x = comm.gather_from(x, "model", -1)
    x = layer_norm(x, take(params["embed_norm"]["scale"]),
                   take(params["embed_norm"]["bias"]), cfg.norm_eps)
    if attention_mask is not None:
        attention_mask = attention_mask.to(device=x.device,
                                           dtype=torch.int32)
    block = checkpoint_block(_block, cfg.remat)
    for l in range(cfg.n_layers):
        x = block(cfg, _layer(params, l), x, attention_mask)
    return x


@takes_quantized
def pooled_output(params, hidden):
    """[CLS] pooler (ref: BertPooler): tanh(dense(h[:, 0])) -> [B, d]."""
    return torch.tanh(_mm(hidden[:, 0], take(params["pooler"]["w"]))
                      + take(params["pooler"]["b"]))


@takes_quantized
def mlm_logits(params, hidden, cfg: BertConfig):
    """MLM head -> f32 logits [B, T, V]: dense, GELU, LayerNorm, then the
    decoder tied to ``embed`` (its transpose, a view) with an f32 result,
    plus ``mlm_bias``."""
    h = gelu(_mm(hidden, take(params["mlm_dense"]["w"]))
             + take(params["mlm_dense"]["b"]))
    h = layer_norm(h, take(params["mlm_norm"]["scale"]),
                   take(params["mlm_norm"]["bias"]), cfg.norm_eps)
    return (tied_head_logits(h, take(params["embed"]))
            + take(params["mlm_bias"]))


def loss_fn(cfg: BertConfig):
    """MLM cross-entropy: the mean NLL of the f32 logits over the positions
    with ``mlm_labels >= 0`` (-100 = unmasked), divided by max(count, 1);
    batch = {tokens, mlm_labels, (token_type_ids, attention_mask)}."""
    def f(params, batch):
        hidden = forward(params, batch["tokens"], cfg,
                         token_type_ids=batch.get("token_type_ids"),
                         attention_mask=batch.get("attention_mask"))
        logits = mlm_logits(params, hidden, cfg)
        labels = batch["mlm_labels"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        return _masked_mean(nll, labels >= 0)

    return f
