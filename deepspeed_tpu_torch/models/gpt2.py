"""GPT-2 family (port of ``deepspeed_tpu/models/gpt2.py``; ref: the
DeepSpeed Megatron-GPT2 example, module layout of
deepspeed/module_inject/containers/gpt2.py).

The layer stack of :mod:`deepspeed_tpu_torch.models.llama` with GPT-2's
parts: learned position embeddings (``wpe``), LayerNorm with bias, a fused
QKV projection with bias, a tanh-GELU MLP, and the head tied to ``wte``
(``f32_matmul(x, wte.T)``: bf16 operands on the card, an f32 result, no
f32 copy of the table; the transposed view goes to the product as it is).
Parameters keep the JAX pytree layout (``wte``, ``wpe``, stacked
``blocks`` leaves ``[L, in, out]``, ``lnf_w``, ``lnf_b``), so the weight
bridge is a plain copy.  Attention is full multi-head (``n_kv_heads ==
n_heads``): the flash kernels B1-B3 in training and prefill, the paged
kernels B5 (B7 on int8 pages) in serving.

Learned positions are a hard table.  JAX's gather clamps a position past
it, and the paged forward's continuation contract relies on that (a
speculative draft position past the table is scored on the last row and
then discarded by the host); an index past a CUDA table is a device-side
assert instead, so :func:`forward_with_cache` and :func:`forward_paged`
clamp explicitly, and the builders (serving, generators) raise
``ValueError`` before a real position can pass the table.

Tensor parallelism (:func:`param_specs`, JAX's tree): every forward takes
a tree whose leaves are this rank's blocks and decides from each leaf's
shape what it holds, as :mod:`~deepspeed_tpu_torch.models.llama` does.
``wte`` holds a block of its features: the lookup's rows are gathered
over ``model``, the tied head gathers the block whole (or reduces its
partial logits for a decode step's few rows), and the loss gathers it
once for both uses.  ``qkv_w`` / ``fc_w`` and their biases hold output
columns, ``proj_w`` / ``out_w`` input rows.  The fused QKV leaf's spec
is a :class:`~deepspeed_tpu_torch.topology.FusedSpec`: a rank holds
``[q_r | k_r | v_r]``, its own heads of each, and the gather puts the
leaf back in order.

Int8 weights: any leaf may be an int8
:class:`~deepspeed_tpu_torch.inference.quantized.QuantizedTensor`; the
forwards carry ``takes_quantized`` and dequantize one layer at a time
(``quantized.take``).  Where a leaf kept exact is wider than a dequantized
one (f32 ``wpe`` beside bf16 ``wte``), products run in the promoted dtype,
as ``jnp`` promotes them.
"""

from __future__ import annotations

import dataclasses

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.quantized import take, takes_quantized
from deepspeed_tpu_torch.ops.attention import flash_attention
from deepspeed_tpu_torch.ops.fused_ops import gelu, layer_norm
from deepspeed_tpu_torch.ops.losses import dense_lm_loss
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    col_input, row_output, tied_head_logits, whole_features)
from deepspeed_tpu_torch.remat import (check as check_remat,
                                       checkpoint_block, checkpoint_named)
from deepspeed_tpu_torch.topology import FusedSpec


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    remat: str = "none"

    def __post_init__(self):
        if self.dim % self.n_heads:
            raise ValueError(f"dim {self.dim} / n_heads {self.n_heads} do "
                             "not divide")
        check_remat(self.remat)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_kv_heads(self) -> int:
        return self.n_heads  # MHA: lets the shared cache builders apply

    @classmethod
    def gpt2_1_3b(cls, **kw):
        # the "GPT-2 1.3B" of the reference's ZeRO-2 benchmark
        return cls(dim=2048, n_layers=24, n_heads=16, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("dim", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("max_seq_len", 128)
        return cls(**kw)


def param_count(cfg: GPT2Config) -> int:
    d, L = cfg.dim, cfg.n_layers
    per_layer = (d * 3 * d + 3 * d) + (d * d + d) + \
        (d * 4 * d + 4 * d) + (4 * d * d + d) + 4 * d
    return int(L * per_layer + cfg.vocab_size * d
               + cfg.max_seq_len * d + 2 * d)


def param_specs(cfg: GPT2Config):
    """Tensor-parallel placements over ``model``, the tree of JAX
    ``param_specs``: ``wte`` on its feature dim, ``wpe`` replicated,
    ``qkv_w`` / ``fc_w`` and their biases column-parallel (the fused QKV
    leaves as :class:`~deepspeed_tpu_torch.topology.FusedSpec` of three
    parts), ``proj_w`` / ``out_w`` row-parallel, the norms and the other
    biases replicated."""
    col, row = (None, None, "model"), (None, "model", None)
    return {
        "wte": (None, "model"), "wpe": (),
        "blocks": {
            "ln1_w": (), "ln1_b": (),
            "qkv_w": FusedSpec(col, 3), "qkv_b": FusedSpec((None, "model"),
                                                           3),
            "proj_w": row, "proj_b": (),
            "ln2_w": (), "ln2_b": (),
            "fc_w": col, "fc_b": (None, "model"),
            "out_w": row, "out_b": (),
        },
        "lnf_w": (), "lnf_b": (),
    }


# ------------------------------------------------------------------- blocks
def _mm(x, w):
    """x @ w in the promoted dtype of the two (``jnp.matmul``'s rule; the
    casts are no-ops when the dtypes agree)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _qkv(cfg: GPT2Config, lp, x):
    """LayerNorm and the fused QKV product -> q, k, v [B, T, h, Dh], each
    contiguous (the flash kernels read them so); h is this rank's heads
    (all of them unless ``qkv_w`` holds its ``[q_r | k_r | v_r]``)."""
    B, T, _ = x.shape
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
    h = col_input(h, lp["qkv_w"], 3 * cfg.dim)
    qkv = _mm(h, lp["qkv_w"]) + lp["qkv_b"]
    return tuple(t.reshape(B, T, -1, cfg.head_dim).contiguous()
                 for t in qkv.split(qkv.shape[-1] // 3, dim=-1))


def _attn_out(cfg: GPT2Config, lp, x):
    """The block's attention context [B, T, h * Dh] (JAX's
    ``attn_out``)."""
    B, T, _ = x.shape
    q, k, v = _qkv(cfg, lp, x)
    return flash_attention(q, k, v, causal=True).reshape(B, T, -1)


def _mlp_out(cfg: GPT2Config, lp, x):
    """The MLP's GELU activation [B, T, 4d] (JAX's ``mlp_out``; this
    rank's features when ``fc_w`` holds a column block)."""
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
    h = col_input(h, lp["fc_w"], 4 * cfg.dim)
    return gelu(_mm(h, lp["fc_w"]) + lp["fc_b"])


def _block_tail(cfg: GPT2Config, lp, x, attn, remat: str = "none"):
    """The attention output's projection and residual, then the MLP and
    its residual; a row-parallel product's partial sums are reduced
    before its whole bias is added."""
    B, T, _ = x.shape
    x = x + row_output(_mm(attn.reshape(B, T, -1), lp["proj_w"]),
                       lp["proj_w"], cfg.dim) + lp["proj_b"]
    mlp = checkpoint_named(_mlp_out, remat)(cfg, lp, x)
    return x + row_output(_mm(mlp, lp["out_w"]), lp["out_w"],
                          4 * cfg.dim) + lp["out_b"]


def _block(cfg: GPT2Config, lp, x):
    """One transformer block; under ``save_attn`` / ``offload_attn`` its
    two named stages are checkpointed."""
    attn = checkpoint_named(_attn_out, cfg.remat)(cfg, lp, x)
    return _block_tail(cfg, lp, x, attn, cfg.remat)


def _layer(params, l: int):
    return {name: take(w, l) for name, w in params["blocks"].items()}


def _embed(params, tokens, positions):
    """Token plus position embeddings [B, T, d], the token rows' features
    gathered over ``model`` when ``wte`` holds a feature block."""
    x = take(params["wte"], tokens.long())
    wpe = take(params["wpe"], positions)
    if x.shape[-1] != wpe.shape[-1]:
        x = comm.gather_from(x, "model", -1)
    return x + wpe


def lm_head(params):
    """The tied head [d, V]: ``wte`` transposed, a view."""
    return take(params["wte"]).T


def _logits(params, cfg: GPT2Config, x):
    h = layer_norm(x, take(params["lnf_w"]), take(params["lnf_b"]),
                   cfg.norm_eps)
    return tied_head_logits(h, take(params["wte"]))


def _clamped(positions, cfg: GPT2Config):
    return positions.long().clamp(max=cfg.max_seq_len - 1)


# ----------------------------------------------------------------- forwards
@takes_quantized
def forward_hidden(params, tokens, cfg: GPT2Config):
    """tokens [B, T] int -> the final LayerNorm's output [B, T, d]."""
    T = tokens.shape[1]
    x = _embed(params, tokens, slice(0, T))
    block = checkpoint_block(_block, cfg.remat)
    for l in range(cfg.n_layers):
        x = block(cfg, _layer(params, l), x)
    return layer_norm(x, take(params["lnf_w"]), take(params["lnf_b"]),
                      cfg.norm_eps)


@takes_quantized
def forward(params, tokens, cfg: GPT2Config):
    """tokens [B, T] int -> logits [B, T, V] f32."""
    return tied_head_logits(forward_hidden(params, tokens, cfg),
                            take(params["wte"]))


@takes_quantized
def forward_with_cache(params, tokens, cfg: GPT2Config, cache):
    """Incremental forward for generation over a dense
    :class:`~deepspeed_tpu_torch.inference.generation.KVCache` (written in
    place): tokens [B, T] at positions ``cache.length ...`` -> (logits [B,
    T, V] f32, cache with ``length + T``)."""
    from deepspeed_tpu_torch.inference.generation import cached_attention

    T = tokens.shape[1]
    start = cache.length
    pos = start + torch.arange(T, device=tokens.device)
    x = _embed(params, tokens, _clamped(pos, cfg))
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(cfg, lp, x)
        attn, _, _ = cached_attention(q, cache.k[l], cache.v[l], k, v, start)
        x = _block_tail(cfg, lp, x, attn)
    return _logits(params, cfg, x), dataclasses.replace(cache,
                                                        length=start + T)


def loss_fn(cfg: GPT2Config):
    """Mean next-token NLL of ``batch["tokens"]`` [B, T+1] (the dense
    log-softmax over f32 logits, as the JAX loss)."""
    def f(params, batch):
        if "segment_ids" in batch:
            raise NotImplementedError(
                "packed segment_ids: use the llama family — GPT-2's "
                "learned absolute positions don't reset per document, "
                "so silently accepting the key would train wrong")
        tokens = batch["tokens"]
        # a feature block of wte is gathered whole once: the lookup and the
        # tied head then run as on one rank
        params = {**params, "wte": whole_features(params["wte"], cfg.dim)}
        x = forward_hidden(params, tokens[:, :-1], cfg)
        return dense_lm_loss(x.reshape(-1, cfg.dim), lm_head(params),
                             tokens[:, 1:].reshape(-1))

    return f


@takes_quantized
def forward_paged(params, tokens, cfg: GPT2Config, cache,
                  continuation: bool = False, paged_kernel=None):
    """Forward over a paged KV cache -> (logits [B, T, V] f32, cache), the
    contract of :func:`~deepspeed_tpu_torch.models.llama.forward_paged`
    (whole-prompt prefill through B1, chunked prefill with
    ``continuation=True`` and decode through B5, pages updated in place,
    int8-resident pages when ``cache.k_scale`` is set).  Each row's
    learned positions start at its own frontier; positions past the table
    clamp into its last row, as JAX's gather does."""
    from deepspeed_tpu_torch.inference.kernels import (
        paged_attention_step, paged_forward_prelude, resolve_serving_kernels)

    T = tokens.shape[1]
    ps, start, prefill = paged_forward_prelude(cache, tokens, continuation)
    paged_kernel = resolve_serving_kernels(
        {"paged_attention": paged_kernel or "auto"},
        device=cache.k.device).paged_attention
    positions = start[:, None] + torch.arange(
        T, dtype=torch.int32, device=start.device)[None]
    x = _embed(params, tokens, _clamped(positions, cfg))
    quant = cache.k_scale is not None
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(cfg, lp, x)
        attn = paged_attention_step(
            q, k, v, cache.k[l], cache.v[l], cache.table, start, ps,
            continuation=continuation, prefill=prefill,
            paged_kernel=paged_kernel,
            flash_force_reference=False,
            kps=cache.k_scale[l] if quant else None,
            vps=cache.v_scale[l] if quant else None)
        x = _block_tail(cfg, lp, x, attn)
    return _logits(params, cfg, x), dataclasses.replace(
        cache, seq_lens=start + T)
