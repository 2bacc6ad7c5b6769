"""Autoregressive generation: KV cache, prefill/decode split, sampling
(port of ``deepspeed_tpu/inference/generation.py``; ref:
deepspeed/inference/engine.py's generate path).

The dense cache is a static ``[L, B, max_seq, KV, Dh]`` pair written in
place (the JAX package returns a new one) with the valid length kept on
the host.  Prefill runs the whole prompt at once; decode steps one token
with masked attention up to the current length (:func:`cached_attention`,
plain PyTorch as in the JAX package, which writes it in ``jnp``).
Temperature-0 rows take the greedy kernel B6 on CUDA
(:func:`~deepspeed_tpu_torch.ops.sampling_cuda.fused_greedy_rows`), the
same function as ``jnp.argmax``: the first occurrence wins.  Sampling rows
draw from an explicit ``torch.Generator``; JAX's threefry keys have no
PyTorch twin, so only greedy output is held to identity.  The paged
generators run the serving forwards (``forward_paged``) over a
:class:`~deepspeed_tpu_torch.inference.kernels.PagedKVCache` with a static
page table.  Builders move ``params`` to ``device`` (None = CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch._tree import tree_map
from deepspeed_tpu_torch.ops.sampling_cuda import fused_greedy_rows


@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache; ``length`` = number of valid positions."""

    k: torch.Tensor          # [L, B, maxT, KV, Dh]
    v: torch.Tensor          # [L, B, maxT, KV, Dh]
    length: int = 0

    @classmethod
    def alloc(cls, n_layers: int, batch: int, max_seq: int, n_kv: int,
              head_dim: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (n_layers, batch, max_seq, n_kv, head_dim)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))


def cached_attention(q, k_cache, v_cache, new_k, new_v, start_pos: int,
                     scale: Optional[float] = None):
    """Attention of q against cache[:start_pos+T] (the reference's
    decode-attention contract: softmax(q @ K^T) @ V with the causal
    frontier at start_pos + local position).

    q: [B, T, H, Dh]; caches [B, maxT, KV, Dh] (one layer, written in
    place); new_k/v: [B, T, KV, Dh].  The write starts at ``start_pos``
    clamped into the cache, as ``lax.dynamic_update_slice`` clamps it.
    Returns (out [B, T, H, Dh], k_cache, v_cache)."""
    _, T, H, Dh = q.shape
    maxT, KV = k_cache.shape[1], k_cache.shape[2]
    at = min(max(int(start_pos), 0), maxT - T)
    k_cache[:, at:at + T] = new_k.to(k_cache.dtype)
    v_cache[:, at:at + T] = new_v.to(v_cache.dtype)
    k, v = k_cache, v_cache
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    scale = scale if scale is not None else Dh ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    kpos = torch.arange(maxT, device=q.device)
    qpos = int(start_pos) + torch.arange(T, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]                      # [T, maxT]
    scores = scores.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)
    return out, k_cache, v_cache


def sample_logits(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """logits: [B, V] -> token ids [B] int32.  temperature == 0 is greedy
    (B6 on CUDA); otherwise a categorical draw from ``generator`` after the
    top-k and top-p cuts."""
    if temperature == 0.0:
        return fused_greedy_rows(logits)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative prob >= top_p; cutoff logit value
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits,
                             float("inf")).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0].to(torch.int32)


class Generator:
    """Model-agnostic generation loop over a prefill and a decode step.

    prefill_fn(params, tokens, cache) -> (logits [B,T,V], cache)
    decode_fn(params, token [B,1], cache) -> (logits [B,1,V], cache)
    alloc_cache(batch, max_seq) -> cache
    """

    def __init__(self, params, prefill_fn, decode_fn, alloc_cache,
                 eos_token_id: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.params = params
        self._prefill = prefill_fn
        self._decode = decode_fn
        self._alloc = alloc_cache
        self.eos = eos_token_id

    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 rng: Optional[torch.Generator] = None,
                 max_seq: Optional[int] = None) -> torch.Tensor:
        """tokens: [B, T] prompt -> [B, T + max_new_tokens] int32
        (eos-padded)."""
        return generate_loop(
            self.params, self._prefill, self._decode, self._alloc, tokens,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, rng=rng, max_seq=max_seq, eos=self.eos,
            device=self.device)


def generate_loop(params, prefill, decode, alloc_cache, tokens,
                  max_new_tokens: int = 32, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0,
                  rng: Optional[torch.Generator] = None,
                  max_seq: Optional[int] = None, eos: Optional[int] = None,
                  device=None) -> torch.Tensor:
    """The host-side autoregressive loop: prefill once, then decode one
    token at a time, sampling on the device.  ``rng`` None draws from a
    generator seeded 0 on the device.

    Always returns ``[B, T + max_new_tokens]``: an early all-eos exit pads
    with eos, so callers see one shape wherever generation stopped.
    """
    dev = resolve_device(device)
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens, np.int32))
    tokens = tokens.to(device=dev, dtype=torch.int32)
    B, T = tokens.shape
    total = max_seq or (T + max_new_tokens)
    if T + max_new_tokens > total:
        # the cache write clamps its start (as dynamic_update_slice does),
        # so an overrun would corrupt the rollout instead of failing
        raise ValueError(
            f"prompt ({T}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"KV cache budget (max_seq={total}) — raise max_seq or shorten "
            "the prompt")
    if rng is None:
        rng = torch.Generator(device=dev)
        rng.manual_seed(0)
    with torch.inference_mode():
        cache = alloc_cache(B, total)
        logits, cache = prefill(params, tokens, cache)
        out = [tokens]
        next_tok = sample_logits(logits[:, -1], rng, temperature, top_k,
                                 top_p)[:, None]
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for produced in range(1, max_new_tokens + 1):
            out.append(next_tok)
            if eos is not None:
                done = done | (next_tok[:, 0] == eos)
                if produced < max_new_tokens and bool(done.all()):
                    out.append(torch.full((B, max_new_tokens - produced), eos,
                                          dtype=torch.int32, device=dev))
                    break
            if produced == max_new_tokens:
                break
            logits, cache = decode(params, next_tok, cache)
            nxt = sample_logits(logits[:, -1], rng, temperature, top_k,
                                top_p)[:, None]
            if eos is not None:
                nxt = torch.where(done[:, None], torch.full_like(nxt, eos),
                                  nxt)
            next_tok = nxt
        return torch.cat(out, dim=1)


def greedy_draft_fn(step, alloc_cache, window: int, k: int):
    """Greedy rollout for speculative drafting: ``(params, tokens [B,
    window]) -> drafts [B, k]`` int32: prefill the (left-padded) history
    window once, then ``k`` argmax decode steps feeding each token forward
    (the JAX package's ``lax.scan``, k steps, the last step's token
    unused)."""

    def rollout(params, tokens):
        with torch.inference_mode():
            cache = alloc_cache(tokens.shape[0], window + k)
            logits, cache = step(params, tokens, cache)
            tok = fused_greedy_rows(logits[:, -1])
            toks = []
            for _ in range(k):
                toks.append(tok)
                logits, cache = step(params, tok[:, None], cache)
                tok = fused_greedy_rows(logits[:, -1])
            return torch.stack(toks, dim=1)

    return rollout


def cached_step_alloc(forward_with_cache, cfg, cache_dtype=torch.bfloat16,
                      device=None):
    """The (step, alloc_cache) pair over any model's
    ``forward_with_cache(params, tokens, cfg, cache)``; the cache lives on
    ``device`` (None = CUDA)."""
    dev = resolve_device(device)

    def alloc(batch, max_seq):
        return KVCache.alloc(cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                             cfg.head_dim, dtype=cache_dtype, device=dev)

    def step(params, tokens, cache):
        return forward_with_cache(params, tokens, cfg, cache)

    return step, alloc


def _on(params: Any, device) -> Any:
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)


def llama_step_alloc(cfg, cache_dtype=torch.bfloat16, device=None):
    from deepspeed_tpu_torch.models import llama

    return cached_step_alloc(llama.forward_with_cache, cfg, cache_dtype,
                             device)


def llama_generator(params, cfg, eos_token_id: Optional[int] = None,
                    cache_dtype=torch.bfloat16, device=None) -> Generator:
    """A :class:`Generator` for models/llama.py weights."""
    step, alloc = llama_step_alloc(cfg, cache_dtype, device)
    return Generator(_on(params, device), step, step, alloc,
                     eos_token_id=eos_token_id, device=device)


def _position_checked(alloc, cfg):
    """``alloc`` that raises past GPT-2's learned position table: the
    forwards clamp positions into it, as JAX's gather does, so generating
    past it would silently reuse the last row (RoPE models have no table
    and need no check)."""
    def checked(batch, max_seq):
        if max_seq > cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens ({max_seq}) exceeds gpt2's "
                f"learned position table ({cfg.max_seq_len})")
        return alloc(batch, max_seq)

    return checked


def gpt2_generator(params, cfg, eos_token_id: Optional[int] = None,
                   cache_dtype=torch.bfloat16, device=None) -> Generator:
    """Cached-attention generation for models/gpt2.py weights."""
    from deepspeed_tpu_torch.models import gpt2

    step, alloc = cached_step_alloc(gpt2.forward_with_cache, cfg,
                                    cache_dtype, device)
    return Generator(_on(params, device), step, step,
                     _position_checked(alloc, cfg),
                     eos_token_id=eos_token_id, device=device)


def mixtral_generator(params, cfg, eos_token_id: Optional[int] = None,
                      cache_dtype=torch.bfloat16, device=None) -> Generator:
    """MoE text generation (ref: DeepSpeed-MoE inference): cached
    attention + the capacity-free dense top-k expert combine."""
    from deepspeed_tpu_torch.models import mixtral

    step, alloc = cached_step_alloc(mixtral.forward_with_cache, cfg,
                                    cache_dtype, device)
    return Generator(_on(params, device), step, step, alloc,
                     eos_token_id=eos_token_id, device=device)


def _paged_generator(forward_paged, params, cfg,
                     eos_token_id: Optional[int] = None,
                     page_size: int = 16, num_pages: Optional[int] = None,
                     cache_dtype=torch.bfloat16, device=None,
                     learned_positions: bool = False) -> Generator:
    """Paged-KV generator over any ``forward_paged(params, tokens, cfg,
    cache)``: row b owns pages ``b * max_pages ...`` (a static table).
    ``learned_positions``: the budget is checked against the model's
    position table (GPT-2)."""
    from deepspeed_tpu_torch.inference.kernels import PagedKVCache

    dev = resolve_device(device)

    def alloc(batch, max_seq):
        mp = -(-max_seq // page_size)
        n = num_pages if num_pages is not None else batch * mp
        return PagedKVCache.alloc(cfg.n_layers, cfg.n_kv_heads, n, page_size,
                                  cfg.head_dim, batch, max_seq,
                                  dtype=cache_dtype, device=dev)

    def step(params, tokens, cache):
        return forward_paged(params, tokens, cfg, cache)

    if learned_positions:
        alloc = _position_checked(alloc, cfg)
    return Generator(_on(params, dev), step, step, alloc,
                     eos_token_id=eos_token_id, device=dev)


def llama_paged_generator(params, cfg, **kw) -> Generator:
    """Paged-KV variant: decode reads only the live pages through the
    paged-attention kernel B5 on CUDA."""
    from deepspeed_tpu_torch.models import llama

    return _paged_generator(llama.forward_paged, params, cfg, **kw)


def mixtral_paged_generator(params, cfg, **kw) -> Generator:
    """Paged-KV MoE generation: the offline oracle for Mixtral serving."""
    from deepspeed_tpu_torch.models import mixtral

    return _paged_generator(mixtral.forward_paged, params, cfg, **kw)


def gpt2_paged_generator(params, cfg, **kw) -> Generator:
    """Paged-KV GPT-2 generation: the offline oracle for GPT-2 serving."""
    from deepspeed_tpu_torch.models import gpt2

    return _paged_generator(gpt2.forward_paged, params, cfg,
                            learned_positions=True, **kw)
