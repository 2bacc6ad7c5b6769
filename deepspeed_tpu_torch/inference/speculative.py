"""Speculative decoding for the paged-KV serving path: draft-and-verify
multi-token generation that amortizes each model sweep (and, under
ZeRO-Inference, each full layer-weight stream) over several tokens (port
of ``deepspeed_tpu/inference/speculative.py``; ref: speculative sampling,
arXiv:2302.01318, and prompt-lookup decoding, applied to the memory-wall
analysis of ZeRO-Inference, arXiv:2206.01861).

- :class:`Drafter`: the proposal interface.  Drafters propose
  DETERMINISTICALLY (greedy), which makes the temperature > 0 acceptance
  below exact with point-mass math, for any drafter.
- :class:`NgramDrafter`: zero-weight prompt lookup over the request's own
  history, self-extending over its own draft (host only).
- :class:`ModelDrafter`: a resident small draft model rolled out greedily
  over a fixed tail window, through the family's cached forward
  (:func:`~deepspeed_tpu_torch.inference.generation.greedy_draft_fn`).
- :func:`verify_accept`: the acceptance on the device: from the verify
  pass's logits at all K + 1 positions, each row's longest accepted draft
  prefix and the token to emit at every possible stop position, so the
  host needs one transfer per sweep.

Exactness: greedy rows accept draft ``d_j`` iff it equals the target's
first-occurrence argmax at its position, so the emitted sequence is the
sequential greedy decode token for token (given the same logits).
Temperature rows accept ``d_j`` with probability ``p_j(d_j)`` and on
rejection sample ``p_j`` with ``d_j``'s mass removed, which reproduces the
target distribution; rows whose drafts ran out sample the full ``p_j``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.config import SpeculativeConfig


# ------------------------------------------------------------- drafters
class Drafter:
    """Proposal interface for speculative decoding.

    ``propose(tokens, k)`` sees the request's full history (prompt +
    generated so far) and returns up to ``k`` draft tokens (possibly
    ``[]``: that row rides the verify sweep as a plain decode step).
    Proposals must be DETERMINISTIC given the history (the temperature
    acceptance treats them as a point mass) and valid vocab ids."""

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup / n-gram drafter: zero weights, zero device work.

    The draft is the continuation that followed the most recent earlier
    occurrence of the sequence's own suffix n-gram, longest n first
    (``max_ngram`` down to ``min_ngram``), SELF-EXTENDING: when the
    matched continuation runs into the end of the history, matching
    restarts over history + draft-so-far until ``k`` tokens are drafted or
    nothing matches, so a period-``p`` loop drafts the full window.  The
    scan looks back at most ``lookback`` tokens."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 lookback: int = 512):
        if not 1 <= int(min_ngram) <= int(max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram} max_ngram={max_ngram}")
        if int(lookback) < 1:
            raise ValueError(f"lookback must be >= 1, got {lookback}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.lookback = int(lookback)

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        out: List[int] = []
        ext = list(tokens)
        while len(out) < k:
            got = self._match_once(ext, k - len(out))
            if not got:
                break
            out.extend(got)
            ext.extend(got)
        return out

    def _match_once(self, tokens: List[int], k: int) -> List[int]:
        tokens = tokens[-self.lookback:]
        T = len(tokens)
        if k <= 0 or T < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, T - 1), self.min_ngram - 1,
                       -1):
            tail = tokens[-n:]
            # most recent EARLIER occurrence (j + n <= T - 1: never the
            # suffix itself, and the continuation is non-empty)
            for j in range(T - n - 1, -1, -1):
                if tokens[j:j + n] == tail:
                    return tokens[j + n:j + n + k]
        return []


class ModelDrafter(Drafter):
    """Resident small-model drafter: greedy ``k``-token rollout of a draft
    model over the tail of the history, through the model family's cached
    forward (the step the generators run).  The tail is LEFT-padded to a
    fixed ``window``; padding can only degrade draft quality, never
    correctness (a rejected draft costs a rolled-back KV write).  One
    rollout and one device fetch per slot per sweep.  ``device`` holds the
    rollout's cache (None = CUDA); ``cache_dtype`` its dtype (bf16, as the
    JAX drafter's)."""

    def __init__(self, params, cfg, draft_tokens: int = 4,
                 window: int = 64, device=None,
                 cache_dtype=torch.bfloat16):
        from deepspeed_tpu_torch._device import resolve_device
        from deepspeed_tpu_torch.inference.generation import (
            cached_step_alloc, greedy_draft_fn)
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config
        from deepspeed_tpu_torch.models.llama import LlamaConfig
        from deepspeed_tpu_torch.models.mixtral import MixtralConfig

        if isinstance(cfg, MixtralConfig):
            from deepspeed_tpu_torch.models import mixtral as fam
        elif isinstance(cfg, LlamaConfig):
            from deepspeed_tpu_torch.models import llama as fam
        elif isinstance(cfg, GPT2Config):
            from deepspeed_tpu_torch.models import gpt2 as fam
            # learned positions are hard-bounded by the wpe table
            window = min(window, cfg.max_seq_len - draft_tokens)
        else:
            raise TypeError(
                f"no draft forward for config type "
                f"{type(cfg).__name__}; supported: LlamaConfig, "
                "MixtralConfig, GPT2Config")
        self.k = int(draft_tokens)
        self.window = int(window)
        if self.k < 1 or self.window < 1:
            raise ValueError(
                f"draft_tokens and window must be >= 1, got "
                f"{draft_tokens}/{window}")
        self.device = resolve_device(device)
        self.params = params
        step, alloc = cached_step_alloc(fam.forward_with_cache, cfg,
                                        cache_dtype=cache_dtype,
                                        device=self.device)
        self._rollout = greedy_draft_fn(step, alloc, self.window, self.k)

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        if k <= 0:
            return []
        tail = list(tokens)[-self.window:]
        toks = np.zeros((1, self.window), np.int64)
        toks[0, self.window - len(tail):] = tail
        drafts = self._rollout(self.params,
                               torch.from_numpy(toks).to(self.device))
        return [int(t) for t in drafts[0, :min(k, self.k)].tolist()]


def build_drafter(cfg: SpeculativeConfig) -> Drafter:
    """Drafter from the config block.  ``model`` cannot be built here (a
    config block carries no params): it must arrive as an explicit
    ``drafter=`` instance on the engine."""
    if cfg.drafter == "ngram":
        return NgramDrafter(max_ngram=cfg.max_ngram,
                            min_ngram=cfg.min_ngram)
    raise ValueError(
        f"speculative.drafter={cfg.drafter!r} needs an explicit drafter "
        "instance — build ModelDrafter(draft_params, draft_cfg, "
        "draft_tokens=K) and pass it as serving_engine(..., drafter=)")


# ------------------------------------------------------ device accept
def verify_accept(logits, drafts, draft_lens, generator=None, temps=None,
                  argmax=None):
    """Batched acceptance for one verify sweep.

    logits: [B, K+1, V] target logits at the K+1 scored positions
    (position 0 = the re-fed last token, 1..K = the drafts); drafts:
    [B, K] proposed tokens; draft_lens: [B] how many are real per row;
    ``generator``: the ``torch.Generator`` (on the logits' device) of the
    temperature rows' draws; temps: host [B] temperatures (None = all
    greedy); ``argmax``: the first-occurrence argmax over ``[N, V]`` rows
    (None: :func:`~deepspeed_tpu_torch.ops.sampling_cuda.
    fused_greedy_rows`, kernel B6 on CUDA, its plain version on the CPU).

    Returns ``(n_acc [B] int32, stop_tok [B, K+1] int32)``: ``n_acc`` is
    the longest accepted draft prefix, ``stop_tok[:, j]`` the token to emit
    when acceptance stops at ``j`` (the residual sample where a draft was
    rejected, the full target sample where drafts ran out or at the bonus
    position K, the argmax everywhere on greedy rows).  The host emits
    ``drafts[:n_acc] + [stop_tok[n_acc]]`` per row.

    The accept test and the stop-token draw are INDEPENDENT draws (one
    uniform per draft, then the categorical draws): sharing one would
    correlate the rejection event with the residual draw and bias the
    output.  An all-greedy batch draws nothing."""
    from deepspeed_tpu_torch.ops.sampling_cuda import fused_greedy_rows

    lg = logits.float()
    B, K1, V = lg.shape
    K = K1 - 1
    dev = lg.device
    temps = (np.zeros((B,), np.float32) if temps is None
             else np.asarray(temps, np.float32))
    am = (argmax or fused_greedy_rows)(
        lg.reshape(B * K1, V)).reshape(B, K1).to(torch.int32)
    drafts = torch.as_tensor(drafts, device=dev).long()
    dl = torch.as_tensor(draft_lens, device=dev)
    in_draft = torch.arange(K, device=dev)[None] < dl[:, None]      # [B, K]
    ok = drafts == am[:, :K]
    stop = am
    if (temps > 0.0).any():
        t = torch.from_numpy(temps).to(dev)
        greedy = (t == 0.0)[:, None]
        probs = torch.softmax(lg / t.clamp(min=1e-6)[:, None, None], -1)
        u = torch.rand((B, K), generator=generator, device=dev)
        p_draft = probs[:, :K].gather(-1, drafts[..., None])[..., 0]
        ok = torch.where(greedy, ok, u < p_draft)
        # a rejected draft's replacement samples the residual (p with the
        # draft's mass removed: exact for a point-mass proposal); the tiny
        # floor keeps an all-zero residual row drawable (its draft had
        # p = 1 and is always accepted, so the draw is never used)
        resid = probs[:, :K] * (1.0 - torch.nn.functional.one_hot(
            drafts, V).float()) + 1e-30
        resid_tok = torch.multinomial(resid.reshape(B * K, V), 1,
                                      generator=generator).reshape(B, K)
        full_tok = torch.multinomial(probs.reshape(B * K1, V), 1,
                                     generator=generator).reshape(B, K1)
        sampled = torch.cat([torch.where(in_draft, resid_tok,
                                         full_tok[:, :K]),
                             full_tok[:, K:]], dim=1).to(torch.int32)
        stop = torch.where(greedy, am, sampled)
    ok = ok & in_draft
    n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    return n_acc.to(torch.int32), stop
