"""Hybrid train+generate engine for RLHF loops (port of
``deepspeed_tpu/hybrid.py``; ref: deepspeed/runtime/hybrid_engine.py
DeepSpeedHybridEngine, DeepSpeed-Chat's rollout-then-train loop).

The reference flips between ZeRO-3's partitioned training layout and the
gathered layout its inference kernels want around every rollout.  On one
GPU at stage 0 the master params are whole on the card already, so the
mode switch is one cast: :meth:`HybridEngine.generate` casts the live f32
master to the compute dtype once per call (the params do not change
within a rollout, so these are the values JAX's per-step traced cast
gives) and runs the dense generator over that copy; the copy is dropped
when the rollout ends.  The generator attends in plain PyTorch
(:func:`~deepspeed_tpu_torch.inference.generation.cached_attention`), as
the JAX one does in XLA; its greedy rows take the sampling kernel B6.

Config parity: the ``hybrid_engine`` JSON block is accepted.  ``enabled``
and ``max_out_tokens`` are honoured; ``inference_tp_size`` above 1 raises
(tensor parallelism is ROADMAP A9); ``release_inference_cache`` /
``pin_parameters`` / ``tp_gather_partition_size`` describe machinery the
one-device engine does not have and are logged as no-ops.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from deepspeed_tpu_torch import precision
from deepspeed_tpu_torch._tree import tree_map
from deepspeed_tpu_torch.inference.generation import generate_loop

logger = logging.getLogger(__name__)


class HybridEngine:
    """A :class:`~deepspeed_tpu_torch.engine.TrainingEngine` with a
    generation path over its live master params.

    ``prefill_fn`` / ``decode_fn``: ``(params, tokens, cache) -> (logits,
    cache)`` over params in the compute dtype; ``alloc_cache``: ``(batch,
    max_seq) -> cache``.  Typical RLHF iteration (ref: DeepSpeed-Chat
    ppo_trainer)::

        rollout = hybrid.generate(prompts, max_new_tokens=..., temperature=1.0)
        ...score the rollout, build the PPO batch...
        loss = hybrid.train_batch(ppo_batch)     # the engine's step
    """

    def __init__(self, engine, prefill_fn: Callable, decode_fn: Callable,
                 alloc_cache: Callable, *, eos_token_id: Optional[int] = None,
                 max_out_tokens: Optional[int] = None):
        if not hasattr(engine, "state"):
            raise ValueError(
                "hybrid_engine needs a TrainingEngine (live train state); "
                f"got {type(engine).__name__}, which holds no params to "
                "serve rollouts from")
        self.engine = engine
        self.eos = eos_token_id
        self.max_out_tokens = max_out_tokens
        self._prefill = prefill_fn
        self._decode = decode_fn
        self._alloc = alloc_cache
        self._cdt = precision.compute_dtype(engine.config.precision)

    # ------------------------------------------------------------- training
    def train_batch(self, batch):
        return self.engine.train_batch(batch)

    def eval_batch(self, batch):
        return self.engine.eval_batch(batch)

    def __getattr__(self, name):
        # engine passthrough (step/backward/save_checkpoint/metrics/...);
        # 'engine' itself must miss cleanly or copy/pickle probes on a
        # half-built instance would recurse forever
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

    # ------------------------------------------------------------- rollout
    def compute_params(self):
        """The live master params cast to the compute dtype (a new tree;
        integer leaves as they are)."""
        with torch.no_grad():
            return tree_map(lambda x: x.to(self._cdt)
                            if x.is_floating_point() else x,
                            self.engine.state.params)

    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 rng: Optional[torch.Generator] = None,
                 max_seq: Optional[int] = None) -> torch.Tensor:
        """tokens [B, T] -> rollouts [B, T + max_new_tokens] int32, from the
        CURRENT params (no staleness: it reads ``engine.state.params``)."""
        if max_seq is None and self.max_out_tokens is not None:
            max_seq = self.max_out_tokens
        # an overrun of the cache budget raises inside generate_loop
        return generate_loop(
            self.compute_params(), self._prefill, self._decode, self._alloc,
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, rng=rng, max_seq=max_seq, eos=self.eos,
            device=self.engine.device)


def _hybrid_block(config) -> dict:
    hb = dict((config.raw or {}).get("hybrid_engine", {}))
    if not hb.get("enabled", True):
        raise ValueError(
            "hybrid_engine.enabled is false in the config — remove the "
            "flag (or set it true) before building a HybridEngine")
    for key in ("release_inference_cache", "pin_parameters",
                "tp_gather_partition_size"):
        if key in hb:
            logger.info(
                "hybrid_engine.%s: accepted no-op — the one-device engine "
                "never re-lays-out weights between train and generate, so "
                "there is no cache to release or partition to gather", key)
    return hb


def llama_hybrid_engine(engine, cfg, *, eos_token_id: Optional[int] = None,
                        cache_dtype: torch.dtype = torch.bfloat16
                        ) -> HybridEngine:
    """A :class:`HybridEngine` over models/llama.py weights: ``engine``
    holds the Llama tree, ``cfg`` is its
    :class:`~deepspeed_tpu_torch.models.llama.LlamaConfig`; the dense
    cache lives on the engine's device."""
    hb = _hybrid_block(engine.config)
    tp = int(hb.get("inference_tp_size", 0) or 0)
    if tp > 1:
        raise ValueError(
            f"hybrid_engine.inference_tp_size={tp}: the port's hybrid engine "
            "shares one device between training and generation; tensor "
            "parallelism comes with the distributed slice (ROADMAP A9)")

    from deepspeed_tpu_torch.inference.generation import llama_step_alloc

    step, alloc = llama_step_alloc(cfg, cache_dtype, device=engine.device)
    return HybridEngine(engine, step, step, alloc, eos_token_id=eos_token_id,
                        max_out_tokens=hb.get("max_out_tokens"))


def init_hybrid_engine(engine, model_cfg, **kw) -> HybridEngine:
    """A train+generate :class:`HybridEngine` for RLHF loops over a Llama
    engine (ref: deepspeed/runtime/hybrid_engine.py; the JAX package's
    ``deepspeed_tpu.init_hybrid_engine``)."""
    return llama_hybrid_engine(engine, model_cfg, **kw)
