"""Paged-KV serving: page store, paged attention, continuous batching;
lot-batched encoder serving; ``init_inference`` / ``init_serving`` and
weight-only int8.  Exports
resolve lazily, so importing the package builds nothing."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "EncoderServingEngine": "deepspeed_tpu_torch.inference.encoder_serving",
    "CNNServingEngine": "deepspeed_tpu_torch.inference.encoder_serving",
    "bert_serving_engine": "deepspeed_tpu_torch.inference.encoder_serving",
    "serving_engine": "deepspeed_tpu_torch.inference.serving",
    "InferenceEngine": "deepspeed_tpu_torch.inference.engine",
    "init_inference": "deepspeed_tpu_torch.inference.engine",
    "init_serving": "deepspeed_tpu_torch.inference.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
