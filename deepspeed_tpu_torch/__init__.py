"""PyTorch / CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

Imports ``torch`` and ``numpy`` only (never ``jax`` nor ``deepspeed_tpu``).
Ported: Llama, GPT-2 and Mixtral (MoE: the capacity-limited top-k gate of
``parallel/moe.py`` in training, the dense top-k combine in serving) greedy
serving with continuous batching over a paged KV cache (prefix cache, host
KV tier, int8-resident pages, int8 weights), their dense and paged
generators, the train step at ZeRO stage 0
on one GPU (``initialize`` -> ``TrainingEngine.train_batch``) with its data
loader, packing, curriculum, activation checkpointing (the host-offload
policies too), timers and checkpoints (``save_checkpoint`` /
``load_checkpoint``, ``zero_to_fp32``), ``init_inference`` and the
environment report.  Their attention, sampling, Adam update and int8 quantization run
hand-written CUDA kernels (``deepspeed_tpu_torch/csrc``).  Exports resolve
lazily, so importing the package builds nothing and touches no device.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "resolve_device": "deepspeed_tpu_torch._device",
    "LlamaConfig": "deepspeed_tpu_torch.models.llama",
    "GPT2Config": "deepspeed_tpu_torch.models.gpt2",
    "MixtralConfig": "deepspeed_tpu_torch.models.mixtral",
    "ServingEngine": "deepspeed_tpu_torch.inference.serving",
    "llama_serving_engine": "deepspeed_tpu_torch.inference.serving",
    "gpt2_serving_engine": "deepspeed_tpu_torch.inference.serving",
    "mixtral_serving_engine": "deepspeed_tpu_torch.inference.serving",
    "serving_engine": "deepspeed_tpu_torch.inference.serving",
    "from_jax_params": "deepspeed_tpu_torch.weights",
    "from_jax_train_state": "deepspeed_tpu_torch.weights",
    "DataLoader": "deepspeed_tpu_torch.data.loader",
    "RepeatingLoader": "deepspeed_tpu_torch.data.loader",
    "PackedDataLoader": "deepspeed_tpu_torch.data.packing",
    "zero_to_fp32": "deepspeed_tpu_torch.checkpoint",
    "init_params": "deepspeed_tpu_torch.weights",
    "init_quantized_params": "deepspeed_tpu_torch.weights",
    "initialize": "deepspeed_tpu_torch.engine",
    "TrainingEngine": "deepspeed_tpu_torch.engine",
    "fused_adam": "deepspeed_tpu_torch.ops.adam_cuda",
    "init_inference": "deepspeed_tpu_torch.inference.engine",
    "init_serving": "deepspeed_tpu_torch.inference.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
