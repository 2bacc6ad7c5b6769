"""PyTorch / CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

Imports ``torch`` and ``numpy`` only (never ``jax`` nor ``deepspeed_tpu``).
Ported: Llama, GPT-2 and Mixtral (MoE: the capacity-limited top-k gate of
``parallel/moe.py`` in training, the dense top-k combine in serving) greedy
serving with continuous batching over a paged KV cache (prefix cache, host
and NVMe KV tiers, int8-resident pages, int8 weights, speculative decoding,
and ZeRO-Inference weight streaming from host memory or NVMe for models
larger than the card), their dense and paged generators; the BERT and CIFAR CNN encoder families, served by lot
batching (BERT in bf16 or int8 weights); stochastic rounding; the train
step, data parallel over ranks (one a GPU, ``python -m
deepspeed_tpu_torch.launcher``) at ZeRO stages 0-3 with ZeRO++ and the
1-bit optimizers (``initialize`` -> ``TrainingEngine.train_batch``; the
collectives in ``deepspeed_tpu_torch.comm``) with its data
loader, packing, curriculum, activation checkpointing (the host-offload
policies too), timers and checkpoints (``save_checkpoint`` /
``load_checkpoint``, ``zero_to_fp32``), ``init_inference`` and the
environment report; HF checkpoints in and out (``from_pretrained`` /
``save_pretrained``, the injection policies, the HF ``Trainer`` bridge),
LoRA adapters, knowledge distillation and the hybrid train+generate
engine; the host natives (pinned-buffer pool, shuffle index service, the
fused CPU Adam); ZeRO-Infinity training of models whose state does not
fit the card (``ParamStreamEngine`` streams each layer's params from host
memory or NVMe and updates them with the host Adam behind the backward,
``InfinityEngine`` streams the optimizer state, and the unscheduled
``offload_*`` blocks keep the stage-0 engine's state in host memory).
Their attention, sampling, Adam update and int8 quantization run
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
    "BertConfig": "deepspeed_tpu_torch.models.bert",
    "CNNConfig": "deepspeed_tpu_torch.models.cnn",
    "ServingEngine": "deepspeed_tpu_torch.inference.serving",
    "llama_serving_engine": "deepspeed_tpu_torch.inference.serving",
    "gpt2_serving_engine": "deepspeed_tpu_torch.inference.serving",
    "mixtral_serving_engine": "deepspeed_tpu_torch.inference.serving",
    "serving_engine": "deepspeed_tpu_torch.inference.serving",
    "EncoderServingEngine": "deepspeed_tpu_torch.inference.encoder_serving",
    "CNNServingEngine": "deepspeed_tpu_torch.inference.encoder_serving",
    "bert_serving_engine": "deepspeed_tpu_torch.inference.encoder_serving",
    "stochastic_round_bf16": "deepspeed_tpu_torch.ops.rounding",
    "stochastic_round_tree": "deepspeed_tpu_torch.ops.rounding",
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
    "from_pretrained": "deepspeed_tpu_torch.integrations.hf",
    "save_pretrained": "deepspeed_tpu_torch.integrations.hf",
    "inject": "deepspeed_tpu_torch.inference.injection",
    "Trainer": "deepspeed_tpu_torch.integrations.trainer",
    "TrainingArguments": "deepspeed_tpu_torch.integrations.trainer",
    "LoRAConfig": "deepspeed_tpu_torch.lora",
    "init_lora": "deepspeed_tpu_torch.lora",
    "lora_loss_fn": "deepspeed_tpu_torch.lora",
    "merge_lora": "deepspeed_tpu_torch.lora",
    "Distiller": "deepspeed_tpu_torch.distill",
    "init_hybrid_engine": "deepspeed_tpu_torch.hybrid",
    "HybridEngine": "deepspeed_tpu_torch.hybrid",
    "HostBufferPool": "deepspeed_tpu_torch.io.native",
    "ShuffleIndexService": "deepspeed_tpu_torch.io.native",
    "cpu_adam_step": "deepspeed_tpu_torch.ops.cpu_adam",
    "LayeredModel": "deepspeed_tpu_torch.param_stream",
    "ParamStreamEngine": "deepspeed_tpu_torch.param_stream",
    "InfinityEngine": "deepspeed_tpu_torch.infinity",
    "NvmeSwapper": "deepspeed_tpu_torch.offload",
    "init_distributed": "deepspeed_tpu_torch.comm",
    "MeshSpec": "deepspeed_tpu_torch.topology",
    "sharded_init": "deepspeed_tpu_torch.zero",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
