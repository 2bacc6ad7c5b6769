"""Model families of the port: Llama, GPT-2, Mixtral, BERT and the CIFAR
CNN.  Exports resolve lazily, so importing the package builds nothing."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "LlamaConfig": "deepspeed_tpu_torch.models.llama",
    "GPT2Config": "deepspeed_tpu_torch.models.gpt2",
    "MixtralConfig": "deepspeed_tpu_torch.models.mixtral",
    "BertConfig": "deepspeed_tpu_torch.models.bert",
    "CNNConfig": "deepspeed_tpu_torch.models.cnn",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
