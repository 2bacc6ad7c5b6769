"""Weights for the port: the bridge from the JAX param tree and train
state, and a seeded initialiser that builds a model on the card.

The port keeps the JAX pytree layout (Llama's ``embed``, stacked ``blocks``
leaves ``[L, in, out]``, ``final_norm``, ``lm_head``; GPT-2's ``wte``,
``wpe``, ``blocks``, ``lnf_w``, ``lnf_b``), so the bridge is a plain array
copy: no transposes, no renames.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch.inference.quantized import QuantizedTensor


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.array(a, order="C")        # a writable copy
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree: Dict[str, Any], *, device=None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A JAX param tree whose leaves are numpy arrays (``jax.device_get``
    of the JAX params) -> the same tree of torch tensors on ``device``
    (None = CUDA), cast to ``dtype`` when given.  An int8 leaf of the JAX
    package's weight-only quantization (its ``QuantizedTensor``, a
    NamedTuple of ``q`` and ``scale``) becomes the port's
    :class:`~deepspeed_tpu_torch.inference.quantized.QuantizedTensor` with
    the same codes and scales (never cast)."""
    return _convert(tree, resolve_device(device), dtype)


def from_jax_train_state(state_np, *, device=None):
    """A ``jax.device_get`` of the JAX engine's ``TrainState`` (step,
    params, ``opt_state``, scaler) -> the port's
    :class:`~deepspeed_tpu_torch.engine.TrainState` on ``device`` (None =
    CUDA): the same params and optimizer trees, leaf for leaf and dtype for
    dtype, and the JAX scalars as the Python ints and floats the port
    holds.  The optimizer state keeps its kind (``AdamState``,
    ``FusedAdamState``, ...).  Assign it to ``engine.state`` (and
    ``engine.global_steps``) of a port engine built with the same config to
    continue the JAX run, or save it to hold its checkpoint against
    JAX's."""
    from deepspeed_tpu_torch.engine import TrainState
    from deepspeed_tpu_torch.ops import adam_cuda, optim
    from deepspeed_tpu_torch.precision import ScalerState

    dev = resolve_device(device)
    opt = state_np.opt_state
    kind = (getattr(optim, type(opt).__name__, None)
            or getattr(adam_cuda, type(opt).__name__, None))
    if kind is None or getattr(kind, "_fields", None) != opt._fields:
        raise ValueError(f"optimizer state {type(opt).__name__} has no "
                         "counterpart in the port")
    opt_state = kind(int(opt.step), *(
        None if v is None else _convert(v, dev, None) for v in opt[1:]))
    return TrainState(
        step=int(state_np.step), params=_convert(state_np.params, dev, None),
        opt_state=opt_state,
        scaler=ScalerState(float(state_np.scaler.scale),
                           int(state_np.scaler.good_steps)))


def _convert(x, dev, dtype):
    if isinstance(x, dict):
        return {k: _convert(v, dev, dtype) for k, v in x.items()}
    if getattr(x, "_fields", None) == QuantizedTensor._fields:
        return QuantizedTensor(q=_tensor(x.q, dev, None),
                               scale=_tensor(x.scale, dev, None))
    return _tensor(x, dev, dtype)


def _normal(shape, generator, dev, dtype, scale) -> torch.Tensor:
    """N(0, scale^2) of ``shape``, drawn in f32 one ``shape[-2:]`` slice at
    a time (so the f32 scratch is one layer, not the stack)."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    for layer in out.view(-1, *shape[-2:]):
        layer.copy_(torch.randn(shape[-2:], generator=generator,
                                device=dev, dtype=torch.float32) * scale)
    return out


def init_params(cfg, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random weights in the JAX layout, drawn on ``device`` from
    ``generator`` (a ``torch.Generator`` on that device), for a Llama or a
    GPT-2 config.  Llama: normal with std 1/sqrt(fan_in) as the JAX
    ``init_params`` does, norms at one.  GPT-2: normal with std 0.02
    (``gpt2.py``'s), LayerNorm weights at one and biases at zero.  JAX's
    threefry draws cannot be reproduced; only the distribution matches.
    Stacked leaves are drawn one layer at a time, so the f32 scratch is
    one layer, not the model."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    dev = resolve_device(device)
    if isinstance(cfg, GPT2Config):
        return _init_gpt2(cfg, generator, dev, dtype)
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def w(*shape):
        return _normal(shape, generator, dev, dtype,
                       1.0 / math.sqrt(shape[-2]))

    params = {
        "embed": w(cfg.vocab_size, d),
        "blocks": {
            "attn_norm": torch.ones((L, d), dtype=dtype, device=dev),
            "wq": w(L, d, nh * hd),
            "wk": w(L, d, nkv * hd),
            "wv": w(L, d, nkv * hd),
            "wo": w(L, nh * hd, d),
            "mlp_norm": torch.ones((L, d), dtype=dtype, device=dev),
            "w1": w(L, d, f),
            "w3": w(L, d, f),
            "w2": w(L, f, d),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = w(d, cfg.vocab_size)
    return params


def _init_gpt2(cfg, generator, dev, dtype) -> Dict[str, Any]:
    d, L = cfg.dim, cfg.n_layers

    def w(*shape):
        return _normal(shape, generator, dev, dtype, 0.02)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return {
        "wte": w(cfg.vocab_size, d),
        "wpe": w(cfg.max_seq_len, d),
        "blocks": {
            "ln1_w": const(1.0, L, d), "ln1_b": const(0.0, L, d),
            "qkv_w": w(L, d, 3 * d), "qkv_b": const(0.0, L, 3 * d),
            "proj_w": w(L, d, d), "proj_b": const(0.0, L, d),
            "ln2_w": const(1.0, L, d), "ln2_b": const(0.0, L, d),
            "fc_w": w(L, d, 4 * d), "fc_b": const(0.0, L, 4 * d),
            "out_w": w(L, 4 * d, d), "out_b": const(0.0, L, d),
        },
        "lnf_w": const(1.0, d), "lnf_b": const(0.0, d),
    }
