"""Weights for the port: the bridge from the JAX param tree and train
state, and a seeded initialiser that builds a model on the card.

The port keeps the JAX pytree layout (Llama's ``embed``, stacked ``blocks``
leaves ``[L, in, out]``, ``final_norm``, ``lm_head``; Mixtral's the same
plus the router ``gate`` ``[L, d, E]`` and expert stacks ``[L, E, in,
out]``; GPT-2's ``wte``, ``wpe``, ``blocks``, ``lnf_w``, ``lnf_b``), so the
bridge is a plain array copy: no transposes, no renames.
:func:`init_quantized_params` builds a model's int8 tree a layer at a time,
for a model whose bf16 weights would not fit the card.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

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


# a leaf of a model's layout: a normal draw of std ``value`` or a constant
# ``value``, of ``shape``
class _Leaf(NamedTuple):
    kind: str               # "normal" | "const"
    shape: tuple
    value: float


def _w(*shape) -> _Leaf:
    """Normal with std 1/sqrt(fan_in) (the JAX ``init_params``' ``s``)."""
    return _Leaf("normal", shape, 1.0 / math.sqrt(shape[-2]))


def _layout(cfg) -> Dict[str, Any]:
    """The JAX layout of ``cfg``'s params, leaf by leaf in draw order."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    if isinstance(cfg, GPT2Config):
        return _gpt2_layout(cfg)
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    blocks = {
        "attn_norm": _Leaf("const", (L, d), 1.0),
        "wq": _w(L, d, nh * hd),
        "wk": _w(L, d, nkv * hd),
        "wv": _w(L, d, nkv * hd),
        "wo": _w(L, nh * hd, d),
        "mlp_norm": _Leaf("const", (L, d), 1.0),
    }
    if isinstance(cfg, MixtralConfig):
        E = cfg.num_experts
        blocks.update({
            "gate": _Leaf("normal", (L, d, E), 0.02),
            # expert FFNs stacked [L, E, ...]
            "w1": _w(L, E, d, f),
            "w3": _w(L, E, d, f),
            "w2": _w(L, E, f, d),
        })
    else:
        blocks.update({"w1": _w(L, d, f), "w3": _w(L, d, f),
                       "w2": _w(L, f, d)})
    layout = {"embed": _w(cfg.vocab_size, d), "blocks": blocks,
              "final_norm": _Leaf("const", (d,), 1.0)}
    if not getattr(cfg, "tie_embeddings", False):
        layout["lm_head"] = _w(d, cfg.vocab_size)
    return layout


def _gpt2_layout(cfg) -> Dict[str, Any]:
    d, L = cfg.dim, cfg.n_layers

    def w(*shape):
        return _Leaf("normal", shape, 0.02)

    def const(value, *shape):
        return _Leaf("const", shape, value)

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


def _make(leaf: _Leaf, generator, dev, dtype) -> torch.Tensor:
    if leaf.kind == "const":
        return torch.full(leaf.shape, leaf.value, dtype=dtype, device=dev)
    return _normal(leaf.shape, generator, dev, dtype, leaf.value)


def _build(tree, fn):
    """``fn(name, leaf, stacked)`` over a layout in draw order; ``stacked``:
    the leaf is a ``blocks`` leaf, whose first dim is the layer."""
    return {k: ({n: fn(n, leaf, True) for n, leaf in v.items()}
                if k == "blocks" else fn(k, v, False))
            for k, v in tree.items()}


def init_params(cfg, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random weights in the JAX layout, drawn on ``device`` from
    ``generator`` (a ``torch.Generator`` on that device), for a Llama, a
    Mixtral or a GPT-2 config.  Llama and Mixtral: normal with std
    1/sqrt(fan_in) as the JAX ``init_params`` does (the expert stacks
    ``[L, E, in, out]`` by their ``in``), Mixtral's router ``gate`` with std
    0.02, norms at one.  GPT-2: normal with std 0.02 (``gpt2.py``'s),
    LayerNorm weights at one and biases at zero.  JAX's threefry draws
    cannot be reproduced; only the distribution matches.  Stacked leaves
    are drawn one ``[in, out]`` matrix at a time, so the f32 scratch is
    one matrix, not the model."""
    dev = resolve_device(device)
    return _build(_layout(cfg),
                  lambda _n, leaf, _s: _make(leaf, generator, dev, dtype))


def init_quantized_params(cfg, generator: torch.Generator, skip_paths,
                          device=None, dtype: torch.dtype = torch.bfloat16,
                          group_size: int = 128) -> Dict[str, Any]:
    """:func:`init_params`'s weights, int8 from the start: the tree that
    ``quantized.quantize_params(init_params(cfg, generator, device, dtype),
    group_size=group_size, skip_paths=skip_paths)`` gives, code for code
    and scale for scale (the same draws, in the same order), without ever
    holding the ``dtype`` tree.  Each matrix leaf is drawn in ``dtype`` one
    layer at a time (one ``[E, in, out]`` expert stack of a Mixtral
    layer), quantized (B9 on CUDA) and written into a preallocated stacked
    :class:`~deepspeed_tpu_torch.inference.quantized.QuantizedTensor`, so
    the ``dtype`` scratch is one layer of one leaf.  ``skip_paths``: leaf
    names kept exact in ``dtype`` (the serving engine's list, e.g.
    :data:`~deepspeed_tpu_torch.inference.serving.MIXTRAL_INT8_SKIP`, which
    keeps the router exact); vectors stay exact too, as
    ``quantize_params`` keeps them."""
    from deepspeed_tpu_torch.inference.quantized import (_pick_groups,
                                                         quantize_params)

    dev = resolve_device(device)
    skip = set(skip_paths)

    def one(name, leaf, stacked):
        if leaf.kind == "const" or name in skip or len(leaf.shape) < 2:
            return _make(leaf, generator, dev, dtype)
        if not stacked:
            return quantize_params({name: _make(leaf, generator, dev, dtype)},
                                   group_size=group_size)[name]
        L, shape = leaf.shape[0], leaf.shape[1:]
        probe = torch.empty(shape, device="meta")
        per_row = _pick_groups(probe, group_size) // probe[..., 0].numel()
        out = QuantizedTensor(
            q=torch.empty(leaf.shape, dtype=torch.int8, device=dev),
            scale=torch.empty(leaf.shape[:-1] + (per_row,),
                              dtype=torch.float32, device=dev))
        for l in range(L):
            w = _normal(shape, generator, dev, dtype, leaf.value)
            qt = quantize_params({name: w}, group_size=group_size)[name]
            out.q[l].copy_(qt.q)
            out.scale[l].copy_(qt.scale)
            del w, qt
        return out

    return _build(_layout(cfg), one)
