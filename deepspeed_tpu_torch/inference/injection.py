"""Architecture policies that turn an HF checkpoint into the port's models
(port of ``deepspeed_tpu/inference/injection.py``; ref:
deepspeed/module_inject/*, replace_policy.py and containers/llama.py).

The reference walks a torch module tree and swaps HF layers for fused
kernels, guided by per-architecture policies.  The port's models are pure
functions over ``nn``-free param trees, so "injection" is a registry that
maps an architecture name to the model family's config constructor, its
weight converter (HF names and ``[out, in]`` matrices -> the stacked ``[L,
in, out]`` tree) and its forward.  :func:`inject` returns ``(apply_fn, params,
cfg, specs)``; ``specs`` (the tensor-parallel spec tree) is ``None``: the
port has no TP spec trees until the distributed slice (ROADMAP A9).

The converters build each leaf on the target device directly: every HF
tensor is moved there, transposed and cast one at a time into its place in
the stacked leaf, so host memory holds at most one HF tensor (and, read
through :class:`~deepspeed_tpu_torch.io.safetensors.SafeTensorsFile`,
only while it is copied).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from deepspeed_tpu_torch._device import resolve_device


@dataclasses.dataclass
class InjectionPolicy:
    """Per-architecture policy (ref: module_inject/replace_policy.py
    DSPolicy subclasses)."""

    arch: str
    build_config: Callable      # hf_config dict -> model config
    convert_weights: Callable   # (state_dict, cfg, device, dtype) -> params
    apply_fn: Callable          # (params, tokens, cfg) -> logits
    param_specs: Callable       # cfg -> TP spec tree (None until A9)


_REGISTRY: Dict[str, InjectionPolicy] = {}


def register_policy(policy: InjectionPolicy) -> None:
    _REGISTRY[policy.arch.lower()] = policy


def get_policy(arch: str) -> InjectionPolicy:
    try:
        return _REGISTRY[arch.lower()]
    except KeyError:
        raise ValueError(
            f"no injection policy for architecture {arch!r}; "
            f"registered: {sorted(_REGISTRY)}") from None


def inject(arch: str, hf_config: Dict[str, Any],
           state_dict: Optional[Mapping[str, torch.Tensor]] = None,
           attn_impl: str = "auto", dtype: torch.dtype = torch.bfloat16,
           device=None):
    """ref: module_inject.replace_module -> ``(apply_fn, params, cfg,
    specs)``.  ``state_dict`` maps HF tensor names to CPU tensors (or
    numpy arrays): :func:`~deepspeed_tpu_torch.integrations.hf.
    load_state_dict`'s result.  Floating leaves are cast to ``dtype``; the
    params land on ``device`` (None = CUDA).  ``specs`` is None (no TP spec
    trees before ROADMAP A9)."""
    pol = get_policy(arch)
    cfg = pol.build_config(hf_config)
    if hasattr(cfg, "attn_impl"):
        # replace() re-runs the config's checks on the new attn_impl
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    params = None
    if state_dict is not None:
        params = pol.convert_weights(state_dict, cfg,
                                     resolve_device(device), dtype)

    def fn(p, tokens):
        return pol.apply_fn(p, tokens, cfg)

    return fn, params, cfg, pol.param_specs(cfg)


# ------------------------------------------------------------- converters
def _cpu(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _target(src: torch.Tensor, dtype) -> torch.dtype:
    return dtype if src.is_floating_point() else src.dtype


def _leaf(sd, name: str, device, dtype, transpose: bool = False):
    """One HF tensor as a fresh leaf on ``device`` (transposed from torch's
    ``[out, in]`` Linear layout when ``transpose``), cast there."""
    src = _cpu(sd[name]).to(device)
    if transpose:
        src = src.T
    return torch.empty(src.shape, dtype=_target(src, dtype),
                       device=device).copy_(src)


def _stack(sd, names, device, dtype, transpose: bool):
    """The HF tensors ``names`` stacked on a new leading axis, filled one
    tensor at a time into a leaf allocated once on ``device``."""
    out = None
    for i, name in enumerate(names):
        src = _cpu(sd[name]).to(device)
        if transpose:
            src = src.T
        if out is None:
            out = torch.empty((len(names), *src.shape),
                              dtype=_target(src, dtype), device=device)
        out[i].copy_(src)
        del src
    return out


def _llama_config(hf: Dict[str, Any]):
    from deepspeed_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=hf.get("vocab_size", 32000),
        dim=hf.get("hidden_size", 4096),
        n_layers=hf.get("num_hidden_layers", 32),
        n_heads=hf.get("num_attention_heads", 32),
        n_kv_heads=hf.get("num_key_value_heads",
                          hf.get("num_attention_heads", 32)),
        ffn_dim=hf.get("intermediate_size"),
        max_seq_len=hf.get("max_position_embeddings", 2048),
        rope_theta=hf.get("rope_theta", 10000.0),
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )


_LAYER = "model.layers.{}."


def _attn_leaves(sd, L, device, dtype) -> Dict[str, torch.Tensor]:
    """The attention half of a decoder block's leaves, shared by Llama and
    Mixtral."""
    def stack(suffix, transpose=True):
        return _stack(sd, [(_LAYER + suffix).format(i) for i in range(L)],
                      device, dtype, transpose)

    return {
        "attn_norm": stack("input_layernorm.weight", transpose=False),
        "wq": stack("self_attn.q_proj.weight"),
        "wk": stack("self_attn.k_proj.weight"),
        "wv": stack("self_attn.v_proj.weight"),
        "wo": stack("self_attn.o_proj.weight"),
        "mlp_norm": stack("post_attention_layernorm.weight",
                          transpose=False),
    }


def _llama_weights(sd, cfg, device, dtype):
    """HF Llama layout -> the stacked tree (torch Linear stores W^T: HF
    ``[out, in]`` -> ours ``[in, out]``)."""
    L = cfg.n_layers
    blocks = _attn_leaves(sd, L, device, dtype)
    for ours, hf in (("w1", "mlp.gate_proj.weight"),
                     ("w3", "mlp.up_proj.weight"),
                     ("w2", "mlp.down_proj.weight")):
        blocks[ours] = _stack(sd, [(_LAYER + hf).format(i) for i in range(L)],
                              device, dtype, transpose=True)
    params = {
        "embed": _leaf(sd, "model.embed_tokens.weight", device, dtype),
        "blocks": blocks,
        "final_norm": _leaf(sd, "model.norm.weight", device, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _leaf(sd, "lm_head.weight", device, dtype,
                                  transpose=True)
    return params


def _mixtral_config(hf: Dict[str, Any]):
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    return MixtralConfig(
        vocab_size=hf.get("vocab_size", 32000),
        dim=hf.get("hidden_size", 4096),
        n_layers=hf.get("num_hidden_layers", 32),
        n_heads=hf.get("num_attention_heads", 32),
        n_kv_heads=hf.get("num_key_value_heads", 8),
        ffn_dim=hf.get("intermediate_size"),
        num_experts=hf.get("num_local_experts", 8),
        top_k=hf.get("num_experts_per_tok", 2),
        max_seq_len=hf.get("max_position_embeddings", 4096),
        rope_theta=hf.get("rope_theta", 1e6),
        norm_eps=hf.get("rms_norm_eps", 1e-5),
    )


def _mixtral_weights(sd, cfg, device, dtype):
    """HF Mixtral layout -> stacked ``[L, ...]`` / ``[L, E, ...]`` tree."""
    L, E = cfg.n_layers, cfg.num_experts
    moe = _LAYER + "block_sparse_moe."
    blocks = _attn_leaves(sd, L, device, dtype)
    blocks["gate"] = _stack(sd, [(moe + "gate.weight").format(i)
                                 for i in range(L)], device, dtype, True)
    for w in ("w1", "w3", "w2"):
        names = [(moe + "experts.{}." + w + ".weight").format(i, e)
                 for i in range(L) for e in range(E)]
        flat = _stack(sd, names, device, dtype, transpose=True)
        blocks[w] = flat.view(L, E, *flat.shape[1:])
    return {
        "embed": _leaf(sd, "model.embed_tokens.weight", device, dtype),
        "blocks": blocks,
        "final_norm": _leaf(sd, "model.norm.weight", device, dtype),
        "lm_head": _leaf(sd, "lm_head.weight", device, dtype,
                         transpose=True),
    }


def _no_specs(cfg):
    return None


def _register_builtin():
    from deepspeed_tpu_torch.models import llama, mixtral

    for arch in ("llama", "llamaforcausallm"):
        register_policy(InjectionPolicy(
            arch=arch, build_config=_llama_config,
            convert_weights=_llama_weights,
            apply_fn=lambda p, tokens, cfg: llama.forward(p, tokens, cfg),
            param_specs=_no_specs))
    for arch in ("mixtral", "mixtralforcausallm"):
        register_policy(InjectionPolicy(
            arch=arch, build_config=_mixtral_config,
            convert_weights=_mixtral_weights,
            # eval forward: the capacity-free dense top-k combine, so
            # injected inference never drops tokens on router imbalance
            apply_fn=lambda p, tokens, cfg: mixtral.forward_eval(
                p, tokens, cfg),
            param_specs=_no_specs))


_register_builtin()
