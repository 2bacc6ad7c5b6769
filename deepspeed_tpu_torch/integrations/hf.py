"""HuggingFace checkpoints in and out (port of
``deepspeed_tpu/integrations/hf.py``; ref: the reference's HF integration
and module_inject checkpoint loading, deepspeed/module_inject/
load_checkpoint.py).

:func:`load_state_dict` reads an HF checkpoint directory (safetensors
shards through the port's own reader, :mod:`deepspeed_tpu_torch.io.
safetensors`, or ``pytorch_model*.bin`` through ``torch.load``), and
:func:`from_pretrained` converts it through the architecture policies of
:mod:`deepspeed_tpu_torch.inference.injection`, leaf by leaf on the target
device.  :func:`save_pretrained` is the inverse for Llama: what the JAX
exporter writes (f32 tensors under the HF names, matrices transposed to
``[out, in]``, the same ``config.json`` keys), one tensor at a time from
the device, so host memory holds one tensor.  Tokenizers are not touched.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Mapping, Optional

import torch

from deepspeed_tpu_torch.io import safetensors as st


class ShardedStateDict(Mapping):
    """``{HF name: CPU tensor}`` over safetensors shards.  Each lookup maps
    that tensor's bytes afresh (nothing is cached), so a converter that
    drops each tensor after use never holds more than one."""

    def __init__(self, paths):
        self._files = {}
        for path in paths:
            f = st.SafeTensorsFile(path)
            self._files.update(dict.fromkeys(f.keys(), f))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._files[name].get(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._files)

    def __len__(self) -> int:
        return len(self._files)


def load_state_dict(model_dir: str) -> Mapping[str, torch.Tensor]:
    """Every weight shard under ``model_dir`` -> ``{name: CPU tensor}`` in
    the stored dtype: a :class:`ShardedStateDict` over ``*.safetensors``,
    else the ``pytorch_model*.bin`` shards (memory-mapped,
    ``weights_only``)."""
    entries = sorted(os.listdir(model_dir))
    safes = [e for e in entries if e.endswith(".safetensors")]
    bins = [e for e in entries if e.endswith(".bin") and "pytorch_model" in e]
    if safes:
        return ShardedStateDict(os.path.join(model_dir, e) for e in safes)
    if bins:
        sd: Dict[str, torch.Tensor] = {}
        for fname in bins:
            sd.update(torch.load(os.path.join(model_dir, fname),
                                 map_location="cpu", weights_only=True,
                                 mmap=True))
        return sd
    raise FileNotFoundError(
        f"no .safetensors or pytorch_model*.bin under {model_dir}")


def load_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def from_pretrained(model_dir: str, attn_impl: str = "auto",
                    dtype: Optional[torch.dtype] = None,
                    arch: Optional[str] = None, device=None):
    """An HF checkpoint directory -> ``(apply_fn, params, cfg, specs)``
    with the params on ``device`` (None = CUDA) in ``dtype`` (default
    bfloat16).  The architecture is ``config.json``'s
    ``architectures[0]`` unless given.  The counterpart of the reference's
    ``deepspeed.init_inference(AutoModel.from_pretrained(...))`` without a
    torch module."""
    from deepspeed_tpu_torch.inference.injection import inject

    hf_cfg = load_config(model_dir)
    arch = arch or (hf_cfg.get("architectures") or ["llama"])[0]
    return inject(arch, hf_cfg, load_state_dict(model_dir),
                  attn_impl=attn_impl, dtype=dtype or torch.bfloat16,
                  device=device)


# ours -> (HF name of layer i, stored transposed)
_LLAMA_BLOCKS = {
    "attn_norm": ("model.layers.{}.input_layernorm.weight", False),
    "wq": ("model.layers.{}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{}.self_attn.o_proj.weight", True),
    "mlp_norm": ("model.layers.{}.post_attention_layernorm.weight", False),
    "w1": ("model.layers.{}.mlp.gate_proj.weight", True),
    "w3": ("model.layers.{}.mlp.up_proj.weight", True),
    "w2": ("model.layers.{}.mlp.down_proj.weight", True),
}


def _llama_export_plan(params) -> Dict[str, tuple]:
    """HF name -> (our tensor, transposed), in the file's order."""
    plan = {"model.embed_tokens.weight": (params["embed"], False),
            "model.norm.weight": (params["final_norm"], False)}
    blocks = params["blocks"]
    for i in range(blocks["wq"].shape[0]):
        for ours, (fmt, transpose) in _LLAMA_BLOCKS.items():
            plan[fmt.format(i)] = (blocks[ours][i], transpose)
    if "lm_head" in params:
        plan["lm_head.weight"] = (params["lm_head"], True)
    return plan


def save_pretrained(params, cfg, save_dir: str) -> int:
    """Export a Llama tree to an HF-layout checkpoint: ``model.safetensors``
    (f32, HF names, matrices ``[out, in]``) and ``config.json``.  Each
    tensor is cast and transposed where it lives, then copied to the host
    and written before the next; returns the file's bytes."""
    os.makedirs(save_dir, exist_ok=True)
    plan = _llama_export_plan(params)
    specs = [(name, torch.float32,
              tuple(w.shape[::-1]) if t else tuple(w.shape))
             for name, (w, t) in plan.items()]

    def produce(name):
        w, transpose = plan[name]
        w = w.float()
        return (w.T if transpose else w).contiguous().cpu()

    nbytes = st.write_file(os.path.join(save_dir, "model.safetensors"),
                           specs, produce, metadata={"format": "pt"})
    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "vocab_size": int(cfg.vocab_size),
        "hidden_size": int(cfg.dim),
        "num_hidden_layers": int(cfg.n_layers),
        "num_attention_heads": int(cfg.n_heads),
        "num_key_value_heads": int(cfg.n_kv_heads),
        "intermediate_size": int(cfg.ffn_dim),
        "max_position_embeddings": int(cfg.max_seq_len),
        "rope_theta": float(cfg.rope_theta),
        "rms_norm_eps": float(cfg.norm_eps),
        "tie_word_embeddings": bool(cfg.tie_embeddings),
        "model_type": "llama",
    }
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return nbytes
