"""LoRA adapter training (port of ``deepspeed_tpu/lora.py``; ref:
deepspeed/linear/optimized_linear.py LoRAOptimizedLinear and
deepspeed/linear/config.py LoRAConfig: only the low-rank A/B factors of
the wrapped Linear layers train).

The port's models are ``nn``-free param trees, so LoRA is a tree
transform.  The engine's params are the adapter tree alone, so its master
copy, optimizer state, gradients and checkpoints are adapter-sized, while
the frozen base is cast once to the compute dtype (``requires_grad``
false) and closed over by the loss.  Each step forms ``W_eff = W +
(alpha/r)·A@B`` per target leaf (the product in f32, the sum in the base's
dtype), so gradients reach only A and B.

Adapters are keyed by dotted leaf paths (``"blocks.wq"``, the JAX
package's ``utils/trees.leaf_path`` spelling); a stacked ``[L, in, out]``
leaf gets stacked adapters ``A [L, in, r]`` and ``B [L, r, out]``::

    lcfg = LoRAConfig()
    adapters = init_lora(torch.Generator("cuda").manual_seed(0), base, lcfg)
    engine, _, _, _ = initialize(
        loss_fn=lora_loss_fn(llama.loss_fn(cfg), base, lcfg),
        params=adapters, config={...})
    ...
    merged = merge_lora(base, engine.module_params(), lcfg)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch._tree import (tree_leaves, tree_leaves_with_path,
                                       tree_map, tree_map_with_path)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """ref: deepspeed/linear/config.py LoRAConfig (lora_r, lora_alpha;
    ``base_weight_sharding`` waits for the distributed slice)."""

    lora_r: int = 8
    lora_alpha: int = 32
    target_modules: Sequence[str] = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.lora_alpha / self.lora_r

    def matches(self, path: str) -> bool:
        leaf = path.split(".")[-1]
        return any(t == leaf or t == path for t in self.target_modules)


def _target_leaves(params: Any, cfg: LoRAConfig):
    out = [(path, leaf) for path, leaf in tree_leaves_with_path(params, ".")
           if cfg.matches(path) and getattr(leaf, "ndim", 0) >= 2]
    if not out:
        raise ValueError(
            f"no parameter matched target_modules={cfg.target_modules!r} "
            "— check the leaf names against your params tree")
    return out


def init_lora(generator: torch.Generator, base_params: Any, cfg: LoRAConfig,
              dtype: torch.dtype = torch.float32) -> Dict[str, dict]:
    """Adapter tree ``{path: {"A": [..., in, r], "B": [..., r, out]}}``
    beside each target leaf (on its device).  A is N(0, 1)/r, drawn from
    ``generator`` on its device in path order; B is zeros, so training
    starts exactly at the base model."""
    adapters = {}
    for path, leaf in _target_leaves(base_params, cfg):
        *lead, din, dout = leaf.shape
        a = torch.randn((*lead, din, cfg.lora_r), generator=generator,
                        device=generator.device, dtype=torch.float32)
        adapters[path] = {
            "A": (a / cfg.lora_r).to(device=leaf.device, dtype=dtype),
            "B": torch.zeros((*lead, cfg.lora_r, dout), dtype=dtype,
                             device=leaf.device),
        }
    return adapters


def _delta(ad, scale: float, dtype: torch.dtype) -> torch.Tensor:
    return (scale * ad["A"].float() @ ad["B"].float()).to(dtype)


def apply_lora(base_params: Any, adapters: Dict[str, dict],
               cfg: LoRAConfig) -> Any:
    """Effective params: ``base + scale·A@B`` on the target leaves (call it
    inside the loss, so autograd reaches A and B)."""
    def leaf(path, w):
        ad = adapters.get(path)
        return w if ad is None else w + _delta(ad, cfg.scale, w.dtype)

    return tree_map_with_path(leaf, base_params)


def lora_loss_fn(base_loss_fn: Callable, base_params: Any, cfg: LoRAConfig,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> Callable:
    """``(adapters, batch) -> loss`` for ``initialize(params=adapters)``.

    The frozen base is moved to ``device`` (None = CUDA) and cast to the
    compute dtype once, here (a leaf already there in that dtype is used
    as it is, without a copy); no f32 master of it is ever built."""
    dev = resolve_device(device)
    frozen = tree_map(
        lambda x: x.detach().to(device=dev, dtype=compute_dtype)
        if x.is_floating_point() else x.detach().to(dev), base_params)

    def f(adapters, batch):
        return base_loss_fn(apply_lora(frozen, adapters, cfg), batch)

    return f


def merge_lora(base_params: Any, adapters: Dict[str, dict],
               cfg: LoRAConfig) -> Any:
    """Fold trained adapters into a standalone tree (ref: peft
    merge_and_unload / the reference's full-weight export)."""
    with torch.no_grad():
        return apply_lora(base_params, adapters, cfg)


def count_trainable(adapters: Any) -> Tuple[int, int]:
    """(adapter parameters, their bytes): the LoRA footprint."""
    leaves = tree_leaves(adapters)
    return (sum(l.numel() for l in leaves),
            sum(l.numel() * l.element_size() for l in leaves))
