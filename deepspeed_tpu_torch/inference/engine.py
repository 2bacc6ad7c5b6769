"""Inference engine and the ``init_inference`` / ``init_serving`` entry
points (port of ``deepspeed_tpu/inference/engine.py``; ref:
deepspeed/inference/engine.py ``InferenceEngine``).

The engine holds the params on one device and runs the model's forward
under ``torch.inference_mode()``.  ``dtype="int8"`` is weight-only int8
(:mod:`~deepspeed_tpu_torch.inference.quantized`): every floating leaf with
``ndim >= 2`` is quantized (kernel B9 on CUDA).  A forward marked
``takes_quantized`` (the Llama forwards, or a ``functools.partial`` of one)
gets the int8 tree and dequantizes one layer at a time; any other forward
is wrapped to dequantize the whole tree to bfloat16 on each call, as the
JAX package does for every forward (a bf16 copy of the model per call).

Tensor parallelism: ``init_inference(mesh=, param_specs=)`` keeps this
rank's block of each leaf (int8 codes and scales cut like their weight)
and runs the forward with that mesh current, so a model whose forwards
read their leaves' shapes (the Llama and Mixtral ones) performs the
collectives its blocks need; every rank returns the same output.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from deepspeed_tpu_torch import precision, topology
from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch._tree import tree_map
from deepspeed_tpu_torch.config import Config, PrecisionConfig
from deepspeed_tpu_torch.inference.quantized import quantize_for_inference
from deepspeed_tpu_torch.inference.serving import serving_engine


class InferenceEngine:
    """The forward ``apply_fn(params, *inputs)`` over params on one
    device (None = CUDA, raising without it; ``"cpu"`` runs the plain
    versions)."""

    def __init__(self, apply_fn: Callable, params: Any, device=None,
                 dtype: str = "bfloat16", quant_group_size: int = 128,
                 mesh: Optional[topology.MeshSpec] = None,
                 param_specs: Any = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and param_specs is not None:
            from deepspeed_tpu_torch.inference.quantized import (
                _takes_quantized, quantized_apply)
            from deepspeed_tpu_torch.inference.sharded import (
                place_for_serving)

            # the JAX engine quantizes every ndim >= 2 leaf (no skips),
            # then places codes and scales under the weight's spec
            params, _ = place_for_serving(params, param_specs, mesh,
                                          self.device, dtype,
                                          quant_group_size)
            if dtype == "int8":
                if not _takes_quantized(apply_fn):
                    apply_fn = quantized_apply(apply_fn)
            else:
                params = precision.cast_for_compute(
                    params, PrecisionConfig(dtype=dtype))
            self.apply_fn, self.params = apply_fn, params
            return
        params = tree_map(lambda t: t.to(self.device), params)
        if dtype == "int8":
            # weight-only quantization (ref: init_inference(dtype=int8)):
            # int8 codes + group scales resident.  Every ndim >= 2 leaf
            # quantizes, the stacked norm gains too, as the JAX engine
            # passes no skip_paths
            params, apply_fn = quantize_for_inference(
                params, apply_fn, group_size=quant_group_size)
        else:
            params = precision.cast_for_compute(
                params, PrecisionConfig(dtype=dtype))
        self.apply_fn = apply_fn
        self.params = params

    def __call__(self, *inputs):
        inputs = [x.to(self.device) if isinstance(x, torch.Tensor) else x
                  for x in inputs]
        if self.mesh is not None:
            topology.set_current_mesh(self.mesh)
        with torch.inference_mode():
            return self.apply_fn(self.params, *inputs)

    def forward(self, *inputs):
        return self(*inputs)


def init_inference(model: Any = None, *, apply_fn: Optional[Callable] = None,
                   params: Any = None, config: Any = None, device=None,
                   mesh: Any = None, param_specs: Any = None,
                   dtype: str = "bfloat16", quant_group_size: int = 128,
                   **_compat) -> InferenceEngine:
    """ref: deepspeed.init_inference(model, config...) -> engine.

    ``model`` may be an object with ``.apply`` / ``.params``, or pass
    ``apply_fn`` + ``params`` explicitly.  A ``config`` dict is parsed
    (and so validated) as the training config is.  ``mesh`` (a
    :class:`~deepspeed_tpu_torch.topology.MeshSpec` over the process
    group) with ``param_specs`` runs one tensor-parallel replica: each rank
    keeps its blocks (the JAX engine's ``param_shardings`` at stage 0);
    other keywords of DeepSpeed's signature are accepted and unused, as in
    the JAX package."""
    if mesh is not None and not isinstance(mesh, topology.MeshSpec):
        raise TypeError(f"mesh must be a topology.MeshSpec, got "
                        f"{type(mesh).__name__}")
    if param_specs is not None and mesh is None:
        raise ValueError("param_specs place leaves over a mesh: pass mesh= "
                         "(a topology.MeshSpec over the process group)")
    if isinstance(config, dict):
        config = Config.from_dict(config)
    if apply_fn is None:
        if model is None or not hasattr(model, "apply"):
            raise ValueError("provide apply_fn+params or a model with .apply")
        apply_fn = model.apply
        params = params if params is not None else getattr(model, "params",
                                                           None)
    if params is None:
        raise ValueError("init_inference requires params")
    return InferenceEngine(apply_fn, params, device=device, dtype=dtype,
                           quant_group_size=quant_group_size, mesh=mesh,
                           param_specs=param_specs)


def serving_mesh_from_config(config: Any) -> Optional[topology.MeshSpec]:
    """The serving mesh a config's ``mesh`` block asks for: None when every
    axis but ``data`` is 1 (the one-device engine), else a
    :class:`~deepspeed_tpu_torch.topology.MeshSpec` of those sizes over
    the ranks of the process group (``data`` is a training axis, read as 1
    here as the JAX package does: one replica has no data axis, and the
    fleet replicates)."""
    import logging

    mc = config.mesh
    sizes = {"pipe": mc.pipe, "expert": mc.expert, "seq": mc.seq,
             "model": mc.model}
    if mc.data not in (1, -1):
        logging.getLogger(__name__).warning(
            "serving mesh: ignoring mesh.data=%s — one serving replica has "
            "no data axis (replicate via the fleet instead)", mc.data)
    if all(int(v) <= 1 for v in sizes.values()):
        return None
    return topology.MeshSpec.build(dict(sizes, data=1))


# config blocks that are off unless enabled, passed through when they are
_OPT_IN_BLOCKS = ("zero_inference", "prefix_cache", "kv_tier", "speculative",
                  "slo", "faults", "history", "incidents")


def init_serving(params, model_config, *, config: Any = None, **kw):
    """Serving counterpart of :func:`init_inference`: the continuous-
    batching engine for a model-family config
    (:func:`~deepspeed_tpu_torch.inference.serving.serving_engine`),
    honouring a DeepSpeed-style config.  Each enabled block of ``config``
    reaches the engine unless a keyword of the same name is given (the
    keyword wins), as the JAX package routes them: ``zero_inference`` to
    the weight-streamed engine of the Llama and Mixtral builders,
    ``speculative`` to the draft-and-verify sweep (a model drafter rides
    the ``drafter=`` keyword), ``slo``, ``faults``, ``history`` and
    ``incidents`` to the control plane.  The ``telemetry``, ``tracing``
    and ``kernels`` blocks always pass (on by default in the schema, as
    in the JAX package).  Remaining ``kw`` (``max_batch``, ``page_size``,
    ``num_pages``, ``prefill_chunk``, ``weight_dtype``, ...) pass through
    to the model family's engine function."""
    if isinstance(config, dict):
        config = Config.from_dict(config)
    if config is not None:
        mesh = serving_mesh_from_config(config)
        if mesh is not None:
            kw.setdefault("mesh", mesh)
        if "comm" in config.raw:
            kw.setdefault("comm", config.comm)
        for name in _OPT_IN_BLOCKS:
            block = getattr(config, name)
            if block.enabled:
                kw.setdefault(name, block)
        for name in ("telemetry", "tracing"):
            kw.setdefault(name, getattr(config, name))
        kw.setdefault("kernels", {
            "paged_attention": config.kernels.paged_attention,
            "fused_sampling": config.kernels.fused_sampling})
    return serving_engine(params, model_config, **kw)
