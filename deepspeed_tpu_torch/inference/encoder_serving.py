"""Encoder-model serving: shape-bucketed lot batching (port of
``deepspeed_tpu/inference/encoder_serving.py``; ref: the reference
kernel-injects BERT-class encoders and serves them through
``init_inference``, deepspeed/module_inject/containers/bert.py).

An encoder has no decode loop, so iteration-level scheduling reduces to
LOT BATCHING: queued requests are grouped into ``(max_batch, bucket_len)``
lots, each lot one forward.  Padding rows and positions are masked (pad
tokens attend only to each other, through the mask passed as segment ids,
and their outputs are sliced off on the host), so a request's result does
not depend on its lot-mates.  Each lot makes one host-to-device copy (its
tokens and mask together) and one device-to-host copy (its result).

A ``mesh`` with ``model`` > 1 shards the encoder's weights over its ranks
(:mod:`~deepspeed_tpu_torch.inference.sharded`, after int8 quantization
when asked), as the JAX engine does.  ``telemetry`` takes the decoder
engine's loose contract (None/bool/dict/TelemetryConfig, or a
:class:`~deepspeed_tpu_torch.telemetry.MetricsRegistry` to share): the
``encoder_lots``, ``encoder_requests`` and ``encoder_rows_padded``
counters beside ``stats``, and an exporter when sink keys are set.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch.inference.quantized import (_takes_quantized,
                                                     quantize_for_inference,
                                                     quantized_apply,
                                                     takes_quantized)
from deepspeed_tpu_torch.topology import set_current_mesh

# BERT leaves an int8 engine keeps exact (the JAX builder's list): norm
# scales and biases, every bias, and the embedding tables (``embed`` is
# also the tied MLM decoder, kept exact so the logits stay trustworthy)
BERT_INT8_SKIP = ("scale", "bias", "b_in", "b_out", "bqkv", "bo",
                  "attn_norm_scale", "attn_norm_bias", "mlp_norm_scale",
                  "mlp_norm_bias", "embed", "pos_embed", "type_embed",
                  "mlm_bias", "b")


def _encoder_telemetry(telemetry):
    """Same loose telemetry contract as the decoder ServingEngine:
    None/bool/dict/TelemetryConfig build a registry (plus an exporter
    when sink keys are set); an existing MetricsRegistry is shared and
    the caller owns its sinks.  Returns ``(registry, exporter)``."""
    from deepspeed_tpu_torch.config import TelemetryConfig
    from deepspeed_tpu_torch.telemetry import (MetricsRegistry,
                                               TelemetryExporter)

    if isinstance(telemetry, MetricsRegistry):
        return telemetry, None
    tcfg = TelemetryConfig.coerce(telemetry)
    reg = MetricsRegistry(enabled=tcfg.enabled)
    exp = None
    if reg.enabled and (tcfg.prometheus_path
                        or tcfg.http_port is not None):
        exp = TelemetryExporter(reg, prometheus_path=tcfg.prometheus_path,
                                interval_s=tcfg.interval_s,
                                http_port=tcfg.http_port)
    return reg, exp


def _to_host(res: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of a lot's result, as float32 numpy (numpy
    has no bfloat16; the upcast is exact)."""
    if res.dtype != torch.float32:
        res = res.float()
    return res.cpu().numpy()


class EncoderServingEngine:
    """Batched scoring over ``apply_fn(params, tokens, mask)`` (tokens and
    mask [B, T] int32 on the engine's device).

    ``apply_fn`` returns a per-row tensor ([B, ...]); ``run()`` hands each
    request its own row, sliced to its true length when the output carries
    the sequence axis (``per_token=True``).  ``params`` move to ``device``
    (None = CUDA); ``weight_dtype="int8"`` quantizes them there (B9 on
    CUDA) but for ``quant_skip_paths``.

    ``mesh``: a :class:`~deepspeed_tpu_torch.topology.MeshSpec` with
    ``model`` (or ``expert``) > 1 shards the weights over its ranks, as the
    JAX engine does: quantized first (int8), then each rank keeps its
    blocks under ``specs_tree`` (the model's ``param_specs``, required
    there), and each lot runs with that mesh current.  Every rank forms the
    same lots from the same queue, so lots, buckets and stats are one
    rank's.
    """

    def __init__(self, apply_fn: Callable, params: Any, *,
                 buckets: Tuple[int, ...] = (32, 64, 128),
                 max_batch: int = 8, per_token: bool = False,
                 mesh=None, specs_tree=None,
                 weight_dtype: str = "bfloat16",
                 quant_group_size: int = 128, quant_skip_paths=(),
                 telemetry=None, device=None):
        from deepspeed_tpu_torch.inference.serving import (_active_mesh,
                                                           _to_device)

        self.device = resolve_device(device)
        self.mesh = _active_mesh(mesh)
        if weight_dtype not in ("bfloat16", "int8"):
            quantize_for_inference(params, weight_dtype=weight_dtype)  # raises
        if self.mesh is not None:
            if specs_tree is None:
                raise ValueError(
                    "sharded encoder serving needs the model's "
                    "param_specs (specs_tree)")
            from deepspeed_tpu_torch.inference.sharded import (
                place_for_serving)

            params, _ = place_for_serving(
                params, specs_tree, self.mesh, self.device, weight_dtype,
                quant_group_size, quant_skip_paths)
        else:
            params = _to_device(params, self.device)
            if weight_dtype == "int8":
                params, = quantize_for_inference(
                    params, group_size=quant_group_size,
                    skip_paths=quant_skip_paths)
        if weight_dtype == "int8" and not _takes_quantized(apply_fn):
            apply_fn = quantized_apply(apply_fn)
        self.params = params
        self.per_token = per_token
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets:
            raise ValueError("need at least one bucket length")
        self._fn = apply_fn
        self.queue: "collections.deque" = collections.deque()
        self.stats = {"lots": 0, "rows_padded": 0, "requests": 0}
        self.registry, self._tel_exporter = _encoder_telemetry(telemetry)
        self._c_lots = self.registry.counter(
            "encoder_lots", "static-shape lots scored")
        self._c_requests = self.registry.counter(
            "encoder_requests", "requests submitted")
        self._c_rows_padded = self.registry.counter(
            "encoder_rows_padded", "padding rows shipped in lots")

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request length {n} exceeds the largest bucket "
            f"{self.buckets[-1]}")

    def submit(self, req_id, tokens) -> None:
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError(f"request {req_id}: empty input")
        self._bucket(len(tokens))  # validate now, not at lot time
        self.queue.append((req_id, tokens))
        self.stats["requests"] += 1
        self._c_requests.inc()

    def _next_lot(self):
        """The next lot, greedily in arrival order: the queue head's bucket
        and up to ``max_batch`` requests of that bucket, the others keeping
        their places -> (lot, bucket length)."""
        lead_bucket = self._bucket(len(self.queue[0][1]))
        lot, keep = [], collections.deque()
        while self.queue and len(lot) < self.max_batch:
            rid, toks = self.queue.popleft()
            if self._bucket(len(toks)) == lead_bucket:
                lot.append((rid, toks))
            else:
                keep.append((rid, toks))
        keep.extend(self.queue)
        self.queue = keep
        return lot, lead_bucket

    @torch.no_grad()
    def run(self) -> Dict[Any, np.ndarray]:
        """Drain the queue; returns {req_id: output row} (float32 numpy).

        Lots are formed greedily in arrival order from requests sharing a
        bucket, so a long request never blocks short ones behind it (they
        board an earlier short-bucket lot)."""
        out: Dict[Any, np.ndarray] = {}
        while self.queue:
            lot, T = self._next_lot()
            B = self.max_batch
            host = np.zeros((2, B, T), np.int32)   # tokens, mask
            for r, (_, toks) in enumerate(lot):
                host[0, r, :len(toks)] = toks
                host[1, r, :len(toks)] = 1
            dev = torch.from_numpy(host).to(self.device)
            if self.mesh is not None:
                set_current_mesh(self.mesh)
            res = _to_host(self._fn(self.params, dev[0], dev[1]))
            self.stats["lots"] += 1
            self.stats["rows_padded"] += B - len(lot)
            self._c_lots.inc()
            self._c_rows_padded.inc(B - len(lot))
            for r, (rid, toks) in enumerate(lot):
                row = res[r]
                out[rid] = row[:len(toks)] if self.per_token else row
        if self._tel_exporter is not None:
            self._tel_exporter.maybe_export()
        return out


def bert_serving_engine(params, cfg, head: str = "pooled", mesh=None,
                        weight_dtype: str = "bfloat16", **kw):
    """Serve a BERT encoder (ref: module_inject/containers/bert.py).

    ``head``: "pooled" ([CLS] pooler vector per request), "mlm" (per-token
    f32 vocab logits) or "hidden" (per-token hidden states).  Default
    buckets (32, 64, ``max_seq_len``) are clamped to the learned position
    table, so a request the model cannot encode fails at ``submit()``.
    ``weight_dtype="int8"`` keeps :data:`BERT_INT8_SKIP` exact; the forward
    dequantizes one layer at a time.  ``mesh`` (``model`` > 1) serves the
    encoder over its ranks under ``bert.param_specs``.
    """
    from deepspeed_tpu_torch.models import bert

    if head not in ("pooled", "mlm", "hidden"):
        raise ValueError(f"unknown head {head!r}: pooled | mlm | hidden")

    @takes_quantized
    def apply(p, tokens, mask):
        hidden = bert.forward(p, tokens, cfg, attention_mask=mask)
        if head == "pooled":
            return bert.pooled_output(p, hidden)
        if head == "mlm":
            return bert.mlm_logits(p, hidden, cfg)
        return hidden

    kw.setdefault("buckets", tuple(sorted(
        {min(32, cfg.max_seq_len), min(64, cfg.max_seq_len),
         cfg.max_seq_len})))
    return EncoderServingEngine(
        apply, params, per_token=head != "pooled", mesh=mesh,
        specs_tree=bert.param_specs(cfg), weight_dtype=weight_dtype,
        quant_skip_paths=BERT_INT8_SKIP, **kw)


class CNNServingEngine:
    """Batched image scoring for the CNN family: a fixed input shape, so
    the only scheduling is lot formation up to ``max_batch``.  ``params``
    move to ``device`` (None = CUDA)."""

    def __init__(self, params, *, cfg=None, max_batch: int = 8,
                 image_shape: Tuple[int, int, int] = (32, 32, 3),
                 telemetry=None, device=None):
        from deepspeed_tpu_torch.inference.serving import _to_device
        from deepspeed_tpu_torch.models import cnn

        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.max_batch = int(max_batch)
        self.image_shape = tuple(image_shape)
        self._fn = cnn.forward
        self.queue: "collections.deque" = collections.deque()
        self.stats = {"lots": 0, "requests": 0}
        self.registry, self._tel_exporter = _encoder_telemetry(telemetry)
        self._c_lots = self.registry.counter(
            "encoder_lots", "static-shape lots scored")
        self._c_requests = self.registry.counter(
            "encoder_requests", "requests submitted")

    def submit(self, req_id, image) -> None:
        image = np.asarray(image, np.float32)
        if image.shape != self.image_shape:
            raise ValueError(
                f"request {req_id}: image shape {image.shape} != "
                f"{self.image_shape}")
        self.queue.append((req_id, image))
        self.stats["requests"] += 1
        self._c_requests.inc()

    @torch.no_grad()
    def run(self) -> Dict[Any, np.ndarray]:
        out: Dict[Any, np.ndarray] = {}
        while self.queue:
            lot = [self.queue.popleft()
                   for _ in range(min(self.max_batch, len(self.queue)))]
            batch = np.zeros((self.max_batch,) + self.image_shape,
                             np.float32)
            for r, (_, img) in enumerate(lot):
                batch[r] = img
            logits = _to_host(self._fn(
                self.params, torch.from_numpy(batch).to(self.device)))
            self.stats["lots"] += 1
            self._c_lots.inc()
            for r, (rid, _) in enumerate(lot):
                out[rid] = logits[r]
        if self._tel_exporter is not None:
            self._tel_exporter.maybe_export()
        return out
