"""ZeRO-Inference: serve models larger than the card by streaming layer
weights from host memory or NVMe under the sweep (port of
``deepspeed_tpu/inference/zero_inference.py``; ref: DeepSpeed
ZeRO-Inference, arXiv:2206.01861, on ZeRO-Infinity's parameter offload,
arXiv:2104.07857).

The model is factored per layer (``paged_layered_fns`` of the Llama and
Mixtral families): stem (embedding, rope tables) and head (final norm, LM
head) stay on the card, and so do as many leading layers as
``hbm_budget_bytes`` holds (:func:`plan_residency`); the rest live on a tier
(:mod:`~deepspeed_tpu_torch.infinity`) and stream through a ring of
``prefetch_depth + 1`` preallocated device buffers per leaf while the host
drives the layer sweep:

- host tier: each streamed layer's leaves sit in ONE page-locked host
  buffer (registered once, at ingest), so ``copy_(non_blocking=True)`` on
  a side stream really overlaps the compute stream;
- NVMe tier: one file per leaf, read through the port's aio pool into two
  page-locked staging buffers on alternating slots, then uploaded the same
  way (prefetch depth 1, as in the JAX package).

Ordering is by CUDA events, never by a host synchronise: the copy into a
ring slot waits for the compute event of the layer that last used the slot,
and the compute stream waits for the slot's copy event before the layer
runs.  The exposed wait of each streamed layer (the compute stream's idle
time between the previous block and this one, on the device clock; the
JAX package's ``zi_prefetch_wait_seconds``) is what
:meth:`ZeroInferenceServingEngine.prefetch_wait_seconds` returns.

The KV cache keeps the base engine's stacked ``[L, KV, P, ps, Dh]`` layout:
a block writes its layer's view in place, so the base engine's page moves
(demote, promote) serve unchanged.  The scheduler is the base
:class:`~deepspeed_tpu_torch.inference.serving.ServingEngine`'s: prefill,
chunked prefill, decode chunks and the speculative verify pass are its
forwards, each one layer sweep, so one weight stream scores every position
of every active slot (speculation divides the streamed bytes per emitted
token by the mean acceptance length).

Over a sharding ``mesh`` (``model`` and, for Mixtral, ``expert``; JAX's
``zero_inference_serving_engine(mesh=)``) each rank ingests only its block
of every leaf under the family's ``param_specs`` (int8 leaves quantized
whole on the resident builders' grid and then cut, as
:func:`~deepspeed_tpu_torch.inference.sharded.shard_quantized` cuts them),
so its tier holds and its ring streams 1/tp of each layer; the paged KV
cache holds ``n_kv_heads / tp`` heads a rank, the residency plan is per
rank, and the forward runs with the mesh current (the models' sharded
blocks decide their collectives from the leaves' shapes).

The fleet methods of the JAX engine serve the elastic fleet
(:mod:`~deepspeed_tpu_torch.autoscale`): :meth:`~ZeroInferenceServingEngine.
promote_resident_layers` moves streamed layers onto the card between
scheduler steps until :attr:`~ZeroInferenceServingEngine.fully_resident`
(the streamed cold start's flip), :meth:`~ZeroInferenceServingEngine.
swap_weights` is the drained engine's rolling update, and ``statusz``
reports the live residency.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch._tree import (tree_leaves, tree_leaves_with_path,
                                       tree_map, tree_unflatten_like)
from deepspeed_tpu_torch.config import KVTierConfig, ZeroInferenceConfig
from deepspeed_tpu_torch.infinity import (PinnedBuffer, _NvmeTier, _RamTier,
                                          pinned_views)
from deepspeed_tpu_torch.inference.quantized import (param_bytes,
                                                     quantize_params)
from deepspeed_tpu_torch.inference.serving import (ServingEngine,
                                                   _weak_method)
from deepspeed_tpu_torch.param_stream import TierLayerReader

logger = logging.getLogger(__name__)


def plan_residency(*, n_layers: int, layer_bytes: int,
                   stem_head_bytes: int, cache_bytes: int,
                   budget: Optional[int],
                   prefetch_depth: int) -> Dict[str, Any]:
    """Device-budget planner: how many leading layers stay resident.

    Fixed charges come first: stem + head weights, the paged KV cache, and
    (whenever anything streams) the ``(prefetch_depth + 1)``-layer ring.
    Whatever budget remains pins layers resident.  ``budget=None`` streams
    everything; a budget that cannot hold the fixed charges is a config
    error, not a silent out-of-memory."""
    total_resident = stem_head_bytes + cache_bytes + n_layers * layer_bytes
    working = (prefetch_depth + 1) * layer_bytes
    if budget is None:
        n_res = 0
    elif budget >= total_resident:
        n_res = n_layers
    else:
        floor = stem_head_bytes + cache_bytes + working
        if floor > budget:
            raise ValueError(
                f"zero_inference.hbm_budget_bytes={budget} cannot hold "
                f"the streaming floor: stem+head {stem_head_bytes} B + "
                f"KV cache {cache_bytes} B + {prefetch_depth + 1}-layer "
                f"working set {working} B = {floor} B")
        n_res = min(n_layers - 1, (budget - floor) // max(layer_bytes, 1))
    ws = stem_head_bytes + cache_bytes + n_res * layer_bytes + (
        0 if n_res == n_layers else working)
    return {
        "n_layers": n_layers,
        "n_resident": int(n_res),
        "n_streamed": int(n_layers - n_res),
        "layer_bytes": int(layer_bytes),
        "stem_head_bytes": int(stem_head_bytes),
        "cache_bytes": int(cache_bytes),
        "weight_image_bytes": int(stem_head_bytes
                                  + n_layers * layer_bytes),
        "hbm_budget_bytes": budget,
        "prefetch_depth": int(prefetch_depth),
        "hbm_working_set_bytes": int(ws),
    }


def _layer_source(blocks, n_layers: int):
    """``l -> layer l's tree`` over the JAX layout's stacked blocks (every
    leaf ``[L, ...]``, int8 leaves as stacked QuantizedTensors) or over a
    sequence of per-layer trees (which may be lazy: a model larger than
    both the card and the host's spare memory is drawn or loaded one layer
    at a time)."""
    if isinstance(blocks, dict):
        for a in tree_leaves(blocks):
            if a.shape[0] != n_layers:
                raise ValueError(
                    f"stacked block leaf {tuple(a.shape)} does not carry "
                    f"the layer axis (n_layers={n_layers}) in dim 0")
        return lambda l: tree_map(lambda a: a[l], blocks)
    if len(blocks) != n_layers:
        raise ValueError(f"{len(blocks)} layer trees for n_layers="
                         f"{n_layers}")
    return lambda l: blocks[l]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ZeroInferenceServingEngine(ServingEngine):
    """Weight-streamed continuous-batching serving engine: the
    :class:`ServingEngine` surface and scheduler, with the three forwards
    replaced by host-driven layer sweeps that stream non-resident layers
    from ``self.tier``.  ``plan`` is the residency decision;
    :meth:`hbm_weight_working_set_bytes` the streaming contract.

    Counts (plain ints, the JAX metric names): ``zi_layer_sweeps``,
    ``zi_layer_h2d_uploads``, ``zi_bytes_uploaded``; and
    :meth:`prefetch_wait_seconds`, one exposed wait per streamed layer."""

    def __init__(self, *, stem, blocks, head, fns, zi: ZeroInferenceConfig,
                 n_layers: int, n_kv: int, head_dim: int, layer_fn=None,
                 **kw):
        self._zi = zi
        kvt = KVTierConfig.coerce(kw.get("kv_tier"))
        if kvt.enabled and kvt.quantized_resident:
            # the streamed blocks write dense pages; there are no int8
            # code/scale planes to publish into — fail loudly, never serve
            # dense pages under a quantized-resident config
            raise NotImplementedError(
                "kv_tier.quantized_resident is not wired for the "
                "weight-streamed (zero_inference) engine — serve "
                "resident, or drop quantized_resident")
        self._stem_fn, self._block_fn, self._head_fn = fns
        self._L = n_layers
        self._layer_fn = layer_fn
        layer = _layer_source(blocks, n_layers)
        if layer_fn is not None:
            raw = layer
            layer = lambda l: layer_fn(raw(l))  # noqa: E731
        # layer 0 is drawn once: its leaves size the plan, then it is the
        # ingest's first layer (a lazy source draws nothing twice)
        first = layer(0)
        leaves = tree_leaves(first)
        # the layer tree's structure only
        self._template = tree_map(lambda a: 0, first)
        self._shapes = [tuple(a.shape) for a in leaves]
        self._dtypes = [a.dtype for a in leaves]
        layer_bytes = sum(_nbytes(a) for a in leaves)
        self._layer_bytes = int(layer_bytes)
        del leaves

        # ---- residency plan, per rank; the cache geometry is the base
        # engine's signature defaults (kw is forwarded to it as is), its
        # heads this rank's under a model axis
        from deepspeed_tpu_torch.inference.serving import _active_mesh

        mesh = _active_mesh(kw.get("mesh"))
        tp = mesh.size("model") if mesh is not None else 1
        cache_dtype = kw.get("cache_dtype", torch.bfloat16)
        cache_bytes = (2 * n_layers * (n_kv // tp) * kw.get("num_pages", 128)
                       * kw.get("page_size", 16) * head_dim
                       * torch.empty((), dtype=cache_dtype).element_size())
        # tied embeddings alias ONE table between stem and head: charge it
        # once
        seen, stem_head_bytes = set(), 0
        for x in list(stem.values()) + list(head.values()):
            if id(x) not in seen:
                seen.add(id(x))
                stem_head_bytes += param_bytes(x)
        self.plan = plan_residency(
            n_layers=n_layers, layer_bytes=layer_bytes,
            stem_head_bytes=stem_head_bytes, cache_bytes=cache_bytes,
            budget=zi.hbm_budget_bytes, prefetch_depth=zi.prefetch_depth)
        n_res = self.plan["n_resident"]
        self._streamed_ids = list(range(n_res, n_layers))

        fwd = _weak_method(self._forward)
        super().__init__(
            None, lambda p, t, c: fwd(t, c, False),
            lambda p, t, c: fwd(t, c, False), n_layers=n_layers, n_kv=n_kv,
            head_dim=head_dim,
            chunk_prefill_fn=lambda p, t, c: fwd(t, c, True), **kw)
        dev = self.device
        self._cuda = dev.type == "cuda"
        self.zi_layer_h2d_uploads = 0
        self.zi_layer_sweeps = 0
        self.zi_bytes_uploaded = 0
        self._waits: List[float] = []
        self._wait_events: List = []

        # ---- ingest: resident layers to the card, streamed ones to the
        # tier, one layer at a time (a lazy source never holds two)
        nvme = zi.tier == "nvme" and bool(self._streamed_ids)
        swap = os.path.join(zi.nvme_path, "zero_inference")
        if mesh is not None:
            from deepspeed_tpu_torch import comm

            # a subdir a rank: each holds its own blocks
            swap = os.path.join(swap, f"proc{comm.get_rank()}")
        self.tier = _NvmeTier(swap) if nvme else _RamTier()
        self._resident: Dict[int, Any] = {}
        self._pinned: List[PinnedBuffer] = []
        for l in range(n_layers):
            tree, first = (first if l == 0 else layer(l)), None
            if l < n_res:
                self._resident[l] = tree_map(lambda a: a.to(dev), tree)
            elif nvme:
                for i, a in enumerate(tree_leaves(tree)):
                    self.tier.put(self._name(l, i),
                                  a.detach().to("cpu").contiguous())
                self.tier.fence_writes()
            else:
                views = self._host_layer()
                for i, (v, a) in enumerate(zip(views, tree_leaves(tree))):
                    v.copy_(a)
                    self.tier.put(self._name(l, i), v)
            del tree

        # ---- the device ring (prefetch_depth + 1 slots per leaf), its
        # events, and the NVMe tier's pinned staging slots
        self._ring_n = zi.prefetch_depth + 1 if not nvme else 2
        self._rings = [torch.empty((self._ring_n,) + s, dtype=d, device=dev)
                       for s, d in zip(self._shapes, self._dtypes)]
        self._uploads = 0
        self._staging = [self._host_layer() for _ in range(2)] if nvme \
            else []
        self._staging_of: Dict[int, int] = {}
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(device=dev)
            self._ready = [torch.cuda.Event() for _ in range(self._ring_n)]
            self._free = [torch.cuda.Event() for _ in range(self._ring_n)]
            self._staged = [torch.cuda.Event() for _ in self._staging]
        self._reader = TierLayerReader(
            self.tier, names_fn=_weak_method(self._names),
            shapes=self._shapes, dtypes=self._dtypes,
            to_device=_weak_method(self._upload), depth=zi.prefetch_depth,
            retries=zi.io_retries, retry_backoff_s=zi.io_retry_backoff_s,
            out_fn=_weak_method(self._stage) if nvme else None)
        # KV promotion and the weight stream share the disk when both
        # tiers are NVMe: the weight reads rank ABOVE the KV channel, so a
        # promotion defers (bounded) while layer fetches are in flight — a
        # starved weight read stalls the whole batch, a deferred promotion
        # one admission
        if self._kv_pool is not None and isinstance(self.tier, _NvmeTier):
            from deepspeed_tpu_torch.io.aio import AioPriorityGroup

            grp = AioPriorityGroup()
            for h in self.tier.rpools:
                grp.register(h.pending, 1)
            self._kv_pool.set_priority(grp, 0)
        self._stem = tree_map(lambda a: a.to(dev), stem)
        self._head = {k: (self._stem[k] if v is stem.get(k)
                          else tree_map(lambda a: a.to(dev), v))
                      for k, v in head.items()}
        logger.info(
            "zero-inference: %d/%d layers resident (%.1f MB/layer), "
            "tier=%s depth=%d, device weight working set %.1f MB of a "
            "%.1f MB image", n_res, n_layers, layer_bytes / 1e6, zi.tier,
            self._reader.depth, self.plan["hbm_working_set_bytes"] / 1e6,
            self.plan["weight_image_bytes"] / 1e6)

    # ------------------------------------------------------------- tiers
    @staticmethod
    def _name(l: int, i: int) -> str:
        return f"zi_p_{l}_{i}"

    def _names(self, l: int) -> List[str]:
        return [self._name(l, i) for i in range(len(self._shapes))]

    def _host_layer(self) -> List[torch.Tensor]:
        """Views of one page-locked host buffer holding a layer's leaves
        (one registration per layer)."""
        return pinned_views(self._shapes, self._dtypes, self._pinned)

    def _stage(self, l: int) -> List[torch.Tensor]:
        """``out_fn`` of the NVMe reader: layer ``l``'s reads land in the
        staging slot of the tier's current read slot, once the upload that
        last read that slot has finished."""
        s = self.tier.rslot
        if self._cuda:
            self._staged[s].synchronize()
        self._staging_of[l] = s
        return self._staging[s]

    def _upload(self, bufs, l: int) -> int:
        """The reader's ``to_device``: copy layer ``l``'s fenced host
        buffers into the next ring slot, asynchronously on the copy stream
        on CUDA; returns the slot."""
        s = self._uploads % self._ring_n
        self._uploads += 1
        if self._cuda:
            cs = self._copy_stream
            # the compute stream is done with the slot's previous layer
            cs.wait_event(self._free[s])
            with torch.cuda.stream(cs):
                for ring, buf in zip(self._rings, bufs):
                    ring[s].copy_(buf, non_blocking=True)
                self._ready[s].record(cs)
                if l in self._staging_of:
                    self._staged[self._staging_of.pop(l)].record(cs)
        else:
            for ring, buf in zip(self._rings, bufs):
                ring[s].copy_(buf)
        self.zi_layer_h2d_uploads += 1
        self.zi_bytes_uploaded += self._layer_bytes
        return s

    # ------------------------------------------------------ layer sweep
    def _layer_sweep(self):
        """Yield ``(l, layer tree, ring slot or None)`` over all layers in
        order; streamed layers come off the reader with the next uploads
        in flight.  The reader is primed before the resident prefix runs,
        so the first streamed layers upload under it."""
        self.zi_layer_sweeps += 1
        gen = (self._reader.sweep(self._streamed_ids) if self._streamed_ids
               else iter(()))
        first = next(gen, None)
        for l in range(self._L):
            if l in self._resident:
                yield l, self._resident[l], None
                continue
            item, first = (first if first is not None else next(gen)), None
            s = item[1]
            yield l, tree_unflatten_like(
                self._template, [r[s] for r in self._rings]), s

    def _forward(self, tokens, cache, continuation: bool):
        """One streamed forward with :func:`~deepspeed_tpu_torch.models.
        llama.forward_paged`'s contract: the same stem, blocks and head,
        in the same order."""
        from deepspeed_tpu_torch.inference.kernels import (
            paged_forward_prelude)

        if self.mesh is not None:
            from deepspeed_tpu_torch import topology

            topology.set_current_mesh(self.mesh)
        T = tokens.shape[1]
        _, start, prefill = paged_forward_prelude(cache, tokens,
                                                  continuation)
        x, cos, sin = self._stem_fn(self._stem, tokens, start)
        cur = torch.cuda.current_stream() if self._cuda else None
        for l, lp, s in self._layer_sweep():
            if s is not None and self._cuda:
                before = torch.cuda.Event(enable_timing=True)
                after = torch.cuda.Event(enable_timing=True)
                before.record(cur)
                cur.wait_event(self._ready[s])
                after.record(cur)
                self._wait_events.append((before, after))
            x = self._block_fn(lp, x, cos, sin, cache.k[l], cache.v[l],
                               cache.table, start,
                               continuation=continuation, prefill=prefill)
            if s is not None and self._cuda:
                self._free[s].record(cur)
        return self._head_fn(self._head, x), dataclasses.replace(
            cache, seq_lens=start + T)

    # ------------------------------------------ streamed -> resident flip
    # (the elastic fleet's warm cold start: a replica spawns streamed —
    # serving at once while its weights live on the tier — and the
    # autoscaler promotes layers onto the card between scheduler steps
    # until the engine is fully resident)
    @property
    def fully_resident(self) -> bool:
        """True once every layer's weights are on the card (no tier reads
        left on the decode path)."""
        return not self._streamed_ids

    @property
    def resident_flip_blocked(self) -> bool:
        """True when ``hbm_budget_bytes`` cannot hold another resident
        layer: streaming is then this engine's steady state, and a
        cold-start promoter stops here."""
        return bool(self._streamed_ids) and not self._promote_budget_ok()

    def _promote_budget_ok(self) -> bool:
        budget = self._zi.hbm_budget_bytes
        if budget is None:
            return True
        working = (self._ring_n * self._layer_bytes
                   if len(self._streamed_ids) > 1 else 0)
        after = (self.plan["stem_head_bytes"] + self.plan["cache_bytes"]
                 + (len(self._resident) + 1) * self._layer_bytes + working)
        return after <= budget

    def promote_resident_layers(self, n: int = 1) -> int:
        """Move up to ``n`` streamed layers' weights onto the card (a
        synchronous tier read and upload; call BETWEEN scheduler steps,
        when no sweep is in flight).  Stops early when ``hbm_budget_bytes``
        cannot hold another resident layer.  Returns the number promoted;
        the engine is fully resident once :attr:`fully_resident` is
        True."""
        done = 0
        dev = self.device
        while self._streamed_ids and done < n:
            if not self._promote_budget_ok():
                break
            l = self._streamed_ids[0]
            bufs = [self.tier.read_sync(name, s, d) for name, s, d in
                    zip(self._names(l), self._shapes, self._dtypes)]
            self._resident[l] = tree_unflatten_like(
                self._template, [b.to(dev) for b in bufs])
            self._streamed_ids.pop(0)
            done += 1
        return done

    # ------------------------------------------------------- weight swap
    def swap_params(self, new_params, version=None) -> None:
        raise NotImplementedError(
            "the streamed engine serves a decomposed weight image "
            "(resident stem/head + tiered blocks) — use swap_weights("
            "stem, blocks, head, version=) with trees prepared like the "
            "constructor's (same quantization)")

    def swap_weights(self, stem, blocks, head, version=None) -> None:
        """Rolling-update weight swap for the streamed engine: ``stem`` and
        ``head`` as the builder passes them to the constructor, ``blocks``
        in the constructor's form (stacked ``[L, ...]`` leaves or a
        sequence of per-layer trees; the engine's own per-layer
        preparation applies).  Refreshes every streamed layer's tier
        entries, re-uploads the resident layers, re-places stem and head,
        and drops the warm prefix pages.  The drained-engine contract of
        :meth:`~deepspeed_tpu_torch.inference.serving.ServingEngine.
        swap_params`, and its refusal of a tree whose structure, shapes or
        dtypes differ."""
        from deepspeed_tpu_torch.inference.serving import EngineClosed

        if self._closed:
            raise EngineClosed(
                "swap_weights on a shut-down engine"
                + (f" (replica {self.replica_id})"
                   if self.replica_id else ""))
        if self.has_work:
            raise RuntimeError(
                "swap_weights needs a drained engine (queue and slots "
                "empty) — drain the replica first so no in-flight request "
                "mixes weight versions")
        src = _layer_source(blocks, self._L)
        layer = src if self._layer_fn is None else (
            lambda l: self._layer_fn(src(l)))

        def mismatch(new, ref) -> bool:
            a, b = tree_leaves_with_path(new), tree_leaves_with_path(ref)
            return [p for p, _ in a] != [p for p, _ in b] or any(
                getattr(x, "shape", None) != getattr(y, "shape", None)
                or getattr(x, "dtype", None) != getattr(y, "dtype", None)
                for (_, x), (_, y) in zip(a, b))

        first = layer(0)
        if mismatch(first, tree_unflatten_like(self._template, [
                torch.empty(s, dtype=d, device="meta")
                for s, d in zip(self._shapes, self._dtypes)])):
            raise ValueError(
                "swap_weights: new block tree does not match the served "
                "one (structure/shape/dtype) — rebuild the engine for an "
                "architecture change")
        for what, new, ref in (("stem", stem, self._stem),
                               ("head", head, self._head)):
            if mismatch(new, ref):
                raise ValueError(
                    f"swap_weights: new {what} tree does not match the "
                    "served one (structure/shape/dtype) — rebuild the "
                    "engine for an architecture change")
        dev = self.device
        nvme = isinstance(self.tier, _NvmeTier)
        for l in range(self._L):
            tree, first = (first if l == 0 else layer(l)), None
            if l in self._resident:
                self._resident[l] = tree_map(lambda a: a.to(dev), tree)
                continue
            for name, a in zip(self._names(l), tree_leaves(tree)):
                if nvme:
                    self.tier.put(name, a.detach().to("cpu").contiguous())
                else:
                    self.tier.store[name].copy_(a)
            if nvme:
                self.tier.fence_writes()
        self._stem = tree_map(lambda a: a.to(dev), stem)
        self._head = {k: (self._stem[k] if v is stem.get(k)
                          else tree_map(lambda a: a.to(dev), v))
                      for k, v in head.items()}
        self._invalidate_warm_pages()
        if version is not None:
            self.weights_version = version
        if self._trace_on:
            self.tracer.event("weights_swap", attrs={
                "version": str(self.weights_version)})

    # ------------------------------------------------------- inspection
    def statusz(self) -> Dict[str, Any]:
        """Base snapshot + the weight-streaming view: the residency plan,
        the live residency (:meth:`promote_resident_layers` moves layers
        out of the streamed set after the plan was made) and the bytes
        shipped."""
        s = ServingEngine.statusz(self)
        s["zero_inference"] = {
            "tier": self._zi.tier,
            "plan": dict(self.plan),
            "n_streamed_now": len(self._streamed_ids),
            "n_resident_now": len(self._resident),
            "fully_resident": self.fully_resident,
            "layer_h2d_uploads": int(self.zi_layer_h2d_uploads),
            "layer_sweeps": int(self.zi_layer_sweeps),
            "bytes_uploaded": int(self.zi_bytes_uploaded),
            "stream_retries": int(self._reader.io_retries),
            "stream_sync_fallbacks": int(self._reader.sync_fallbacks),
        }
        return s

    # ------------------------------------------------------- inspection
    def prefetch_wait_seconds(self) -> List[float]:
        """One entry per streamed layer consumed so far: the time the
        compute stream stood idle before the layer's block, waiting for
        its weights (``zi_prefetch_wait_seconds``; device clock, read
        after the device reaches it).  On the CPU the uploads are
        synchronous copies and nothing waits."""
        if self._wait_events:
            pend, self._wait_events = self._wait_events, []
            pend[-1][1].synchronize()
            self._waits += [b.elapsed_time(a) / 1e3 for b, a in pend]
        return list(self._waits)

    def hbm_weight_working_set_bytes(self) -> int:
        """Peak weight bytes on the card under the plan: stem + head +
        pinned layers + the streaming ring (the full image never
        lands)."""
        return self.plan["hbm_working_set_bytes"]


# --------------------------------------------------------------- builders
def _drop_layer_dim(spec) -> tuple:
    """A stacked block leaf's spec without its layer dim (JAX's refusal
    when it is split: the streaming schedule owns that axis)."""
    if spec is None:
        return ()
    if len(spec) and spec[0] is not None:
        raise ValueError(
            f"stacked block spec {spec} shards the layer axis — the "
            "streaming engine owns that axis (host schedule)")
    return tuple(spec)[1:]


_FAMILY_SKIPS = {
    # the resident builders' exact-leaf sets: the quantization grid must
    # match or streamed and resident outputs diverge
    "llama": ("attn_norm", "mlp_norm", "final_norm"),
    "mixtral": ("gate", "attn_norm", "mlp_norm", "final_norm"),
}


def zero_inference_serving_engine(params, cfg, zi, *, family: str,
                                  weight_dtype: str = "bfloat16",
                                  quant_group_size: int = 128,
                                  device=None, **kw
                                  ) -> ZeroInferenceServingEngine:
    """Build the weight-streamed serving engine for a layered decoder
    family (ref: deepspeed-inference's ``init_inference`` with
    ZeRO-Inference offload).  ``params`` is the JAX layout; its ``blocks``
    may also be a sequence of per-layer trees (see
    :class:`ZeroInferenceServingEngine`).  ``zi.dtype`` overrides
    ``weight_dtype``; int8 quantizes each layer as it is ingested on the
    same per-leaf grid as the resident builders (groups never cross a
    row), so streamed int8 serving is token-identical to resident int8
    serving."""
    from deepspeed_tpu_torch.inference.kernels import resolve_serving_kernels

    from deepspeed_tpu_torch.inference.serving import _active_mesh

    zi = ZeroInferenceConfig.coerce(zi)
    if family not in _FAMILY_SKIPS:
        raise NotImplementedError(
            f"zero-inference streaming supports llama/mixtral, got "
            f"{family!r}")
    dev = resolve_device(device)
    kw["kernels"] = resolve_serving_kernels(kw.get("kernels"), device=dev)
    pk = kw["kernels"].paged_attention
    mesh = _active_mesh(kw.get("mesh"))
    if family == "mixtral":
        from deepspeed_tpu_torch.models import mixtral as fam

        if mesh is not None and cfg.num_experts % mesh.size("expert"):
            raise ValueError(
                f"num_experts {cfg.num_experts} not divisible by "
                f"expert-axis size {mesh.size('expert')}")
    else:
        from deepspeed_tpu_torch.models import llama as fam
    fns = fam.paged_layered_fns(cfg, paged_kernel=pk)

    stem = {"embed": params["embed"]}
    head = {"final_norm": params["final_norm"]}
    tied = getattr(cfg, "tie_embeddings", False)
    if tied:
        head["embed"] = params["embed"]
    else:
        head["lm_head"] = params["lm_head"]
    layer_fn = None
    wd = zi.dtype or weight_dtype
    if wd not in ("bfloat16", "int8"):
        raise NotImplementedError(
            f"weight-only quantized inference supports 'int8' only, "
            f"got {wd!r}")
    skips = _FAMILY_SKIPS[family]
    if mesh is not None:
        from deepspeed_tpu_torch.inference.sharded import place_for_serving

        specs = fam.param_specs(cfg)
        layer_specs = {k: _drop_layer_dim(v)
                       for k, v in specs["blocks"].items()}
        # int8 quantizes each whole leaf on the card before the cut;
        # exact blocks are cut on the host, where the tier keeps them
        where = dev if wd == "int8" else torch.device("cpu")

        def layer_fn(t):
            return place_for_serving(t, layer_specs, mesh, where, wd,
                                     quant_group_size, skips)[0]

        def place(t, names):
            return place_for_serving(t, {k: specs[k] for k in names}, mesh,
                                     dev, wd, quant_group_size, skips)[0]

        stem = place(stem, stem)
        head = place({k: v for k, v in head.items() if k != "embed"},
                     [k for k in head if k != "embed"])
        if tied:
            head["embed"] = stem["embed"]
    elif wd == "int8":
        def q(t):
            return quantize_params(tree_map(lambda a: a.to(dev), t),
                                   group_size=quant_group_size,
                                   skip_paths=skips)

        layer_fn = q
        stem = q(stem)
        # tied embeddings: quantize the shared table ONCE and alias it
        head = q({k: v for k, v in head.items() if k != "embed"})
        if tied:
            head["embed"] = stem["embed"]
    return ZeroInferenceServingEngine(
        stem=stem, blocks=params["blocks"], head=head, fns=fns, zi=zi,
        n_layers=cfg.n_layers, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        layer_fn=layer_fn, device=dev, **kw)
