"""ZeRO-Infinity parameter offload: layer-streamed training where the bf16
compute params never fully reside on the card (port of
``deepspeed_tpu/param_stream.py``; ref: deepspeed/runtime/swap_tensor/
partitioned_param_swapper.py + zero/stage3.py's prefetch / release around
each submodule).

:class:`TierLayerReader` streams items (transformer layers) off a tier
(:mod:`~deepspeed_tpu_torch.infinity`): the training engine below and the
ZeRO-Inference serving engine read their streamed layers through it, and
:class:`TierPageReader` runs KV page promotion over the same core.

:class:`ParamStreamEngine` trains a :class:`LayeredModel` (stem, one block
per layer, head) with the schedule on the host, as the JAX engine does:

    stem      (stem, batch) -> x0                 [embedding; on the card]
    block     (layer, x) -> x                     [one layer, streamed]
    head      (head, xL, batch) -> loss, dhead, dxL
    block vjp the layer's forward recomputed under autograd from the kept
              boundary activation, then its backward: (dlayer, dx)
    stem vjp  (stem, batch, dx0) -> dstem

The forward streams layer l+1's bf16 image host -> device on a copy stream
while layer l computes; the backward streams the layers again in reverse
(params cross the link twice a step, as the reference swaps them in for the
backward).  Layer-boundary activations stay on the card.  The device param
working set is a two-slot ring per leaf plus the stem and head, so the
trainable size is bounded by host memory (or the NVMe tier), not the card.

Gradients: each layer's bf16 grads copy into a page-locked ring slot on a
side stream; two drain workers land them in host f32 accumulators (one per
leaf and layer, kept across steps) in one native pass that also sums their
squares, and on the last micro-batch take the layer's finite bit and its
share of the norm.  The host Adam scales the summed grads by the mean (and
clip) factor in its own pass.  Under ``offload_param.
overlap_step`` (on unless gradient clipping needs the global norm first)
layer l's native host Adam (:mod:`~deepspeed_tpu_torch.ops.cpu_adam`) runs
on a one-thread update pool as soon as its grads land, behind the vjps of
layers l-1..0, writing the fresh bf16 image straight into the tier's
page-locked buffer; at most four updates wait at once (backpressure stalls
the drain, so host grads in flight stay a few layers).  The update worker
has its own aio channel on the NVMe tier.  The stem and head keep bf16
copies on the card and their f32 state on the host, updated after the
backward.

Overflow: a nonfinite loss is seen before the backward and skips the whole
step exactly.  A nonfinite grad under a finite loss raises
``FloatingPointError`` in overlap mode (earlier layers have committed);
``overlap_step: false`` restores the strict whole-step skip.

Several processes (row-sliced f32 state, cross-process image all-gathers)
and ``param_specs`` raise until ROADMAP A9's distributed part; the metrics
registry and tracer hooks wait for A10 (the counts are plain attributes).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import math
import os
import tempfile
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import lr_schedules, precision
from deepspeed_tpu_torch._device import resolve_device
from deepspeed_tpu_torch._tree import (tree_leaves, tree_leaves_with_keystr,
                                       tree_map, tree_unflatten_like)
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.data.curriculum import (CurriculumScheduler,
                                                 apply_seqlen_curriculum)
from deepspeed_tpu_torch.engine import _to_device, accum_split
from deepspeed_tpu_torch.faults import retry_with_backoff
from deepspeed_tpu_torch.infinity import (PinnedBuffer, _NvmeTier, _RamTier,
                                          pinned_views)
from deepspeed_tpu_torch.ops.cpu_adam import (accumulate_bf16, cpu_adam_step,
                                              f32_to_bf16)
from deepspeed_tpu_torch.ops.optim import default_lr

logger = logging.getLogger(__name__)


def _nbytes(shape, dtype) -> int:
    size = (torch.empty((), dtype=dtype).element_size()
            if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize)
    return int(np.prod(shape, dtype=np.int64)) * size


class TierLayerReader:
    """Double-buffered tier -> device per-item read pipeline: while the
    caller consumes item ``order[i]``, the reads (and uploads) of the items
    after it are already in flight, so the device working set stays
    ``depth + 1`` items instead of the model.

    ``tier`` implements the read interface (``get_submit`` /
    ``reads_pending`` / ``fence_reads`` / ``next_read_slot``, optionally
    ``read_sync``); ``names_fn(l)`` gives the tier keys of item ``l``,
    aligned with ``shapes``/``dtypes``; ``to_device(bufs, l)`` turns the
    fenced host buffers into what the sweep yields (the ZeRO-Inference
    engine issues its asynchronous upload there); ``out_fn(l)``, optional,
    gives the host buffers item ``l``'s reads land in (pinned staging).

    Two paths, as in the JAX package.  An NVMe tier (and every KV
    promotion) takes the submit / fence path: item ``i + 1``'s reads are
    submitted on the tier's alternating read slots when item ``i`` is
    fenced, so ``depth`` is forced to 1.  The RAM tier takes the pump path:
    its reads are free, and up to ``depth`` uploads ride ahead of the item
    being consumed.  A failed fence resubmits the item's reads up to
    ``retries`` times (exponential backoff), then falls over to the tier's
    synchronous ``read_sync``, and only then raises.

    Counts: ``hits`` (the item's reads had landed when the sweep reached
    it: its fence was free), ``stalls``, ``bytes_read``, and
    ``last_sweep``, the same three for the newest sweep."""

    def __init__(self, tier, names_fn: Callable[[int], List[str]], shapes,
                 dtypes, to_device, depth: int = 1, retries: int = 2,
                 retry_backoff_s: float = 0.05, out_fn=None):
        from deepspeed_tpu_torch.infinity import _NvmeTier

        self.tier = tier
        self._nvme = isinstance(tier, _NvmeTier)
        self.names_fn = names_fn
        self.shapes = list(shapes)
        self.dtypes = list(dtypes)
        self.to_device = to_device
        self.out_fn = out_fn
        self.depth = 1 if self._nvme else max(1, int(depth))
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._layer_bytes = sum(_nbytes(s, d)
                                for s, d in zip(self.shapes, self.dtypes))
        self.hits = 0
        self.stalls = 0
        self.bytes_read = 0
        self.last_sweep = {"bytes": 0, "hits": 0, "stalls": 0}
        self.io_retries = 0
        self.sync_fallbacks = 0

    def _meta(self, l: int):
        """``(names, shapes, dtypes, nbytes)`` of item ``l``'s tier reads:
        fixed across items here; :class:`TierPageReader` overrides it."""
        return self.names_fn(l), self.shapes, self.dtypes, self._layer_bytes

    def _submit(self, l: int):
        names, shapes, dtypes, _ = self._meta(l)
        outs = self.out_fn(l) if self.out_fn is not None else None
        if outs is None:
            outs = [None] * len(names)
        return [self.tier.get_submit(n, s, d, out=o)
                for n, s, d, o in zip(names, shapes, dtypes, outs)]

    def _count(self, l: int, hit: bool) -> None:
        nbytes = self._meta(l)[3]
        self.bytes_read += nbytes
        self.last_sweep["bytes"] += nbytes
        key = "hits" if hit else "stalls"
        setattr(self, key, getattr(self, key) + 1)
        self.last_sweep[key] += 1

    def _fence_retry(self, l: int, pending):
        """Fence item ``l``'s reads: a transient IO failure resubmits them
        (bounded, exponential backoff); exhausted retries fall over to the
        tier's synchronous ``read_sync``; if that fails too (or the tier
        has none) the last error propagates.  Returns the valid
        buffers."""
        state = {"pending": pending}

        def fence():
            self.tier.fence_reads()
            return state["pending"]

        def resubmit(attempt, err):
            self.io_retries += 1
            logger.warning("tier fence failed (%s): retry %d/%d", err,
                           attempt + 1, self.retries)
            state["pending"] = self._submit(l)

        try:
            return retry_with_backoff(fence, attempts=self.retries,
                                      backoff_s=self.retry_backoff_s,
                                      on_retry=resubmit)
        except (IOError, OSError) as e:
            last = e
        read_sync = getattr(self.tier, "read_sync", None)
        if read_sync is None:
            raise last
        names, shapes, dtypes, _ = self._meta(l)
        bufs = [read_sync(n, s, d) for n, s, d in zip(names, shapes, dtypes)]
        self.sync_fallbacks += 1
        logger.warning("tier retries exhausted for item %s: served by "
                       "synchronous reads", l)
        return bufs

    def presubmit(self, l: int):
        """Submit item ``l``'s tier reads NOW (generators are lazy) and
        return the pending buffers; hand them to :meth:`sweep` as
        ``primed=``.  KV promotion starts an admission's reads this way at
        admission time."""
        return self._submit(l)

    def sweep(self, order, on_wait=None, primed=None):
        """Yield ``(l, to_device(bufs, l))`` over ``order`` with the next
        items' reads and uploads in flight.  ``on_wait(seconds)`` reports
        the time blocked on each fence (the exposed IO cost of the NVMe
        path; the RAM path never blocks on the tier).  ``primed``: buffers
        from :meth:`presubmit` of ``order[0]``."""
        order = list(order)
        self.last_sweep = {"bytes": 0, "hits": 0, "stalls": 0}
        if not order:
            return
        if self._nvme:
            pending = primed if primed is not None \
                else self._submit(order[0])
            for i, l in enumerate(order):
                self._count(l, self.tier.reads_pending() == 0)
                t0 = time.perf_counter()
                pending = self._fence_retry(l, pending)
                if on_wait is not None:
                    on_wait(time.perf_counter() - t0)
                self.tier.next_read_slot()
                bufs = pending
                if i + 1 < len(order):
                    pending = self._submit(order[i + 1])
                yield l, self.to_device(bufs, l)
            return
        ready: collections.deque = collections.deque()
        idx = 0

        def pump():
            # ready never exceeds `depth`: with the item in use that caps
            # the device working set at depth + 1 items
            nonlocal idx
            while idx < len(order) and len(ready) < self.depth:
                nxt = order[idx]
                idx += 1
                self._count(nxt, True)
                ready.append((nxt, self.to_device(self._submit(nxt), nxt)))

        pump()
        while ready:
            l, tree = ready.popleft()
            pump()            # the next uploads issue before l's compute
            yield l, tree


class TierPageReader(TierLayerReader):
    """Double-buffered tier -> device promotion pipeline for demoted KV
    pages on the :class:`TierLayerReader` core: the items are GROUPS of
    ``group_pages`` demoted pages, and while group ``g`` is fenced,
    decoded and uploaded into its fresh device pages (the ``to_device``
    callback, the serving engine's batched page scatter), group ``g+1``'s
    reads are already submitted.

    ``pool`` is a :class:`~deepspeed_tpu_torch.inference.kv_tier.
    KVTierPool` (the read interface plus per-entry geometry); per-group
    shapes come from the pool's entry records through :meth:`_meta`, since
    a group may mix 2-buffer dense and 4-buffer quantised encodings."""

    def __init__(self, pool, keys, to_device, group_pages: int = 8,
                 retries: int = 2, retry_backoff_s: float = 0.05):
        group_pages = max(1, int(group_pages))
        self._pool = pool
        self._groups = [list(keys[i:i + group_pages])
                        for i in range(0, len(keys), group_pages)]
        super().__init__(pool, names_fn=lambda g: [], shapes=(), dtypes=(),
                         to_device=to_device, retries=retries,
                         retry_backoff_s=retry_backoff_s)
        # always the submit / fence path: host-resident entries report no
        # pending reads, so they fence free and count as hits; one pipeline
        # serves mixed host / NVMe chains
        self._nvme = True
        self.depth = 1

    @property
    def n_groups(self) -> int:
        return len(self._groups)

    def group_keys(self, g: int):
        return self._groups[g]

    def _meta(self, g: int):
        names, shapes, dtypes = [], [], []
        for key in self._groups[g]:
            n, s, d = self._pool.entry_meta(key)
            names += n
            shapes += list(s)
            dtypes += list(d)
        return names, shapes, dtypes, sum(
            _nbytes(s, d) for s, d in zip(shapes, dtypes))


# ------------------------------------------------------------ the engine
def process_count() -> int:
    """Processes in the default ``torch.distributed`` group (1 without
    one)."""
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _weak(bound):
    """``bound`` as a callable that does not keep its object alive (the
    reader the engine owns calls back into it)."""
    ref = weakref.WeakMethod(bound)
    return lambda *args: ref()(*args)


def _cpu_tensor(a) -> torch.Tensor:
    """A CPU tensor over a leaf: a tensor (moved off the card), or a numpy
    array (bfloat16 ones by their 16-bit payload)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu")
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def default_swap_dir() -> str:
    """The NVMe tiers' directory when the config names none."""
    return os.path.join(tempfile.gettempdir(), "dstpu_nvme_swap")


@dataclasses.dataclass
class LayeredModel:
    """A model factored for layer streaming.

    ``stem_fn(stem, batch) -> x`` (embedding), ``block_fn(layer, x) -> x``
    (ONE layer; all layers share shapes), ``head_fn(head, x, batch) ->``
    scalar f32 loss.  ``blocks`` is the stacked ``[L, ...]`` tree, or a
    callable ``blocks(l) -> layer tree`` (lazy init: then ``blocks_spec``
    gives the stacked shapes as meta tensors, and only one layer is ever
    materialized outside the engine's tier).  ``stem`` / ``head`` stay on
    the card.  ``assemble(stem, blocks, head)`` maps the factored trees
    back to the model's own layout (``master_params``).  ``block_has_aux``:
    ``block_fn`` returns ``(x, aux)``, a per-layer loss term (MoE
    load-balance + z) that adds to the total, pulled with cotangent 1.
    ``factor_specs`` maps a tensor-parallel spec tree onto the factoring
    (ROADMAP A9's distributed part).  Models provide builders
    (``models.llama.layered_model``)."""
    stem_fn: Callable
    block_fn: Callable
    head_fn: Callable
    stem: Any
    blocks: Any
    head: Any
    n_layers: int
    assemble: Optional[Callable] = None
    block_has_aux: bool = False
    factor_specs: Optional[Callable] = None
    blocks_spec: Any = None


class ParamStreamEngine:
    """Host-scheduled layer-streaming engine: params and optimizer state
    offloaded; the card holds a two-slot layer ring, the stem, the head and
    the boundary activations.  ``device``: None = CUDA (``"cpu"`` runs the
    same schedule with plain copies and no streams)."""

    def __init__(self, layered: LayeredModel, config: Config,
                 lr_scheduler=None, param_specs=None, device=None):
        if param_specs is not None:
            raise NotImplementedError(
                "param_specs (tensor-parallel layer streaming) comes with "
                "ROADMAP A9's distributed part; the param-stream engine "
                "trains on one GPU")
        if process_count() > 1:
            raise NotImplementedError(
                "param-stream training over several processes (row-sliced "
                "f32 state, cross-process image all-gathers) comes with "
                "ROADMAP A9's distributed part")
        self.config = config
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        config.resolve_batch_sizes(1)
        self.layered = layered
        self.L = layered.n_layers
        self._last_grad_norm = 0.0
        self.curriculum_scheduler = (
            CurriculumScheduler(config.curriculum)
            if config.curriculum is not None and config.curriculum.enabled
            else None)

        off = dict(config.zero.offload_param or {})
        self.device_tier = off.get("device", "cpu")
        clip = config.gradient_clipping
        # overlap_step: layer l's host Adam starts as soon as its grads
        # drain, behind the remaining vjps; clipping needs the global norm
        # first, so it takes the strict path
        self.overlap_step = bool(off.get("overlap_step", True)) and not (
            clip and clip > 0)
        if self.device_tier == "nvme":
            swap = os.path.join(off.get("nvme_path", default_swap_dir()),
                                "pstream_proc0")
            self.tier = _NvmeTier(swap)
            # the update worker's own aio channel: slot state is one
            # thread's, and the per-key files keep the channels apart
            self._utier = _NvmeTier(swap)
        else:
            self.tier = _RamTier()
            self._utier = self.tier

        opt_type = config.optimizer.type.lower()
        if opt_type not in ("adam", "adamw", "fusedadam"):
            raise ValueError(
                f"param-stream engine supports the Adam family (the "
                f"reference's swappable optimizer is CPU-Adam), got "
                f"{opt_type!r}")
        oparams = dict(config.optimizer.params)
        opt_lr = float(oparams.pop("lr", default_lr(opt_type)))
        self.lr_schedule = (
            lr_scheduler if callable(lr_scheduler)
            else lr_schedules.from_config(config.scheduler.type,
                                          config.scheduler.params,
                                          fallback_lr=opt_lr))
        self._hyp = _adam_hyper(oparams)
        self.optimizer = None          # the engine is the optimizer here

        if precision.compute_dtype(config.precision) != torch.bfloat16:
            raise NotImplementedError(
                "param-stream engine streams bf16 compute images (the "
                "fused CPU-Adam emits bf16); set bf16.enabled")
        bf16 = torch.bfloat16

        # ---- block leaves: per-layer, per-leaf tier keys
        lazy = callable(layered.blocks)
        src = layered.blocks_spec if lazy else layered.blocks
        if lazy and src is None:
            raise ValueError(
                "callable LayeredModel.blocks (lazy init) requires "
                "blocks_spec — the stacked abstract shapes")
        spec = tree_leaves_with_keystr(src)
        self._bpaths = [p for p, _ in spec]
        self._btemplate = tree_map(lambda a: 0, src)
        self._bshapes = [tuple(a.shape[1:]) for _, a in spec]
        self._bsizes = [int(np.prod(s, dtype=np.int64))
                        for s in self._bshapes]
        self._bnames = [f"b{i}" for i in range(len(spec))]
        nvme = isinstance(self.tier, _NvmeTier)
        self._pinned: List[PinnedBuffer] = []
        self._images: List[List[torch.Tensor]] = []

        def layer_arrays(l):
            if lazy:
                got = tree_leaves_with_keystr(layered.blocks(l))
                if [p for p, _ in got] != self._bpaths:
                    raise ValueError(
                        f"blocks({l}) leaves {[p for p, _ in got]} != "
                        f"blocks_spec leaves {self._bpaths}")
                return [_cpu_tensor(a) for _, a in got]
            return [_cpu_tensor(leaf[l]) for _, leaf in spec]

        for l, arrs in enumerate(_prefetched(layer_arrays, self.L,
                                             4 if lazy else 1)):
            if not nvme:
                # the layer's bf16 image in one page-locked buffer: the
                # forward and backward upload from it, the host Adam
                # rewrites it in place
                self._images.append(pinned_views(
                    [(sz,) for sz in self._bsizes], [bf16] * len(arrs),
                    self._pinned))
            for i, (nm, a) in enumerate(zip(self._bnames, arrs)):
                if tuple(a.shape) != self._bshapes[i]:
                    raise ValueError(
                        f"layer {l} leaf {self._bpaths[i]}: shape "
                        f"{tuple(a.shape)} != spec {self._bshapes[i]}")
                flat = a.reshape(-1)
                if nvme:
                    self.tier.put(f"p_{l}_{nm}", flat.to(bf16).contiguous())
                else:
                    self._images[l][i].copy_(flat)
                    self.tier.put(f"p_{l}_{nm}", self._images[l][i])
                self.tier.put(f"w_{l}_{nm}",
                              flat.to(torch.float32, copy=True).contiguous())
                self.tier.put(f"m_{l}_{nm}", torch.zeros(self._bsizes[i]))
                self.tier.put(f"v_{l}_{nm}", torch.zeros(self._bsizes[i]))
            del arrs
            if nvme:
                self.tier.fence_writes()

        # ---- stem / head: f32 state on the host, bf16 on the card; one
        # page-locked image per leaf serves the upload after each update
        # and the grad download during the step
        self._stem_state, self._stem_tmpl, self._stem_img = \
            self._host_state(layered.stem)
        self._head_state, self._head_tmpl, self._head_img = \
            self._host_state(layered.head)
        self.stem_c = self._device_copy(self._stem_tmpl, self._stem_state,
                                        self._stem_img)
        self.head_c = self._device_copy(self._head_tmpl, self._head_state,
                                        self._head_img)

        # ---- the device ring, the grad staging ring, streams and events
        dev = self.device
        self._ring_n = 2
        self._ring = [torch.empty((self._ring_n, sz), dtype=bf16, device=dev)
                      for sz in self._bsizes]
        self._uploads = 0
        self._grad_slots = [pinned_views(
            [(sz,) for sz in self._bsizes], [bf16] * len(self._bsizes),
            self._pinned) for _ in range(3)]
        self._n_drains = 0
        self._staging = ([pinned_views(
            [(sz,) for sz in self._bsizes], [bf16] * len(self._bsizes),
            self._pinned) for _ in range(2)] if nvme else [])
        self._staging_of: Dict[int, int] = {}
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(device=dev)
            self._d2h_stream = torch.cuda.Stream(device=dev)
            self._ready = [torch.cuda.Event() for _ in range(self._ring_n)]
            self._free = [torch.cuda.Event() for _ in range(self._ring_n)]
            self._staged = [torch.cuda.Event() for _ in self._staging]
        self._preader = TierLayerReader(
            self.tier, names_fn=_weak(self._layer_keys),
            shapes=[(sz,) for sz in self._bsizes],
            dtypes=[bf16] * len(self._bsizes),
            to_device=_weak(self._upload_layer),
            out_fn=_weak(self._stage) if nvme else None)
        # host f32 grad accumulators, one per leaf (and layer), kept across
        # steps; zero-filled here so their pages fault in at build, not in
        # the first step's drains
        self._gbuf = [[torch.zeros(sz) for sz in self._bsizes]
                      for _ in range(self.L)]
        self._gstem = [torch.zeros(s["w"].numel()) for s in self._stem_state]
        self._ghead = [torch.zeros(s["w"].numel()) for s in self._head_state]

        self.global_steps = 0
        self._opt_steps = 0
        self.skipped_steps = 0
        self.step_times: List[float] = []
        self.phase_times: Dict[str, float] = {}
        # bytes over the host <-> device link in the last step
        self.link_bytes = {"up": 0, "down": 0}
        self._last_metrics: Dict[str, Any] = {}
        self._d2h_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="dstt-pstream-d2h")
        # one worker: the layer updates serialize among themselves (one aio
        # channel, layer-ordered writes); the overlap is with the vjps
        self._upd_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dstt-pstream-upd")
        self._ph_lock = threading.Lock()
        logger.info(
            "ParamStreamEngine: tier=%s layers=%d block-leaves=%d "
            "per-layer=%d params (%.1f MB bf16), stem+head on the card",
            self.device_tier, self.L, len(self._bnames),
            sum(self._bsizes), 2 * sum(self._bsizes) / 1e6)

    # ---------------------------------------------------------- set-up
    def _host_state(self, tree):
        """Per-leaf host f32 state (``w``, ``m``, ``v``) of a resident
        tree, its structure, and one page-locked bf16 image per leaf."""
        leaves = tree_leaves_with_keystr(tree)
        state = []
        for path, a in leaves:
            t = _cpu_tensor(a)
            state.append({"w": t.to(torch.float32, copy=True).reshape(-1)
                          .contiguous(),
                          "m": torch.zeros(t.numel()),
                          "v": torch.zeros(t.numel()),
                          "shape": tuple(t.shape), "path": path})
        imgs = pinned_views([(s["w"].numel(),) for s in state],
                            [torch.bfloat16] * len(state), self._pinned)
        for s, img in zip(state, imgs):
            img.copy_(s["w"])
        return state, tree_map(lambda a: 0, tree), imgs

    def _device_copy(self, tmpl, state, imgs):
        return tree_unflatten_like(tmpl, [
            torch.empty(s["shape"], dtype=torch.bfloat16,
                        device=self.device).copy_(img.view(s["shape"]))
            for s, img in zip(state, imgs)])

    def __del__(self):
        # the last reference may drop on a worker thread: never join here
        for pool in ("_d2h_pool", "_upd_pool"):
            p = getattr(self, pool, None)
            if p is not None:
                p.shutdown(wait=False)

    # ------------------------------------------------------------ streaming
    def _layer_keys(self, l: int) -> List[str]:
        """The tier keys of layer ``l``'s bf16 compute leaves."""
        return [f"p_{l}_{nm}" for nm in self._bnames]

    def _stage(self, l: int) -> List[torch.Tensor]:
        """``out_fn`` of the NVMe reader: layer ``l``'s reads land in the
        staging slot of the tier's current read slot, once the upload that
        last read that slot has finished."""
        s = self.tier.rslot
        if self._cuda:
            self._staged[s].synchronize()
        self._staging_of[l] = s
        return self._staging[s]

    def _upload_layer(self, bufs, l: int) -> int:
        """The reader's ``to_device``: layer ``l``'s host images into the
        next ring slot, on the copy stream on CUDA; returns the slot."""
        s = self._uploads % self._ring_n
        self._uploads += 1
        if self._cuda:
            cs = self._copy_stream
            cs.wait_event(self._free[s])   # the slot's last reader is done
            with torch.cuda.stream(cs):
                for ring, buf in zip(self._ring, bufs):
                    ring[s].copy_(buf, non_blocking=True)
                self._ready[s].record(cs)
                if l in self._staging_of:
                    self._staged[self._staging_of.pop(l)].record(cs)
        else:
            for ring, buf in zip(self._ring, bufs):
                ring[s].copy_(buf)
        self.link_bytes["up"] += 2 * sum(self._bsizes)
        return s

    def _slot_leaves(self, s: int, grad: bool) -> List[torch.Tensor]:
        """Ring slot ``s``'s leaves, shaped, once their upload landed (the
        compute stream waits on it)."""
        if self._cuda:
            torch.cuda.current_stream().wait_event(self._ready[s])
        leaves = [r[s].view(sh) for r, sh in zip(self._ring, self._bshapes)]
        if grad:
            leaves = [v.detach().requires_grad_(True) for v in leaves]
        return leaves

    def _release(self, s: int) -> None:
        if self._cuda:
            self._free[s].record(torch.cuda.current_stream())

    def _download(self, grads, views):
        """Copy device grads into page-locked host views, on the side
        stream on CUDA once the compute stream produced them; returns the
        event to wait on (None on the CPU, where the copy is done)."""
        nbytes = sum(v.numel() * v.element_size() for v in views)
        self.link_bytes["down"] += nbytes
        if not self._cuda:
            for g, v in zip(grads, views):
                v.copy_(g.reshape(-1))
            return None
        ds = self._d2h_stream
        ds.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(ds):
            for g, v in zip(grads, views):
                v.copy_(g.reshape(-1), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(ds)
        return ev

    @staticmethod
    def _land(ev, keep, views, accs, first: bool) -> float:
        """Wait for a download, then fold it into the f32 accumulators
        (copy on a step's first micro-batch, add after), one native pass a
        leaf; returns the accumulators' new sum of squares."""
        if ev is not None:
            ev.synchronize()
        keep.clear()                  # the device grads may be freed now
        return sum(accumulate_bf16(a, v, first) for a, v in zip(accs, views))

    @staticmethod
    def _stats(accs, ssq: float):
        """(sum of squares, all finite) of a layer's accumulated grads: a
        finite sum means finite grads; otherwise the grads decide (a sum of
        finite squares can overflow)."""
        fin = math.isfinite(ssq) or all(bool(torch.isfinite(a).all())
                                        for a in accs)
        return ssq, fin

    def _phase_reset(self):
        self.phase_times = {
            "fwd_compute": 0.0, "bwd_compute": 0.0, "param_read_wait": 0.0,
            "grad_d2h_wait": 0.0, "host_adam": 0.0, "tier_write": 0.0,
            "update_wait": 0.0, "total": 0.0}
        return self.phase_times

    def _ph_add(self, ph, key, dt):
        """Worker-thread-safe phase accounting."""
        with self._ph_lock:
            ph[key] += dt

    def phase_report(self) -> Dict[str, float]:
        """Per-phase host seconds of the last step.  Phases overlap by
        design (param reads and grad downloads run behind the layer
        computes; in overlap_step mode host_adam / tier_write run behind
        bwd_compute), so the parts can sum past 'total'.  The exposed cost
        of the optimizer pass is 'update_wait': how long the step blocked
        at the end for in-flight layer updates; a hidden host Adam means
        update_wait << host_adam."""
        return dict(self.phase_times)

    # ------------------------------------------------------------------ step
    def curriculum_difficulty(self):
        """Current curriculum difficulty, or None without a curriculum."""
        if self.curriculum_scheduler is None:
            return None
        return self.curriculum_scheduler.get_difficulty(self.global_steps)

    def _apply_curriculum(self, batch):
        return apply_seqlen_curriculum(batch, self.curriculum_scheduler,
                                       self.global_steps)

    def _finish(self, t0, ph, loss, skipped: bool) -> torch.Tensor:
        self.global_steps += 1
        if skipped:
            self.skipped_steps += 1
        else:
            self._opt_steps += 1
        out = torch.tensor(loss, dtype=torch.float32)
        self._last_metrics = {"loss": out, "overflow": int(skipped)}
        if self._cuda:
            torch.cuda.current_stream().synchronize()
        self.step_times.append(time.perf_counter() - t0)
        ph["total"] = self.step_times[-1]
        return out

    def train_batch(self, batch) -> torch.Tensor:
        """One optimizer step on a global batch; returns the loss (an f32
        scalar tensor on the host)."""
        t0 = time.perf_counter()
        lm = self.layered
        batch = self._apply_curriculum(batch)
        ph = self._phase_reset()
        self.link_bytes = {"up": 0, "down": 0}
        nvme = isinstance(self.tier, _NvmeTier)
        accum = self.config.gradient_accumulation_steps
        batch = tree_map(lambda x: _to_device(x, self.device), batch)
        if accum > 1:
            split = accum_split(batch, accum)
            micros = [tree_map(lambda x, _i=i: x[_i], split)
                      for i in range(accum)]
        else:
            micros = [batch]
        gbuf = self._gbuf
        loss_sum = 0.0
        loss_bad = False             # nonfinite loss: exact whole-step skip
        stats: Dict[int, tuple] = {}  # layer -> (ssq, finite), final grads
        upd_futs: List[Any] = []     # in-flight overlapped layer updates
        t_step = self._opt_steps + 1
        lr = float(self.lr_schedule(t_step))
        inv = 1.0 / accum
        read_wait = functools.partial(self._ph_add, ph, "param_read_wait")
        stem_leaves = tree_leaves(self.stem_c)
        head_leaves = tree_leaves(self.head_c)

        for im, mb in enumerate(micros):
            first_mb, final_mb = im == 0, im == accum - 1
            # ---------------- forward: stream the layers up
            t1 = time.perf_counter()
            with torch.no_grad():
                x = lm.stem_fn(self.stem_c, mb)
                aux_acc = (torch.zeros((), dtype=torch.float32,
                                       device=self.device)
                           if lm.block_has_aux else None)
                xs: List[Any] = []
                for l, s in self._preader.sweep(range(self.L),
                                                on_wait=read_wait):
                    lp = tree_unflatten_like(self._btemplate,
                                             self._slot_leaves(s, False))
                    xs.append(x)
                    if lm.block_has_aux:
                        x, aux = lm.block_fn(lp, x)
                        aux_acc = aux_acc + aux.float()
                    else:
                        x = lm.block_fn(lp, x)
                    del lp
                    self._release(s)
            ph["fwd_compute"] += time.perf_counter() - t1

            # ---------------- head: loss, dhead, dx on the card
            t1 = time.perf_counter()
            hp = [v.detach().requires_grad_(True) for v in head_leaves]
            xl = x.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = lm.head_fn(tree_unflatten_like(self.head_c, hp), xl,
                                  mb).float()
                grads = _grads(loss, hp + [xl], None)
            dx = grads.pop()
            mb_loss = float(loss.detach())        # sync: forward + head
            if lm.block_has_aux:
                mb_loss += float(aux_acc)         # total = lm + aux terms
            loss_sum += mb_loss
            # the loss gate precedes every update, so a compute overflow
            # (which reaches the loss under bf16) skips the step exactly
            if not math.isfinite(mb_loss):
                loss_bad = True
            del loss, hp, xl, x
            ev = self._download(grads, self._head_img)
            hfut = self._d2h_pool.submit(self._land, ev, grads,
                                         self._head_img, self._ghead,
                                         first_mb)
            del grads
            ph["bwd_compute"] += time.perf_counter() - t1

            # ---------------- backward: stream the layers down
            t1 = time.perf_counter()
            can_update = final_mb and not loss_bad and self.overlap_step
            dfuts: List[Any] = []
            for l, s in self._preader.sweep(range(self.L - 1, -1, -1),
                                            on_wait=read_wait):
                leaves = self._slot_leaves(s, True)
                xin = xs[l].requires_grad_(True)
                with torch.enable_grad():
                    out = lm.block_fn(
                        tree_unflatten_like(self._btemplate, leaves), xin)
                    if lm.block_has_aux:
                        # total = head(x_L) + sum_l aux_l: each layer's aux
                        # output carries cotangent 1; dx already carries
                        # the downstream layers' aux by induction
                        y, aux = out
                        dlp = _grads([y, aux], leaves + [xin],
                                     [dx, torch.ones_like(aux)])
                    else:
                        dlp = _grads([out], leaves + [xin], [dx])
                del out, leaves
                dx = dlp.pop()
                xs[l] = xin = None
                self._release(s)
                # bound in-flight drains (their ring slots and the device
                # grads they hold) at the pool width
                while len(dfuts) >= 2:
                    tw = time.perf_counter()
                    dfuts.pop(0).result()
                    ph["grad_d2h_wait"] += time.perf_counter() - tw
                slot = self._grad_slots[self._n_drains % len(
                    self._grad_slots)]
                self._n_drains += 1
                ev = self._download(dlp, slot)
                dfuts.append(self._d2h_pool.submit(
                    self._drain_block, l, ev, dlp, slot, gbuf, first_mb,
                    final_mb, can_update, stats, upd_futs, lr, t_step, inv,
                    ph))
                del dlp
            sp = [v.detach().requires_grad_(True) for v in stem_leaves]
            with torch.enable_grad():
                x0 = lm.stem_fn(tree_unflatten_like(self.stem_c, sp), mb)
                ds = _grads([x0], sp, [dx])
            del x0, sp, dx
            res_ssq = self._land(self._download(ds, self._stem_img), ds,
                                 self._stem_img, self._gstem, first_mb)
            res_ssq += hfut.result()
            tw = time.perf_counter()
            for f in dfuts:
                f.result()
            ph["grad_d2h_wait"] += time.perf_counter() - tw
            ph["bwd_compute"] += time.perf_counter() - t1

        loss = loss_sum * inv
        if loss_bad:
            # no update launched anywhere (the loss gate precedes every
            # drain's finalize): the reference's exact whole-step skip
            self._last_grad_norm = float("inf")
            return self._finish(t0, ph, loss, skipped=True)

        # ---------------- finite consensus + unconditional grad norm
        res_ssq, res_fin = self._stats(self._gstem + self._ghead, res_ssq)
        ssq = res_ssq + sum(s[0] for s in stats.values())
        norm = math.sqrt(ssq) * inv if math.isfinite(ssq) else float("inf")
        self._last_grad_norm = norm          # every step, clip or not
        finite = res_fin and all(s[1] for s in stats.values())
        if not finite:
            if upd_futs:
                # overlap mode already committed earlier layers: a torn
                # step, unrecoverable by design, so fail loudly
                for f in upd_futs:
                    f.result()
                if isinstance(self._utier, _NvmeTier):
                    self._utier.fence_all()
                raise FloatingPointError(
                    "param-stream overlap_step: nonfinite gradient under "
                    "a finite loss after some layers already updated; "
                    "set offload_param.overlap_step=false for strict "
                    "whole-step overflow skipping")
            return self._finish(t0, ph, loss, skipped=True)

        clip = self.config.gradient_clipping
        if clip and clip > 0:
            # engine.clip_by_global_norm's semantics on the host copies:
            # the clipped quantity is the mean grad
            inv = inv * min(1.0, clip / (norm + 1e-6))
        if self.overlap_step:
            tw = time.perf_counter()
            for f in upd_futs:
                f.result()               # worker errors propagate too
            if isinstance(self._utier, _NvmeTier):
                self._utier.fence_all()
            ph["update_wait"] += time.perf_counter() - tw
        else:
            self._update_blocks(gbuf, lr, t_step, inv, ph, nvme)
        self._update_resident(self._stem_state, self._gstem, self._stem_img,
                              stem_leaves, lr, t_step, inv, ph)
        self._update_resident(self._head_state, self._ghead, self._head_img,
                              head_leaves, lr, t_step, inv, ph)
        if nvme:
            t1 = time.perf_counter()
            self.tier.fence_all()
            ph["tier_write"] += time.perf_counter() - t1
        return self._finish(t0, ph, loss, skipped=False)

    # ------------------------------------------------------------- updates
    def _drain_block(self, l, ev, keep, slot, gbuf, first, finalize,
                     can_update, stats, upd_futs, lr, t, inv, ph):
        """Drain-pool job: land layer ``l``'s grads in its f32
        accumulators.  On the last micro-batch also take the layer's
        finite bit and norm share (hidden behind the next vjp) and, in
        overlap mode, hand the grads to the update worker.  Jobs of
        different layers touch disjoint accumulators and ``stats`` slots,
        so the two drain workers never race."""
        ssq = self._land(ev, keep, slot, gbuf[l], first)
        if not finalize:
            return
        stats[l] = self._stats(gbuf[l], ssq)
        if can_update and stats[l][1]:
            # backpressure: a lagging host Adam must not let layers' f32
            # grads pile up; blocking here stalls the drain, which stalls
            # the vjp loop at its drain bound
            while sum(1 for f in upd_futs if not f.done()) > 4:
                pending = next((f for f in upd_futs if not f.done()), None)
                if pending is None:
                    break
                pending.result()
            upd_futs.append(self._upd_pool.submit(
                self._update_one_layer, l, gbuf[l], lr, t, inv, ph))

    def _read_state(self, tier, l: int):
        return [tuple(tier.get_submit(f"{k}_{l}_{nm}", (sz,), torch.float32)
                      for k in "wmv")
                for nm, sz in zip(self._bnames, self._bsizes)]

    def _update_one_layer(self, l, grads, lr, t, inv, ph):
        """Update worker: the host Adam over one layer's leaves and its
        fresh bf16 image, on the update channel."""
        bufs = self._read_state(self._utier, l)
        if isinstance(self._utier, _NvmeTier):
            t1 = time.perf_counter()
            self._utier.fence_reads()
            self._ph_add(ph, "param_read_wait", time.perf_counter() - t1)
            self._utier.next_read_slot()
        self._apply_layer_update(self._utier, l, bufs, grads, lr, t, inv,
                                 ph)

    def _apply_layer_update(self, tier, l, bufs, grads, lr, t, inv, ph):
        """Per-leaf Adam and write-back, shared by the overlap (update
        worker, ``_utier``) and strict (main thread, ``tier``) paths.  The
        RAM tier's state and page-locked image update in place."""
        nvme = isinstance(tier, _NvmeTier)
        for i, ((w, m, v), g) in enumerate(zip(bufs, grads)):
            nm = self._bnames[i]
            t1 = time.perf_counter()
            img = (torch.empty(self._bsizes[i], dtype=torch.bfloat16)
                   if nvme else self._images[l][i])
            self._adam(w, m, v, g, lr, t, img, inv)
            self._ph_add(ph, "host_adam", time.perf_counter() - t1)
            t1 = time.perf_counter()
            if nvme:
                tier.fence_writes()
            tier.put(f"w_{l}_{nm}", w)
            tier.put(f"m_{l}_{nm}", m)
            tier.put(f"v_{l}_{nm}", v)
            tier.put(f"p_{l}_{nm}", img)
            if nvme:
                tier.next_write_slot()
            self._ph_add(ph, "tier_write", time.perf_counter() - t1)

    def _adam(self, w, m, v, g, lr, t, out, inv):
        """The host Adam on the summed grad ``g`` scaled by ``inv`` (the mean
        over micro-batches, clipped), its bf16 image into ``out``."""
        b1, b2 = self._hyp["betas"]
        cpu_adam_step(w, m, v, g, lr=lr, b1=b1, b2=b2, eps=self._hyp["eps"],
                      wd=self._hyp["wd"], adamw=self._hyp["adamw"], t=t,
                      bias_correction=self._hyp["bias_correction"],
                      emit_bf16=True, out=out, grad_scale=inv)

    def _update_blocks(self, gbuf, lr, t, inv, ph, nvme) -> None:
        """Strict path: the host Adam per layer after the backward, the
        tier's state reads double-buffered ahead of it."""
        pending = self._read_state(self.tier, 0)
        for l in range(self.L):
            if nvme:
                t1 = time.perf_counter()
                self.tier.fence_reads()
                ph["param_read_wait"] += time.perf_counter() - t1
                self.tier.next_read_slot()
            bufs = pending
            if l + 1 < self.L:
                pending = self._read_state(self.tier, l + 1)
            self._apply_layer_update(self.tier, l, bufs, gbuf[l], lr, t,
                                     inv, ph)

    def _update_resident(self, state, grads, imgs, dev, lr, t, inv, ph):
        """Stem / head: host Adam into the page-locked images, then the
        card's bf16 copies from them."""
        t1 = time.perf_counter()
        for st, g, img in zip(state, grads, imgs):
            self._adam(st["w"], st["m"], st["v"], g, lr, t, img, inv)
        ph["host_adam"] += time.perf_counter() - t1
        for st, img, d in zip(state, imgs, dev):
            d.copy_(img.view(st["shape"]), non_blocking=True)
            self.link_bytes["up"] += img.numel() * 2

    # ----------------------------------------------------------- inspection
    @property
    def metrics(self):
        return self._last_metrics

    def get_lr(self):
        return [float(self.lr_schedule(self._opt_steps))]

    def get_global_grad_norm(self) -> float:
        """Pre-clip global norm of the last step's mean grad, every step
        (clipping on or off), from the drains' per-layer sums; ``inf`` on
        an overflow-skipped step, 0.0 before the first."""
        return self._last_grad_norm

    @property
    def train_batch_size(self):
        return self.config.train_batch_size

    @property
    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def hbm_param_working_set_bytes(self) -> int:
        """Peak bf16 param bytes on the card during a step: the two-slot
        ring plus stem and head (an engine holding the compute copy would
        hold all L layers)."""
        per_layer = 2 * sum(self._bsizes)
        stem_head = sum(x.numel() * x.element_size() for x in
                        tree_leaves(self.stem_c) + tree_leaves(self.head_c))
        return self._ring_n * per_layer + stem_head

    def total_param_count(self) -> int:
        return (self.L * sum(self._bsizes)
                + sum(s["w"].numel() for s in self._stem_state)
                + sum(s["w"].numel() for s in self._head_state))

    def master_params(self) -> Any:
        """The f32 masters as CPU tensors: in the model's own layout when
        the LayeredModel gives ``assemble`` (llama's does), else the
        factored ``{stem, blocks, head}``.  NVMe reads land in place, all
        L rows of a leaf under one fence."""
        nvme = isinstance(self.tier, _NvmeTier)
        blocks = []
        for nm, sz, shape in zip(self._bnames, self._bsizes, self._bshapes):
            stack = torch.empty((self.L,) + shape, dtype=torch.float32)
            bufs = [self.tier.get_submit(f"w_{l}_{nm}", (sz,), torch.float32,
                                         out=stack[l].view(-1))
                    for l in range(self.L)]
            self.tier.fence_reads()
            if not nvme:          # the RAM tier returned its stored tensors
                for l, b in enumerate(bufs):
                    stack[l].copy_(b.view(shape))
            blocks.append(stack)
        blocks_tree = tree_unflatten_like(self._btemplate, blocks)
        stem, head = (tree_unflatten_like(tmpl, [
            s["w"].view(s["shape"]).clone() for s in st])
            for tmpl, st in ((self._stem_tmpl, self._stem_state),
                             (self._head_tmpl, self._head_state)))
        if self.layered.assemble is not None:
            return self.layered.assemble(stem, blocks_tree, head)
        return {"stem": stem, "blocks": blocks_tree, "head": head}

    def module_params(self) -> Any:
        return self.master_params()

    # ---------------------------------------------------------- checkpoint
    def _manifest(self) -> dict:
        """The layout saved into meta.json, so offline tooling
        (``zero_to_fp32``) reassembles the factored state without the
        model: per block leaf its key, path and per-layer shape, and the
        stem / head leaves (the JAX package's manifest)."""
        return {
            "version": 1, "n_layers": self.L,
            "blocks": [{"key": nm, "path": p, "shape": list(s)}
                       for nm, p, s in zip(self._bnames, self._bpaths,
                                           self._bshapes)],
            "stem": [{"path": s["path"], "shape": list(s["shape"])}
                     for s in self._stem_state],
            "head": [{"path": s["path"], "shape": list(s["shape"])}
                     for s in self._head_state]}

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        async_save: bool = False):
        """The universal per-leaf layout (:class:`~deepspeed_tpu_torch.
        checkpoint.UniversalLeafCheckpointer`): one flat unpadded f32
        ``.npy`` per (layer, leaf, kind), so the transient is one leaf.
        Saves are synchronous (``async_save`` is accepted for parity)."""
        from deepspeed_tpu_torch.checkpoint import (
            UniversalLeafCheckpointer, finalize_checkpoint_dir,
            wait_for_checkpoint)

        wait_for_checkpoint()
        tag = tag or f"global_step{self.global_steps}"
        d = os.path.join(os.path.abspath(save_dir), tag)
        ulc = UniversalLeafCheckpointer(d)
        for l in range(self.L):
            for nm, sz in zip(self._bnames, self._bsizes):
                for kind in "wmv":
                    buf = self.tier.get_submit(f"{kind}_{l}_{nm}", (sz,),
                                               torch.float32)
                    self.tier.fence_reads()
                    ulc.save(f"{kind}{l:04d}_{nm}", buf)
        for pre, st in (("stem", self._stem_state),
                        ("head", self._head_state)):
            for i, s in enumerate(st):
                for kind in "wmv":
                    ulc.save(f"{pre}{kind}_{i:03d}", s[kind])
        ulc.wait()
        if isinstance(self.tier, _NvmeTier):
            self.tier.fence_all()
        finalize_checkpoint_dir(save_dir, tag, {
            "global_steps": self.global_steps,
            "opt_steps": self._opt_steps,
            "skipped_steps": self.skipped_steps,
            "pstream_universal": self._manifest(),
            "client_state": client_state or {}})
        return d

    def wait_for_checkpoint(self) -> None:
        """Parity with TrainingEngine: saves here are synchronous."""
        from deepspeed_tpu_torch.checkpoint import wait_for_checkpoint

        wait_for_checkpoint()

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None):
        """Restore a universal checkpoint onto this engine's tier (any
        tier: a RAM-tier save loads on NVMe).  Returns (path,
        client_state)."""
        from deepspeed_tpu_torch.checkpoint import (
            UniversalLeafCheckpointer, read_meta, resolve_offload_tag)

        d = resolve_offload_tag(load_dir, tag)
        ulc = UniversalLeafCheckpointer(d)
        nvme = isinstance(self.tier, _NvmeTier)
        for l in range(self.L):
            for i, nm in enumerate(self._bnames):
                if nvme:
                    items = {k: ulc.restore(f"{k}{l:04d}_{nm}")
                             for k in "wmv"}
                    for k in "wmv":
                        self.tier.put(f"{k}_{l}_{nm}", items[k])
                    self.tier.put(f"p_{l}_{nm}", f32_to_bf16(items["w"]))
                    self.tier.fence_writes()
                else:
                    for k in "wmv":
                        ulc.restore_into(f"{k}{l:04d}_{nm}",
                                         self.tier.store[f"{k}_{l}_{nm}"]
                                         .numpy())
                    f32_to_bf16(self.tier.store[f"w_{l}_{nm}"],
                                out=self._images[l][i])
        for pre, st, imgs, dev in (
                ("stem", self._stem_state, self._stem_img,
                 tree_leaves(self.stem_c)),
                ("head", self._head_state, self._head_img,
                 tree_leaves(self.head_c))):
            for i, (s, img, dv) in enumerate(zip(st, imgs, dev)):
                for kind in "wmv":
                    ulc.restore_into(f"{pre}{kind}_{i:03d}", s[kind].numpy())
                f32_to_bf16(s["w"], out=img)
                dv.copy_(img.view(s["shape"]))
        if nvme:
            self.tier.fence_all()
        meta = read_meta(d)
        self.global_steps = meta["global_steps"]
        self._opt_steps = meta["opt_steps"]
        self.skipped_steps = meta["skipped_steps"]
        return d, meta.get("client_state", {})


def _adam_hyper(oparams: dict) -> dict:
    """The host Adam's hyperparameters from the optimizer block's params
    (``adam_w_mode`` defaults on, as the registry's ``adam`` does)."""
    return {"betas": tuple(oparams.get("betas", (0.9, 0.999))),
            "eps": float(oparams.get("eps", 1e-8)),
            "wd": float(oparams.get("weight_decay", 0.0)),
            "adamw": bool(oparams.get("adam_w_mode", True)),
            "bias_correction": bool(oparams.get("bias_correction", True))}


def _grads(outputs, inputs, grad_outputs):
    """``torch.autograd.grad`` with unused inputs given zero grads."""
    got = torch.autograd.grad(outputs, inputs, grad_outputs,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, inputs)]


def _prefetched(fn, n: int, workers: int):
    """``fn(0) .. fn(n - 1)`` in order, at most ``workers`` computed ahead
    on threads (a lazy init's layer draws release the GIL)."""
    if workers <= 1:
        for i in range(n):
            yield fn(i)
        return
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="dstt-pstream-init") as ex:
        futs = collections.deque(ex.submit(fn, i)
                                 for i in range(min(workers, n)))
        nxt = len(futs)
        while futs:
            out = futs.popleft().result()
            if nxt < n:
                futs.append(ex.submit(fn, nxt))
                nxt += 1
            yield out
            del out
