"""Double-buffered tier -> device read pipeline (the port's part of
``deepspeed_tpu/param_stream.py``).

:class:`TierLayerReader` streams items (transformer layers) off a tier
(:mod:`~deepspeed_tpu_torch.infinity`): the ZeRO-Inference serving engine
reads its streamed layers through it, and :class:`TierPageReader` runs KV
page promotion over the same core.  The streamed training engine
(``LayeredModel`` / ``ParamStreamEngine``) comes with ZeRO offload (ROADMAP
A9).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Callable, List

import numpy as np
import torch

from deepspeed_tpu_torch.faults import retry_with_backoff

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
