"""Double-buffered tier -> device read pipeline (the port's part of
``deepspeed_tpu/param_stream.py``).

:class:`TierLayerReader` keeps its submit / fence / sweep core — the path
on which each item's tier reads are submitted one item ahead and fenced
when the sweep reaches it — and :class:`TierPageReader` runs KV-page
promotion over it.  The layer-weight readers of ZeRO-Inference and the
streamed training engine come with the ``zero_inference`` port.
"""

from __future__ import annotations

import logging
from typing import Callable, List

from deepspeed_tpu_torch.faults import retry_with_backoff

logger = logging.getLogger(__name__)


class TierLayerReader:
    """Double-buffered tier -> device per-item read pipeline: while the
    caller consumes item ``order[i]``, item ``order[i+1]``'s tier reads are
    already submitted.

    ``tier`` implements the read interface (``get_submit`` /
    ``reads_pending`` / ``fence_reads`` / ``next_read_slot``, optionally
    ``read_sync``); ``names_fn(l)`` gives the tier keys of item ``l``,
    aligned with ``shapes``/``dtypes``; ``to_device(bufs, l)`` turns the
    fenced host buffers into what the sweep yields.  A failed fence
    resubmits the item's reads up to ``retries`` times (exponential
    backoff), then falls over to the tier's synchronous ``read_sync``, and
    only then raises."""

    def __init__(self, tier, names_fn: Callable[[int], List[str]], shapes,
                 dtypes, to_device, retries: int = 2,
                 retry_backoff_s: float = 0.05):
        self.tier = tier
        self.names_fn = names_fn
        self.shapes = list(shapes)
        self.dtypes = list(dtypes)
        self.to_device = to_device
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        # a HIT: the item's reads had already landed when the sweep
        # reached it (its fence was free)
        self.hits = 0
        self.stalls = 0
        self.io_retries = 0
        self.sync_fallbacks = 0

    def _meta(self, l: int):
        """``(names, shapes, dtypes)`` of item ``l``'s tier reads: fixed
        across items here; :class:`TierPageReader` overrides it."""
        return self.names_fn(l), self.shapes, self.dtypes

    def _submit(self, l: int):
        names, shapes, dtypes = self._meta(l)
        return [self.tier.get_submit(n, s, d)
                for n, s, d in zip(names, shapes, dtypes)]

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
        names, shapes, dtypes = self._meta(l)
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

    def sweep(self, order, primed=None):
        """Yield ``(l, to_device(bufs, l))`` over ``order`` with the next
        item's reads in flight.  ``primed``: buffers from
        :meth:`presubmit` of ``order[0]``."""
        order = list(order)
        if not order:
            return
        pending = primed if primed is not None else self._submit(order[0])
        for i, l in enumerate(order):
            if self.tier.reads_pending() == 0:
                self.hits += 1
            else:
                self.stalls += 1
            pending = self._fence_retry(l, pending)
            self.tier.next_read_slot()
            bufs = pending
            if i + 1 < len(order):
                pending = self._submit(order[i + 1])
            yield l, self.to_device(bufs, l)


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
        return names, shapes, dtypes
