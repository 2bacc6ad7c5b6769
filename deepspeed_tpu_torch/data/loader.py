"""Host-side data loader (port of ``deepspeed_tpu/data/loader.py``; ref:
deepspeed/runtime/dataloader.py DeepSpeedDataLoader).

The loader yields GLOBAL batches (dict/tuple of numpy arrays), as the
reference does; the engine moves them to its device.  A background
prefetch thread overlaps host batch assembly with device compute.

The epoch order comes from the port's native index service
(:class:`~deepspeed_tpu_torch.io.native.ShuffleIndexService`, over
``csrc/host/hostruntime.cpp``), as the JAX loader takes it from its own;
where the native build is absent the service runs its bit-identical
pure-Python mirror, so the port's batches equal the JAX loader's for every
seed and epoch either way.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


class DataLoader:
    def __init__(self, dataset: Sequence, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 collate_fn: Optional[Callable] = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.prefetch = prefetch
        self.epoch = 0
        self._idx_svc = None  # the native shuffle service, built lazily

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.dataset))
        if self._idx_svc is None or self._idx_svc.n != len(self.dataset):
            from deepspeed_tpu_torch.io.native import ShuffleIndexService

            self._idx_svc = ShuffleIndexService(len(self.dataset),
                                                seed=self.seed)
        return self._idx_svc.epoch_order(self.epoch)

    def __iter__(self) -> Iterator[Any]:
        idx = self._indices()
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that re-checks stop so an abandoned iterator
            # doesn't leave this thread parked on a full queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            for b in range(nb):
                if stop.is_set():
                    return
                sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                if not put(self.collate_fn([self.dataset[int(i)] for i in sel])):
                    return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()


def _default_collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([it[i] for it in items])
                           for i in range(len(first)))
    return np.stack(items)


class RepeatingLoader:
    """ref: deepspeed/runtime/dataloader.py RepeatingLoader — endless iter."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self._it = iter(self.loader)
            return next(self._it)
