"""ctypes bindings for the port's host runtime natives
(``deepspeed_tpu_torch/csrc/host/hostruntime.cpp``; port of
``deepspeed_tpu/io/native.py``).

Reference behaviour: deepspeed's pinned host-tensor pool
(csrc/aio/py_lib/deepspeed_pin_tensor.cpp: get_new_cpu_locked_tensor /
free_cpu_locked_tensor) and the index shuffling torch's DataLoader does
natively.  Here: a page-aligned recycled buffer pool for host staging, and
an epoch-seeded shuffled-index service feeding
:mod:`deepspeed_tpu_torch.data.loader`.

The shared library builds with ``g++`` at first use into
``build/deepspeed_tpu_torch/host/``.  Where there is no toolchain, a
pure-Python arm keeps both APIs working (the shuffle's mirror,
:func:`_splitmix64_shuffle`, is bit-identical to the C++ one), and
``HostBufferPool.stats()["native"]`` / :attr:`ShuffleIndexService.native`
say which arm is live.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.utils.ctypes_build import (HOST_BUILD_DIR,
                                                    load_or_build)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "hostruntime.cpp")
_LIB = str(HOST_BUILD_DIR / "libdstt_host.so")
_build_lock = threading.Lock()


def _ensure_lib() -> Optional[ctypes.CDLL]:
    with _build_lock:
        lib = load_or_build(_LIB, _SRC)
        if lib is None:
            return None
    lib.dstt_pool_create.restype = ctypes.c_void_p
    lib.dstt_pool_create.argtypes = []
    lib.dstt_pool_destroy.restype = None
    lib.dstt_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.dstt_pool_get.restype = ctypes.c_void_p
    lib.dstt_pool_get.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dstt_pool_put.restype = None
    lib.dstt_pool_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dstt_pool_trim.restype = None
    lib.dstt_pool_trim.argtypes = [ctypes.c_void_p]
    lib.dstt_pool_stats.restype = None
    lib.dstt_pool_stats.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.dstt_idx_create.restype = ctypes.c_void_p
    lib.dstt_idx_create.argtypes = [ctypes.c_int64, ctypes.c_uint64]
    lib.dstt_idx_destroy.restype = None
    lib.dstt_idx_destroy.argtypes = [ctypes.c_void_p]
    lib.dstt_idx_window.restype = ctypes.c_int64
    lib.dstt_idx_window.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    return lib


class HostBufferPool:
    """Recycled page-aligned host staging buffers.

    ``get(nbytes)`` -> (numpy uint8 view, handle); ``put(handle)`` recycles
    (a second put of the same handle is ignored).  The view aliases the C
    buffer: drop it before, or with, its put.  ``torch.from_numpy`` of the
    view gives a CPU tensor over the same bytes.
    """

    def __init__(self):
        self._lib = _ensure_lib()
        self._pool = self._lib.dstt_pool_create() if self._lib else None
        self._fallback = {}
        self._lock = threading.Lock()
        self._next = 1

    def get(self, nbytes: int) -> Tuple[np.ndarray, int]:
        if self._pool:
            ptr = self._lib.dstt_pool_get(self._pool, nbytes)
            if not ptr:
                raise MemoryError(f"pool allocation of {nbytes} failed")
            arr = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(nbytes,))
            return arr, ptr
        with self._lock:
            h = self._next
            self._next += 1
            arr = np.empty(nbytes, np.uint8)
            self._fallback[h] = arr
        return arr, h

    def put(self, handle: int) -> None:
        if self._pool:
            self._lib.dstt_pool_put(self._pool, ctypes.c_void_p(handle))
        else:
            with self._lock:
                self._fallback.pop(handle, None)

    def stats(self) -> dict:
        if not self._pool:
            with self._lock:
                live = sum(a.nbytes for a in self._fallback.values())
            return {"bytes_pooled": 0, "bytes_live": live, "hits": 0,
                    "misses": 0, "native": False}
        out = (ctypes.c_int64 * 4)()
        self._lib.dstt_pool_stats(self._pool, out)
        return {"bytes_pooled": out[0], "bytes_live": out[1],
                "hits": out[2], "misses": out[3], "native": True}

    def trim(self) -> None:
        if self._pool:
            self._lib.dstt_pool_trim(self._pool)

    def close(self) -> None:
        if self._pool:
            self._lib.dstt_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _splitmix64_shuffle(n: int, seed: int, epoch: int) -> np.ndarray:
    """Pure-Python mirror of ``hostruntime.cpp``'s ``IndexService::
    Shuffle`` (and of the JAX package's ``io/native._splitmix64_shuffle``):
    Fisher–Yates driven by splitmix64 from a state seeded by ``seed`` and
    ``epoch``.  It must stay bit-identical, so a host whose native build
    failed produces the same batch order as one running the C++ path."""
    order = np.arange(n, dtype=np.int64)
    mask = np.uint64(0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        state = (np.uint64(seed) ^
                 (np.uint64(epoch & 0xFFFFFFFFFFFFFFFF) *
                  np.uint64(0xD1B54A32D192ED03) & mask) ^
                 np.uint64(0x2545F4914F6CDD1D))
        for i in range(n - 1, 0, -1):
            state = (state + np.uint64(0x9E3779B97F4A7C15)) & mask
            z = state
            z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & mask
            z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & mask
            z = z ^ (z >> np.uint64(31))
            j = int(z % np.uint64(i + 1))
            order[i], order[j] = order[j], order[i]
    return order


class ShuffleIndexService:
    """Epoch-seeded shuffled index windows for the dataloader."""

    def __init__(self, n: int, seed: int = 0, shuffle: bool = True):
        self.n = n
        self.seed = seed
        self.shuffle = shuffle
        self._lib = _ensure_lib() if shuffle else None
        self._svc = (self._lib.dstt_idx_create(n, seed)
                     if self._lib else None)

    def window(self, epoch: int, start: int, count: int) -> np.ndarray:
        if not self.shuffle:
            hi = min(self.n, start + count)
            return np.arange(start, max(start, hi), dtype=np.int64)
        if self._svc:
            out = np.empty(count, np.int64)
            m = self._lib.dstt_idx_window(
                self._svc, epoch, start, count,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            return out[:m]
        order = _splitmix64_shuffle(self.n, self.seed, epoch)
        return order[start:start + count]

    def epoch_order(self, epoch: int) -> np.ndarray:
        return self.window(epoch, 0, self.n)

    def close(self) -> None:
        if self._svc:
            self._lib.dstt_idx_destroy(self._svc)
            self._svc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def native(self) -> bool:
        return self._svc is not None
