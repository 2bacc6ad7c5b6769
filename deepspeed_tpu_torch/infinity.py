"""Host and NVMe tiers for streamed state (the port's part of
``deepspeed_tpu/infinity.py``; ref: deepspeed/runtime/swap_tensor/ —
ZeRO-Infinity's partitioned swappers).

A tier holds named host buffers between uses: :class:`_RamTier` in host
memory, :class:`_NvmeTier` in one flat file per name under a directory,
read and written through the port's aio pool (:mod:`~deepspeed_tpu_torch.
io.aio`) on ALTERNATING read and write slots: a pool's ``wait`` fences
everything it has, so two pools per direction give per-slot fencing and
keep one item of IO in flight in each direction.  The ZeRO-Inference
serving engine streams layer weights through either tier
(:class:`~deepspeed_tpu_torch.param_stream.TierLayerReader`).

Buffers are numpy arrays or CPU tensors of any dtype (bfloat16 too: the
files hold raw bytes).  :class:`PinnedBuffer` page-locks host memory once,
so host -> device copies out of it run asynchronously on a side stream.

The ZeRO-Infinity training engine (:class:`InfinityEngine`) comes with
ZeRO offload (ROADMAP A9).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.io.aio import as_bytes


def _empty(shape, dtype):
    """A host buffer of ``shape`` and ``dtype`` (a torch dtype gives a CPU
    tensor, anything else a numpy array)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(tuple(shape), dtype=dtype)
    return np.empty(tuple(shape), np.dtype(dtype))


class PinnedBuffer:
    """``nbytes`` of host memory, page-locked with ``cudaHostRegister``
    when CUDA is available (one registration for the whole buffer, at its
    exact size: ``pin_memory`` would round a 2.9 GB layer up to 4 GiB), so
    a ``copy_(non_blocking=True)`` out of it is truly asynchronous.  The
    registration is undone when the buffer is collected, before its memory
    is freed.  Without CUDA the buffer is plain host memory."""

    def __init__(self, nbytes: int):
        self.tensor = torch.empty((max(int(nbytes), 1),), dtype=torch.uint8)
        self._registered = False
        if torch.cuda.is_available():
            rt = torch.cuda.cudart()
            torch.cuda.check_error(rt.cudaHostRegister(
                self.tensor.data_ptr(), self.tensor.numel(), 0))
            self._registered = True

    def view(self, offset: int, shape, dtype: torch.dtype) -> torch.Tensor:
        """A tensor of ``shape`` and ``dtype`` over the bytes at
        ``offset``."""
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        return self.tensor[offset:offset + n].view(dtype).view(tuple(shape))

    def __del__(self):
        if getattr(self, "_registered", False):
            torch.cuda.cudart().cudaHostUnregister(self.tensor.data_ptr())
            self._registered = False


class _Tier:
    """Where streamed host buffers live between uses."""

    def put(self, name: str, arr) -> None:
        raise NotImplementedError

    def get_submit(self, name: str, shape, dtype, out=None):
        """Begin fetching; returns the buffer (valid after
        :meth:`fence_reads`).  ``out``: an optional preallocated
        destination, honoured by the NVMe tier (reads land in place); the
        RAM tier returns its stored buffer regardless."""
        raise NotImplementedError

    def reads_pending(self) -> int:
        return 0

    def fence_reads(self) -> None:
        pass

    def fence_writes(self) -> None:
        pass

    def fence_all(self) -> None:
        pass

    def next_read_slot(self) -> None:
        pass


class _RamTier(_Tier):
    """Buffers kept in host memory as they are put (the ZeRO-Inference
    engine puts views of one pinned buffer per layer)."""

    def __init__(self):
        self.store: Dict[str, object] = {}

    def put(self, name, arr):
        self.store[name] = arr

    def get_submit(self, name, shape, dtype, out=None):
        return self.store[name]

    def read_sync(self, name, shape, dtype):
        """Synchronous read (the degradation rung below aio: trivially the
        stored buffer here)."""
        return self.store[name]


class _NvmeTier(_Tier):
    """A flat file per name; alternating aio pools for per-slot fencing."""

    def __init__(self, path: str, n_threads: int = 4):
        from deepspeed_tpu_torch.io.aio import AioHandle

        os.makedirs(path, exist_ok=True)
        self.dir = path
        self.rpools = [AioHandle(n_threads), AioHandle(n_threads)]
        self.wpools = [AioHandle(n_threads), AioHandle(n_threads)]
        self.rslot = 0
        self.wslot = 0
        self._wbufs: List[list] = [[], []]
        self._fds: Dict[Tuple[str, bool], int] = {}

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".bin")

    def _fd(self, pool, name: str, write: bool) -> int:
        key = (name, write)
        if key not in self._fds:
            self._fds[key] = pool.open(self._path(name), write=write)
        return self._fds[key]

    def next_read_slot(self):
        self.rslot ^= 1

    def next_write_slot(self):
        self.wslot ^= 1

    def put(self, name, arr):
        pool = self.wpools[self.wslot]
        self._wbufs[self.wslot].append(arr)  # keep alive until the fence
        pool.pwrite(self._fd(pool, name, True), arr, 0)

    def get_submit(self, name, shape, dtype, out=None):
        pool = self.rpools[self.rslot]
        buf = _empty(shape, dtype) if out is None else out
        pool.pread(self._fd(pool, name, False), buf, 0)
        return buf

    def reads_pending(self) -> int:
        """In-flight reads on the CURRENT slot (non-blocking): 0 means the
        next :meth:`fence_reads` is free, the prefetch hid behind
        compute."""
        return self.rpools[self.rslot].pending()

    def read_sync(self, name, shape, dtype):
        """Synchronous read through the plain OS path, bypassing the aio
        pools: the rung a reader drops to when a fence exhausted its
        retries."""
        buf = _empty(shape, dtype)
        view = as_bytes(buf)
        with open(self._path(name), "rb") as f:
            if f.readinto(memoryview(view)) != view.nbytes:
                raise IOError(f"short read of {self._path(name)}")
        return buf

    def fence_reads(self):
        errs = self.rpools[self.rslot].wait()
        if errs:
            raise IOError(f"{errs} NVMe reads failed")

    def fence_writes(self):
        errs = self.wpools[self.wslot].wait()
        self._wbufs[self.wslot] = []
        if errs:
            raise IOError(f"{errs} NVMe writes failed")

    def fence_all(self):
        for s in (0, 1):
            self.rpools[s].wait()
            errs = self.wpools[s].wait()
            self._wbufs[s] = []
            if errs:
                raise IOError(f"{errs} NVMe writes failed")


class InfinityEngine:
    """The ZeRO-Infinity training engine (rank-partitioned optimizer-state
    streaming) of the JAX package."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "InfinityEngine (ZeRO-Infinity optimizer-state streaming) comes "
            "with ZeRO offload (ROADMAP A9)")
