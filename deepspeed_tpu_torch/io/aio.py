"""ctypes bindings for the port's host async-IO pool
(``deepspeed_tpu_torch/csrc/host/aio.cpp``; port of
``deepspeed_tpu/io/aio.py``).

Reference behaviour: deepspeed/ops/aio's AsyncIOBuilder, an aio_handle with
``async_pread`` / ``async_pwrite`` / ``wait`` used by ZeRO-Infinity's NVMe
swapper: submit, overlap with compute, wait.  Host buffers are C-contiguous
numpy arrays or CPU tensors (any dtype, bfloat16 too: the pool moves their
raw bytes).

The shared library builds with ``g++`` at first use into
``build/deepspeed_tpu_torch/host/``; where there is no toolchain a
pure-Python thread pool keeps the API working, and :attr:`AioHandle.native`
says which arm is live.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.ctypes_build import (HOST_BUILD_DIR,
                                                    load_or_build)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "aio.cpp")
_LIB = str(HOST_BUILD_DIR / "libdstt_aio.so")
_build_lock = threading.Lock()


def _ensure_lib() -> Optional[ctypes.CDLL]:
    with _build_lock:
        lib = load_or_build(_LIB, _SRC)
        if lib is None:
            return None
    lib.dstt_aio_create.restype = ctypes.c_void_p
    lib.dstt_aio_create.argtypes = [ctypes.c_int]
    lib.dstt_aio_destroy.argtypes = [ctypes.c_void_p]
    lib.dstt_aio_open.restype = ctypes.c_int
    lib.dstt_aio_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.dstt_aio_close.argtypes = [ctypes.c_int]
    for fn in (lib.dstt_aio_pread, lib.dstt_aio_pwrite):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64]
    lib.dstt_aio_wait.restype = ctypes.c_int64
    lib.dstt_aio_wait.argtypes = [ctypes.c_void_p]
    lib.dstt_aio_pending.restype = ctypes.c_int64
    lib.dstt_aio_pending.argtypes = [ctypes.c_void_p]
    return lib


def as_bytes(buf) -> np.ndarray:
    """A host buffer's bytes as a flat uint8 numpy view (no copy): a
    C-contiguous numpy array or a contiguous CPU tensor.  Anything else
    raises: the pool writes through the pointer, so a copy would lose the
    read."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError(
                f"aio buffers must be contiguous CPU tensors, got "
                f"{buf.device} contiguous={buf.is_contiguous()}")
        return buf.reshape(-1).view(torch.uint8).numpy()
    if not isinstance(buf, np.ndarray) or not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous numpy arrays or "
                         "CPU tensors")
    return buf.reshape(-1).view(np.uint8)


class AioPriorityGroup:
    """Cooperative priority among aio users sharing one storage device.

    The pool has no notion of priority, so consumers that share a disk
    coordinate on the host: each registers a non-blocking ``pending_fn``
    (typically :meth:`AioHandle.pending`) with a priority, and a
    lower-priority consumer polls :meth:`busy_above` before submitting a
    batch, deferring while any higher-priority member has ops in flight.
    The ZeRO-Inference engine registers its layer-weight read pools above
    the KV tier's promotion channel: a sweep stalled on weights stalls the
    whole batch, a deferred promotion only one admission.  Callers bound
    their own deferral (the serving engine caps promotion deferrals)."""

    def __init__(self):
        self._members: List = []   # (pending_fn, priority)

    def register(self, pending_fn, priority: int) -> None:
        self._members.append((pending_fn, int(priority)))

    def busy_above(self, priority: int) -> bool:
        """True when any member registered above ``priority`` has
        submitted-but-unfinished ops."""
        return any(prio > priority and fn() > 0
                   for fn, prio in self._members)


class AioHandle:
    """ref: deepspeed.ops.aio aio_handle(block_size, queue_depth, ...)."""

    def __init__(self, n_threads: int = 8):
        self._lib = _ensure_lib()
        self._fds: List[int] = []
        # fault injection (deepspeed_tpu_torch.faults): error rules swallow
        # the submit and surface as failed ops at the next wait(); latency
        # rules sleep at submit.  No plan installed = one branch per op
        self._inject_errs = 0
        # buffers of submitted ops, kept alive until the next wait()
        self._inflight: List[np.ndarray] = []
        if self._lib is not None:
            self._pool = self._lib.dstt_aio_create(n_threads)
            self._exec = None
        else:  # pure-python arm
            self._pool = None
            self._exec = ThreadPoolExecutor(max_workers=n_threads)
            self._futures = []

    @property
    def native(self) -> bool:
        return self._pool is not None

    # ------------------------------------------------------------- file ops
    def open(self, path: str, write: bool = False) -> int:
        if self.native:
            fd = self._lib.dstt_aio_open(path.encode(), int(write), 0)
        else:
            fd = os.open(path, (os.O_WRONLY | os.O_CREAT) if write
                         else os.O_RDONLY, 0o644)
        if fd < 0:
            raise OSError(f"cannot open {path}")
        self._fds.append(fd)
        return fd

    def close(self, fd: int) -> None:
        if self.native:
            self._lib.dstt_aio_close(fd)
        else:
            os.close(fd)
        if fd in self._fds:
            self._fds.remove(fd)

    # ------------------------------------------------------------ async ops
    def _maybe_inject(self, subsystem: str) -> bool:
        """Consult the process-wide fault plan for one op: applies latency
        rules, records error rules as a failed op reported by the next
        :meth:`wait`.  Returns True when the op must NOT be submitted (it
        is the injected failure)."""
        from deepspeed_tpu_torch import faults

        if faults.active_plan() is None:
            return False
        delay, err = faults.poll(subsystem)
        if delay:
            import time

            time.sleep(delay)
        if err is not None:
            self._inject_errs += 1
            return True
        return False

    def _submit(self, fd: int, buf, offset: int, write: bool) -> None:
        if self._maybe_inject("aio_write" if write else "aio_read"):
            return                # swallowed: wait() reports the error
        view = as_bytes(buf)
        self._inflight.append(view)
        if self.native:
            fn = self._lib.dstt_aio_pwrite if write else \
                self._lib.dstt_aio_pread
            fn(self._pool, fd, view.ctypes.data_as(ctypes.c_void_p),
               view.nbytes, offset)
        else:
            self._futures.append(self._exec.submit(
                self._py_rw, fd, view, offset, write))

    def pread(self, fd: int, buf, offset: int = 0) -> None:
        """Submit an async read of ``buf``'s bytes at ``offset`` into
        ``buf``."""
        self._submit(fd, buf, offset, False)

    def pwrite(self, fd: int, buf, offset: int = 0) -> None:
        """Submit an async write of ``buf``'s bytes at ``offset``."""
        self._submit(fd, buf, offset, True)

    @staticmethod
    def _py_rw(fd: int, view: np.ndarray, offset: int, write: bool):
        mv = memoryview(view)
        if write:
            done = 0
            while done < view.nbytes:
                n = os.pwrite(fd, mv[done:], offset + done)
                if n <= 0:
                    raise OSError(f"short write at {offset + done}")
                done += n
        else:
            data = os.pread(fd, view.nbytes, offset)
            if len(data) != view.nbytes:
                raise OSError(f"short read: {len(data)} of {view.nbytes}")
            mv[:] = data

    def pending(self) -> int:
        """Submitted-but-unfinished op count, without blocking.  Streaming
        readers use it to tell a prefetch hit (ops already landed; the
        fence is free) from a stall."""
        if self.native:
            return int(self._lib.dstt_aio_pending(self._pool))
        return sum(1 for f in self._futures if not f.done())

    def wait(self) -> int:
        """Block until all submitted ops complete; returns the number that
        failed."""
        if self.native:
            errs = int(self._lib.dstt_aio_wait(self._pool))
        else:
            errs = 0
            for f in self._futures:
                try:
                    f.result()
                except OSError:
                    errs += 1
            self._futures = []
        self._inflight = []
        errs += self._inject_errs
        self._inject_errs = 0
        return errs

    def __del__(self):
        try:
            if self.native:
                self._lib.dstt_aio_wait(self._pool)
            for fd in list(self._fds):
                self.close(fd)
            if self.native and self._pool is not None:
                self._lib.dstt_aio_destroy(self._pool)
                self._pool = None
            elif self._exec is not None:
                self._exec.shutdown(wait=True)
        except (AttributeError, OSError):
            pass
