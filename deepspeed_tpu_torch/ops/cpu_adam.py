"""ctypes binding for the port's fused C++ CPU Adam
(``deepspeed_tpu_torch/csrc/host/cpu_adam.cpp``; port of
``deepspeed_tpu/ops/cpu_adam.py``).

Reference behaviour: deepspeed/ops/adam/cpu_adam.cpp DeepSpeedCPUAdam.
ZeRO-Offload/Infinity update the optimizer state on the HOST, and doing it
with a fused threaded loop (one memory pass) instead of a chain of tensor
expressions (~10 passes) is what makes host updates viable at billions of
parameters.

:func:`cpu_adam_step` updates flat f32 ``(p, m, v)`` in place from ``g``
and can emit the bf16 compute image of the new ``p`` in the same pass.
Its buffers are contiguous CPU f32 ``torch.Tensor``\\ s (pinned ones too)
or C-contiguous numpy arrays.  The library builds with ``g++`` (and
``-ffp-contract=off``) at first use into ``build/deepspeed_tpu_torch/
host/``; where there is no toolchain the plain mirror runs the JAX
package's numpy fallback in torch ops (more passes) and rounds the bf16
image to nearest even as the C++ does.  Each arm agrees with its JAX twin
within an f32 ulp.  The two arms differ more than that: the C++ forms
``1 - b1`` and ``1 - b2`` in f32, the mirror rounds them from f64, which
moves ``v`` by up to ~5e-5 relative (both JAX arms differ the same way).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.utils.ctypes_build import (HOST_BUILD_DIR,
                                                    load_or_build)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "cpu_adam.cpp")
_LIB = str(HOST_BUILD_DIR / "libdstt_cpuadam.so")
_build_lock = threading.Lock()

N_THREADS = max(1, min((os.cpu_count() or 1), 16))

Buffer = Union[torch.Tensor, np.ndarray]


def _ensure_lib() -> Optional[ctypes.CDLL]:
    with _build_lock:
        # -ffp-contract=off: no FMA contraction, so each operation rounds
        # in the order it is written, as in the JAX package's build of the
        # same source (the two natives agree bit for bit)
        lib = load_or_build(_LIB, _SRC, extra_flags=("-ffp-contract=off",))
        if lib is None:
            return None
    f = ctypes.c_void_p
    lib.dstt_cpu_adam.restype = None
    lib.dstt_cpu_adam.argtypes = [
        f, f, f, f, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        f, ctypes.c_int, ctypes.c_float]
    lib.dstt_accum_bf16.restype = ctypes.c_double
    lib.dstt_accum_bf16.argtypes = [f, f, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int]
    lib.dstt_f32_to_bf16.restype = None
    lib.dstt_f32_to_bf16.argtypes = [f, f, ctypes.c_int64, ctypes.c_int]
    return lib


def native_available() -> bool:
    return _ensure_lib() is not None


def _as_tensor(a: Buffer, name: str) -> torch.Tensor:
    """A CPU f32 tensor over ``a``'s memory (no copy); anything that is not
    a contiguous CPU f32 buffer raises, since the update writes through
    it."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu" \
            or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"cpu_adam: {name} must be a contiguous CPU float32 tensor or "
            f"a C-contiguous float32 numpy array, got "
            f"{getattr(t, 'dtype', type(a))} on "
            f"{getattr(t, 'device', 'host')}")
    return t


def _bf16_image(like: Buffer, shape) -> tuple:
    """(the bf16 image as the caller gets it, its bf16 tensor view): a
    uint16 numpy array of bf16 bit patterns for numpy callers, as the JAX
    package returns, a bfloat16 tensor for tensor callers."""
    if isinstance(like, np.ndarray):
        out = np.empty(shape, np.uint16)
        return out, torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    out = torch.empty(shape, dtype=torch.bfloat16)
    return out, out


def _bf16_out(out: Buffer, n: int) -> torch.Tensor:
    """The bf16 tensor view of a caller's image buffer of ``n``
    elements."""
    out_t = (torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
             if isinstance(out, np.ndarray) else out)
    if out_t.dtype != torch.bfloat16 or out_t.numel() != n \
            or not out_t.is_contiguous() or out_t.device.type != "cpu":
        raise ValueError("cpu_adam: out must be a contiguous CPU bf16 (or "
                         "uint16) buffer of p's size")
    return out_t


def cpu_adam_step(p: Buffer, m: Buffer, v: Buffer, g: Buffer, *, lr: float,
                  b1: float, b2: float, eps: float, wd: float, adamw: bool,
                  t: int, bias_correction: bool = True,
                  emit_bf16: bool = False,
                  out: Optional[Buffer] = None,
                  grad_scale: float = 1.0) -> Optional[Buffer]:
    """One fused Adam step over flat f32 buffers, in place.

    Returns the bf16 compute image of the new ``p`` when ``emit_bf16``
    (uint16 bit patterns for numpy buffers, a bfloat16 tensor for
    tensors), else None; ``out``, a contiguous bf16 tensor (or uint16
    array) of ``p``'s size, receives the image in place of a new buffer
    (the streamed engines write it straight into page-locked memory).
    ``grad_scale``: the step's grad is ``g * grad_scale`` in f32, as a
    separate ``g *= grad_scale`` would make it (``g`` is not written).
    ``p``/``m``/``v``/``g`` must be contiguous CPU f32 of equal size; the
    native loop runs on :data:`N_THREADS` threads.
    """
    tp, tm, tv, tg = (_as_tensor(a, n) for a, n in
                      ((p, "p"), (m, "m"), (v, "v"), (g, "g")))
    n = tp.numel()
    if not tm.numel() == tv.numel() == tg.numel() == n:
        raise ValueError("cpu_adam: p, m, v and g differ in size")
    if bias_correction:
        inv_c1 = 1.0 / (1.0 - b1 ** t)
        inv_c2 = 1.0 / (1.0 - b2 ** t)
    else:
        inv_c1 = inv_c2 = 1.0
    out_t = None
    if emit_bf16 and out is None:
        out, out_t = _bf16_image(p, tuple(p.shape))
    elif emit_bf16:
        out_t = _bf16_out(out, n)
    lib = _ensure_lib()
    if lib is not None:
        lib.dstt_cpu_adam(
            tp.data_ptr(), tm.data_ptr(), tv.data_ptr(), tg.data_ptr(), n,
            lr, b1, b2, eps, wd, int(adamw), inv_c1, inv_c2,
            out_t.data_ptr() if out_t is not None else None, N_THREADS,
            grad_scale)
        return out
    # plain mirror: the same arithmetic, in more passes
    gg = tg * grad_scale if grad_scale != 1.0 else tg
    if wd and not adamw:
        gg = gg + wd * tp
    tm.mul_(b1).add_((1.0 - b1) * gg)
    tv.mul_(b2).add_((1.0 - b2) * (gg * gg))
    # torch's CPU f32 sqrt is not always correctly rounded (it differs
    # from C's and numpy's in ~0.7% of elements); the f64 root rounded to
    # f32 is
    u = (tm * inv_c1) / (torch.sqrt((tv * inv_c2).double()).float() + eps)
    if wd and adamw:
        u = u + wd * tp
    tp.sub_(lr * u)
    if out_t is not None:
        out_t.view(-1).copy_(tp.view(-1))
    return out


def accumulate_bf16(acc: torch.Tensor, g: torch.Tensor,
                    first: bool) -> float:
    """Land a bf16 grad in its f32 accumulator in one pass: ``acc = g`` on
    the first micro-batch, ``acc += g`` after (the widening is exact, the
    add rounds once in f32); returns the sum of squares of the new ``acc``
    (in f64, its threads' shares summed in order)."""
    ta = _as_tensor(acc, "acc")
    if g.dtype != torch.bfloat16 or g.device.type != "cpu" \
            or not g.is_contiguous() or g.numel() != ta.numel():
        raise ValueError("accumulate_bf16: g must be a contiguous CPU bf16 "
                         "tensor of acc's size")
    lib = _ensure_lib()
    if lib is not None:
        return float(lib.dstt_accum_bf16(ta.data_ptr(), g.data_ptr(),
                                         ta.numel(), int(first), N_THREADS))
    if first:
        ta.copy_(g)
    else:
        ta.add_(g)
    return float(torch.dot(ta.double(), ta.double()))


def f32_to_bf16(src: Buffer, out: Optional[Buffer] = None) -> Buffer:
    """Threaded f32 -> bf16 conversion, rounded to nearest even (a uint16
    numpy array of bit patterns for a numpy ``src``, a bfloat16 tensor for
    a tensor)."""
    ts = _as_tensor(src, "src")
    if out is None:
        out, out_t = _bf16_image(src, tuple(src.shape))
    else:
        out_t = _bf16_out(out, ts.numel())
    lib = _ensure_lib()
    if lib is not None:
        lib.dstt_f32_to_bf16(ts.data_ptr(), out_t.data_ptr(), ts.numel(),
                             N_THREADS)
        return out
    out_t.view(-1).copy_(ts.view(-1))
    return out
