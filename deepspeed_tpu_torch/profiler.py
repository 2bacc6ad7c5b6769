"""FLOPs profiler (port of ``deepspeed_tpu/profiler.py``; ref:
deepspeed/profiling/flops_profiler/profiler.py).

The reference hooks every torch module to count MACs/params.  The JAX
package reads XLA's cost analysis of the compiled program; the port has
no compiled program, so it counts what the plain call dispatches:

- **Counted FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the
  call — the matmul, convolution and attention FLOPs of the ops that ran
  (elementwise ops count zero, as in XLA's estimate they are a rounding
  error).  ``bytes_accessed`` is the bytes of the call's tensor inputs
  and outputs, each read or written once (the least it must move).
- **Analytic formulas** for transformer train/inference FLOPs (the
  standard 6*N*T + attention terms), used for MFU targets and for the
  serving engine's roofline denominators (:mod:`~deepspeed_tpu_torch.
  devprof`).

Latency is timed with CUDA events on the card (the device's own clock)
and with ``perf_counter`` on the CPU.  ``get_model_profile`` mirrors the
reference's entrypoint name.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch._tree import tree_leaves
from deepspeed_tpu_torch.timers import device_peak_flops

# ----------------------------------------------------------------- analytic
def transformer_train_flops(n_params: float, tokens: float,
                            n_layers: int = 0, hidden: int = 0,
                            seq_len: int = 0,
                            checkpoint_activations: bool = False) -> float:
    """FLOPs for one train step over ``tokens`` tokens.

    Standard decomposition (Kaplan/Chinchilla accounting): 6*N per token
    for fwd+bwd matmuls (8*N with full activation rematerialisation), plus
    the seq-quadratic attention term 12*L*H*T^2 per sequence-token batch.
    """
    mult = 8.0 if checkpoint_activations else 6.0
    flops = mult * n_params * tokens
    if n_layers and hidden and seq_len:
        attn_mult = 4.0 if checkpoint_activations else 3.0
        flops += attn_mult * 4.0 * n_layers * hidden * seq_len * tokens
    return flops


def transformer_decode_flops(n_params: float, n_layers: int, hidden: int,
                             kv_len: int) -> float:
    """FLOPs for decoding ONE token with a ``kv_len`` KV cache."""
    return 2.0 * n_params + 4.0 * n_layers * hidden * kv_len


def params_count(params: Any) -> int:
    """Total leaf elements of a tree (ref: profiler's params column)."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(params)
               if hasattr(x, "shape"))


# ----------------------------------------------------------------- counted
def _tensor_bytes(tree: Any) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def counted_cost(fn: Callable, *args, **kw) -> Dict[str, float]:
    """FLOPs the call dispatches (``FlopCounterMode``) and the bytes of its
    tensor arguments and results; runs ``fn`` once."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        out = fn(*args, **kw)
    return {"flops": float(fc.get_total_flops()),
            "bytes_accessed": float(_tensor_bytes((args, kw))
                                    + _tensor_bytes(out))}


def _device_of(tree: Any) -> Optional[torch.device]:
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            return x.device
    return None


class FlopsProfiler:
    """Measure a step: counted flops, latency, achieved TFLOPS, MFU.

    ref: deepspeed/profiling/flops_profiler — ``start_profile`` /
    ``stop_profile`` / ``print_model_profile`` flow, minus module hooks.
    ``static_argnums`` is accepted for the JAX signature and unused (no
    tracing happens)."""

    def __init__(self, fn: Callable, static_argnums=()):
        self.fn = fn
        self.static_argnums = static_argnums
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.latency = 0.0
        self.device: Optional[torch.device] = None

    def profile(self, *args, iters: int = 5,
                warmup: int = 2) -> Dict[str, float]:
        cost = counted_cost(self.fn, *args)
        self.flops = cost["flops"]
        self.bytes_accessed = cost["bytes_accessed"]
        self.device = _device_of(args)
        cuda = self.device is not None and self.device.type == "cuda"
        with torch.no_grad():
            for _ in range(warmup):
                self.fn(*args)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    self.fn(*args)
                end.record()
                end.synchronize()
                self.latency = start.elapsed_time(end) / 1e3 / iters
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    self.fn(*args)
                self.latency = (time.perf_counter() - t0) / iters
        return self.summary()

    def summary(self) -> Dict[str, float]:
        tflops = self.flops / self.latency / 1e12 if self.latency else 0.0
        peak = device_peak_flops(self.device)
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "latency_s": self.latency,
            "tflops": tflops,
            "mfu": tflops * 1e12 / peak if peak else 0.0,
            "arithmetic_intensity": (self.flops / self.bytes_accessed
                                     if self.bytes_accessed else 0.0),
        }


def get_model_profile(fn: Callable, args: Tuple, params: Optional[Any] = None,
                      iters: int = 5, print_profile: bool = True,
                      static_argnums=()) -> Dict[str, float]:
    """One-call profile (ref: flops_profiler.get_model_profile)."""
    prof = FlopsProfiler(fn, static_argnums=static_argnums)
    out = prof.profile(*args, iters=iters)
    if params is not None:
        out["params"] = float(params_count(params))
    if print_profile:
        from deepspeed_tpu_torch.utils.logging import log_dist

        rows = [f"  {k:>22}: {v:.4g}" for k, v in out.items()]
        log_dist("flops profile:\n" + "\n".join(rows))
    return out
