#!/usr/bin/env python3
"""Times the PyTorch port's greedy-argmax kernel B6 on one CUDA GPU at the
serving vocabulary of Llama-3-8B (V = 128256), once per round.

    python3 tools/torch_greedy_bench.py [--rounds 1] [--root CHECKOUT]
                                        [--spans 1,2,4,8,16]

For B in 1, 8 and 64 rows, f32 and bf16 logits: ``fused_greedy_rows`` on
the device clock (``chip_smoke.device_ms``: per call, summed over every
kernel it launches, and the kernels per call, over 50 calls), with events
around the wrapper, and ``torch.argmax`` on the same clock, beside the
bytes bound; each answer against ``torch.argmax``, exactly.  Every call
reads copies of its input in turn, together three times the L2
(``chip_smoke.cold_inputs``), so it reads from HBM as the bound assumes;
the kernel and ``argmax`` are also timed on one input, which stays in L2
(``l2_*``, no share of the bound).  A share above 1 is kept out of
``bound_share`` and reported as ``above_bound``.  A checkout whose wrapper
takes only f32 reports the bf16 cases as not supported.  ``--spans`` also
times this checkout's kernel with each row over S blocks (S = 1 is the
row body), called through its C entry point.

The package comes from ``--root`` (default: the checkout this script sits
in), so two checkouts compare in one call by running this script on each
in turns; timers and bounds are this checkout's ``chip_smoke``.  Prints
one JSON line per round with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 128256


def _smoke():
    """This checkout's ``chip_smoke`` (its timers and bounds)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed(smoke, fn, x):
    want = torch.argmax(x, dim=-1)
    try:
        got = fn(x)
    except (TypeError, ValueError) as e:
        return {"not_supported": str(e)}
    exact = bool(torch.equal(got.long(), want))
    cold = smoke.cold_inputs(x)
    dev, kernels = smoke.device_ms(lambda: fn(cold()), iters=50,
                                   kernels=True)
    return {"exact": exact, "device_ms_per_call": dev,
            "kernels_per_call": kernels,
            "events_ms": smoke.time_ms(lambda: fn(cold()), iters=50),
            "l2_device_ms_per_call": smoke.device_ms(lambda: fn(x),
                                                     iters=50)}


def _spans_fn(S):
    """This checkout's kernel with each row over S blocks, or None where
    its C entry point takes no span count."""
    from deepspeed_tpu_torch.ops import _build

    if len(_build.SIGNATURES["dstt_greedy_argmax"]) != 8:
        return None
    from deepspeed_tpu_torch.ops.sampling_cuda import GREEDY_DTYPES

    def fn(x):
        B, n = x.shape
        out = torch.empty((B,), dtype=torch.int32, device=x.device)
        _build.check("dstt_greedy_argmax", _build.lib().dstt_greedy_argmax(
            x.data_ptr(), out.data_ptr(), B, n, x.stride(0),
            GREEDY_DTYPES[x.dtype], S, _build.stream_of(x)))
        return out
    return fn


def one_round(smoke, seed, spans):
    from deepspeed_tpu_torch.ops.sampling_cuda import fused_greedy_rows

    gen = torch.Generator("cuda").manual_seed(seed)
    out = {}
    for B in (1, 8, 64):
        x32 = torch.randn((B, V), generator=gen, device="cuda")
        x32[:, [V // 3, V - 1]] = 40.0          # a tie in every row
        for dtype, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
            b_ms, b_by = smoke.bound(B * V * x.element_size() + B * 4, B * V,
                                     smoke.F32_FLOPS_PER_S)
            case = _timed(smoke, fused_greedy_rows, x)
            dev = case.get("device_ms_per_call")
            share = b_ms / dev if dev else None
            case.update(bound_ms=b_ms, bound_by=b_by)
            if share is not None and share > 1.0:
                case["above_bound"] = share
            else:
                case["bound_share"] = share
            cold = smoke.cold_inputs(x)
            case["argmax_device_ms"] = smoke.device_ms(
                lambda: torch.argmax(cold(), dim=-1), iters=50)
            case["argmax_l2_device_ms"] = smoke.device_ms(
                lambda: torch.argmax(x, dim=-1), iters=50)
            for s in spans:
                fn = _spans_fn(s)
                case[f"spans={s}"] = (_timed(smoke, fn, x) if fn else
                                      {"not_supported": "no span count"})
            out[f"B{B} {dtype}"] = case
        del x32, x
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--root", default=HERE,
                    help="checkout whose deepspeed_tpu_torch is timed")
    ap.add_argument("--spans", default="",
                    help="comma-separated spans a row to time, e.g. 1,8,16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_greedy_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = _smoke()
    from deepspeed_tpu_torch.ops import _build

    _build.lib()
    spans = [int(s) for s in args.spans.split(",") if s]
    card = smoke.card()
    for r in range(args.rounds):
        print(json.dumps({"round": r, "card": card, "root": root,
                          "kernels": {"greedy_argmax": one_round(
                              smoke, r, spans)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
