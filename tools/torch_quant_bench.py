#!/usr/bin/env python3
"""Times the PyTorch port's group-quantize kernel B9 and the int8-resident
K/V writes on one CUDA GPU, at the shapes of phase 12 of ``chip_smoke.py``,
once per round.

    python3 tools/torch_quant_bench.py [--rounds 1] [--root CHECKOUT]

- the stacked w1 leaf of Llama-3-8B, ``[32, 4096, 14336]`` bf16 as 14.68 M
  groups of 128: ``quantize_rows`` on the device clock (mean of 10 calls)
  and with events, beside its bytes bound; codes and scales of the first
  4 M groups against the plain version;
- a decode step's K/V rows, ``[8, 8, 128]`` bf16 as 64 groups: the device
  median of 100 calls;
- one layer's int8-resident K/V write at a decode step (``[8, 8, 128]``)
  and at a C = 256 chunk (``[8, 256, 8, 128]``), through the package's
  ``write_token_pages_quant`` / ``write_chunk_pages_quant`` into pages of
  16 of 8 rows of 128-slot tables: device time per call summed over every
  kernel it launches, the kernels per call, and events around the call.

The package comes from ``--root`` (default: the checkout this script sits
in), so two checkouts compare in one call by running this script on each
in turns; timers, bounds and inputs are this checkout's ``chip_smoke``.
Prints one JSON line per round with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's ``chip_smoke`` (its timers, bounds and inputs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_round(smoke, seed):
    from deepspeed_tpu_torch.inference import kernels as pk
    from deepspeed_tpu_torch.ops.quant_cuda import (quantize_rows,
                                                    quantize_rows_reference)

    gen = torch.Generator("cuda").manual_seed(seed)
    out = {}
    w1 = torch.empty((32, 4096, 14336), dtype=torch.bfloat16, device="cuda")
    for layer in w1:
        layer.normal_(generator=gen)
    rows = w1.view(-1, 128)
    G, n = rows.shape[0], w1.numel()
    q, sc = quantize_rows(rows)
    rq, rs = quantize_rows_reference(rows[:1 << 22])
    equal = bool(torch.equal(q[:1 << 22], rq) and torch.equal(sc[:1 << 22],
                                                              rs))
    del q, sc, rq, rs
    dev = smoke.device_ms(lambda: quantize_rows(rows), iters=10)
    ms = smoke.time_ms(lambda: quantize_rows(rows), iters=10)
    b_ms, b_by = smoke.bound(n * 3 + G * 4, 5 * n, smoke.F32_FLOPS_PER_S)
    out["w1 leaf"] = {"device_ms": dev, "events_ms": ms, "bound_ms": b_ms,
                      "bound_by": b_by, "bound_share": b_ms / dev if dev
                      else None, "bit_equal_first_4M_groups": equal}
    del w1, rows
    torch.cuda.empty_cache()

    kv = torch.randn((64, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    med = smoke.device_median_ms(lambda: quantize_rows(kv), iters=100)
    kb = smoke.bound(64 * 128 * 3 + 64 * 4, 5 * 64 * 128,
                     smoke.F32_FLOPS_PER_S)
    out["K/V rows [64, 128]"] = {"device_median_ms": med,
                                 "bound_ms": kb[0], "bound_by": kb[1]}

    for case, rows_, starts in (("decode", 1, [0, 128, 255, 400, 1024, 1500,
                                               2000, 2047]),
                                ("chunk", 256, [0, 128, 256, 300, 512, 600,
                                                1000, 1792])):
        planes, new, table, st = smoke.kv_write_inputs(gen, rows_, starts)
        if case == "decode":
            fn = lambda: pk.write_token_pages_quant(  # noqa: E731
                *planes, new[0][:, 0], new[1][:, 0], table, st, 16)
        else:
            fn = lambda: pk.write_chunk_pages_quant(  # noqa: E731
                *planes, *new, table, st, 16)
        dev, kernels = smoke.device_ms(fn, iters=50, kernels=True)
        ms = smoke.time_ms(fn, iters=50)
        stored = smoke.kv_write_rows(rows_, starts) * 8 * 2
        wb = smoke.bound(stored * (128 * 2 + 128 + 4), 5 * stored * 128,
                         smoke.F32_FLOPS_PER_S)
        out[f"K/V write {case}"] = {
            "device_ms_per_call": dev, "kernels_per_call": kernels,
            "events_ms": ms, "bound_ms": wb[0], "bound_by": wb[1]}
        del planes, new, table, st
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--root", default=HERE,
                    help="checkout whose deepspeed_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_quant_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = _smoke()
    from deepspeed_tpu_torch.ops import _build

    _build.lib()
    card = smoke.card()
    for r in range(args.rounds):
        print(json.dumps({"round": r, "card": card, "root": root,
                          "kernels": one_round(smoke, r)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
