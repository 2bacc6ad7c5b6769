#!/usr/bin/env python3
"""Times the PyTorch port's paged attention kernels B5 (bf16 pages), B7
(int8 codes with f32 row scales) and B8 (the ``pallas_v1`` arm, bf16 pages)
on one CUDA GPU, at the shapes of phases 3 and 9 of ``chip_smoke.py``, once
per seed.

    python3 tools/torch_paged_bench.py [--seeds 3] [--root CHECKOUT]

The shapes are the Llama-3-8B paths' (bf16 q, 32 / 8 heads, head_dim 128,
pages of 16): decode over 8 rows of 0..1024 keys, and a C = 256 chunk at
starts 0..768.  For each seed, shape and kernel it prints the largest
|error| against the plain version, the kernel's time on the device clock
(every kernel of one call, summed: B8 launched two before it took B5's
body) and with events around the wrapper, and its bound (the
smoke's bounds and timers).  The kernels come from the package of
``--root`` (default: the checkout this script sits in), so two checkouts
compare in one call by running this script on each in turns.  Prints one
JSON line per seed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, KV, D, PS, C_CHUNK = 32, 8, 128, 16, 256
SHAPES = (("decode", 1, [0, 128, 256, 400, 512, 700, 900, 1024]),
          ("chunk", C_CHUNK, [0, 128, 256, 300, 512, 600, 700, 768]))


def _smoke():
    """This checkout's ``chip_smoke`` (its timers, bounds and inputs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_seed(smoke, seed):
    from deepspeed_tpu_torch.inference.kernels import quantize_kv_rows
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_chunk_attention, paged_chunk_attention_quant,
        paged_chunk_attention_quant_reference,
        paged_chunk_attention_reference, paged_chunk_attention_v1)

    gen = torch.Generator("cuda").manual_seed(seed)
    rows = {}
    for shape, C, lens in SHAPES:
        kp, vp, table = smoke._paged_inputs(gen, lens, C)
        kq, ks = quantize_kv_rows(kp)
        vq, vs = quantize_kv_rows(vp)
        q = torch.randn((8, C, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        # decode is the C = 1 case at start = length - 1 (-1: an empty row)
        st = torch.tensor([n - 1 for n in lens] if C == 1 else lens,
                          dtype=torch.int32, device="cuda")
        live = sum(lens) if C == 1 else sum(s + C for s in lens)
        pairs = live if C == 1 else sum(s * C + C * (C + 1) // 2
                                        for s in lens)
        io = 2 * 2 * 8 * C * H * D
        for name, fn, ref, nbytes in (
                ("B5", lambda: paged_chunk_attention(q, kp, vp, table, st),
                 lambda: paged_chunk_attention_reference(q, kp, vp, table,
                                                         st),
                 2 * live * KV * D * 2 + io),
                ("B7", lambda: paged_chunk_attention_quant(
                    q, kq, ks, vq, vs, table, st),
                 lambda: paged_chunk_attention_quant_reference(
                    q, kq, ks, vq, vs, table, st),
                 2 * live * KV * (D + 4) + io),
                ("B8", lambda: paged_chunk_attention_v1(q, kp, vp, table, st),
                 lambda: paged_chunk_attention_reference(q, kp, vp, table,
                                                         st),
                 2 * live * KV * D * 2 + io)):
            got, want = fn(), ref()
            torch.cuda.synchronize()
            if C == 1:      # the plain chunk version does not zero row 0
                ok_empty = not got[0].any().item()
                got, want = got[1:], want[1:]
            else:
                ok_empty = True
            err = (got.float() - want.float()).abs().max().item()
            iters = 20 if C == 1 else 10
            dev = smoke.device_ms(fn, iters=iters)
            ms = smoke.time_ms(fn, iters=iters)
            b_ms, b_by = smoke.bound(nbytes, 4 * pairs * H * D,
                                     smoke.BF16_FLOPS_PER_S)
            rows[f"{name} {shape}"] = {
                "max_abs_err": err, "empty_row_zero": ok_empty,
                "device_ms": dev, "events_ms": ms, "bound_ms": b_ms,
                "bound_by": b_by,
                "bound_share": b_ms / dev if dev else None}
        del kp, vp, kq, ks, vq, vs, q
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--root", default=HERE,
                    help="checkout whose deepspeed_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = _smoke()
    from deepspeed_tpu_torch.ops import _build

    _build.lib()
    card = smoke.card()
    for seed in range(args.seeds):
        rows = one_seed(smoke, seed)
        print(json.dumps({"seed": seed, "card": card, "root": root,
                          "kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
