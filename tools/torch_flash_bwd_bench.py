#!/usr/bin/env python3
"""Times the PyTorch port's flash attention backward (B2 dQ, B3 dK/dV) on
one CUDA GPU: phase 6 of ``chip_smoke.py`` (``phase_backward``), run
``--rounds`` times.

    python3 tools/torch_flash_bwd_bench.py [--rounds 2] [--seeds 0]

Each round holds B2's delta (the O.dO reduction it forms) to the plain
``flash_delta`` and both kernels' gradients to their plain version, and
times the two kernels, SDPA's backward and the plain backward at the
training shape (Llama-3-8B heads, bf16, T = 2047 causal and with 3 packed
segments), on the device clock and with events, with the smoke's bounds.  ``--seeds N`` then holds them to the plain version on N
more random inputs of each shape under the smoke's metric and gate
(``FLASH_BWD_REL_TOL``), untimed, and counts the inputs over it.  The
kernels come from the checkout this script sits in, so two checkouts
compare by running each one's copy in turns.  Prints one JSON line per
round, and one for the seeds, with the card's name and power limit; exits
1 when any input read over the gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seeds", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bwd_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = chip_smoke.card()
    gen = torch.Generator("cuda").manual_seed(0)
    failed = False
    for r in range(args.rounds):
        try:
            rows = chip_smoke.phase_backward(gen)
        except SystemExit as e:     # over the smoke's gate: report, go on
            failed = True
            rows = {"failed": str(e)}
        print(json.dumps({"round": r, "card": card, "root": ROOT, **rows}),
              flush=True)
    if args.seeds:
        sweep = seed_sweep(chip_smoke, args.seeds)
        failed = failed or sweep["over_gate"] > 0
        print(json.dumps({"card": card, "root": ROOT, **sweep}), flush=True)
    return int(failed)


def seed_sweep(chip_smoke, n):
    """B2 and B3 against their plain version on n random inputs of each
    training shape: the largest relative error of each gradient per input,
    and how many inputs read over the smoke's gate."""
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_bwd,
                                                        flash_bwd_reference,
                                                        flash_fwd)

    B, T, H, KV, D = 1, 2047, 32, 8, 128
    errs = []
    for seed in range(n):
        gen = torch.Generator("cuda").manual_seed(100 + seed)
        q, do = (torch.randn((B, T, H, D), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        for nseg in (0, 3):
            seg = chip_smoke._segments(T, nseg)[0] if nseg else None
            o, lse = flash_fwd(q, k, v, seg=seg)
            got = flash_bwd(q, k, v, o, lse, do, seg)
            want = flash_bwd_reference(q, k, v, o, lse, do, seg)
            errs.append({"seed": 100 + seed, "segments": nseg, **{
                name: chip_smoke._rel(g, w)
                for name, g, w in zip(("dq", "dk", "dv"), got, want)}})
    tol = chip_smoke.FLASH_BWD_REL_TOL
    return {"inputs": len(errs), "gate": tol,
            "over_gate": sum(max(e[g] for g in ("dq", "dk", "dv")) > tol
                             for e in errs),
            "worst": {g: max(e[g] for e in errs) for g in ("dq", "dk", "dv")},
            "per_input": errs}


if __name__ == "__main__":
    sys.exit(main())
