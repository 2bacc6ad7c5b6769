#!/usr/bin/env python3
"""Times the PyTorch port's flash attention forward (B1) on one CUDA GPU:
phase 3 of ``chip_smoke.py`` (``phase_flash``), run ``--rounds`` times.

    python3 tools/torch_flash_fwd_bench.py [--rounds 2]

Each round holds the kernel to its plain version and times it, SDPA and the
plain version at the main paths' shapes (Llama-3-8B heads, bf16: T = 1024
causal, T = 2047 causal and with 3 packed segments), with the smoke's
timers and bounds.  The kernel comes from the checkout this script sits
in, so two checkouts compare by running each one's copy in turns.  Prints
one JSON line per round with the card's name and power limit.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_fwd_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = chip_smoke.card()
    gen = torch.Generator("cuda").manual_seed(0)
    for r in range(args.rounds):
        row = chip_smoke.phase_flash(gen)
        row.pop("fn")
        print(json.dumps({"round": r, "card": card, "root": ROOT, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
