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
(``FLASH_BWD_REL_TOL``), untimed, and counts the inputs over it.  Beside
the gate it measures what the elements over it are: for each such dq / dk /
dv element, whether the kernel's bf16 value (and the plain version's) is one
of the two bf16 neighbours of an f64 oracle, the backward's formulas
evaluated in f64 on the same bf16 q, k, v, o, dO and f32 lse (for dq also
with dS rounded to bf16 before dS.K, as the reference and the kernel round
it: the "spec" oracle).  A neighbour is a faithful rounding of the exact
value; an element that is not one is a kernel fault.  A round that reads
over the gate is measured the same way on its own inputs.  The
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
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the gate, its f64 oracle, phase 6)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seeds", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bwd_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    card = chip_smoke.card()
    gen = torch.Generator("cuda").manual_seed(0)
    failed = False
    for r in range(args.rounds):
        drawn = gen.get_state()
        try:
            rows = chip_smoke.phase_backward(gen)
        except SystemExit as e:     # over the smoke's gate: report, go on
            failed = True
            # the round's own inputs again, its elements over the gate
            # against the f64 oracle
            again = torch.Generator("cuda")
            again.set_state(drawn)
            q, k, v, do = round_inputs(again)
            errs = [check_input(chip_smoke, q, k, v, do, nseg)
                    for nseg in (0, 3)]
            rows = {"failed": str(e), "per_input": errs,
                    **summarize(errs, chip_smoke.FLASH_BWD_REL_TOL)}
        print(json.dumps({"round": r, "card": card, "root": ROOT, **rows}),
              flush=True)
    if args.seeds:
        sweep = seed_sweep(chip_smoke, args.seeds)
        failed = failed or sweep["over_gate"] > 0
        print(json.dumps({"card": card, "root": ROOT, **sweep}), flush=True)
    return int(failed)


def over_gate_check(got, want, oracles, tol):
    """The elements of ``got`` over the gate (|got - want| > tol *
    max|want|): their count, and how many of them the kernel (``got``) and
    the plain version (``want``) hold at a bf16 neighbour of each oracle."""
    over = (got.float() - want.float()).abs() > tol * want.float().abs().max()
    out = {"over_gate": int(over.sum())}
    if out["over_gate"]:
        for name, exact in oracles.items():
            x = exact[over]
            out["kernel_neighbour_" + name] = int(
                chip_smoke.bf16_neighbour(got[over], x).sum())
            out["plain_neighbour_" + name] = int(
                chip_smoke.bf16_neighbour(want[over], x).sum())
    return out


SHAPE = dict(B=1, T=2047, H=32, KV=8, D=128)


def round_inputs(gen):
    """q, k, v, dO of the training shape, drawn from ``gen`` in the order
    ``chip_smoke.phase_backward`` draws them."""
    B, T, H, KV, D = (SHAPE[n] for n in ("B", "T", "H", "KV", "D"))
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    return q, k, v, do


def check_input(chip_smoke, q, k, v, do, nseg):
    """B2 + B3 against their plain version on one input: each gradient's
    relative error and, where one reads over the gate, its elements over it
    against the f64 oracle (``over_gate_check``)."""
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_bwd,
                                                        flash_bwd_reference,
                                                        flash_fwd)

    tol = chip_smoke.FLASH_BWD_REL_TOL
    seg = chip_smoke._segments(SHAPE["T"], nseg)[0] if nseg else None
    o, lse = flash_fwd(q, k, v, seg=seg)
    got = flash_bwd(q, k, v, o, lse, do, seg)
    want = flash_bwd_reference(q, k, v, o, lse, do, seg)
    e = {"segments": nseg, **{name: chip_smoke._rel(g, w) for name, g, w in
                              zip(("dq", "dk", "dv"), got, want)}}
    if max(e[g] for g in ("dq", "dk", "dv")) > tol:
        dq, dq_spec, dk, dv = chip_smoke.flash_bwd_f64_oracle(
            q, k, v, o, lse, do, seg)
        e["elements"] = {
            "dq": over_gate_check(got[0], want[0], {
                "exact": dq, "spec": dq_spec}, tol),
            "dk": over_gate_check(got[1], want[1], {"exact": dk}, tol),
            "dv": over_gate_check(got[2], want[2], {"exact": dv}, tol)}
    return e


def summarize(errs, tol):
    """Inputs over the gate, their elements' counts summed, and whether
    every element over it is at a bf16 neighbour of its exact oracle (dq:
    of the exact or of the spec oracle)."""
    over = [e["elements"] for e in errs if "elements" in e]
    total = {}
    for el in over:
        for g, counts in el.items():
            for key, val in counts.items():
                total[f"{g}_{key}"] = total.get(f"{g}_{key}", 0) + val
    faithful = all(
        c.get("kernel_neighbour_exact", 0) == c["over_gate"]
        or c.get("kernel_neighbour_spec", 0) == c["over_gate"]
        for el in over for c in el.values())
    return {"inputs": len(errs), "gate": tol, "over_gate": len(over),
            "over_gate_elements": total,
            "over_gate_all_neighbours": faithful,
            "worst": {g: max(e[g] for e in errs) for g in ("dq", "dk", "dv")}}


def seed_sweep(chip_smoke, n):
    """B2 and B3 against their plain version on n random inputs of each
    training shape (``check_input``), summarized."""
    B, T, H, KV, D = (SHAPE[n] for n in ("B", "T", "H", "KV", "D"))
    errs = []
    for seed in range(n):
        gen = torch.Generator("cuda").manual_seed(100 + seed)
        q, do = (torch.randn((B, T, H, D), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        for nseg in (0, 3):
            errs.append({"seed": 100 + seed,
                         **check_input(chip_smoke, q, k, v, do, nseg)})
    return dict(summarize(errs, chip_smoke.FLASH_BWD_REL_TOL),
                per_input=errs)


if __name__ == "__main__":
    sys.exit(main())
