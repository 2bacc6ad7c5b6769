#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's Llama-3-8B server spends its
time, on one CUDA GPU.

    python3 tools/torch_decode_profile.py [--steps 5] [--layers 32]
        [--weight-dtype bfloat16|int8] [--kv-cache bfloat16|int8]
        [--paged-kernel auto|pallas_v1] [--root CHECKOUT]

Builds the engine at full width (random seeded bf16 weights, quantized to
int8 on the card with ``--weight-dtype int8``; 8 requests
with prompts of 128..1024 tokens, whole-prompt prefill), lets every prompt
prefill, then times ``--steps`` decode steps on the host clock (each ends
in the host's token fetch) and traces the same number under
``torch.profiler``: device time per step by kernel, kernel launches per
step, and the device's idle share of the traced window.  ``--kv-cache
int8`` serves from the int8-resident pool of ``chip_smoke.py``'s phase 11
(``prefix_cache`` and ``kv_tier`` with ``quantized_resident``: B7 reads the
pages, and each layer's K/V write quantises), ``--paged-kernel pallas_v1``
through the v1 arm (B8).  The package comes from ``--root`` (default: the
checkout this script sits in), so two checkouts compare in one call by
running this script on each in turns.  Prints a summary and one JSON line,
also written as ``torch_decode_profile_<weight dtype>_<kv cache>_<paged
kernel>.json`` into the repo's gitignored output directory when it exists.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--weight-dtype", default="bfloat16",
                    choices=("bfloat16", "int8"))
    ap.add_argument("--kv-cache", default="bfloat16",
                    choices=("bfloat16", "int8"))
    ap.add_argument("--paged-kernel", default="auto",
                    choices=("auto", "pallas_v1"))
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose deepspeed_tpu_torch is profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.lib()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=args.layers)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    extra = {}
    if args.kv_cache == "int8":
        extra = {"prefix_cache": {}, "kv_tier": {
            "quantize_cold": True, "quantized_resident": True,
            "demote_watermark": 0.0}}
    eng = llama_serving_engine(params, cfg, max_batch=8, page_size=16,
                               max_seq=2048, num_pages=1025,
                               cache_dtype=torch.bfloat16,
                               weight_dtype=args.weight_dtype,
                               kernels={"paged_attention": args.paged_kernel},
                               **extra)
    if (eng.cache.k.dtype == torch.int8) != (args.kv_cache == "int8"):
        print(f"the pool holds {eng.cache.k.dtype}, not {args.kv_cache}",
              file=sys.stderr)
        return 1
    del params
    for i, n in enumerate(np.linspace(128, 1024, 8).astype(int)):
        eng.submit(i, rng.integers(1, cfg.vocab_size, n).tolist(),
                   max_new_tokens=4 + 2 * args.steps + 4)
    for _ in range(3):             # admission + prefill, then warm decode
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                      "cuLaunchKernelEx"):
            launches += ev.count
        if dev_us > 0 and not ev.key.startswith("aten::"):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    out = {
        "card": card, "root": root, "layers": cfg.n_layers,
        "steps": args.steps, "weight_dtype": args.weight_dtype,
        "kv_cache": args.kv_cache, "paged_kernel": args.paged_kernel,
        "active_rows": 8,
        "ms_per_decode_step_host": step_ms,
        "ms_per_decode_step_traced": traced_ms / args.steps,
        "device_ms_per_step": device_ms / args.steps,
        "device_idle_share": 1.0 - device_ms / traced_ms,
        "kernel_launches_per_step": launches / args.steps,
        "top_kernels_ms_per_step": {k[:90]: v / args.steps for k, v in top},
    }
    print(f"{card}: {args.weight_dtype} weights, {args.kv_cache} KV, "
          f"{args.paged_kernel} paged kernel: decode step {step_ms:.2f} ms "
          f"(host clock), device "
          f"{out['device_ms_per_step']:.2f} ms/step, idle share "
          f"{out['device_idle_share']:.3f}, "
          f"{out['kernel_launches_per_step']:.0f} launches/step")
    for name, ms in out["top_kernels_ms_per_step"].items():
        print(f"  {ms:9.4f} ms/step  {name}")
    line = json.dumps(out)
    print(line)
    dest = os.path.join(ROOT, "chiprun_out")
    if os.path.isdir(dest):
        name = (f"torch_decode_profile_{args.weight_dtype}_{args.kv_cache}_"
                f"{args.paged_kernel}.json")
        with open(os.path.join(dest, name), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
