#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``deepspeed_tpu_torch/csrc`` (into ``build/``)
and runs, in order:

3. the serving kernels (flash forward, paged attention, greedy argmax)
   against their plain PyTorch versions on the card at the serving shapes,
   and the flash forward at the training shape too (T = 2047, causal and
   with 3 packed segments), each timed beside SDPA; paged attention (B5)
   at decode and C = 256 on its Hopper body, and greedy argmax (B6, each
   row split over a cluster of blocks) beside ``torch.argmax`` at B = 8
   f32 (planted ties, NaN rows), B = 1 f32 and B = 8 bf16, on the device
   clock too, reading from HBM (copies in turn) and from L2;
9. the int8-resident paged kernel (B7) and the v1 arm (B8: B5's Hopper
   body for bf16, held to its tiled twin; the split-key pair for f32, held
   to the split plain version) against their plain versions at the same
   shapes, beside B5, on the device clock too;
4. the kernel arms and the plain arms of the serving engine on a tiny f32
   Llama: identical greedy tokens;
10. the same on engines with ``prefix_cache`` and ``kv_tier``
   (int8-resident pages: B7 and B9's fused K/V write against the ``xla``
   arm, whose writes are plain; the ``pallas_v1`` arm: B8), with pages
   demoted and promoted;
5. Llama-3-8B at full width (random seeded weights, bf16) served through
   ``llama_serving_engine`` with whole-prompt and chunked prefill;
11. the prefix-cached, tiered, int8-resident path at the same width: two
   waves of prompts on one shared prefix (the second promotes it from the
   host tier), each layer's K/V written by one launch of B9's fused entry
   (as many as B7's), then the ``pallas_v1`` arm on phase 5's traffic;
12. the group-quantize kernel (B9) against its plain version, bit for bit,
   at the stacked FFN leaf of Llama-3-8B (device clock) and at a decode
   step's K/V rows (device median; also against the host codec), with NaN
   / inf / zero groups, and its fused K/V write of one layer at a decode
   step, a C = 256 chunk and a padded prompt (all four page planes against
   the plain version's, rows past and at capacity among them); the probe
   kernel (B10) through ``env_report.report()``, then timed beside
   ``torch.mul`` with events and on the device clock;
13. the int8 engine built on the card (B9) against one over weights
   quantized on the host by B9's plain version, on a tiny f32 Llama:
   equal codes and scales, identical greedy tokens;
14. Llama-3-8B at full width with int8 weights (``weight_dtype="int8"``,
   built from phase 5's weights, which are then freed), phase 5's traffic,
   then one ``init_inference(dtype="int8")`` forward over the int8 tree;
6. the training kernels (flash backward dQ and dK/dV on their tensor-core
   body, fused Adam) against their plain versions at the training shapes,
   the backward at T = 2047 causal and with 3 packed segments (B2 forms
   the O.dO reduction and is held to its plain version), timed on the
   device clock and with events beside SDPA's backward, and fused Adam at
   the LM head's leaf on the device clock beside ``_fused_adamw_``;
7. five train steps of ``initialize(...).train_batch`` on a tiny f32 Llama
   with the kernel arms against the plain arms: the same losses and params;
8. the training main path at full width: Llama-3-8B widths cut to 4 layers
   (one card's memory), f32 master, bf16 compute, fused Adam, 4 steps; all
   32 + 32 backward launches on the tensor-core body, and a profiled step
   that lists the LM-head products and the flash kernels;
15. resumable packed training at Llama-3-8B widths cut to 2 layers:
   ``PackedDataLoader`` rows of 2048 (+1) tokens holding 2-4 documents
   each, a seqlen curriculum (1024 -> 2048 over 3 steps), ``remat="full"``,
   fused Adam; an uninterrupted run of 4 steps twice (bit-equal: the
   run-to-run reading), a run saved after 2 steps (``async_save``), its
   engine dropped, a new engine loaded and run 2 more steps (bit-equal to
   the uninterrupted run: losses and every state leaf), and the same 4
   steps with ``remat="none"`` (ms/step, peak memory and MFU beside the
   remat run's); every flash launch on the tensor-core body with segment
   ids.
16. the serving and training kernels at GPT-2's shapes: B6 at V = 50257 on
   ``logits[:, -1]`` rows (each off a 16-byte boundary), B5's Hopper body
   at G = 1 (16 heads of 128, 12 of 64) at decode and C = 256, B1 at
   H = KV, T = 1024, both head dims; then the kernel arms against the plain
   arms on a tiny f32 GPT-2: the engine, ``gpt2_generator`` and
   ``gpt2_paged_generator`` (card against CPU), and the engine against the
   paged generator: identical greedy tokens;
17. GPT-2 1.3B at full width (24 layers, 16 heads of 128, V 50257, seeded
   bf16 weights): the tied head's product over ``wte.T`` without a copy;
   the engine with whole-prompt and chunked prefill over 8 prompts of
   64-768 tokens; both generators on 8 prompts of 128; then int8 weights
   (B9 at build) on the engine's traffic and one ``init_inference(dtype=
   "int8")`` forward;
18. GPT-2 small (768 / 12 / 12, head_dim 64) served whole-prompt and
   chunked, so the head_dim-64 Hopper bodies of B1 and B5 carry a main
   path;
19. GPT-2 1.3B trained at all 24 layers (micro 8 x 1024 tokens, fused
   Adam) under ``remat="none"``, ``"save_attn"`` and ``"offload_attn"``:
   ms/step, peak memory, ``ThroughputTimer`` tokens/s and MFU, the idle
   share of a profiled step; the offload run's state equals ``save_attn``'s
   bit for bit, it moves every layer's ``attn_out`` and ``mlp_out`` to
   pinned host memory, and its peak is lower by about those bytes.
20. the kernels at Mixtral-8x7B's new shapes (B6 at V = 32000, B9 on one
   layer's expert stack [8, 4096, 14336], B4 on the 939.5 M-element ``w1``
   leaf of the 2-layer training run, B2/B3 at micro 4 x 1024 with 32 / 8
   heads), then the kernel arms against the plain arms on a tiny f32
   Mixtral: the engine (whole prompt, ``prefill_chunk``, ``decode_chunk``),
   ``mixtral_generator`` and ``mixtral_paged_generator`` (card against
   CPU), the engine against the paged generator, and the capacity-limited
   top-2 gate at the training shape (dispatch equal, combine at 1e-6);
21. Mixtral-8x7B at full width (4096, 32 heads of 128, 8 kv heads, 8
   experts, top-2, V 32000, seeded weights): bf16 at 8 layers (the first
   prefill's logits, kernel arm against plain arm, and the (token, layer)
   routings that differ between them; the engine whole-prompt and chunked
   over 8 prompts of 64-768 tokens; both generators on 8 prompts of 128;
   a decode step's split between dequantization, the MoE FFN and
   attention), then int8 weights at all 32 layers built a layer at a time
   (``weights.init_quantized_params``: 226 B9 launches, the router exact):
   the engine's traffic, a decode step's split, and one
   ``init_inference(dtype="int8")`` forward over ``mixtral.forward_eval``;
22. Mixtral-8x7B widths trained at 2 layers (3.16 B params) through the
   capacity-limited top-2 gate (micro 4 x 1024, C = 1280,
   ``remat="save_attn"``, fused Adam, ``has_aux=True``): the loss falls;
   aux and z losses and expert load per step, ms/step, peak memory,
   tokens/s and MFU over the active top-2 FLOPs, a profiled step's idle
   share and its dispatch / combine and expert products' shares.
23. B1 at BERT-large's serving shapes (lots of 8 rows at T = 32, 64 and
   512, 16 heads of 64 with H = KV, bidirectional, the attention mask as
   segment ids that descend, one filler row all padding) and B2 / B3 at
   its training shape (T = 512), on the tensor-core bodies, against their
   plain versions, timed beside their bounds and SDPA under the pad mask;
24. tiny BERT through ``bert_serving_engine`` on the card, the kernel arm
   against the plain arm (reference attention) for the pooled, MLM and
   hidden heads, in f32 (head_dim 16; also against the CPU engine) and
   bf16 (head_dim 64); the int8 engine built on the card against the CPU's
   build and against the unquantized engine;
25. BERT-large at full width (24 layers, 16 heads of 64, V 30522, seeded
   bf16 weights) served to 64 requests of 8-512 tokens in lots of 8 at the
   default buckets, each head in bf16, then pooled and MLM with int8
   weights built on the card (B9): sequences/s, real tokens/s, per-lot
   host ms, the padding's share, peak memory, int8's resident bytes,
   build seconds and pooled cosine against bf16;
26. BERT-large trained at all 24 layers (MLM at T = 512, micro 8 x
   accumulation 2, padded rows with their attention mask, fused Adam, 5
   steps): ms/step, real tokens/s, MFU, peak, idle share, the loss falling;
27. the CIFAR CNN served (64 images in lots of 8, against the CPU engine)
   and trained (5 steps at batch 128, fused Adam), and
   ``stochastic_round_bf16`` on a card tensor (distributional checks, and
   the CPU's result on the same random bits);
28. the port's host aio pool (``deepspeed_tpu_torch/csrc/host/aio.cpp``,
   built with g++): a round trip on the temp dir's file system (its
   native arm), 10,000 submit / wait cycles of racing small reads bounded
   by a joined worker, 1 GB written and read back (cache-warm), and the
   pinned host -> device rate of one Mixtral-8x7B layer (2.90 GB), the
   link bound of phases 29-31;
29. ZeRO-Inference against resident serving: Llama-3-8B (32 layers) on
   phase 5's queue with every layer streamed from the host tier, bf16 and
   int8 at 16 layers (identical tokens, the first prefill's and first
   decode step's logits bitwise equal), Mixtral-8x7B bf16 at 4 layers the
   same, and the NVMe tier against the host tier at 2 layers (the smoke's
   time);
30. speculative decoding: f32 Llama-3-8B widths at 2 layers, n-gram and
   model drafters against plain greedy (identical tokens); bf16 at 32
   layers (divergences reported); B5 at the verify window C = K+1 (4, 5)
   beside C = 1; ``verify_accept`` card against CPU;
31. the headline: Llama-3-8B all streamed with speculation, and
   Mixtral-8x7B in bf16 at 4 of 32 layers (11.7 GB image; 32 before
   phases 48-52, 16 before 53-59, 8 before 60-61) under an 11 GB device
   budget, speculation off and on: sweeps, streamed bytes per emitted
   token, ms per sweep beside the link bound, the exposed-wait
   share, tokens/s, acceptance, peak memory;
32. phase 11's two waves with speculation on, the host tier against a
   host pool small enough that wave A cascades to NVMe (wave B promotes
   from NVMe): identical tokens, pages per location, admission waits;
33. the port's host natives (``csrc/host/hostruntime.cpp``, ``cpu_adam.cpp``,
   built with g++): the buffer pool and the shuffle service native (the
   shuffle equals its pure-Python mirror at n = 100,000), the fused CPU
   Adam over Llama-3-8B's 525 M-element embedding leaf (seconds, GB/s, a
   16 M-element slice against the plain mirror), the env report's host
   rows;
34. Llama-3-8B's seeded bf16 weights at 4 of 32 layers (the smoke's time;
   all 32 are 32.1 GB) exported with ``save_pretrained`` (f32 safetensors
   under the temp dir) and loaded back with ``from_pretrained``: the tree bit for bit, phase 5's traffic served with
   identical tokens and bitwise first logits, peak host RSS; a tiny
   Mixtral through ``inject`` on the card against the CPU;
35. LoRA of Llama-3-8B at all 32 layers (r 8, wq/wk/wv/wo, frozen bf16 base,
   fused Adam on the adapters, micro 1 x accumulation 2 x 2048): step 1
   equal to the base loss bit for bit, the loss falling, the base
   unchanged, ``merge_lora`` against ``apply_lora``, ms/step, peak, idle;
36. at phase 8's widths (4 layers): the hybrid engine's greedy rollouts
   (paged cache: B1 prefill, B5 decode) before and after a train step,
   each identical to a standalone paged generator over the engine's
   params, and the cast's ms; distillation of
   a 4-layer teacher into a 2-layer student; the HF Trainer bridge from a
   ``save_pretrained`` directory through 2 steps to ``save_model``, read
   back bit for bit;
37. ZeRO offload on tiny bf16 models (4 steps each): the layer-streaming
   ``ParamStreamEngine`` on the card (B1-B3) against the same engine on
   the CPU, and on the card its NVMe tier against its RAM tier and its
   strict against its overlap mode bit for bit (losses and masters), the
   stream against the stage-0 engine, ``InfinityEngine``'s device update
   against its host update, the layered Mixtral against the stage-0
   engine, and the unscheduled ``offload_optimizer: {device: cpu}``
   engine (fused Adam, its state in page-locked host memory) against the
   plain one bit for bit;
38. the headline: Llama-3-8B widths at 2 of 32 layers (1.49 B params,
   ``layered_model_lazy(seed=0)``) trained by ``ParamStreamEngine`` on the
   RAM tier with the host Adam overlapped (micro 1 x accumulation 2 x
   2048 tokens, 3 steps, the third profiled): ms/step, tokens/s, peak
   card memory against stage 0's 82 GB, host RSS, link bytes, the phase
   split, the bound (host Adam at phase 33's rate, link at phase 28's,
   FLOPs) and the idle share; every B1-B3 launch on the tensor-core body;
39. the same widths at 1 layer on the NVMe tier against the RAM tier, bit
   for bit (its checkpoint round trip is a CPU test's);
40. ``InfinityEngine`` on phase 39's 1-layer cut and phase 38's traffic,
   ``update: "device"`` then ``"host"``: step 1 equal to phase 39's RAM
   run's, ms/step, peak, state bytes on the card and over the link;
41. in a rank that the port's launcher starts (``python -m
   deepspeed_tpu_torch.launcher --nproc_per_node 1 chip_smoke.py
   --zero-child ...``, one NCCL group of one rank): ZeRO++'s int8 wire on
   a seeded flat f32 gradient of GPT-2 1.3B's 1,313,626,112 elements:
   ``quantized_reduce_scatter`` (groups of 512), ``quantized_all_gather``
   and ``hierarchical_all_reduce`` on the blockwise codec (what the
   engine's qgZ, qwZ and hpZ run at a world above one), each bit for bit
   the same function over B9's plain version on the card; B9's launches,
   device time, bound and share at this flat shape;
42. in the same rank: GPT-2 1.3B at 2 of 24 layers (phase 19's config under
   ``save_attn``) through ZeRO stages 0, 1, 2 and 3, 3 steps each: losses
   and every master leaf bit for bit equal across stages, ms/step beside
   phase 19's, peak memory, the comms logger's collectives and bytes a
   step against what each stage moves, B1-B4 launches; qwZ at a world of
   one warns and runs the plain path; a stage-3 save loaded into a stage-1
   engine bit for bit;
48. in the same rank: ZeRO-Offload, phase 42's GPT-2 1.3B at stage 2 with
   ``offload_optimizer: cpu`` and at stage 3 with both blocks, 3 steps
   each: losses bit for bit phase 42's, the state this rank's shards in
   page-locked host memory, the comms logger and ``comms_digest`` against
   the stage's expectation, peak memory beside phase 42's, the host bytes
   a step.
43-47, 49-57. in two ranks that the port's launcher starts on the one card
   (``python -m deepspeed_tpu_torch.launcher --local_hosts 2 chip_smoke.py
   --mp-child ...``, one gloo group: NCCL refuses two ranks on one device,
   and gloo stages every collective of a CUDA tensor but all_reduce and
   broadcast through host memory, so collective times are host-staged
   gloo's): 43, tensor-parallel serving over model 2, Llama-3-8B bf16 at
   4 of 32 layers on phase 5's queue, then int8 weights, each against the
   one-rank engine on the same weights (first prefill logits), and a tiny
   f32 Llama's tokens identical; 44, tensor-parallel training at phase 8's
   config against phase 8's losses, with the hybrid engine's rollouts
   before and after its first step; 45, Ulysses (T = 8192) and ring (T = 4096) over
   seq 2 at 2 layers, loss and grads against one rank; 46, pipe 2 with
   n_micro 4 at 4 layers against one rank with 4 accumulation steps; 47,
   Mixtral-8x7B widths over expert 2, trained at 1 layer and served at 8
   against one rank, and a tiny f32 Mixtral's tokens identical; 49,
   ZeRO-Offload over data 2 (phase 48's stage-2 config) against phase
   48's one-rank run; 50, ``ParamStreamEngine`` over data 2 at phase
   38's depth against phase 38's losses; 51, ``InfinityEngine`` over data
   2 at phase 40's depth against its step 1; 52, ZeRO-Inference over
   model 2, Llama-3-8B bf16 at 32 layers streamed from each rank's host
   tier, against phase 29's first prefill logits, and a tiny f32 Llama's
   tokens identical; 53, GPT-2 1.3B served over model 2 at 6 of 24 layers (each
   rank its heads of the fused QKV), bf16 and int8, against the one-rank
   engine; 54, GPT-2 1.3B at 4 layers trained over model 2 against phase
   42's losses, its stage-0 checkpoint read into one rank bit for bit; 55,
   BERT-large over model 2, the pooled and MLM heads bf16 and int8 at 6
   of 24 layers against one rank, two training steps at 24 against phase
   26's losses; 56, phase 43's
   Llama-3-8B with int8-resident pages over model 2, each rank's pages
   against the one-rank cache's head slice; 57, an injected tiny Llama
   and Mixtral over model 2 (and expert 2), the hybrid engine's first
   rollout of phase 44 against one rank's, an elastic batch at world 2.
   Each phase holds its kernels (B1-B7, B9) at a rank's shapes against
   their plain versions;
58. block-sparse attention at phase 8's config ("fixed" and "bigbird",
   blocks of 64): every layer's output against dense f32 attention under
   the layout's token mask, the "dense" layout's loss against phase 8's,
   two falling steps each, ms and peak memory beside phase 8's;
59. ``autotune_config`` over GPT-2 1.3B at 4 layers: micro 1 / 2 x remat
   none / full and an unknown policy, the fastest measured candidate
   wins, the failed ones are listed, a second call reads the cache;
60. the serving control plane on phase 5's Llama-3-8B weights cut to 8
   layers (after phase 11): every block of the slice on (telemetry,
   tracing, two SLO tiers with deadline shedding, queue-depth shedding,
   history, incidents, devprof on CUDA events, a seeded fault plan
   failing three named slots and corrupting every demote), two waves of
   16 prompts through the prefix cache and the host tier, against the
   engine with them off:
   survivors' tokens identical, the corrupted spans caught by the crc and
   re-prefilled to the same tokens, counts reconciled, no leak; then
   whole-prompt prefill (B1) on vs off, and an int8-resident pair (B9, B7)
   under the same corruption;
61. the training control plane at phase 8's widths cut to 2 layers (after
   phase 8): telemetry, the csv monitor, a Watchdog and one
   ``FlopsProfiler`` forward against the engine without them, losses and
   state bit for bit;
62. the in-process serving fleet on phase 5's Llama-3-8B weights cut to 8
   layers (after phase 60), one weight tree for three replicas: affinity
   waves, a
   seeded kill of one replica mid-traffic (typed partition), drain and
   rejoin, a migration through the KV fabric and a corrupted one that
   re-prefills; the same traffic through ``fleet.roles`` (prefill ->
   decode handoff); an int8-resident chain migrated (B7, B9); tokens
   against one engine's, near-ties held and counted;
63. the out-of-process fleet: two ``python -m
   deepspeed_tpu_torch.replica_child`` children on the card (shm and TCP)
   serving Llama-3-8B at 8 layers from ``(config, seed)``, a migration
   child -> router fabric -> child, a SIGKILL mid-traffic and the
   failover's seconds, the scrape plane and a merged trace; tokens
   against an in-process engine, no child left running;
64. the elastic fleet: GPT-2 1.3B at 24 layers scaled 1 -> 3 -> 1 on a
   burst and rolled out to a second weight version through
   ``swap_params`` (each request on one version, its tokens a fresh
   engine's of that version), and a streamed ZeRO-Inference cold start of
   Llama-3-8B at 8 layers that flips to resident, its tokens the resident
   engine's;
65. (after phase 23) DeepSpeed's fp16 mode on the kernels: B1, B2 and B3
   in float16 on their tensor-core bodies at Llama's training shape (T =
   2047, causal and with 3 packed segments), GPT-2 1.3B's and BERT-large's
   (pad ids), and B5 with an fp16 q over bf16 pages at decode and C = 256,
   each against its plain version beside its bound and SDPA's fp16 call;
   B3's fp16 dK and dV (P and dS rounded once) against the f64 oracle,
   beside that rounding in f64 sums and the outputs' own;
66. (after phase 26) phase 8's run under DeepSpeed's fp16 defaults
   (dynamic loss scaling from 2^16): losses beside phase 8's bf16 ones,
   overflow flags and scales step by step equal to the same run on
   ``attn_impl="reference"``; then from 2^32, the first steps overflowing
   on the kernels and the scaler backing off, against its twin too;
67. (a, b) GPT-2 1.3B and BERT-large at 4 layers, full widths, under the
   fp16 defaults against their plain-attention twins (flags, scales,
   losses), the loss falling; (c, on phase 66's first engine) the fp16
   hybrid's greedy rollouts over the paged cache (B1 prefill, B5 decode
   with an fp16 q over the bf16 cache), a train step, and rollouts again,
   against the dense generator's plain attention over the same params:
   near-ties held and counted.

Each main path (the env report of phase 12, the two serving runs of phase
5, the two waves and the v1 run of phase 11, the int8 build, the two
int8 serving runs and the ``init_inference`` forward of phase 14, the
training run of phase 8, the four runs of phase 15, the GPT-2 paths of
phases 17-19, the Mixtral paths of phases 21-22, the BERT-large paths of
phases 25-26, the CNN's of phase 27, the streamed, speculative and
KV-NVMe paths of phases 29-32, the env report of phase 33, the HF-loaded
serving run and the injected Mixtral of phase 34, the LoRA run of phase
35, the hybrid rollouts and step, distillation and Trainer runs of
phase 36, the offload engines' runs of phases 37-40, the wire of phase
41, each ZeRO stage's run of phase 42, the offload runs of phase 48, the
two-rank runs of phases 43-47 and 49-57, both ranks' counts summed, the
sparse and autotune runs of phases 58-59, the control-plane runs of
phases 60-61, the fleets of phase 62, the children of phase 63 (each
child's counts, read through its ``launches`` verb) and the elastic
fleets of phase 64, the fp16 runs of phases 66-67 and the fp16 hybrid's
rollouts and step) counts the launches of every kernel on its own
(counters set to 0 just before it and read just after), and the launches
per body of the flash kernels, B5, B7, B8, B9 and B6: every Llama-3-8B
path must run only their Hopper bodies (flash "wgmma", B5 / B7 / B8
"sm90"), B9's vector body and B6's cluster body, the f32 runs only the
scalar attention bodies; the fp16 paths launch B1, B2, B3 and B5 only
with an fp16 q.
Prints a ``{"kernels": [...]}`` line (the fp16 bodies of B1, B2, B3 and
B5 as rows of their own, ``*_fp16``) and ends with
``{"ok": true, "device": {...}}``; any failure exits non-zero.  Exits
non-zero without printing a result when CUDA is not available.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20            # H100 SXM L2
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12            # f32 outside the tensor cores
# bf16 attention tolerances, each set from the error the card read at these
# shapes (flash 3.9e-3, T=300 3.9e-3, paged decode 4.9e-4, C=256 3.9e-3:
# one bf16 ulp of the largest |o|) with room of 2.5x to 8x, and each below
# the ~1e-2 shift that dropping one key of a long row makes
FLASH_TOL = 1e-2
PAGED_DECODE_TOL = 4e-3
PAGED_CHUNK_TOL = 1e-2
# flash backward, bf16 at T=2047: the largest |error| over the largest
# |plain value| of dq, dk and dv.  The card read dq 0, dk 1.40e-3, dv
# 1.38e-3 (a bf16 ulp of the largest value is 2^-8 = 3.9e-3 of it): about
# 3x room
FLASH_BWD_REL_TOL = 4e-3
# B2's delta against the plain O.dO reduction: the same f32 products summed
# in another order, a few f32 ulps of each row's sum of |O * dO|; held to
# 1e-5 of the largest |delta|
FLASH_DELTA_REL_TOL = 1e-5
# fused Adam in f32: both sides round every operation once, in one order;
# the card read 0 at 2.1 M and 525 M elements, bf16 and f32 grads
ADAM_TOL = 1e-6
# phase 7, f32 llama-tiny, 5 steps: kernel vs plain attention sum in another
# order; the card read 7.8e-8 relative on the losses and 2.0e-6 on the
# params: about 10x room
TRAIN_LOSS_RTOL = 1e-6
TRAIN_PARAM_ATOL = 2e-5

# B7 (int8 pages) and B8's split-key pair against their plain versions at
# the serving shapes, set from the card's first reading as for B5: B7 read
# 9.8e-4 at decode and 3.9e-3 at C=256 (bf16), the pair 3.1e-5 and 3.9e-3
# in bf16 (the smoke holds it in f32, its only dtype on the paths); room of
# 2.5x to 30x, each bound below the ~1e-2 shift that dropping one key of a
# long row makes.  B8's launches on B5's Hopper body are held to B5's gates
# against the body's tiled twin
PAGED_QUANT_DECODE_TOL = 4e-3
PAGED_QUANT_CHUNK_TOL = 1e-2
PAGED_V1_DECODE_TOL = 1e-3
PAGED_V1_CHUNK_TOL = 1e-2

SERVING_KERNELS = ("flash_fwd", "paged_attention", "greedy_argmax")
# phase 11: Llama-3-8B, a 1024-token shared prefix, 128-token suffixes
TIER_PREFIX, TIER_SUFFIX, TIER_NEW = 1024, 128, 32
TIER_KV = {"quantize_cold": True, "quantized_resident": True,
           "demote_watermark": 0.0}

ROOT = os.path.dirname(os.path.abspath(__file__))
# kernel with two bodies -> main path -> its launches per body (the flash
# kernels' tensor-core "wgmma", B5's, B7's and B8's Hopper "sm90",
# "scalar"; B9's "vec" and "scalar"; B6's "cluster" and "row"), read just
# after the path as its other counts are
BODIES = {}
# B1, B2, B3 and B5 -> main path -> their launches per dtype of q (the
# kernels line's fp16 rows read the float16 ones)
DTYPES = {}
# rates this run measured that later phases' bounds read: phase 28's
# pinned host -> device GB/s of one 2.9 GB copy, phase 33's host Adam GB/s
RATES = {}


def log(*a):
    print(*a, flush=True)


_LAP = [time.perf_counter()]


def _lap(what: str) -> None:
    """Log the seconds since the previous lap (the smoke's time by
    phase)."""
    now = time.perf_counter()
    log(f"[smoke] {what}: {now - _LAP[0]:.1f} s")
    _LAP[0] = now


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, kernels: bool = False):
    """Device time per call of ``fn`` under ``torch.profiler``, without the
    host's launch cost that back-to-back event timing includes when the host
    is the slower side: each kernel's mean time per recorded launch, times
    its launches per call (its records over ``iters``, rounded up).  The
    profiler can drop some of a window's records, and a plain sum over them
    reads low (it read 0 once); a trace that holds none is taken again, up
    to three times; None if none held any.  With ``kernels``, returns that
    time and the kernels launched per call (0 with None)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in _device_events(prof) if e.count]
        total = sum(e.self_device_time_total / e.count * -(-e.count // iters)
                    for e in evs)
        if total > 0:
            n = sum(-(-e.count // iters) for e in evs)
            return (total / 1e3, n) if kernels else total / 1e3
    return (None, 0) if kernels else None


def device_median_ms(fn, iters: int = 100) -> Optional[float]:
    """Median device time of one launch of the single kernel ``fn``
    launches, over ``iters`` calls under ``torch.profiler``: robust to the
    few launches a busy host delays; None if the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return float(np.median(us)) / 1e3 if us else None


def cold_inputs(x: torch.Tensor, total: int = 3 * L2_BYTES):
    """A function that hands out copies of ``x`` in turn, copies that
    together hold ``total`` bytes or more: a kernel called on each in turn
    finds its input evicted from L2 since its last use, so it reads it from
    HBM, as the bytes bound assumes."""
    n = max(2, -(-total // (x.numel() * x.element_size())))
    return functools.partial(next, itertools.cycle(
        [x.clone() for _ in range(n)]))


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ phase 3
def _flash_bound(B, T, H, KV, D, pairs):
    """Bytes (q, k, v read once, o written, lse f32) and the two products'
    flops over the live (query, key) pairs of one head."""
    nbytes = 2 * (2 * B * T * H * D + 2 * B * T * KV * D) + 4 * B * H * T
    return bound(nbytes, 4 * B * H * D * pairs, BF16_FLOPS_PER_S)


def phase_flash(gen):
    """B1 against its plain version at the serving shape (T = 1024 and a
    ragged T = 300) and the training shape (T = 2047, causal, and with 3
    packed segments), each timed beside SDPA (under the segments' mask
    where there are segments); every launch here takes the tensor-core
    body."""
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_fwd,
                                                        flash_fwd_body,
                                                        flash_fwd_reference)

    B, T, H, KV, D = 1, 1024, 32, 8, 128
    dt = torch.bfloat16
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dt)
    if flash_fwd_body(q) != "wgmma":
        raise SystemExit("phase 3: the serving shape does not take the "
                         "tensor-core body")
    o, lse = flash_fwd(q, k, v)
    ro, rlse = flash_fwd_reference(q, k, v)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    # ragged: no T % 128 (or 64) gate
    qr, kr, vr = q[:, :300].contiguous(), k[:, :300].contiguous(), \
        v[:, :300].contiguous()
    o300, _ = flash_fwd(qr, kr, vr)
    r300, _ = flash_fwd_reference(qr, kr, vr)
    err300 = (o300.float() - r300.float()).abs().max().item()
    ms = time_ms(lambda: flash_fwd(q, k, v))
    dev_ms = device_ms(lambda: flash_fwd(q, k, v))
    plain_ms = time_ms(lambda: flash_fwd_reference(q, k, v), iters=5)
    sdpa = _sdpa(q, k, v)
    library_ms = sdpa and time_ms(sdpa)
    library_dev = sdpa and device_ms(sdpa)
    b_ms, b_by = _flash_bound(B, T, H, KV, D, T * (T + 1) // 2)
    log(f"[flash] B={B} T={T} H={H} KV={KV} D={D} bf16: max_abs_err "
        f"{err:.3e} (tol {FLASH_TOL}) lse_err {lse_err:.3e} (tol 1e-3); "
        f"T=300 max_abs_err {err300:.3e} (tol {FLASH_TOL}); kernel {ms:.5f} "
        f"ms (device {dev_ms}) plain {plain_ms:.4f} ms sdpa {library_ms} "
        f"ms (device {library_dev}) bound {b_ms:.5f} ms ({b_by})")
    ok = err <= FLASH_TOL and err300 <= FLASH_TOL and lse_err <= 1e-3
    del o, ro, lse, rlse, o300, r300, q, k, v, qr, kr, vr

    # the training shape: T = 2047 (one 2048-token row less its last)
    T2 = 2047
    q = torch.randn((B, T2, H, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, T2, KV, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, T2, KV, D), generator=gen, device="cuda").to(dt)
    train = {}
    for label, nseg in (("causal", 0), ("causal + 3 segments", 3)):
        seg, lens = _segments(T2, nseg) if nseg else (None, [T2])
        o, lse = flash_fwd(q, k, v, seg=seg)
        ro, rlse = flash_fwd_reference(q, k, v, seg=seg)
        torch.cuda.synchronize()
        e = (o.float() - ro.float()).abs().max().item()
        le = (lse - rlse).abs().max().item()
        t_ms = time_ms(lambda: flash_fwd(q, k, v, seg=seg))
        t_dev = device_ms(lambda: flash_fwd(q, k, v, seg=seg))
        t_plain = time_ms(lambda: flash_fwd_reference(q, k, v, seg=seg),
                          iters=3, warmup=1)
        sdpa = _sdpa(q, k, v, seg)
        t_lib = sdpa and time_ms(sdpa)
        t_lib_dev = sdpa and device_ms(sdpa)
        # the yardstick computes the same o (it does not round p to bf16)
        lib_err = sdpa and (sdpa().transpose(1, 2).float()
                            - ro.float()).abs().max().item()
        tb_ms, tb_by = _flash_bound(B, T2, H, KV, D,
                                    sum(n * (n + 1) // 2 for n in lens))
        log(f"[flash] B={B} T={T2} H={H} KV={KV} D={D} bf16 {label}: "
            f"max_abs_err {e:.3e} (tol {FLASH_TOL}) lse_err {le:.3e} (tol "
            f"1e-3); kernel {t_ms:.5f} ms (device {t_dev}) plain "
            f"{t_plain:.4f} ms sdpa {t_lib} ms (device {t_lib_dev}; o vs "
            f"plain {lib_err}) bound {tb_ms:.5f} ms ({tb_by})")
        ok = ok and e <= FLASH_TOL and le <= 1e-3
        train[label] = {"max_abs_err": e, "lse_err": le, "ms": t_ms,
                        "device_ms": t_dev, "plain_ms": t_plain,
                        "library_ms": t_lib, "library_device_ms": t_lib_dev,
                        "library_max_abs_err": lib_err,
                        "bound_ms": tb_ms, "bound_by": tb_by}
        del o, ro, lse, rlse
    del q, k, v
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("flash kernel disagrees with its plain version")
    return {"name": "flash_fwd", "fn": flash_fwd,
            "source": "deepspeed_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "deepspeed_tpu/ops/attention_pallas.py:34",
            "max_abs_err": max([err, err300] + [r["max_abs_err"]
                                                for r in train.values()]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "device_ms": dev_ms,
            "library_device_ms": library_dev, "training_shape": train}


def _sdpa_mask(seg, causal=True):
    """SDPA's mask keywords: ``is_causal`` without segment ids (none when
    not causal), else the segments' boolean block-diagonal mask [B, 1, T,
    T], causal or not."""
    if seg is None:
        return {"is_causal": causal}
    T = seg.shape[1]
    same = seg[:, None, :, None] == seg[:, None, None, :]
    if not causal:
        return {"attn_mask": same}
    tril = torch.ones((T, T), dtype=torch.bool, device=seg.device).tril()
    return {"attn_mask": same & tril}


def _sdpa(q, k, v, seg=None, causal=True):
    """One PyTorch call computing the same GQA attention (causal or not;
    with segment ids, under their block-diagonal mask, built here once), as
    a function of no arguments giving o [B, H, T, D], or None on a PyTorch
    without ``enable_gqa``.  A yardstick only: the port never calls it."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = _sdpa_mask(seg, causal)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **kw)
    try:
        call()
    except TypeError:                   # a PyTorch without enable_gqa
        return None
    return call


def _paged_inputs(gen, lens, C, H=32, KV=8, D=128, ps=16, mp=64):
    """Pages holding each row's live tokens on distinct random pages; table
    slots past a row's frontier hold stale ids (other rows' pages, or the
    trash page P-1)."""
    B = len(lens)
    used = [-(-(n + (C if C > 1 else 0)) // ps) for n in lens]
    P = sum(used) + 1
    perm = torch.randperm(P - 1, generator=gen, device="cuda").int()
    table = torch.randint(0, P, (B, mp), generator=gen, device="cuda",
                          dtype=torch.int32)
    off = 0
    for b, u in enumerate(used):
        table[b, :u] = perm[off:off + u]
        off += u
    dt = torch.bfloat16
    kp = torch.randn((KV, P, ps, D), generator=gen, device="cuda").to(dt)
    vp = torch.randn((KV, P, ps, D), generator=gen, device="cuda").to(dt)
    return kp, vp, table


def _share(bound_ms, dev_ms):
    """The bound's share of a device time (None where none was read)."""
    return bound_ms / dev_ms if dev_ms else None


def phase_paged(gen):
    """B5 against its plain version at the decode and chunk shapes of the
    Llama-3-8B paths (bf16, 32 / 8 heads, head_dim 128, pages of 16): both
    take the Hopper body; each timed with events around the wrapper and on
    the device clock around the kernel alone, beside its bound."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_attention_reference, paged_body, paged_chunk_attention,
        paged_chunk_attention_reference, paged_decode_attention)

    H, KV, D, ps = 32, 8, 128, 16
    # decode: KV lengths 128..1024 and one empty row
    lens = [0, 128, 256, 400, 512, 700, 900, 1024]
    kp, vp, table = _paged_inputs(gen, lens, 1)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((8, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    if paged_body(q) != "sm90":
        raise SystemExit("phase 3: the serving shape does not take B5's "
                         "Hopper body")
    out = paged_decode_attention(q, kp, vp, table, seq)
    ref = paged_attention_reference(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    empty_zero = bool((out[0] == 0).all())
    ms = time_ms(lambda: paged_decode_attention(q, kp, vp, table, seq))
    q1, st1 = q[:, None], seq - 1
    dev = device_ms(lambda: paged_chunk_attention(q1, kp, vp, table, st1))
    plain_ms = time_ms(
        lambda: paged_attention_reference(q, kp, vp, table, seq), iters=5)
    live = sum(lens)
    nbytes = 2 * live * KV * D * 2 + 2 * 2 * 8 * H * D
    b_ms, b_by = bound(nbytes, 4 * live * H * D, BF16_FLOPS_PER_S)
    log(f"[paged decode] B=8 C=1 ps={ps} lens={lens} bf16: max_abs_err "
        f"{err:.3e} (tol {PAGED_DECODE_TOL}) empty_row_zero {empty_zero}; kernel "
        f"{ms:.4f} ms (device {dev}, bound share {_share(b_ms, dev)}) plain "
        f"{plain_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")

    # chunked prefill: C = 256 at per-row starts, history + chunk
    C = 256
    starts = [0, 128, 256, 300, 512, 600, 700, 768]
    kp2, vp2, table2 = _paged_inputs(gen, starts, C)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    qc = torch.randn((8, C, H, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    oc = paged_chunk_attention(qc, kp2, vp2, table2, st)
    rc = paged_chunk_attention_reference(qc, kp2, vp2, table2, st)
    torch.cuda.synchronize()
    err_c = (oc.float() - rc.float()).abs().max().item()
    ms_c = time_ms(lambda: paged_chunk_attention(qc, kp2, vp2, table2, st))
    dev_c = device_ms(lambda: paged_chunk_attention(qc, kp2, vp2, table2, st))
    plain_c = time_ms(lambda: paged_chunk_attention_reference(
        qc, kp2, vp2, table2, st), iters=3)
    live_c = sum(s + C for s in starts)
    pairs = sum(s * C + C * (C + 1) // 2 for s in starts)
    bc_ms, bc_by = bound(2 * live_c * KV * D * 2 + 2 * 2 * 8 * C * H * D,
                         4 * pairs * H * D, BF16_FLOPS_PER_S)
    log(f"[paged chunk] B=8 C={C} ps={ps} starts={starts} bf16: max_abs_err "
        f"{err_c:.3e} (tol {PAGED_CHUNK_TOL}); kernel {ms_c:.4f} ms (device "
        f"{dev_c}, bound share {_share(bc_ms, dev_c)}) plain {plain_c:.4f} "
        f"ms bound {bc_ms:.5f} ms ({bc_by})")
    if not (err <= PAGED_DECODE_TOL and err_c <= PAGED_CHUNK_TOL
            and empty_zero):
        raise SystemExit("paged kernel disagrees with its plain version")
    return {"name": "paged_attention", "fn": paged_chunk_attention,
            "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
            "replaces": "deepspeed_tpu/inference/kernels.py:656",
            "max_abs_err": max(err, err_c), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": dev, "bound_share": _share(b_ms, dev),
            "chunk": {"C": C, "ms": ms_c, "device_ms": dev_c,
                      "bound_share": _share(bc_ms, dev_c),
                      "plain_ms": plain_c, "bound_ms": bc_ms,
                      "bound_by": bc_by, "max_abs_err": err_c}}


def _greedy_case(fn, x):
    """One B6 case timed on copies of ``x`` read from HBM in turn
    (:func:`cold_inputs`): the kernel with events and on the device clock,
    its plain version, and ``torch.argmax`` (events and device clock),
    beside the bound (each element read once, B indices written).  The
    kernel and ``argmax`` again on ``x`` alone, which stays in L2 as the LM
    head's fresh output would in serving (``l2_*``: no share of the bound,
    which assumes HBM)."""
    from deepspeed_tpu_torch.ops.sampling_cuda import greedy_rows_reference

    B, V = x.shape
    b_ms, b_by = bound(B * V * x.element_size() + B * 4, B * V,
                       F32_FLOPS_PER_S)
    cold = cold_inputs(x)
    dev = device_ms(lambda: fn(cold()), iters=50)
    return {"ms": time_ms(lambda: fn(cold()), iters=50),
            "device_ms": dev, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": _share(b_ms, dev),
            "plain_ms": time_ms(lambda: greedy_rows_reference(cold()),
                                iters=50),
            "library_ms": time_ms(lambda: torch.argmax(cold(), dim=-1),
                                  iters=50),
            "library_device_ms": device_ms(
                lambda: torch.argmax(cold(), dim=-1), iters=50),
            "l2_device_ms": device_ms(lambda: fn(x), iters=50),
            "library_l2_device_ms": device_ms(
                lambda: torch.argmax(x, dim=-1), iters=50)}


def phase_greedy(gen):
    """B6 at the serving vocabulary: B = 8 f32 with planted ties (and NaN
    rows), B = 1 f32 (a prefill flush of one row) and B = 8 bf16, each
    exact against the plain version and ``torch.argmax``; each row split
    over a cluster of blocks (the "cluster" body)."""
    from deepspeed_tpu_torch.ops.sampling_cuda import (fused_greedy_rows,
                                                       greedy_rows_reference)

    B, V = 8, 128256
    x = torch.randn((B, V), generator=gen, device="cuda")
    # planted ties: each row's max appears at two or more indices
    ties = [(0, 1), (5, 128255), (127, 128), (64000, 3), (7, 70000, 9),
            (128254, 128255), (0, 128255), (4, 4000, 40000)]
    for b, idx in enumerate(ties):
        x[b, list(idx)] = 50.0
    fused_greedy_rows.body_launches = dict.fromkeys(
        fused_greedy_rows.body_launches, 0)
    got = fused_greedy_rows(x)
    ref = greedy_rows_reference(x)
    arg = torch.argmax(x, dim=-1)
    torch.cuda.synchronize()
    err = (got.long() - ref.long()).abs().max().item()
    exact = {"B8 f32": bool(torch.equal(got.long(), ref.long())
                            and torch.equal(got.long(), arg)
                            and got.tolist() == [min(t) for t in ties])}
    # NaN counts as the max: an all-NaN row gives 0, a row with some NaN
    # its first NaN (ahead of its planted tie)
    xn = x.clone()
    xn[0] = float("nan")
    xn[6, [70001, 128000]] = float("nan")
    got_n = fused_greedy_rows(xn)
    exact["B8 f32 NaN rows"] = bool(
        torch.equal(got_n, greedy_rows_reference(xn))
        and got_n[0].item() == 0 and got_n[6].item() == 70001)
    x1 = x[7:].clone()                  # B = 1: its max at 4, tied at 4000
    xh = x.to(torch.bfloat16)           # bf16: the ties stay exact (50.0)
    for key, xc, want in (("B1 f32", x1, [4]),
                          ("B8 bf16", xh, [min(t) for t in ties])):
        got_c = fused_greedy_rows(xc)
        exact[key] = bool(torch.equal(got_c, greedy_rows_reference(xc))
                          and torch.equal(got_c.long(),
                                          torch.argmax(xc, dim=-1))
                          and got_c.tolist() == want)
    bodies = dict(fused_greedy_rows.body_launches)
    split = bodies["row"] == 0
    cases = {"B8 f32": _greedy_case(fused_greedy_rows, x),
             "B1 f32": _greedy_case(fused_greedy_rows, x1),
             "B8 bf16": _greedy_case(fused_greedy_rows, xh)}
    for key, c in cases.items():
        log(f"[greedy] {key} V={V}: exact {exact[key]} (tol: exact); "
            f"from HBM: kernel device {c['device_ms']} ms (bound share "
            f"{c['bound_share']}), events {c['ms']:.4f} ms; plain "
            f"{c['plain_ms']:.4f} ms; argmax device {c['library_device_ms']}"
            f" ms, events {c['library_ms']:.4f} ms; bound "
            f"{c['bound_ms']:.5f} ms ({c['bound_by']}); from L2: kernel "
            f"device {c['l2_device_ms']} ms, argmax {c['library_l2_device_ms']}"
            f" ms")
    log(f"[greedy] NaN rows exact {exact['B8 f32 NaN rows']}; launches by "
        f"body {bodies} (all on the cluster body: {split})")
    if not all(exact.values()) or not split:
        raise SystemExit(f"greedy kernel is not bit-exact or left the "
                         f"cluster body: {exact} {bodies}")
    c = cases["B8 f32"]
    return {"name": "greedy_argmax", "fn": fused_greedy_rows,
            "source": "deepspeed_tpu_torch/csrc/greedy_argmax.cu",
            "replaces": "deepspeed_tpu/ops/sampling_pallas.py:65",
            "max_abs_err": float(err), "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "device_ms": c["device_ms"],
            "library_device_ms": c["library_device_ms"],
            "bound_share": c["bound_share"], "cases": cases}


# ------------------------------------------------------------ phase 9
def phase_paged_quant_v1(gen):
    """B7 over int8 pages made by the port's codec from bf16 pages, B8 and
    B5 over the bf16 pages, at phase 3's decode and chunk shapes.  B8 takes
    B5's Hopper body there (one launch) and is held to the body's tiled
    twin at B5's gates; over the same pages in f32 it takes the split-key
    pair (two launches), held to the split plain version at its own."""
    from deepspeed_tpu_torch.inference.kernels import quantize_kv_rows
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_attention_quant_reference, paged_chunk_attention,
        paged_chunk_attention_quant, paged_chunk_attention_quant_reference,
        paged_chunk_attention_split_reference,
        paged_chunk_attention_tiled_reference, paged_chunk_attention_v1,
        paged_decode_attention, paged_decode_attention_quant,
        paged_decode_attention_v1)

    H, KV, D, ps = 32, 8, 128, 16
    out = {"quant": {}, "v1": {}, "b5": {}}
    for shape, C, lens in (("decode", 1, [0, 128, 256, 400, 512, 700, 900,
                                          1024]),
                           ("chunk", 256, [0, 128, 256, 300, 512, 600, 700,
                                           768])):
        kp, vp, table = _paged_inputs(gen, lens, C)
        kq, ks = quantize_kv_rows(kp)
        vq, vs = quantize_kv_rows(vp)
        st = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if C == 1:
            q = torch.randn((8, H, D), generator=gen,
                            device="cuda").to(torch.bfloat16)
            quant = lambda: paged_decode_attention_quant(  # noqa: E731
                q, kq, ks, vq, vs, table, st)
            quant_ref = lambda: paged_attention_quant_reference(  # noqa
                q, kq, ks, vq, vs, table, st)
            v1 = lambda: paged_decode_attention_v1(  # noqa: E731
                q, kp, vp, table, st)
            b5 = lambda: paged_decode_attention(  # noqa: E731
                q, kp, vp, table, st)
            # the chunk entries at start = length - 1: the kernels alone,
            # for the device clock, and B8's inputs in its chunk form
            q1, st1 = q[:, None], st - 1
            quant_k = lambda: paged_chunk_attention_quant(  # noqa: E731
                q1, kq, ks, vq, vs, table, st1)
            b5_k = lambda: paged_chunk_attention(  # noqa: E731
                q1, kp, vp, table, st1)
            live = sum(lens)
            pairs = live
            io = 2 * 2 * 8 * H * D                     # q and o, bf16
        else:
            q = torch.randn((8, C, H, D), generator=gen,
                            device="cuda").to(torch.bfloat16)
            quant = lambda: paged_chunk_attention_quant(  # noqa: E731
                q, kq, ks, vq, vs, table, st)
            quant_ref = lambda: paged_chunk_attention_quant_reference(  # noqa
                q, kq, ks, vq, vs, table, st)
            v1 = lambda: paged_chunk_attention_v1(  # noqa: E731
                q, kp, vp, table, st)
            b5 = lambda: paged_chunk_attention(  # noqa: E731
                q, kp, vp, table, st)
            q1, st1 = q, st
            quant_k, b5_k = quant, b5
            live = sum(s + C for s in lens)
            pairs = sum(s * C + C * (C + 1) // 2 for s in lens)
            io = 2 * 2 * 8 * C * H * D
        v1_k = lambda: paged_chunk_attention_v1(  # noqa: E731
            q1, kp, vp, table, st1)
        v1_ref = lambda: paged_chunk_attention_tiled_reference(  # noqa
            q1, kp, vp, table, st1)
        sm90_before = paged_chunk_attention_v1.body_launches["sm90"]
        got_q, want_q = quant(), quant_ref()
        got_1, want_1 = v1_k(), v1_ref()
        v1_sm90 = paged_chunk_attention_v1.body_launches["sm90"] \
            - sm90_before == 1
        # the split-key pair over the same pages and q in f32
        qf, kf, vf = q1.float(), kp.float(), vp.float()
        scalar_before = paged_chunk_attention_v1.body_launches["scalar"]
        got_f = paged_chunk_attention_v1(qf, kf, vf, table, st1)
        want_f = paged_chunk_attention_split_reference(qf, kf, vf, table,
                                                       st1)
        v1_split = paged_chunk_attention_v1.body_launches["scalar"] \
            - scalar_before == 2
        torch.cuda.synchronize()
        err_q = (got_q.float() - want_q.float()).abs().max().item()
        err_1 = (got_1.float() - want_1.float()).abs().max().item()
        err_f = (got_f - want_f).abs().max().item()
        # the decode row 0 is empty: zeros from every kernel
        empty_zero = C > 1 or bool((got_q[0] == 0).all()
                                   and (got_1[0] == 0).all()
                                   and (got_f[0] == 0).all())
        iters = 20 if C == 1 else 10
        ms_q = time_ms(quant, iters=iters)
        dev_q = device_ms(quant_k, iters=iters)
        plain_q = time_ms(quant_ref, iters=3)
        ms_1 = time_ms(v1, iters=iters)
        dev_1 = device_ms(v1_k, iters=iters)
        plain_1 = time_ms(v1_ref, iters=2, warmup=1)
        dev_f = device_ms(lambda: paged_chunk_attention_v1(
            qf, kf, vf, table, st1), iters=iters)
        plain_f = time_ms(lambda: paged_chunk_attention_split_reference(
            qf, kf, vf, table, st1), iters=2, warmup=1)
        ms_5 = time_ms(b5, iters=iters)
        dev_5 = device_ms(b5_k, iters=iters)
        flops = 4 * pairs * H * D
        # B7 reads (D codes + one f32 scale) per live row, head and K/V;
        # B5 and B8 read 2·D bytes of bf16 (4·D in f32)
        bq = bound(2 * live * KV * (D + 4) + io, flops, BF16_FLOPS_PER_S)
        b1 = bound(2 * live * KV * D * 2 + io, flops, BF16_FLOPS_PER_S)
        bf = bound(2 * live * KV * D * 4 + 2 * io, flops, F32_FLOPS_PER_S)
        tol_q = PAGED_QUANT_DECODE_TOL if C == 1 else PAGED_QUANT_CHUNK_TOL
        tol_1 = PAGED_DECODE_TOL if C == 1 else PAGED_CHUNK_TOL
        tol_f = PAGED_V1_DECODE_TOL if C == 1 else PAGED_V1_CHUNK_TOL
        log(f"[paged {shape} B7 int8] B=8 C={C} ps={ps} lens={lens}: "
            f"max_abs_err {err_q:.3e} (tol {tol_q}); kernel {ms_q:.4f} ms "
            f"(device {dev_q}, bound share {_share(bq[0], dev_q)}) plain "
            f"{plain_q:.4f} ms bound {bq[0]:.5f} ms ({bq[1]}) library none")
        log(f"[paged {shape} B8 v1 sm90] B=8 C={C} ps={ps} bf16, one launch "
            f"{v1_sm90}: max_abs_err vs the tiled twin {err_1:.3e} (tol "
            f"{tol_1}); kernel {ms_1:.4f} ms (device {dev_1}, bound share "
            f"{_share(b1[0], dev_1)}) plain (tiled twin) {plain_1:.4f} ms "
            f"bound {b1[0]:.5f} ms ({b1[1]}) library none")
        log(f"[paged {shape} B8 v1 split] B=8 C={C} ps={ps} f32, two "
            f"launches {v1_split}: max_abs_err vs the split plain version "
            f"{err_f:.3e} (tol {tol_f}); device {dev_f} plain (split) "
            f"{plain_f:.4f} ms bound {bf[0]:.5f} ms ({bf[1]})")
        log(f"[paged {shape} B5 same bf16 pages] kernel {ms_5:.4f} ms "
            f"(device {dev_5}, bound share {_share(b1[0], dev_5)}) bound "
            f"{b1[0]:.5f} ms ({b1[1]}); empty_row_zero {empty_zero}")
        if not (err_q <= tol_q and err_1 <= tol_1 and err_f <= tol_f
                and empty_zero and v1_sm90 and v1_split):
            raise SystemExit(f"B7/B8 disagree with their plain versions "
                             f"({shape})")
        for key, ms, dev, plain, err, bnd in (
                ("quant", ms_q, dev_q, plain_q, err_q, bq),
                ("v1", ms_1, dev_1, plain_1, err_1, b1),
                ("b5", ms_5, dev_5, None, None, b1)):
            out[key][shape] = {"ms": ms, "device_ms": dev, "plain_ms": plain,
                               "err": err, "bound_ms": bnd[0],
                               "bound_by": bnd[1],
                               "bound_share": _share(bnd[0], dev)}
        out["v1"][shape]["f32_split"] = {
            "device_ms": dev_f, "plain_ms": plain_f, "max_abs_err": err_f,
            "bound_ms": bf[0], "bound_by": bf[1]}
        del kp, vp, kq, ks, vq, vs, q, got_q, want_q, got_1, want_1
        del qf, kf, vf, got_f, want_f
        torch.cuda.empty_cache()

    def row(name, fn, source, replaces, key):
        d, c = out[key]["decode"], out[key]["chunk"]
        r = {"name": name, "fn": fn, "source": source,
             "replaces": replaces, "max_abs_err": max(d["err"], c["err"]),
             "ms": d["ms"], "plain_ms": d["plain_ms"],
             "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
             "library_ms": None, "device_ms": d["device_ms"],
             "bound_share": d["bound_share"],
             "chunk": {"C": 256, "ms": c["ms"], "device_ms": c["device_ms"],
                       "bound_share": c["bound_share"],
                       "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                       "bound_by": c["bound_by"], "max_abs_err": c["err"]}}
        if "f32_split" in d:
            r["f32_split"] = {
                "source": "deepspeed_tpu_torch/csrc/paged_attention_split.cu",
                "decode": d["f32_split"], "chunk": c["f32_split"]}
        return r

    return [row("paged_attention_quant", paged_chunk_attention_quant,
                "deepspeed_tpu_torch/csrc/paged_attention_quant.cu",
                "deepspeed_tpu/inference/kernels.py:795", "quant"),
            row("paged_attention_v1", paged_chunk_attention_v1,
                "deepspeed_tpu_torch/csrc/paged_attention.cu",
                "deepspeed_tpu/inference/kernels.py:958", "v1")]


# ------------------------------------------------------------ phase 12
def _quant_err(got, want) -> float:
    """The largest |difference| of codes and of scales; a scale equal to
    its plain value (an inf to an inf) or NaN where that is NaN counts 0, a
    NaN on one side only counts inf."""
    (q, s), (rq, rs) = got, want
    q_err = (q.int() - rq.int()).abs().max().item() if q.numel() else 0
    same = (s == rs) | (torch.isnan(s) & torch.isnan(rs))
    s_err = torch.where(same, 0.0, (s - rs).abs().nan_to_num(
        nan=float("inf"))).max().item() if s.numel() else 0.0
    return float(max(q_err, s_err))


# the fused K/V write's cases at the tier's widths (8 rows of 128-slot
# tables of 16-key pages, 8 kv heads of 128, bf16): name -> (rows a
# sequence, starts; None = a prompt from 0).  Decode holds a row at the last
# slot, one at capacity and one past it; the chunk rows that run past
# capacity and one wholly past it; the prompt a padded tail (1000 % 16)
KV_WRITE_CASES = {
    "decode": (1, [0, 128, 255, 400, 1024, 2047, 2048, 3000]),
    "chunk": (256, [0, 128, 256, 300, 512, 600, 1900, 2048]),
    "prompt": (1000, None),
}


def kv_write_inputs(gen, rows, starts, B=8, KV=8, D=128, ps=16, mp=128):
    """Inputs of one layer's int8-resident K/V write: new K and V [B, rows,
    KV, D] bf16, a table of distinct pages, the starts (None for a prompt)
    and the four page planes filled with random codes and scales."""
    P = B * mp + 1
    perm = torch.randperm(P, generator=gen, device="cuda").int()
    table = perm[:B * mp].reshape(B, mp).contiguous()
    new = [(torch.randn((B, rows, KV, D), generator=gen, device="cuda")
            * 3.0).to(torch.bfloat16) for _ in range(2)]
    planes = []
    for _ in range(2):
        planes.append(torch.randint(-127, 128, (KV, P, ps, D), generator=gen,
                                    device="cuda", dtype=torch.int8))
        planes.append(torch.rand((KV, P, ps, 1), generator=gen,
                                 device="cuda"))
    st = (None if starts is None else
          torch.tensor(starts, dtype=torch.int32, device="cuda"))
    return planes, new, table, st


def kv_write_rows(rows, starts, B=8, mp=128, ps=16):
    """The rows a write stores per plane and kv head (in capacity, and a
    prompt's padded tail)."""
    if starts is None:
        return B * -(-rows // ps) * ps
    return sum(max(0, min(rows, mp * ps - s)) for s in starts)


def phase_quant(gen):
    """B9 against its plain version, bit for bit: the stacked w1 leaf of
    Llama-3-8B ([32, 4096, 14336] bf16 as 14.68 M groups of 128 in one
    launch, as the engine build quantizes it; the plain version runs on 4
    M-group slices of the same input, for memory), the K/V rows of one
    decode step ([8, 8, 128] bf16, also against the host codec), f32 groups
    holding NaN, inf and zeros, and the fused K/V write of one layer at a
    decode step, a C = 256 chunk and a prompt with a padded tail (all four
    page planes against the plain version's).  Times on the device clock
    (the w1 leaf's mean, the medians of 100 launches at the small shapes)
    beside events around the wrapper.  ``max_abs_err`` is the largest over
    all of them."""
    from deepspeed_tpu_torch.inference.kernels import (
        quantize_kv_rows, write_kv_quant, write_kv_quant_reference)
    from deepspeed_tpu_torch.inference.kv_tier import quantize_page
    from deepspeed_tpu_torch.ops.quant_cuda import (quant_body, quantize_rows,
                                                    quantize_rows_reference)

    L, d, f = 32, 4096, 14336
    w1 = torch.empty((L, d, f), dtype=torch.bfloat16, device="cuda")
    for layer in w1:
        layer.normal_(generator=gen)
    rows = w1.view(-1, 128)
    G, n = rows.shape[0], w1.numel()
    vec_before = quantize_rows.body_launches["vec"]
    q, sc = quantize_rows(rows)          # the build's one launch
    vec_ok = (quant_body(rows) == "vec"
              and quantize_rows.body_launches["vec"] == vec_before + 1)
    err_w1 = 0.0
    for lo in range(0, G, 1 << 22):      # plain version in slices (memory)
        hi = min(G, lo + (1 << 22))
        err_w1 = max(err_w1, _quant_err(
            (q[lo:hi], sc[lo:hi]), quantize_rows_reference(rows[lo:hi])))
    del q, sc
    # informational: scales from a division by the Python scalar 127.0
    # (PyTorch's CUDA division multiplies by its reciprocal) that differ
    # from the IEEE quotient the kernel and the host codec compute
    amax = rows[:1 << 22].float().abs().amax(-1)
    scalar_div_off = int((amax / 127.0
                          != amax / torch.full_like(amax, 127.0)).sum())
    del amax
    ms = time_ms(lambda: quantize_rows(rows), iters=10)
    dev = device_ms(lambda: quantize_rows(rows), iters=10)
    plain_ms = time_ms(lambda: quantize_rows_reference(rows), iters=2,
                       warmup=1)
    # read each bf16 element, write its code and one f32 scale per group;
    # |x|, max, divide, round and clamp per element in f32
    b_ms, b_by = bound(n * 2 + n + G * 4, 5 * n, F32_FLOPS_PER_S)
    del w1, rows
    torch.cuda.empty_cache()

    kv = torch.randn((8, 8, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    kq, ks = quantize_kv_rows(kv)
    hq, hs = quantize_page(kv.float().cpu().numpy())
    err_kv = _quant_err((kq.view(64, 128), ks.view(64)),
                        quantize_rows_reference(kv.view(64, 128)))
    host_kv = (np.array_equal(kq.cpu().numpy(), hq)
               and np.array_equal(ks.cpu().numpy(), hs))
    kv_ms = time_ms(lambda: quantize_kv_rows(kv), iters=50)
    kv_med = device_median_ms(lambda: quantize_kv_rows(kv), iters=100)
    kv_plain = time_ms(lambda: quantize_kv_rows(kv, force_reference=True),
                       iters=50)
    kb_ms, kb_by = bound(64 * 128 * 3 + 64 * 4, 5 * 64 * 128,
                         F32_FLOPS_PER_S)

    x = torch.randn((4096, 128), generator=gen, device="cuda") * 3.0
    x[0] = 0.0
    x[1, 5] = float("nan")
    x[2, 7] = float("inf")
    x[3, 0] = -float("inf")
    x[4] = float("nan")
    got = quantize_rows(x)
    err_f32 = _quant_err(got, quantize_rows_reference(x))
    special = bool(got[1][0] == 1.0 and not got[0][:5].any()
                   and torch.isnan(got[1][[1, 4]]).all()
                   and torch.isinf(got[1][[2, 3]]).all())
    torch.cuda.synchronize()

    writes, err_write = {}, 0.0
    for case, (nrows, starts) in KV_WRITE_CASES.items():
        planes, new, table, st = kv_write_inputs(gen, nrows, starts)
        want = [p.clone() for p in planes]
        before = quantize_rows.launches
        write_kv_quant(*planes, *new, table, st, 16)
        one_launch = quantize_rows.launches == before + 1
        write_kv_quant_reference(*want, *new, table, st, 16)
        torch.cuda.synchronize()
        err = max(_quant_err((planes[i], planes[i + 1]),
                             (want[i], want[i + 1])) for i in (0, 2))
        err_write = max(err_write, err if one_launch else float("inf"))
        del want
        fn = functools.partial(write_kv_quant, *planes, *new, table, st, 16)
        w_ms = time_ms(fn, iters=50)
        w_med = device_median_ms(fn, iters=100)
        w_plain = time_ms(functools.partial(
            write_kv_quant_reference, *planes, *new, table, st, 16), iters=5)
        stored = kv_write_rows(nrows, starts) * 8 * 2     # rows, K and V
        read = min(stored, 2 * 8 * 8 * nrows) * 128 * 2
        wb = bound(read + stored * (128 + 4), 5 * stored * 128,
                   F32_FLOPS_PER_S)
        writes[case] = {"rows": nrows, "starts": starts, "max_abs_err": err,
                        "one_launch": one_launch, "ms": w_ms,
                        "device_median_ms": w_med, "plain_ms": w_plain,
                        "bound_ms": wb[0], "bound_by": wb[1],
                        "bound_share": _share(wb[0], w_med)}
        log(f"[quantize B9 K/V write] {case}: B=8 rows={nrows} starts="
            f"{starts} KV=8 D=128 bf16 into int8 pages of 16 (tables of "
            f"128): one launch {one_launch}, max |err| of the four planes "
            f"{err} (bit-equal: 0); kernel {w_ms:.4f} ms (device median "
            f"{w_med}, bound share {_share(wb[0], w_med)}) plain "
            f"{w_plain:.4f} ms bound {wb[0]:.6f} ms ({wb[1]})")
        del planes, new, table, st
        torch.cuda.empty_cache()

    err = max(err_w1, err_kv, err_f32, err_write)
    log(f"[quantize B9] w1 leaf [{L}, {d}, {f}] bf16 as [{G}, 128], one "
        f"launch on the vector body {vec_ok}: max |err| of codes and scales "
        f"{err_w1} (bit-equal: 0); kernel {ms:.4f} ms (device {dev}, bound "
        f"share {_share(b_ms, dev)}) plain {plain_ms:.4f} ms bound "
        f"{b_ms:.4f} ms ({b_by}) library none; scalar-divisor scales off "
        f"the IEEE quotient: {scalar_div_off} of {1 << 22} groups")
    log(f"[quantize B9] decode K/V rows [8, 8, 128] bf16: max |err| "
        f"{err_kv}, equal to the host codec {host_kv}; kernel {kv_ms:.4f} "
        f"ms (device median {kv_med}, bound share {_share(kb_ms, kv_med)}) "
        f"plain {kv_plain:.4f} ms bound {kb_ms:.6f} ms ({kb_by})")
    log(f"[quantize B9] [4096, 128] f32 with zero / NaN / inf groups: max "
        f"|err| {err_f32}, special groups as the plain version {special}")
    if not (err == 0.0 and host_kv and special and vec_ok):
        raise SystemExit("quantize kernel disagrees with its plain version")
    return {"name": "quantize", "fn": quantize_rows,
            "source": "deepspeed_tpu_torch/csrc/quant.cu",
            "replaces": "deepspeed_tpu/ops/quant.py:190",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": dev, "bound_share": _share(b_ms, dev),
            "kv_rows": {"ms": kv_ms, "device_median_ms": kv_med,
                        "plain_ms": kv_plain, "bound_ms": kb_ms,
                        "bound_by": kb_by,
                        "bound_share": _share(kb_ms, kv_med)},
            "kv_write": writes}


def phase_env_probe(fns):
    """B10's main path is the port's ds_report: with every count at 0,
    ``env_report.report()`` must show the probe compiled and right and
    launch B10 once; then the kernel alone against ``2 * x``.  Returns the
    kernel's row and the report's launch counts."""
    from deepspeed_tpu_torch import env_report

    _zero(fns.values())
    r = env_report.report()
    launches = {n: f.launches for n, f in fns.items()}
    log("[env_report] " + json.dumps(r))
    _check_launches("env report", launches, ("env_probe",))
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(
        8, 128)
    out = env_report.env_probe(x)
    want = env_report.env_probe_reference(x)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    ms = time_ms(lambda: env_report.env_probe(x), iters=100)
    plain_ms = time_ms(lambda: env_report.env_probe_reference(x), iters=100)
    library_ms = time_ms(lambda: torch.mul(x, 2.0), iters=100)
    # the device clock takes the host's launch cost out of both: the mean
    # per launch, and the median of 100 launches of each
    dev = device_ms(lambda: env_report.env_probe(x), iters=100)
    library_dev = device_ms(lambda: torch.mul(x, 2.0), iters=100)
    med = device_median_ms(lambda: env_report.env_probe(x), iters=100)
    library_med = device_median_ms(lambda: torch.mul(x, 2.0), iters=100)
    b_ms, b_by = bound(2 * x.numel() * 4, x.numel(), F32_FLOPS_PER_S)
    log(f"[env probe B10] (8, 128) f32: exact {err == 0.0}; kernel "
        f"{ms:.4f} ms (device {dev}, median {med}) plain {plain_ms:.4f} ms "
        f"torch.mul {library_ms:.4f} ms (device {library_dev}, median "
        f"{library_med}); kernel / torch.mul device medians "
        f"{med / library_med if med and library_med else None}; bound "
        f"{b_ms:.7f} ms ({b_by})")
    if not (r["ops"]["cuda probe"]["ok"] and err == 0.0):
        raise SystemExit("env probe failed")
    return {"name": "env_probe", "fn": env_report.env_probe,
            "source": "deepspeed_tpu_torch/csrc/env_probe.cu",
            "replaces": "deepspeed_tpu/env_report.py:46",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "device_ms": dev,
            "library_device_ms": library_dev, "device_median_ms": med,
            "library_device_median_ms": library_med}, launches


# ------------------------------------------------------------ phase 13
def phase_int8_identity(fns):
    """The int8 engine built on the card (B9 quantizes every matrix leaf)
    against one handed the same weights quantized on the host by B9's plain
    version (no launch at build): equal codes and scales, identical greedy
    tokens, whole-prompt and chunked over an int8-resident tier (whose K/V
    rows go through B9 in both engines; phase 12 holds those rows to the
    plain version and the host codec)."""
    from deepspeed_tpu_torch._tree import tree_leaves, tree_map
    from deepspeed_tpu_torch.inference.quantized import quantize_params
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.weights import init_params

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(1),
                         device="cuda", dtype=torch.float32)
    host_tree = quantize_params(tree_map(lambda t: t.cpu(), params),
                                skip_paths=("attn_norm", "mlp_norm",
                                            "final_norm"))
    waves = _tier_waves(np.random.default_rng(5), cfg.vocab_size, 40, 9, 4)
    opts = dict(max_batch=3, page_size=8, num_pages=64, max_seq=96,
                prefill_bucket=8, cache_dtype=torch.bfloat16)
    for label, extra in (("whole-prompt", {}),
                         ("chunked, int8-resident tier",
                          {"prefill_chunk": 8, "prefix_cache": {},
                           "kv_tier": dict(TIER_KV)})):
        outs, built, trees = [], [], []
        for tree in (params, host_tree):
            fns["quantize"].launches = 0
            eng = llama_serving_engine(tree, cfg, weight_dtype="int8",
                                       **opts, **extra)
            built.append(fns["quantize"].launches)
            trees.append(tree_leaves(eng.params))
            out = {}
            for wave in waves:
                for rid, p in wave.items():
                    eng.submit(rid, p, max_new_tokens=10)
                out.update(eng.run())
            if eng.check_leaks():
                raise SystemExit(f"int8 identity: leaks {eng.check_leaks()}")
            outs.append(out)
        same_tree = all(torch.equal(x, y) for x, y in zip(*trees))
        same = outs[0] == outs[1]
        log(f"[int8 identity] llama-tiny f32 weights as int8, {label}: "
            f"built on the card (B9, {built[0]} launches) == quantized on "
            f"the host (plain, {built[1]} launches at build): codes and "
            f"scales {same_tree}, tokens {same} ({len(outs[0])} requests)")
        if not (same and same_tree and built[0] and not built[1]):
            raise SystemExit(f"int8 identity ({label}) failed")


# ------------------------------------------------------------ phase 4
def phase_identity(kernels):
    """Kernel arms vs plain arms on a tiny f32 Llama: identical greedy
    tokens with whole-prompt and chunked prefill."""
    import dataclasses

    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.weights import init_params

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(1),
                         device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = {f"r{i}": rng.integers(1, cfg.vocab_size,
                                     rng.integers(3, 40)).tolist()
               for i in range(6)}
    opts = dict(max_batch=3, page_size=8, num_pages=48, max_seq=96,
                prefill_bucket=8, cache_dtype=torch.float32)
    plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
    flash = next(k["fn"] for k in kernels if k["name"] == "flash_fwd")
    paged = next(k["fn"] for k in kernels if k["name"] == "paged_attention")
    for chunk in (0, 8):
        before = [k["fn"].launches for k in kernels]
        wgmma_before = flash.body_launches["wgmma"]
        sm90_before = paged.body_launches["sm90"]
        outs = []
        for c, kn in ((cfg, None),
                      (plain_cfg, {"paged_attention": "xla",
                                   "fused_sampling": "off"})):
            eng = llama_serving_engine(params, c, kernels=kn,
                                       prefill_chunk=chunk, **opts)
            for rid, p in prompts.items():
                eng.submit(rid, p, max_new_tokens=12)
            outs.append(eng.run())
            if eng.check_leaks():
                raise SystemExit(f"identity: leaks {eng.check_leaks()}")
        used = [k["fn"].launches - b for k, b in zip(kernels, before)]
        same = outs[0] == outs[1]
        log(f"[identity] llama-tiny f32 prefill_chunk={chunk}: kernel arm "
            f"== plain arm: {same} ({len(outs[0])} requests); kernel "
            f"launches {dict(zip((k['name'] for k in kernels), used))}")
        if not same:
            raise SystemExit("greedy tokens differ between the kernel and "
                             "plain arms")
        # chunked prefill never runs the whole-prompt flash kernel
        if any(u == 0 for k, u in zip(kernels, used)
               if not (chunk and k["name"] == "flash_fwd")):
            raise SystemExit("identity: a kernel arm did not launch")
        # f32 attention takes the scalar bodies
        if flash.body_launches["wgmma"] != wgmma_before \
                or paged.body_launches["sm90"] != sm90_before:
            raise SystemExit("identity: f32 attention launched a Hopper "
                             "body")


# ------------------------------------------------------------ phase 10
def _tier_waves(rng, vocab, prefix, suffix, n):
    """Two waves of n prompts: one shared prefix, distinct suffixes."""
    shared = rng.integers(1, vocab, prefix).tolist()
    return [{f"{w}{i}": shared + rng.integers(1, vocab, suffix).tolist()
             for i in range(n)} for w in ("A", "B")]


def phase_tier_identity(fns):
    """Kernel arms vs plain arms of engines with ``prefix_cache`` and
    ``kv_tier`` on a tiny f32 Llama: int8-resident pages (B7 against its
    plain arm) and the ``pallas_v1`` arm (B8) against ``xla`` on a dense
    tier; identical greedy tokens over two waves on one shared prefix, with
    pages demoted and promoted and no leaks.  The plain arms launch no
    kernel: the ``xla`` arm writes int8-resident K/V through the fused
    write's plain version, the kernel arm through B9's fused entry."""
    import dataclasses

    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.weights import init_params

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(1),
                         device="cuda", dtype=torch.float32)
    waves = _tier_waves(np.random.default_rng(3), cfg.vocab_size, 40, 9, 4)
    opts = dict(max_batch=3, page_size=8, num_pages=64, max_seq=96,
                prefill_bucket=8, cache_dtype=torch.float32,
                prefix_cache={})
    plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
    plain = {"paged_attention": "xla", "fused_sampling": "off"}
    for label, kernel_name, kv, paged in (
            ("int8-resident", "paged_attention_quant", TIER_KV, "pallas_v2"),
            ("pallas_v1", "paged_attention_v1", {"demote_watermark": 0.0},
             "pallas_v1")):
        outs, stats = [], []
        for c, kn in ((cfg, {"paged_attention": paged}), (plain_cfg, plain)):
            _zero(fns.values())
            eng = llama_serving_engine(params, c, kernels=kn, kv_tier=kv,
                                       prefill_chunk=8, **opts)
            out = {}
            for wave in waves:
                for rid, p in wave.items():
                    eng.submit(rid, p, max_new_tokens=10)
                out.update(eng.run())
            al = eng.allocator
            stats.append({"demoted": al.demoted, "promoted": al.promoted,
                          "quant_promotes":
                          eng.kv_tier_quant_resident_promotes,
                          "hits": eng.prefix_cache_hits,
                          "leaks": eng.check_leaks(),
                          "launches": {n: f.launches
                                       for n, f in fns.items()}})
            outs.append(out)
            _check_bodies(f"tier identity {label}", hopper=False,
                          record=False)
        same = outs[0] == outs[1]
        log(f"[tier identity] llama-tiny f32 {label}: kernel arm == plain "
            f"arm: {same} ({len(outs[0])} requests); kernel arm {stats[0]}; "
            f"plain arm {stats[1]}")
        ok = same and all(
            s["demoted"] > 0 and s["promoted"] > 0 and s["hits"] > 0
            and s["leaks"] == [] for s in stats)
        # the plain arm launches nothing (its int8-resident K/V writes take
        # the fused write's plain version on the card too); the kernel arm
        # writes through B9's fused entry, one launch a layer, as many as B7
        ok = ok and stats[0]["launches"][kernel_name] > 0 and not any(
            stats[1]["launches"].values())
        if label == "int8-resident":
            ok = ok and all(s["quant_promotes"] > 0 for s in stats) and (
                stats[0]["launches"]["quantize"]
                == stats[0]["launches"][kernel_name])
        if not ok:
            raise SystemExit(f"tier identity ({label}) failed")


# ------------------------------------------------------------ phase 5
def drive(eng, prompts, new_tokens):
    """Submit every prompt at once, step ``eng`` until all of them finish,
    and time it; returns their outputs and the run's metrics."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, p in prompts.items():
        eng.submit(rid, p, max_new_tokens=new_tokens)
    ttft, decode_only = {}, []
    while eng.has_work:
        chunks, queued = eng.prefill_chunks, len(eng.queue)
        busy = [s is not None for s in eng.slots]
        ts = time.perf_counter()
        eng.step()
        now = time.perf_counter()
        for b, s in enumerate(eng.slots):
            if s is not None and s.generated and s.req.req_id not in ttft:
                ttft[s.req.req_id] = now - t0
        for rid in prompts:
            if rid in eng.finished:
                ttft.setdefault(rid, now - t0)
        if (eng.prefill_chunks == chunks and len(eng.queue) == queued
                and busy == [s is not None for s in eng.slots]):
            decode_only.append(now - ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {rid: eng.finished[rid] for rid in prompts}
    gen_tokens = sum(len(v) - len(prompts[k]) for k, v in out.items())
    return out, {
        "wall_s": wall, "generated_tokens": gen_tokens,
        "tokens_per_s": gen_tokens / wall,
        "ttft_s_mean": float(np.mean(list(ttft.values()))),
        "ttft_s_max": float(np.max(list(ttft.values()))),
        "ms_per_decode_step": (float(np.median(decode_only)) * 1e3
                               if decode_only else None),
        "decode_only_steps": len(decode_only)}


def serve(params, cfg, prompts, new_tokens, **opts):
    """Serve every prompt on a fresh engine of ``cfg``'s family; returns the
    outputs, the engine's leak check and the run's metrics."""
    from deepspeed_tpu_torch.inference.serving import serving_engine

    eng = serving_engine(params, cfg, **opts)
    out, metrics = drive(eng, prompts, new_tokens)
    leaks = eng.check_leaks()
    del eng
    torch.cuda.empty_cache()
    return out, leaks, metrics


def _valid(out, prompts, new_tokens, vocab):
    return sorted(out) == sorted(prompts) and all(
        isinstance(v, list) and len(v) == len(prompts[r]) + new_tokens
        and all(0 <= t < vocab for t in v) for r, v in out.items())


def _check_launches(path, counts, want):
    """Every kernel in ``want`` launched on the path, every other none."""
    for name, n in counts.items():
        if name in want and n == 0:
            raise SystemExit(f"{path}: {name} never launched")
        if name not in want and n:
            raise SystemExit(f"{path}: {name} launched {n} times")


def _zero(fns):
    """Sets every wrapper's launch count, and its counts per body and per
    dtype where it keeps them, to 0."""
    for f in fns:
        f.launches = 0
        if hasattr(f, "body_launches"):
            f.body_launches = dict.fromkeys(f.body_launches, 0)
        if hasattr(f, "dtype_launches"):
            f.dtype_launches = dict.fromkeys(f.dtype_launches, 0)


def _two_body_kernels():
    """Kernel name -> (wrapper, its body on the Llama-3-8B paths, its body on
    the tiny f32 paths) for the kernels with two bodies: the flash kernels'
    tensor-core "wgmma", B5's, B7's and B8's Hopper "sm90" (f32 takes
    "scalar"), B9's "vec" (every group size of both: a multiple of 8), and
    B6's "cluster" (every batch of both is at most 8 rows, split over
    spans; "row" is for batches that fill the card alone)."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_chunk_attention, paged_chunk_attention_quant,
        paged_chunk_attention_v1)
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_bwd_dkv,
                                                        flash_bwd_dq,
                                                        flash_fwd)
    from deepspeed_tpu_torch.ops.quant_cuda import quantize_rows
    from deepspeed_tpu_torch.ops.sampling_cuda import fused_greedy_rows

    return {"flash_fwd": (flash_fwd, "wgmma", "scalar"),
            "flash_bwd_dq": (flash_bwd_dq, "wgmma", "scalar"),
            "flash_bwd_dkv": (flash_bwd_dkv, "wgmma", "scalar"),
            "paged_attention": (paged_chunk_attention, "sm90", "scalar"),
            "paged_attention_quant": (paged_chunk_attention_quant, "sm90",
                                      "scalar"),
            "paged_attention_v1": (paged_chunk_attention_v1, "sm90",
                                   "scalar"),
            "quantize": (quantize_rows, "vec", "vec"),
            "greedy_argmax": (fused_greedy_rows, "cluster", "cluster")}


def _check_bodies(path, hopper=True, record=True):
    """Every launch of the two-body kernels since the counts were set to 0
    went through the body they take on the Llama-3-8B paths (the Hopper
    bodies, B9's vector body, B6's cluster body), or on the tiny f32 paths
    (``hopper=False``); a main path's counts go into the kernels line."""
    for name, (f, hopper_body, f32_body) in _two_body_kernels().items():
        body = hopper_body if hopper else f32_body
        got = dict(f.body_launches)
        if record:
            BODIES.setdefault(name, {})[path] = got
            if hasattr(f, "dtype_launches"):
                DTYPES.setdefault(name, {})[path] = {
                    str(d)[6:]: n for d, n in f.dtype_launches.items()}
        if any(n for b, n in got.items() if b != body):
            raise SystemExit(f"{path}: {name} launches by body {got}, "
                             f"expected only {body}")


def phase_serving(kernels, card_line):
    from deepspeed_tpu_torch.models.llama import LlamaConfig, param_count
    from deepspeed_tpu_torch.weights import init_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[serving] llama3_8b layers={cfg.n_layers} dim={cfg.dim} "
        f"params={param_count(cfg)} bf16 random seeded weights, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens = np.linspace(128, 1024, 8).astype(int).tolist()
    prompts = {f"req{i}": rng.integers(1, cfg.vocab_size, n).tolist()
               for i, n in enumerate(lens)}
    opts = dict(max_batch=8, page_size=16, max_seq=2048, num_pages=1025,
                cache_dtype=torch.bfloat16)
    results, launches, outs = {}, {}, {}
    for chunk in (0, 256):
        path = f"serving prefill_chunk={chunk}"
        torch.cuda.reset_peak_memory_stats()
        _zero(k["fn"] for k in kernels)
        out, leaks, m = serve(params, cfg, prompts, 32, prefill_chunk=chunk,
                              **opts)
        launches[path] = {k["name"]: k["fn"].launches for k in kernels}
        _check_bodies(path)
        done = _valid(out, prompts, 32, cfg.vocab_size)
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[serving] prefill_chunk={chunk} prompts={lens} new=32: "
            f"finished {len(out)}/8 all_valid {done} check_leaks {leaks}; "
            f"tokens/s {m['tokens_per_s']:.2f} ttft_mean "
            f"{m['ttft_s_mean'] * 1e3:.1f} ms ttft_max "
            f"{m['ttft_s_max'] * 1e3:.1f} ms ms/decode_step "
            f"{m['ms_per_decode_step']} peak_mem {m['peak_mem_gb']:.1f} GB "
            f"on {card_line}; kernel launches {launches[path]}")
        if not done or leaks:
            raise SystemExit(f"serving run {path} failed")
        # whole-prompt prefill runs flash, paged (decode) and greedy;
        # chunked prefill runs paged (chunks and decode) and greedy and
        # never flash; serving never runs a training kernel
        _check_launches(path, launches[path],
                        [n for n in SERVING_KERNELS
                         if chunk == 0 or n != "flash_fwd"])
        results[chunk], outs[chunk] = m, out
    launches.update(phase_tier_serving(params, cfg, prompts, kernels,
                                       card_line))
    _lap("phases 5, 11 (serving, the tiered waves, the v1 arm)")
    launches.update(phase_control_plane_serving(params, cfg, kernels,
                                                card_line))
    _lap("phase_control_plane_serving (phase 60)")
    launches.update(phase_fleet(params, cfg, kernels, card_line))
    _lap("phase_fleet (phase 62)")
    # phase 14 builds its int8 engine from these weights and then frees
    # them: hand the only reference over
    holder = [params]
    del params
    launches.update(phase_int8_serving(holder, cfg, prompts, outs, results,
                                       kernels, card_line))
    return launches, results


# ------------------------------------------------------------ phase 11
def phase_tier_serving(params, cfg, v1_prompts, kernels, card_line):
    """The slice's main path at full width: an engine with ``prefix_cache``
    and an int8-resident ``kv_tier`` serves wave A (no hits), its warm pages
    demote to the host tier, and wave B on the same prefix promotes them
    back as int8 pages and runs its suffix chunks and decode through B7,
    every layer's K/V written by one launch of B9's fused entry.  Then the
    ``pallas_v1`` arm (B8, on B5's Hopper body) on phase 5's traffic."""
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine

    def zero():
        _zero(k["fn"] for k in kernels)

    def counts():
        return {k["name"]: k["fn"].launches for k in kernels}

    waves = _tier_waves(np.random.default_rng(1), cfg.vocab_size,
                        TIER_PREFIX, TIER_SUFFIX, 8)
    opts = dict(max_batch=8, page_size=16, max_seq=2048, num_pages=1025,
                cache_dtype=torch.bfloat16, prefill_chunk=256)
    torch.cuda.reset_peak_memory_stats()
    eng = llama_serving_engine(params, cfg, prefix_cache={},
                               kv_tier=dict(TIER_KV), **opts)
    c = eng.cache
    int8_bytes = sum(t.numel() * t.element_size()
                     for t in (c.k, c.v, c.k_scale, c.v_scale))
    bf16_bytes = 2 * c.k.numel() * 2
    log(f"[tier] llama3_8b layers={cfg.n_layers} bf16 weights, prefix_cache "
        f"{{}} kv_tier {TIER_KV} prefill_chunk=256 pages={c.k.shape[2]}: KV "
        f"pool int8 codes + scales {int8_bytes / 1e9:.4f} GB vs "
        f"{bf16_bytes / 1e9:.4f} GB bf16 for the same pages "
        f"({int8_bytes / bf16_bytes:.4f}x)")
    # where wave B's TTFT goes: host clock around the promotions and the
    # chunk forwards, each closed by a device sync (measurement only)
    spent = {"promote_s": 0.0, "chunk_s": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return r
        return run

    launches, al = {}, eng.allocator
    for w, wave in zip("AB", waves):
        path = f"tier wave {w}"
        before = (al.demoted, al.promoted, eng.kv_tier_quant_resident_promotes,
                  eng.prefix_cache_cached_tokens,
                  eng.prefix_cache_prompt_tokens)
        if w == "B":
            eng._complete_promotion = timed("promote_s",
                                            eng._complete_promotion)
            eng._chunk_prefill = timed("chunk_s", eng._chunk_prefill)
        zero()
        out, m = drive(eng, wave, TIER_NEW)
        launches[path] = counts()
        _check_bodies(path)
        if w == "A":
            t = time.perf_counter()
            eng.step()           # idle step: the watermark sweep demotes
            torch.cuda.synchronize()
            spent["demote_s"] = time.perf_counter() - t
        else:
            m.update(spent)
        d = [a - b for a, b in zip(
            (al.demoted, al.promoted, eng.kv_tier_quant_resident_promotes,
             eng.prefix_cache_cached_tokens,
             eng.prefix_cache_prompt_tokens), before)]
        m.update(demoted=d[0], promoted=d[1], quant_promotes=d[2],
                 cached_fraction=d[3] / d[4], leaks=eng.check_leaks(),
                 warm_after=len(al.pool),
                 tier_pages=len(eng._kv_pool.entries),
                 tier_bytes=eng._kv_pool.host_bytes)
        log(f"[tier] wave {w}: 8 prompts = {TIER_PREFIX} shared + "
            f"{TIER_SUFFIX} distinct tokens, {TIER_NEW} new: finished "
            f"{len(out)}/8 all_valid "
            f"{_valid(out, wave, TIER_NEW, cfg.vocab_size)} check_leaks "
            f"{m['leaks']}; ttft_mean {m['ttft_s_mean'] * 1e3:.1f} ms "
            f"ttft_max {m['ttft_s_max'] * 1e3:.1f} ms tokens/s "
            f"{m['tokens_per_s']:.2f} ms/decode_step "
            f"{m['ms_per_decode_step']} cached_fraction "
            f"{m['cached_fraction']:.4f} demoted {m['demoted']} promoted "
            f"{m['promoted']} quant_resident_promotes {m['quant_promotes']} "
            f"host tier {m['tier_pages']} pages {m['tier_bytes']} bytes; "
            f"host clock {spent} "
            f"B7 launches {launches[path]['paged_attention_quant']} B9 "
            f"launches {launches[path]['quantize']} on "
            f"{card_line}; kernel launches {launches[path]}")
        ok = _valid(out, wave, TIER_NEW, cfg.vocab_size) and not m["leaks"]
        if w == "A":
            ok = ok and m["demoted"] > 0 and m["warm_after"] == 0
        else:
            ok = ok and m["promoted"] > 0 and m["quant_promotes"] > 0 \
                and m["cached_fraction"] > 0
        if not ok:
            raise SystemExit(f"{path} failed")
        _check_launches(path, launches[path],
                        ("paged_attention_quant", "greedy_argmax",
                         "quantize"))
        # one fused K/V write a layer and forward: as many B9 launches as B7
        if launches[path]["quantize"] != launches[path][
                "paged_attention_quant"]:
            raise SystemExit(f"{path}: {launches[path]['quantize']} K/V "
                             f"writes for "
                             f"{launches[path]['paged_attention_quant']} "
                             f"B7 launches")
    log(f"[tier] peak_mem {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    # the timing wrappers hold bound methods of the engine they sit on: a
    # reference cycle that would keep the engine (its weights, its KV pool)
    # on the card until the cycle collector ran
    for name in ("_complete_promotion", "_chunk_prefill"):
        vars(eng).pop(name, None)
    del eng, c
    torch.cuda.empty_cache()

    path = "serving pallas_v1"
    zero()
    out, leaks, m = serve(params, cfg, v1_prompts, 32, prefill_chunk=0,
                          kernels={"paged_attention": "pallas_v1"},
                          max_batch=8, page_size=16, max_seq=2048,
                          num_pages=1025, cache_dtype=torch.bfloat16)
    launches[path] = counts()
    _check_bodies(path)
    done = _valid(out, v1_prompts, 32, cfg.vocab_size)
    log(f"[serving v1] prefill_chunk=0 kernels.paged_attention=pallas_v1 "
        f"phase 5 prompts: finished {len(out)}/8 all_valid {done} "
        f"check_leaks {leaks}; tokens/s {m['tokens_per_s']:.2f} ttft_mean "
        f"{m['ttft_s_mean'] * 1e3:.1f} ms ms/decode_step "
        f"{m['ms_per_decode_step']} B8 launches "
        f"{launches[path]['paged_attention_v1']} (by body "
        f"{BODIES['paged_attention_v1'][path]}) on {card_line}; kernel "
        f"launches {launches[path]}")
    if not done or leaks:
        raise SystemExit(f"{path} failed")
    _check_launches(path, launches[path],
                    ("flash_fwd", "paged_attention_v1", "greedy_argmax"))
    return launches


# ------------------------------------------------------------ phase 60
# the control plane on the serving engine: 16 distinct prompts a wave, of
# 300-700 tokens (prefill_chunk 256: two or three chunks), 16 new tokens,
# on phase 5's first 8 layers (32 before phases 65-67: the smoke's time)
CP_PROMPTS, CP_NEW, CP_LO, CP_HI = 16, 16, 300, 700
CP_LAYERS = 8
CP_SLO = {"tiers": {"interactive": {"ttft_s": 60.0, "deadline_s": 600.0,
                                    "target": 0.9},
                    "batch": {"deadline_s": 600.0, "target": 0.5}},
          "default_tier": "interactive"}
# three named requests fail in their slots: A3 at its first opportunity
# (mid prefill), A5 and A6 later (in decode); every demote is corrupted
# after its crc was recorded
CP_FAULTS = {"seed": 22, "rules": [
    {"subsystem": "slot", "match": "A3", "count": 1},
    {"subsystem": "slot", "match": "A5", "after": 6, "count": 1},
    {"subsystem": "slot", "match": "A6", "after": 10, "count": 1},
    {"subsystem": "kv_corrupt"}]}
CP_SHED_DEPTH = 12
# the JAX engine's /statusz, /healthz and /requestz keys
STATUSZ_KEYS = (
    "schema_version", "wire_schema", "t_wall", "t_mono_ns", "engine",
    "replica", "weights_version", "t", "uptime_s", "last_step_age_s",
    "max_batch", "active_slots", "slots", "queue",
    "finished_pending_drain", "kv", "prefix_cache", "kv_tier",
    "speculative", "mesh", "kernels", "history", "incidents", "devprof",
    "telemetry", "slo", "robustness", "metrics")
HEALTHZ_KEYS = ("wire_schema", "t_wall", "t_mono_ns", "alive", "ready",
                "replica", "uptime_s", "last_step_age_s", "queue_depth",
                "active_slots", "watchdog", "degraded", "reasons")
REQUESTZ_KEYS = ("req", "found", "state", "slot", "tracing_enabled",
                 "events")


def _cp_blocks(tmp):
    """Every block of the control-plane slice, on."""
    return dict(
        telemetry={"enabled": True},
        tracing={"sample_rate": 1.0, "dump_dir": os.path.join(tmp, "flight")},
        slo=CP_SLO, shed_queue_depth=CP_SHED_DEPTH,
        shed_expired_deadline=True,
        history={"sample_interval_s": 0.5},
        incidents={"eval_interval_s": 0.5,
                   "dir": os.path.join(tmp, "incidents")},
        devprof={"sample_rate": 1.0}, faults=CP_FAULTS)


def _cp_wave(eng, wave, new, late=None):
    """Submit a wave at once (``late``: one id submitted first, its arrival
    1000 s in the past, on the batch tier) and step until it drains;
    returns every id's typed result and the wave's timing."""
    sheds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (rid, p) in enumerate(wave.items()):
        kw = {}
        if rid == late:
            kw = dict(tier="batch", arrival=time.perf_counter() - 1000.0)
        elif i % 2:
            kw = dict(tier="batch")
        if getattr(eng, "_slo_on", False) is False:
            kw = {}
        sheds += eng.submit(rid, p, max_new_tokens=new, **kw) is not None
    decode_only = []
    while eng.has_work:
        chunks, queued = eng.prefill_chunks, len(eng.queue)
        busy = [s is not None for s in eng.slots]
        ts = time.perf_counter()
        eng.step()
        if (eng.prefill_chunks == chunks and len(eng.queue) == queued
                and busy == [s is not None for s in eng.slots]):
            decode_only.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    return {rid: eng.finished[rid] for rid in wave}, {
        "wall_s": time.perf_counter() - t0, "shed_at_submit": sheds,
        "ms_per_decode_step": (float(np.median(decode_only)) * 1e3
                               if decode_only else None),
        "decode_only_steps": len(decode_only)}


def _cp_paired(engines, wave, new):
    """Serve one wave on each engine, a step of each in turn and the order
    flipped every round, so that the host's drift falls on all alike;
    returns each engine's typed results and its decode-only steps' ms."""
    for eng in engines:
        for rid, p in wave.items():
            eng.submit(rid, p, max_new_tokens=new)
    steps = [[] for _ in engines]
    turn = list(range(len(engines)))
    while any(e.has_work for e in engines):
        for i in turn:
            eng = engines[i]
            if not eng.has_work:
                continue
            queued, busy = len(eng.queue), [s is not None for s in eng.slots]
            ts = time.perf_counter()
            eng.step()
            if (len(eng.queue) == queued
                    and busy == [s is not None for s in eng.slots]):
                steps[i].append((time.perf_counter() - ts) * 1e3)
        turn.reverse()
    return [({rid: e.finished[rid] for rid in wave}, ms)
            for e, ms in zip(engines, steps)]


def _cp_reconcile(eng, typed):
    """Finished, failed and shed counts against the submissions, in the
    typed results, the telemetry counters and the SLO tracker."""
    from deepspeed_tpu_torch.inference.serving import (RequestFailed,
                                                       RequestShed)

    n_tok = sum(isinstance(v, list) for v in typed.values())
    n_shed = sum(isinstance(v, RequestShed) for v in typed.values())
    n_fail = sum(isinstance(v, RequestFailed) for v in typed.values())
    c = eng.registry.snapshot()["counters"]
    life = [t["lifetime"] for t in
            eng.slo_tracker.snapshot()["tiers"].values()]
    got = {"submitted": len(typed), "finished": n_tok, "shed": n_shed,
           "failed": n_fail,
           "counter_shed": c.get("serving_shed_requests", 0),
           "counter_failed": c.get("serving_failed_requests", 0),
           "slo_shed": sum(x["shed"] for x in life),
           "slo_failed": sum(x["failed"] for x in life),
           "slo_classified": sum(x["attained"] + x["violated"]
                                 for x in life)}
    ok = (n_tok + n_shed + n_fail == len(typed)
          and got["counter_shed"] == got["slo_shed"] == n_shed
          and got["counter_failed"] == got["slo_failed"] == n_fail
          and got["slo_classified"] == n_tok + n_fail)
    return ok, got


def _cp_documents(eng, rid):
    """statusz / healthz / requestz / historyz / profilez: each parses as
    JSON and carries the JAX engine's keys."""
    docs = {"statusz": eng.statusz(), "healthz": eng.healthz(),
            "requestz": eng.requestz(rid), "historyz": eng.historyz(),
            "profilez": eng.profilez()}
    for name, doc in docs.items():
        json.loads(json.dumps(doc))
    missing = {n: [k for k in keys if k not in docs[n]] for n, keys in (
        ("statusz", STATUSZ_KEYS), ("healthz", HEALTHZ_KEYS),
        ("requestz", REQUESTZ_KEYS))}
    return docs, {n: m for n, m in missing.items() if m}


def _first_layers(params, cfg, n):
    """A stacked Llama tree's first ``n`` layers (views of its blocks, no
    copy) and the config of that depth."""
    import dataclasses

    return (dict(params, blocks={k: v[:n]
                                 for k, v in params["blocks"].items()}),
            dataclasses.replace(cfg, n_layers=n))


def phase_control_plane_serving(params, cfg, kernels, card_line):
    """Phase 60: the control plane of one serving process at Llama-3-8B full
    width on phase 5's weights (bf16) cut to their first CP_LAYERS layers
    (views), prefix cache and host KV tier on.

    (a) Two waves of the same 16 distinct prompts, the second after an idle
    step that demotes every warm page, on the engine with every block of
    the slice on (telemetry, tracing, two SLO tiers with deadlines and
    deadline shedding, queue-depth shedding at 12 of a burst of 16,
    history, incidents, devprof sampling every phase, and a seeded fault
    plan: three named slot failures, every demote corrupted), and wave A
    on the same engine with the blocks off.  Gates: the survivors' tokens
    equal the blocks-off engine's (wave B, whose demoted pages all fail
    their crc and re-prefill from the span's first page, against the
    blocks-off engine's fresh prefill of the same prompt); the three
    targets fail as ``slot_exception`` (one before its first token);
    check_leaks is empty; the counts reconcile across the typed results,
    the telemetry counters and the SLO tracker; the documents carry JAX's
    keys; devprof's device seconds come from CUDA events.  (b) The blocks'
    cost on the same traffic: the 16 prompts cut to 300 tokens, whole-
    prompt prefill (B1), an engine with every block on but the faults and
    the queue-depth shed (nothing is shed or failed) and one with the
    blocks off, stepped in turn: identical tokens and schedules, and the
    decode step times side by side.  (c) An
    int8-resident wave pair of 4 prompts
    under the same kv_corrupt rule (B9 writes, B7 reads): wave B
    re-prefills to wave A's tokens."""
    import tempfile

    from deepspeed_tpu_torch.inference.serving import (RequestFailed,
                                                       RequestShed,
                                                       llama_serving_engine)

    def zero():
        _zero(k["fn"] for k in kernels)

    def counts():
        return {k["name"]: k["fn"].launches for k in kernels}

    params, cfg = _first_layers(params, cfg, CP_LAYERS)
    rng = np.random.default_rng(60)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(CP_LO, CP_HI, CP_PROMPTS)]
    waves = [{f"{w}{i}": p for i, p in enumerate(prompts)} for w in "AB"]
    opts = dict(max_batch=8, page_size=16, max_seq=1024, num_pages=1025,
                cache_dtype=params["embed"].dtype, prefill_chunk=256,
                prefix_cache={})
    kvt = {"demote_watermark": 0.0, "host_pool_bytes": 4 << 30}
    tmp = tempfile.mkdtemp(prefix="dstt_cp_")
    launches, res, metrics = {}, {}, {}
    for arm in ("off", "on"):
        blocks = (_cp_blocks(tmp) if arm == "on"
                  else dict(telemetry=False, tracing=False))
        path = f"control plane serving ({arm})"
        eng = llama_serving_engine(params, cfg, kv_tier=dict(kvt),
                                   **blocks, **opts)
        try:
            zero()
            out_a, m_a = _cp_wave(eng, waves[0], CP_NEW,
                                  late="A0" if arm == "on" else None)
            out_b, m_b = {}, {"wall_s": 0.0}
            if arm == "on":            # the blocks-off wave A is the oracle
                eng.step()             # idle: the watermark demotes all
                out_b, m_b = _cp_wave(eng, waves[1], CP_NEW)
            launches[path] = counts()
            _check_bodies(path)
            leaks = eng.check_leaks()
            typed = {**out_a, **out_b}
            res[arm] = typed
            metrics[arm] = {"A": m_a, "B": m_b, "leaks": leaks,
                            "checksum_failures":
                                eng.kv_tier_checksum_failures,
                            "fallback_events": eng.kv_tier_fallback_events,
                            "promoted": eng.allocator.promoted,
                            "demoted": eng.allocator.demoted}
            if arm == "on":
                ok_count, recon = _cp_reconcile(eng, typed)
                docs, missing = _cp_documents(eng, "A1")
                plan = eng._fault_plan.snapshot()
                dev = docs["profilez"]
                c = docs["statusz"]["metrics"]["counters"]
                dev["decode_ms_per_chunk"] = (
                    dev["device_seconds"]["decode"] * 1e3
                    / max(c["serving_decode_syncs"], 1))
                metrics["on"].update(reconcile=recon, reconcile_ok=ok_count,
                                     missing_keys=missing,
                                     faults=plan, devprof=dev,
                                     degraded=docs["healthz"]["reasons"])
        finally:
            eng.shutdown()
            del eng
            torch.cuda.empty_cache()
    on, off = res["on"], res["off"]
    failed = {r: v for r, v in on.items() if isinstance(v, RequestFailed)}
    shed = {r: v.reason for r, v in on.items() if isinstance(v, RequestShed)}
    # survivors against the blocks-off engine: wave A by id; wave B
    # re-prefilled from page 0 against the fresh prefill of its prompt
    mismatched = [r for r, v in on.items() if isinstance(v, list) and v != (
        off[r] if r[0] == "A" else off["A" + r[1:]])]
    m = metrics["on"]
    dev = m["devprof"]
    log(f"[control plane] llama3_8b layers={cfg.n_layers} bf16, "
        f"prefix_cache + host kv_tier {kvt}, prefill_chunk=256, "
        f"{CP_PROMPTS} prompts of {CP_LO}-{CP_HI} tokens a wave x 2 "
        f"waves, {CP_NEW} new: failed {sorted(failed)} (generated "
        f"{ {r: v.generated for r, v in failed.items()} }), shed {shed}, "
        f"survivors {sum(isinstance(v, list) for v in on.values())}, "
        f"tokens differing from the blocks-off engine {mismatched}; "
        f"reconcile {m['reconcile']}; "
        f"kv_tier checksum failures {m['checksum_failures']} fallback "
        f"events {m['fallback_events']} promoted {m['promoted']} (off: "
        f"{metrics['off']['promoted']}) demoted {m['demoted']}; faults "
        f"fired {m['faults']['injected']} of {m['faults']['opportunities']}"
        f"; degraded {m['degraded']}; check_leaks on {m['leaks']} off "
        f"{metrics['off']['leaks']}; missing document keys "
        f"{m['missing_keys']}")
    log(f"[control plane] devprof (CUDA events, every phase sampled): "
        f"device seconds {dev['device_seconds']} ("
        f"{dev['decode_ms_per_chunk']:.3f} ms a decode chunk) host-device gap "
        f"{dev['host_device_gap_s']} mfu {dev['mfu']} mbu {dev['mbu']} "
        f"compiles warmup {dev['compiles_warmup']} steady "
        f"{dev['compiles_steady']}")
    log(f"[control plane] decode step wave A (not one traffic: the on arm "
        f"sheds and fails requests; (b) reads the cost): blocks on "
        f"{m['A']['ms_per_decode_step']} ms ({m['A']['decode_only_steps']} "
        f"decode-only steps), off {metrics['off']['A']['ms_per_decode_step']}"
        f" ms ({metrics['off']['A']['decode_only_steps']}); wave walls on "
        f"{m['A']['wall_s']:.2f} / {m['B']['wall_s']:.2f} s, off "
        f"{metrics['off']['A']['wall_s']:.2f} s on {card_line}; kernel "
        f"launches {launches}")
    ok = (sorted(failed) == ["A3", "A5", "A6"]
          and all(v.reason == "slot_exception" for v in failed.values())
          and failed["A3"].generated == 0
          and failed["A5"].generated > 0 and failed["A6"].generated > 0
          and shed.get("A0") == "deadline"
          and sum(r == "queue_depth" for r in shed.values()) == 8
          and not mismatched and m["reconcile_ok"] and not m["leaks"]
          and not metrics["off"]["leaks"] and not m["missing_keys"]
          and m["checksum_failures"] > 0
          and m["checksum_failures"] == m["fallback_events"]
          and dev["device_seconds"]["decode"] > 0
          and dev["device_seconds"]["prefill"] > 0)
    if not ok:
        raise SystemExit("phase 60 (control plane serving) failed")
    for path in launches:
        _check_launches(path, launches[path],
                        ("paged_attention", "greedy_argmax"))

    # (b) the blocks' cost on the same traffic: whole-prompt prefill (B1),
    # every block on but the faults and the queue-depth shed, against off
    short = {f"W{i}": p[:CP_LO] for i, p in enumerate(prompts)}
    path = "control plane whole-prompt (off and on, paired)"
    on_blocks = {k: v for k, v in _cp_blocks(tmp).items()
                 if k not in ("faults", "shed_queue_depth")}
    pair = [llama_serving_engine(params, cfg, **blocks, **dict(
        opts, prefill_chunk=0, prefix_cache=None))
        for blocks in (dict(telemetry=False, tracing=False), on_blocks)]
    try:
        zero()
        (out_off, ms_off), (out_on, ms_on) = _cp_paired(pair, short, CP_NEW)
        launches[path] = counts()
        _check_bodies(path)
        _check_launches(path, launches[path], SERVING_KERNELS)
        leaks = [e.check_leaks() for e in pair]
    finally:
        for e in pair:
            e.shutdown()
        del pair
    ratios = [a / b for a, b in zip(ms_on, ms_off)]
    log(f"[control plane] the blocks' cost on the same traffic ({len(short)} "
        f"prompts of {CP_LO} tokens, whole-prompt prefill, {CP_NEW} new; "
        f"every block on but faults and queue-depth shedding, against off; "
        f"the two engines stepped in turn, the order flipped each round): "
        f"decode-only steps on {len(ms_on)} off {len(ms_off)}; ms a decode "
        f"step on median {float(np.median(ms_on))} off "
        f"{float(np.median(ms_off))}; on / off step by step: median "
        f"{float(np.median(ratios))} quartiles "
        f"{[float(q) for q in np.percentile(ratios, [25, 75])]} on "
        f"{card_line}; tokens identical {out_on == out_off}; check_leaks "
        f"{leaks}")
    if out_on != out_off or any(leaks) or not all(
            isinstance(v, list) for v in out_on.values()):
        raise SystemExit("phase 60 (b): the blocks changed the tokens, or "
                         "an engine leaked")

    # (c) int8-resident pages under the same kv_corrupt rule
    path = "control plane int8-resident"
    eng = llama_serving_engine(
        params, cfg, kv_tier=dict(TIER_KV, host_pool_bytes=1 << 30),
        faults={"rules": [{"subsystem": "kv_corrupt"}]},
        **dict(opts, max_seq=1024))
    try:
        zero()
        wa = {f"QA{i}": p for i, p in enumerate(prompts[:4])}
        wb = {f"QB{i}": p for i, p in enumerate(prompts[:4])}
        out_a, _ = _cp_wave(eng, wa, CP_NEW)
        eng.step()
        out_b, _ = _cp_wave(eng, wb, CP_NEW)
        launches[path] = counts()
        _check_bodies(path)
        _check_launches(path, launches[path],
                        ("paged_attention_quant", "greedy_argmax",
                         "quantize"))
        same = all(out_b["QB" + r[2:]] == v for r, v in out_a.items())
        q = (eng.kv_tier_checksum_failures, eng.kv_tier_fallback_events,
             eng.check_leaks())
    finally:
        eng.shutdown()
        del eng
        torch.cuda.empty_cache()
    log(f"[control plane] int8-resident waves under kv_corrupt: wave B "
        f"equal to wave A {same}, checksum failures {q[0]} fallback events "
        f"{q[1]} check_leaks {q[2]}; B7 launches "
        f"{launches[path]['paged_attention_quant']} B9 launches "
        f"{launches[path]['quantize']}")
    if not (same and q[0] > 0 and q[0] == q[1] and not q[2]):
        raise SystemExit("phase 60 (c) failed")
    return launches


# ------------------------------------------------------------ phase 14
def phase_int8_serving(holder, cfg, prompts, bf16_outs, bf16_metrics,
                       kernels, card_line):
    """Weight-only int8 serving at full width: ``llama_serving_engine(...,
    weight_dtype="int8")`` quantizes phase 5's bf16 weights on the card
    (B9, one launch per matrix leaf), the bf16 tree (``holder``'s only
    item) is freed, and phase 5's traffic is served with whole-prompt and
    chunked prefill.  The chunked engine takes the first engine's quantized
    tree (it passes through unquantized-again), and so does
    ``init_inference(dtype="int8")`` with llama's forward for one forward
    of the longest prompt, whose peak memory shows that no bf16 copy of the
    model is made."""
    from deepspeed_tpu_torch.inference.quantized import param_bytes
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine

    def zero():
        _zero(k["fn"] for k in kernels)

    def counts():
        return {k["name"]: k["fn"].launches for k in kernels}

    opts = dict(max_batch=8, page_size=16, max_seq=2048, num_pages=1025,
                cache_dtype=torch.bfloat16)
    bf16_bytes = param_bytes(holder[0])
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = llama_serving_engine(holder[0], cfg, weight_dtype="int8",
                               prefill_chunk=0, **opts)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    launches["int8 build"] = counts()
    _check_bodies("int8 build")
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    holder.clear()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    int8_bytes = param_bytes(eng.params)
    log(f"[int8] llama3_8b weight_dtype=int8 groups of 128: build "
        f"{build_ms:.1f} ms, B9 launches {launches['int8 build']['quantize']}"
        f" (9 matrix leaves); resident weights {int8_bytes / 1e9:.4f} GB vs "
        f"{bf16_bytes / 1e9:.4f} GB bf16 ({int8_bytes / bf16_bytes:.4f}x); "
        f"build peak_mem {build_peak:.1f} GB, resident after freeing bf16 "
        f"{resident / 1e9:.1f} GB on {card_line}")
    _check_launches("int8 build", launches["int8 build"], ("quantize",))
    # the int8 tree and this engine's KV pool: were anything still holding
    # the bf16 tree, the card would hold more than its 16 GB
    if launches["int8 build"]["quantize"] != 9 or not (
            0.5 < int8_bytes / bf16_bytes < 0.53) or resident >= bf16_bytes:
        raise SystemExit("int8 build: wrong launch count or residency")
    first = {}
    for chunk in (0, 256):
        path = f"int8 serving prefill_chunk={chunk}"
        if chunk:
            qparams = eng.params
            del eng
            torch.cuda.empty_cache()
            eng = llama_serving_engine(qparams, cfg, weight_dtype="int8",
                                       prefill_chunk=chunk, **opts)
            del qparams
        torch.cuda.reset_peak_memory_stats()
        zero()
        out, m = drive(eng, prompts, 32)
        launches[path] = counts()
        _check_bodies(path)
        leaks = eng.check_leaks()
        done = _valid(out, prompts, 32, cfg.vocab_size)
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        gen = [(t, u) for r in prompts
               for t, u in zip(out[r][len(prompts[r]):],
                               bf16_outs[chunk][r][len(prompts[r]):])]
        same = sum(t == u for t, u in gen) / len(gen)
        b = bf16_metrics[chunk]
        lens = [len(p) for p in prompts.values()]
        log(f"[int8] prefill_chunk={chunk} prompts={lens} new=32: finished "
            f"{len(out)}/8 all_valid "
            f"{done} check_leaks {leaks}; tokens/s {m['tokens_per_s']:.2f} "
            f"(bf16 {b['tokens_per_s']:.2f}) ttft_mean "
            f"{m['ttft_s_mean'] * 1e3:.1f} ms (bf16 "
            f"{b['ttft_s_mean'] * 1e3:.1f}) ttft_max "
            f"{m['ttft_s_max'] * 1e3:.1f} ms ms/decode_step "
            f"{m['ms_per_decode_step']} (bf16 {b['ms_per_decode_step']}) "
            f"peak_mem {m['peak_mem_gb']:.1f} GB; greedy tokens equal to "
            f"bf16's {same:.4f} (informational) on {card_line}; kernel "
            f"launches {launches[path]}")
        if not done or leaks:
            raise SystemExit(f"{path} failed")
        _check_launches(path, launches[path],
                        [n for n in SERVING_KERNELS
                         if chunk == 0 or n != "flash_fwd"])
        first[chunk] = {r: out[r][len(prompts[r])] for r in prompts}
    qparams = eng.params
    del eng
    torch.cuda.empty_cache()
    launches.update(_int8_init_inference(qparams, cfg, prompts, first[0],
                                         zero, counts, card_line))
    return launches


def _int8_init_inference(qparams, cfg, prompts, first, zero, counts,
                         card_line):
    """``init_inference(dtype="int8")`` over the int8 engine's tree with
    llama's forward: one forward of the longest prompt, its time, launches
    and peak memory.  Its dense
    ``[L, d]`` norm gains quantize there (two B9 launches), as the JAX
    engine quantizes them."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import llama

    rid = max(prompts, key=lambda r: len(prompts[r]))
    toks = torch.tensor([prompts[rid]], dtype=torch.long, device="cuda")
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ie = init_inference(apply_fn=functools.partial(llama.forward, cfg=cfg),
                        params=qparams, dtype="int8")
    logits = ie(toks)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    path = "int8 init_inference"
    used = counts()
    _check_bodies(path)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ok = (tuple(logits.shape) == (1, toks.shape[1], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()))
    same = int(logits[0, -1].argmax()) == first[rid]
    log(f"[int8] init_inference(dtype=int8) with llama.forward over the "
        f"int8 tree, one forward of [1, {toks.shape[1]}]: {ms:.1f} ms "
        f"(build included), logits finite of shape {ok}, peak_mem "
        f"{peak:.2f} GB with {resident:.2f} GB resident before; B9 "
        f"launches {used['quantize']} (the [L, d] norm gains); first token "
        f"equal to the int8 engine's {same} (informational) on "
        f"{card_line}; kernel launches {used}")
    del ie, logits
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"{path} failed")
    _check_launches(path, used, ("flash_fwd", "quantize"))
    return {path: used}


# ------------------------------------------------------------ phase 6
def _segments(T, n, device="cuda"):
    """[1, T] int32 packed segment ids: n segments of near-equal length."""
    bounds = np.linspace(0, T, n + 1).astype(int)
    seg = np.zeros((1, T), np.int32)
    for i in range(n):
        seg[0, bounds[i]:bounds[i + 1]] = i + 1
    return torch.from_numpy(seg).to(device), np.diff(bounds).tolist()


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _bf16_order(x):
    """bf16 -> int32 keys in the values' order (-0 and +0 both 0)."""
    bits = x.view(torch.int16).to(torch.int32) & 0xFFFF
    mag = bits & 0x7FFF
    return torch.where(bits >= 0x8000, -mag, mag)


def _bf16_from_order(key, dtype=torch.bfloat16):
    bits = torch.where(key < 0, 0x8000 | (-key), key)
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(
        torch.int16).view(dtype)


def bf16_neighbour(got, exact):
    """bool per element: the 16-bit ``got`` (bf16 or fp16: both keep sign
    and magnitude in the same bit order) is one of the two values of its
    dtype around the f64 ``exact`` (equal to it, or no value of the dtype
    lies strictly between them)."""
    g = got.double()
    step = torch.sign(exact - g).to(torch.int32)
    nxt = _bf16_from_order(_bf16_order(got) + step, got.dtype).double()
    return (g == exact) | ((g - exact) * (nxt - exact) < 0)


def flash_bwd_f64_oracle(q, k, v, o, lse, do, seg, causal=True,
                         once=False):
    """(dq, dq_spec, dk, dv) in f64 from the kernels' own inputs: p =
    exp(q.k * scale - lse), delta = rowsum(o * dO), ds = p * (dO.V^T -
    delta) * scale, dq = ds.K, dk = ds^T.Q, dv = p^T.dO over each kv head's
    group; dq_spec takes ds rounded to q's dtype first.  ``once``: also
    (dk, dv) with p and ds each rounded once to q's dtype before the f64
    products (what one 16-bit product a tile without bf16's hi + lo split,
    B3's fp16 arithmetic, gives up to the order of the f32 sums)."""
    from deepspeed_tpu_torch.ops.attention_cuda import _live_mask

    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / D ** 0.5
    qd, od, dod = q.double(), o.double(), do.double()
    kd = k.double().repeat_interleave(G, dim=2)
    vd = v.double().repeat_interleave(G, dim=2)
    s = torch.einsum("bthd,bshd->bhts", qd, kd) * scale
    live = _live_mask(B, T, S, causal, seg, q.device)
    p = torch.exp(s - lse.double()[..., None]).masked_fill(~live, 0.0)
    del s
    delta = (od * dod).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bthd,bshd->bhts", dod, vd)
              - delta[..., None]) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, kd)
    dq_spec = torch.einsum("bhts,bshd->bthd", ds.to(q.dtype).double(), kd)
    dk = torch.einsum("bhts,bthd->bshd", ds, qd).reshape(
        B, S, KV, G, D).sum(3)
    dv = torch.einsum("bhts,bthd->bshd", p, dod).reshape(
        B, S, KV, G, D).sum(3)
    if not once:
        return dq, dq_spec, dk, dv
    dk1 = torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).double(),
                       qd).reshape(B, S, KV, G, D).sum(3)
    dv1 = torch.einsum("bhts,bthd->bshd", p.to(q.dtype).double(),
                       dod).reshape(B, S, KV, G, D).sum(3)
    return dq, dq_spec, dk, dv, dk1, dv1


def _faithful_over_gate(got, want, exacts, tol):
    """The elements of ``got`` over the flash backward's gate (|got - want|
    > tol * max|want|): their count, and whether the kernel holds every
    one of them at a bf16 neighbour of one of the f64 ``exacts`` (a
    faithful rounding: the plain version and the kernel one ulp apart in
    the top binade, ROADMAP C-f6)."""
    over = (got.float() - want.float()).abs() > tol * want.float().abs().max()
    n = int(over.sum())
    return n, n == 0 or any(bool(bf16_neighbour(got[over], x[over]).all())
                            for x in exacts)


def _sdpa_bwd(q, k, v, do, seg=None, causal=True):
    """SDPA's backward (dq, dk, dv together, with its own O.dO pass) on the
    same GQA inputs (causal or not; with segment ids, under their boolean
    block-diagonal mask), as a function of no arguments, or None on a
    PyTorch without ``enable_gqa``.  A yardstick only: the port never calls
    it."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **_sdpa_mask(seg, causal))
    except TypeError:                   # a PyTorch without enable_gqa
        return None
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def phase_backward(gen):
    """B2 and B3 against their plain version at the training shape (T =
    2047, causal, and with 3 packed segments), on the tensor-core body: B2's
    delta against ``flash_delta`` (the plain O.dO reduction), dq, dk and dv
    against the plain backward; each kernel timed on the device clock and
    with events (B2 with delta inside), their sum beside SDPA's backward
    (under the segments' mask where there are segments)."""
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd_body, flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference,
        flash_delta, flash_fwd, flash_fwd_reference)

    B, T, H, KV, D = 1, 2047, 32, 8, 128
    dt = torch.bfloat16
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dt)
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dt)
    body = flash_bwd_body(q)
    if body != "wgmma":
        raise SystemExit("phase 6: the training shape does not take the "
                         "tensor-core body")
    shapes, errs = {}, {}
    for label, nseg in (("causal", 0), ("causal + 3 segments", 3)):
        seg, lens = _segments(T, nseg) if nseg else (None, [T])
        o, lse = flash_fwd(q, k, v, seg=seg)
        ro, rlse = flash_fwd_reference(q, k, v, seg=seg)
        dq, delta = flash_bwd_dq(q, k, v, o, do, lse, seg)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seg)
        want = flash_bwd_reference(q, k, v, o, lse, do, seg)
        want_delta = flash_delta(o, do)
        torch.cuda.synchronize()
        err = {"o": (o.float() - ro.float()).abs().max().item(),
               "lse": (lse - rlse).abs().max().item(),
               "delta": (delta - want_delta).abs().max().item(),
               "delta_rel": _rel(delta, want_delta)}
        for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            err[name] = (g.float() - w.float()).abs().max().item()
            err[name + "_rel"] = _rel(g, w)
        errs[label] = err
        del dq, dk, dv, want, want_delta, ro, rlse
        fn_dq = functools.partial(flash_bwd_dq, q, k, v, o, do, lse, seg)
        fn_dkv = functools.partial(flash_bwd_dkv, q, k, v, do, lse, delta,
                                   seg)
        t = {"dq": time_ms(fn_dq, iters=10), "dkv": time_ms(fn_dkv, iters=10),
             "dq_device": device_ms(fn_dq, iters=10),
             "dkv_device": device_ms(fn_dkv, iters=10)}
        t["plain"] = time_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do,
                                                         seg),
                             iters=3, warmup=1)
        sdpa = _sdpa_bwd(q, k, v, do, seg)
        t["library"] = sdpa and time_ms(sdpa, iters=10)
        t["library_device"] = sdpa and device_ms(sdpa, iters=10)
        del sdpa
        # live (query, key) pairs of this data: causal within each segment
        pairs = sum(n * (n + 1) // 2 for n in lens)
        io = 2 * (2 * B * T * H * D + 2 * B * T * KV * D)   # q, do, k, v
        # B2 also reads O and writes delta (2 flops a product of O.dO)
        b_dq = bound(io + 2 * 2 * B * T * H * D + 8 * B * H * T,
                     6 * D * pairs * H * B + 2 * B * T * H * D,
                     BF16_FLOPS_PER_S)
        b_dkv = bound(io + 2 * 2 * B * T * KV * D + 8 * B * H * T,
                      8 * D * pairs * H * B, BF16_FLOPS_PER_S)
        ours = (None if None in (t["dq_device"], t["dkv_device"])
                else t["dq_device"] + t["dkv_device"])
        t["ratio"] = (ours / t["library_device"]
                      if ours and t["library_device"] else None)
        log(f"[flash bwd] B={B} T={T} H={H} KV={KV} D={D} bf16 {label}, "
            f"body {body}: o err {err['o']:.3e} lse err {err['lse']:.3e}; "
            f"delta err {err['delta']:.3e} (rel {err['delta_rel']:.3e}, tol "
            f"{FLASH_DELTA_REL_TOL}); dq "
            f"err {err['dq']:.3e} (rel {err['dq_rel']:.3e}) dk err "
            f"{err['dk']:.3e} (rel {err['dk_rel']:.3e}) dv err {err['dv']:.3e}"
            f" (rel {err['dv_rel']:.3e}) (rel tol {FLASH_BWD_REL_TOL}); dq "
            f"kernel {t['dq']:.5f} ms (device {t['dq_device']}) bound "
            f"{b_dq[0]:.5f} ms ({b_dq[1]}); dkv kernel {t['dkv']:.5f} ms "
            f"(device {t['dkv_device']}) bound {b_dkv[0]:.5f} ms "
            f"({b_dkv[1]}); dq (with delta) + dkv device {ours} ms; plain "
            f"bwd {t['plain']:.4f} ms; sdpa bwd {t['library']} ms (device "
            f"{t['library_device']}); ours / sdpa device {t['ratio']}")
        shapes[label] = dict(t, bound_dq=b_dq, bound_dkv=b_dkv)
        del o, lse, delta, fn_dq, fn_dkv
        torch.cuda.empty_cache()
    worst = {n: max(e[n + "_rel"] for e in errs.values())
             for n in ("dq", "dk", "dv")}
    fwd_ok = all(e["o"] <= FLASH_TOL and e["lse"] <= 1e-3
                 for e in errs.values())
    if max(e["delta_rel"] for e in errs.values()) > FLASH_DELTA_REL_TOL:
        raise SystemExit("B2's delta disagrees with the plain O.dO reduction")
    if not fwd_ok or max(worst.values()) > FLASH_BWD_REL_TOL:
        raise SystemExit("flash backward disagrees with its plain version")
    rows = {}
    for name, key, line, grads in (("flash_bwd_dq", "dq", 97, ("dq",)),
                                   ("flash_bwd_dkv", "dkv", 145,
                                    ("dk", "dv"))):
        per = {label: {
            "ms": r[key], "device_ms": r[key + "_device"],
            "plain_ms": r["plain"], "library_ms": r["library"],
            "library_device_ms": r["library_device"],
            "b2_b3_over_library_device": r["ratio"],
            "bound_ms": r["bound_" + key][0], "bound_by": r["bound_" + key][1],
            "max_abs_err": max(errs[label][n] for n in grads),
            "rel_err": max(errs[label][n + "_rel"] for n in grads)}
            for label, r in shapes.items()}
        rows[name] = dict(
            per["causal"], name=name, body=body, training_shape=per,
            source="deepspeed_tpu_torch/csrc/flash_bwd_sm90.cuh",
            replaces=f"deepspeed_tpu/ops/attention_pallas.py:{line}",
            max_abs_err=max(r["max_abs_err"] for r in per.values()))
    return rows


def _fused_adamw_ms(n, gen, device_clock=False):
    """``torch._fused_adamw_`` on an f32 leaf of n elements, timed as a
    yardstick only (the port never calls it): events, and with
    ``device_clock`` the device clock too."""
    if not hasattr(torch, "_fused_adamw_"):
        return None, None
    p, g, m = (torch.randn((n,), generator=gen, device="cuda")
               for _ in range(3))
    v = m.abs()
    step = torch.ones((), device="cuda")
    fn = functools.partial(
        torch._fused_adamw_, [p], [g], [m], [v], [], [step], lr=1e-3,
        beta1=0.9, beta2=0.999, weight_decay=0.1, eps=1e-8, amsgrad=False,
        maximize=False)
    return (time_ms(fn, iters=10),
            device_ms(fn, iters=10) if device_clock else None)


def phase_adam(gen):
    from deepspeed_tpu_torch.ops.adam_cuda import (adam_scalars, adam_update,
                                                   adam_update_reference)

    c1, c2 = adam_scalars(0.9, 0.999, 9)
    row, worst = None, 0.0
    # the 525 M leaf is the LM head (4096 x 128256); the train step hands
    # the kernel f32 grads (its accumulators) and f32 master params
    for n in (2_100_000, 4096 * 128256):
        for g_dt in (torch.bfloat16, torch.float32):
            g = torch.randn((n,), generator=gen, device="cuda").to(g_dt)
            p = torch.randn((n,), generator=gen, device="cuda")
            m = torch.randn((n,), generator=gen, device="cuda") * 0.1
            v = torch.rand((n,), generator=gen, device="cuda") * 0.01
            got = adam_update(g, m, v, p, c1, c2, 1e-3, wd=0.1)
            want = adam_update_reference(g, m, v, p, c1, c2, 1e-3, wd=0.1)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            worst = max(worst, err)
            del got, want
            main = n > 2_100_000 and g_dt == torch.float32
            fn = functools.partial(adam_update, g, m, v, p, c1, c2, 1e-3,
                                   wd=0.1)
            ms = time_ms(fn, iters=10)
            # the device clock at the LM head's leaf, the train step's shape
            dev = device_ms(fn, iters=10) if main else None
            del fn
            plain = time_ms(lambda: adam_update_reference(
                g, m, v, p, c1, c2, 1e-3, wd=0.1), iters=3, warmup=1)
            del g, p, m, v
            torch.cuda.empty_cache()
            library, library_dev = _fused_adamw_ms(n, gen, device_clock=main)
            gb = 2 if g_dt == torch.bfloat16 else 4
            b_ms, b_by = bound(n * (gb + 4 * 3 + 4 * 3), 15 * n,
                               F32_FLOPS_PER_S)
            log(f"[fused adam] n={n} g {str(g_dt)[6:]} p float32 wd=0.1: "
                f"max_abs_err {err:.3e} (tol {ADAM_TOL}); kernel {ms:.4f} ms "
                f"(device {dev}, bound share {_share(b_ms, dev)}) plain "
                f"{plain:.4f} ms _fused_adamw_ (f32) {library} ms (device "
                f"{library_dev}) bound {b_ms:.4f} ms ({b_by})")
            if main:
                row = {"name": "fused_adam", "ms": ms, "plain_ms": plain,
                       "source": "deepspeed_tpu_torch/csrc/fused_adam.cu",
                       "replaces": "deepspeed_tpu/ops/adam_pallas.py:64",
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": library, "device_ms": dev,
                       "library_device_ms": library_dev,
                       "bound_share": _share(b_ms, dev)}
    if worst > ADAM_TOL:
        raise SystemExit("fused adam disagrees with its plain version")
    row["max_abs_err"] = worst
    return row


# ------------------------------------------------------------ phase 7
def _train_config(batch, accum, dtype_block):
    return {"train_batch_size": batch, "gradient_accumulation_steps": accum,
            "gradient_clipping": 1.0, **dtype_block,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 3}}}


def _warmup():
    from deepspeed_tpu_torch.lr_schedules import warmup_lr

    return warmup_lr(warmup_min_lr=0.0, warmup_max_lr=1e-3,
                     warmup_num_steps=3)


def _packed_batch(rng, B, T, vocab):
    seg = np.ones((B, T), np.int32)
    for b in range(B):
        cut = int(rng.integers(T // 4, 3 * T // 4))
        seg[b, cut:] = 2
        seg[b, T - 1 - b:] = 0
    return {"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
            "segment_ids": seg}


def phase_train_identity(fns):
    """Kernel arms (flash kernels, fused Adam) vs plain arms (reference
    attention, the same Adam through its plain version) on a tiny f32
    Llama: five steps of train_batch."""
    import dataclasses

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.llama import LlamaConfig, loss_fn
    from deepspeed_tpu_torch.ops.adam_cuda import (_leafwise_adam,
                                                   adam_update_reference,
                                                   fused_adam)
    from deepspeed_tpu_torch.weights import init_params

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(1),
                         device="cuda", dtype=torch.float32)
    conf = _train_config(4, 2, {"bf16": {"enabled": False}})
    rng = np.random.default_rng(1)
    batches = [_packed_batch(rng, 4, 33, cfg.vocab_size) for _ in range(5)]
    arms = {}
    plain_adam = _leafwise_adam(adam_update_reference, "adam_reference",
                                _warmup(), (0.9, 0.999), 1e-8, 0.1)
    for arm, c, opt in (
            ("kernel", cfg, fused_adam(lr=_warmup(), weight_decay=0.1)),
            ("plain", dataclasses.replace(cfg, attn_impl="reference"),
             plain_adam)):
        _zero(fns.values())
        eng, _, _, _ = initialize(loss_fn=loss_fn(c), params=params,
                                  config=conf, optimizer=opt)
        losses = [float(eng.train_batch(b)) for b in batches]
        # f32 attention stays on the scalar body
        _check_bodies(f"train identity {arm}", hopper=False, record=False)
        arms[arm] = (losses, eng.module_params(),
                     {n: f.launches for n, f in fns.items()})
    (kl, kp, kn), (pl, pp, pn) = arms["kernel"], arms["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    from deepspeed_tpu_torch._tree import tree_leaves

    param_err = max((a - b).abs().max().item()
                    for a, b in zip(tree_leaves(kp), tree_leaves(pp)))
    log(f"[train identity] llama-tiny f32 accum=2 clip=1.0 WarmupLR packed "
        f"segments, 5 steps: losses kernel {kl} plain {pl}; max rel loss "
        f"diff {loss_rel:.3e} (tol {TRAIN_LOSS_RTOL}); max abs param diff "
        f"{param_err:.3e} (tol {TRAIN_PARAM_ATOL}); launches kernel arm {kn} "
        f"plain arm {pn}")
    if loss_rel > TRAIN_LOSS_RTOL or param_err > TRAIN_PARAM_ATOL:
        raise SystemExit("train identity: kernel and plain arms disagree")
    if any(kn[n] == 0 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                "fused_adam")) or any(pn.values()):
        raise SystemExit("train identity: launch counts are wrong")


# ------------------------------------------------------------ phase 8
def _device_events(prof):
    """The trace's device-side entries (kernels, copies, sets): the CPU-side
    ops also carry their kernels' time, so only these may be summed."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _device_busy_ms(prof) -> Optional[float]:
    """Sum of the device time of every kernel, copy and set in a trace (one
    stream, so nothing overlaps); None when the trace holds none."""
    total = sum(e.self_device_time_total for e in _device_events(prof))
    return total / 1e3 if total > 0 else None


def phase_train(fns, card_line):
    import dataclasses

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.llama import (LlamaConfig, loss_fn,
                                                  param_count)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    eng, _, _, _ = initialize(
        loss_fn=loss_fn(cfg), params=params,
        config=_train_config(2, 2, {"bf16": {"enabled": True}}),
        optimizer=fused_adam(lr=_warmup(), weight_decay=0.1))
    del params
    torch.cuda.synchronize()
    n_params = param_count(cfg)
    log(f"[train] llama3_8b widths, layers={cfg.n_layers} (cut from 32 to "
        f"fit one card) params={n_params} f32 master, bf16 compute, "
        f"fused_adam wd=0.1, accum=2 micro=1 clip=1.0 WarmupLR; init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB resident")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2048)).astype(
        np.int32)}
    tokens = 2 * 2047
    probe = eng.state.params["blocks"]["wq"][0, :64, :64].clone()
    _zero(fns.values())
    steps = []
    for i in range(4):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        ms = (time.perf_counter() - ts) * 1e3
        steps.append({"loss": loss, "grad_norm": eng.get_global_grad_norm(),
                      "ms": ms, "tokens_per_s": tokens / ms * 1e3,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        log(f"[train] step {i}: loss {loss:.4f} grad_norm "
            f"{steps[-1]['grad_norm']:.4f} lr {eng.metrics['lr']:.3e} "
            f"{ms:.1f} ms/step {steps[-1]['tokens_per_s']:.1f} tokens/s "
            f"peak_mem {steps[-1]['peak_mem_gb']:.1f} GB on {card_line}")
    launches = {n: f.launches for n, f in fns.items()}
    _check_bodies("training")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        if fns[name].body_launches != {"wgmma": 32, "scalar": 0}:
            raise SystemExit(f"training: {name} launches by body "
                             f"{fns[name].body_launches}, expected all 32 on "
                             f"the tensor-core body")
    changed = not torch.equal(probe,
                              eng.state.params["blocks"]["wq"][0, :64, :64])
    want = {"flash_fwd": 32, "flash_bwd_dq": 32, "flash_bwd_dkv": 32,
            "fused_adam": 4 * len(tree_leaves(eng.state.params))}
    log(f"[train] launches {launches} (expected {want}); params changed "
        f"{changed}")
    # one more step under the profiler: device busy time over the step
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        float(eng.train_batch(batch))
        traced_ms = (time.perf_counter() - ts) * 1e3
    busy = _device_busy_ms(prof)
    idle = None if busy is None else 1.0 - busy / traced_ms
    top = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)
    log(f"[train] profiled step: {traced_ms:.1f} ms host clock, device busy "
        f"{busy} ms, device idle share {idle}; top device time: " + "; ".join(
            f"{e.key[:70]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
            for e in top[:10]))
    # the LM-head products (the matrix products over the vocabulary) with
    # their operand shapes, and the flash kernels, by name
    head = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::mm" and cfg.vocab_size in sum(
                (list(x) for x in e.input_shapes if x), [])]
    log("[train] LM-head products: " + "; ".join(
        f"aten::mm {e.input_shapes} x{e.count} "
        f"{e.device_time_total / 1e3:.2f} ms" for e in head))
    log("[train] flash kernels: " + "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
        for e in top if "flash_" in e.key))
    ok = (all(np.isfinite(s["loss"]) for s in steps) and changed
          and all(launches[n] > 0 for n in want)
          and all(launches[n] == 0 for n in (
              "paged_attention", "greedy_argmax", "paged_attention_quant",
              "paged_attention_v1", "quantize", "env_probe")))
    if not ok:
        raise SystemExit("training main path failed")
    del eng
    torch.cuda.empty_cache()
    return launches, {"steps": steps, "traced_ms": traced_ms,
                      "device_busy_ms": busy, "device_idle_share": idle}


# ------------------------------------------------------------ phase 61
# phase 8's widths cut to 2 layers, 2 steps of rows of 2048 tokens
CP_TRAIN_LAYERS, CP_TRAIN_STEPS, CP_TRAIN_T = 2, 2, 2048
# the CSV files JAX's monitor writes for a training run with the telemetry
# exporter bridged in (tests/test_torch_engine_telemetry.py holds the port's
# to JAX's on the CPU)
CP_TRAIN_CSV = (
    "Train_loss.csv", "Train_lr.csv", "Train_grad_norm.csv",
    "Train_samples_per_sec.csv", "Telemetry_train_loss.csv",
    "Telemetry_train_lr.csv", "Telemetry_train_grad_norm.csv",
    "Telemetry_train_mfu.csv", "Telemetry_train_samples_per_sec.csv",
    "Telemetry_train_steps.csv", "Telemetry_train_step_seconds_count.csv",
    "Telemetry_train_step_seconds_mean.csv",
    "Telemetry_train_step_seconds_sum.csv")


def _csv_rows(path) -> int:
    """Data rows of one monitor csv file (its header line not counted)."""
    with open(path) as f:
        return sum(1 for _ in f) - 1


def phase_control_plane_train(fns, card_line):
    """Phase 61: the training engine at phase 8's widths cut to 2 layers,
    2 steps of phase 8's config (fused Adam, bf16 compute), with the
    telemetry block (step_sync) and the csv monitor on, a Watchdog petted
    each step, and one forward profiled by ``FlopsProfiler``, against the
    same engine with every block off: the losses and every state leaf bit
    for bit; the csv files carry JAX's tags, a row a step; the telemetry
    snapshot's step time and MFU are read against
    ``timers.device_peak_flops`` of this card.  The csv files carry JAX's
    tags: a row a step for the ``Train/`` tags (steps_per_print 1), at least
    one for the ``Telemetry/`` tags (the exporter's interval)."""
    import dataclasses
    import tempfile

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.llama import LlamaConfig, loss_fn
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.profiler import FlopsProfiler
    from deepspeed_tpu_torch.timers import device_peak_flops
    from deepspeed_tpu_torch.utils.watchdog import Watchdog
    from deepspeed_tpu_torch.weights import init_params

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              n_layers=CP_TRAIN_LAYERS)
    steps, T = CP_TRAIN_STEPS, CP_TRAIN_T
    rng = np.random.default_rng(61)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, T)).astype(
        np.int32)}
    tmp = tempfile.mkdtemp(prefix="dstt_cp_train_")
    runs = {}
    for arm in ("off", "on"):
        conf = _train_config(2, 2, {"bf16": {"enabled": True}})
        conf["steps_per_print"] = 1
        if arm == "on":
            conf["telemetry"] = {"enabled": True, "step_sync": True,
                                 "prometheus_path": os.path.join(
                                     tmp, "train.prom")}
            conf["csv_monitor"] = {"enabled": True, "output_path": tmp,
                                   "job_name": "phase61"}
        else:
            conf["telemetry"] = {"enabled": False}
        params = init_params(cfg, torch.Generator("cuda").manual_seed(61),
                             device="cuda", dtype=torch.float32)
        eng = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                         optimizer=fused_adam(lr=_warmup(),
                                              weight_decay=0.1))[0]
        del params
        wd = None
        if arm == "on":
            eng.tput_timer.start_step = 0
            eng.tput_timer.seq_len = T - 1
            eng.tput_timer.flops_per_sample = _train_flops_per_sample(
                cfg, T - 1)
            wd = Watchdog(timeout_s=600.0, abort_on_timeout=False).start()
        _zero(fns.values())
        losses, ms = [], []
        try:
            for _ in range(steps):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                losses.append(float(eng.train_batch(batch)))
                ms.append((time.perf_counter() - ts) * 1e3)
                if wd is not None:
                    wd.pet()
        finally:
            if wd is not None:
                wd.stop()
        launches = {n: f.launches for n, f in fns.items()}
        _check_bodies(f"control plane training ({arm})", record=arm == "on")
        run = {"losses": losses, "ms": ms, "launches": launches,
               "digest": _state_digest(eng.state)}
        if arm == "on":
            cparams = eng._compute_params()
            lfn = loss_fn(cfg)
            local = {k: torch.as_tensor(v[:1], device="cuda")
                     for k, v in batch.items()}
            prof = FlopsProfiler(lfn).profile(cparams, local, iters=2,
                                              warmup=1)
            del cparams
            snap = eng.telemetry_snapshot()
            run.update(
                flops_profile=prof, snapshot={
                    "train_steps": snap["counters"]["train_steps"],
                    "train_mfu": snap["gauges"]["train_mfu"],
                    "samples_per_sec": snap["gauges"][
                        "train_samples_per_sec"],
                    "step_seconds": snap["histograms"][
                        "train_step_seconds"]},
                watchdog=wd.health(),
                peak_flops=device_peak_flops(eng.device))
            eng.monitor.close()
            csv_dir = os.path.join(tmp, "phase61")
            run["csv"] = {f: _csv_rows(os.path.join(csv_dir, f))
                          for f in sorted(os.listdir(csv_dir))}
        runs[arm] = run
        del eng
        torch.cuda.empty_cache()
    on, off = runs["on"], runs["off"]
    same = on["losses"] == off["losses"] and on["digest"] == off["digest"]
    # the Train/ tags a row a step (steps_per_print 1), the telemetry
    # exporter's at least one (its interval)
    missing = [f for f in CP_TRAIN_CSV if on["csv"].get(f, 0) < (
        steps if f.startswith("Train_") else 1)]
    step_s = on["snapshot"]["step_seconds"]
    log(f"[control plane train] llama3_8b widths layers={cfg.n_layers}, "
        f"phase 8's config, {steps} steps: losses on {on['losses']} off "
        f"{off['losses']}; losses and state bit for bit {same}; ms/step on "
        f"{[round(x, 1) for x in on['ms']]} off "
        f"{[round(x, 1) for x in off['ms']]} on {card_line}; telemetry "
        f"snapshot {on['snapshot']} (MFU against peak "
        f"{on['peak_flops']} FLOP/s); csv rows {on['csv']} (missing "
        f"{missing}); watchdog {on['watchdog']}; FlopsProfiler forward of "
        f"one row: {on['flops_profile']}; kernel launches on "
        f"{on['launches']}")
    ok = (same and not missing and on["snapshot"]["train_steps"] == steps
          and step_s["count"] == steps and not on["watchdog"]["fired"]
          and on["flops_profile"]["flops"] > 0
          and on["snapshot"]["train_mfu"] > 0)
    if not ok:
        raise SystemExit("phase 61 (control plane training) failed")
    _check_launches("control plane training", on["launches"],
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "fused_adam"))
    return {"control plane training (on)": on["launches"]}


# ------------------------------------------------------------ phase 15
# phase 15: Llama-3-8B widths cut to 2 layers, packed documents of 64-1536
# tokens into rows of 2048 (+1), a seqlen curriculum from 1024 to 2048 in
# steps of 256 over the run's first 3 steps, train batch 2 (micro 1, accum 2)
RESUME_LAYERS, RESUME_SEQ, RESUME_STEPS, RESUME_SAVE_AT = 2, 2048, 4, 2
RESUME_CURRICULUM = {
    "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 1024,
    "max_difficulty": 2048, "schedule_type": "fixed_linear",
    "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 256}}
# remat="none" against remat="full" on the same kernels: the backward's
# recompute runs the same launches on the same inputs, so the runs agree bit
# for bit unless a kernel is not deterministic (losses, relative)
REMAT_LOSS_RTOL = 0.0


def _packed_docs(rng, n, vocab, lo=64, hi=1536):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).astype(
        np.int32) for _ in range(n)]


def _leaf_digest(t) -> tuple:
    """The int64 sums of a leaf's 16- or 32-bit patterns, plain and weighted
    by position (mod 1000003), on the card; equal for bit-equal leaves."""
    v = t.detach().reshape(-1)
    v = v.view(torch.int16 if v.element_size() == 2 else torch.int32)
    plain = weighted = 0
    for i in range(0, v.numel(), 1 << 26):
        c = v[i:i + (1 << 26)].long()
        idx = torch.arange(i, i + c.numel(), device=c.device)
        plain += int(c.sum())
        weighted += int((c * (idx % 1000003 + 1)).sum())
    return plain, weighted


def _tree_digest(tree) -> list:
    from deepspeed_tpu_torch._tree import tree_leaves

    return [_leaf_digest(t) for t in tree_leaves(tree)]


def _state_digest(state) -> list:
    """Per state leaf (master params and optimizer moments):
    :func:`_leaf_digest`."""
    return _tree_digest((state.params, state.opt_state[1:]))


def _train_flops_per_sample(cfg, T):
    """Model FLOPs of one training sample of T tokens (forward + backward =
    3x the forward; the remat recompute is not counted): the weight and
    LM-head products, and causal attention over the whole row."""
    d, f, L, V = cfg.dim, cfg.ffn_dim, cfg.n_layers, cfg.vocab_size
    kvd = cfg.n_kv_heads * cfg.head_dim
    weights = 2 * T * (L * (2 * d * d + 2 * d * kvd + 3 * d * f) + d * V)
    attn = L * 2 * 2 * cfg.n_heads * cfg.head_dim * (T * (T + 1) // 2)
    return 3 * (weights + attn)


def phase_resume(fns, card_line):
    """Resumable packed training at Llama-3-8B widths: an uninterrupted run
    A (twice, for the run-to-run reading), run B saved after 2 steps,
    dropped, rebuilt, loaded and run 2 more steps (equal to A bit for bit),
    and run N with remat="none" (ms/step and peak memory beside A's)."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.data.packing import (PackedDataLoader,
                                                  packing_efficiency)
    from deepspeed_tpu_torch.models.llama import (LlamaConfig, loss_fn,
                                                  param_count)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.timers import ThroughputTimer
    from deepspeed_tpu_torch.weights import init_params

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=RESUME_LAYERS,
                              remat="full")
    rng = np.random.default_rng(15)
    # greedy first-fit over windows of 32 documents: every row of these
    # batches holds 2-4 documents
    loader = PackedDataLoader(_packed_docs(rng, 128, cfg.vocab_size),
                              batch_rows=2, seq_len=RESUME_SEQ,
                              fill_factor=16)
    batches = list(itertools.islice(iter(loader), RESUME_STEPS))
    segs = [int(len(np.unique(r[r > 0]))) for b in batches
            for r in b["segment_ids"]]
    if min(segs) < 2:
        raise SystemExit(f"phase 15: a packed row holds one document {segs}")
    conf = _train_config(2, 2, {"bf16": {"enabled": True}})
    conf["curriculum_learning"] = RESUME_CURRICULUM
    T = RESUME_SEQ - 1
    flops = _train_flops_per_sample(cfg, T)

    def engine(c):
        torch.cuda.empty_cache()
        params = init_params(c, torch.Generator("cuda").manual_seed(0),
                             device="cuda", dtype=torch.float32)
        eng = initialize(loss_fn=loss_fn(c), params=params, config=conf,
                         optimizer=fused_adam(lr=_warmup(),
                                              weight_decay=0.1))[0]
        del params
        torch.cuda.synchronize()
        return eng

    def steps(eng, todo, timer=None):
        """train_batch over ``todo``: per step its loss, seq length, ms and
        peak memory."""
        rows = []
        for b in todo:
            torch.cuda.reset_peak_memory_stats()
            seqlen = eng.curriculum_difficulty()
            if timer is not None:
                timer.start()
            ts = time.perf_counter()
            loss = float(eng.train_batch(b))
            ms = (time.perf_counter() - ts) * 1e3
            if timer is not None:
                timer.stop()
            rows.append({"loss": loss, "seqlen": seqlen, "ms": ms,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        return rows

    def run(c, path):
        """One uninterrupted run, its counts set to 0 just before its first
        step and read just after its last."""
        eng = engine(c)
        timer = ThroughputTimer(batch_size=2, seq_len=T,
                                flops_per_sample=flops,
                                start_step=RESUME_STEPS - 1, device="cuda")
        _zero(fns.values())
        rows = steps(eng, batches, timer)
        out = {"steps": rows, "launches": {n: f.launches
                                           for n, f in fns.items()},
               "tput": timer.summary(), "digest": _state_digest(eng.state),
               "leaves": len(tree_leaves(eng.state.params))}
        _check_bodies(path)
        del eng
        gc.collect()
        return out

    log(f"[resume] llama3_8b widths, layers={cfg.n_layers} (cut from 32 to "
        f"keep the checkpoint's write and read short) params="
        f"{param_count(cfg)} f32 master, bf16 compute, fused_adam wd=0.1, "
        f"accum=2 micro=1 clip=1.0 WarmupLR remat=full; {len(batches)} "
        f"packed batches [2, {RESUME_SEQ + 1}] of documents 64-1536 tokens "
        f"(first-fit windows of 32), "
        f"segments per row {segs}, packing efficiency "
        f"{[round(packing_efficiency(b['segment_ids']), 4) for b in batches]}"
        f"; curriculum {RESUME_CURRICULUM['schedule_config']} "
        f"{RESUME_CURRICULUM['min_difficulty']}->"
        f"{RESUME_CURRICULUM['max_difficulty']}; {flops:.4e} flops/sample "
        f"at T={T}")
    a = run(cfg, "packed training A")
    a2 = run(cfg, "packed training A again")
    deterministic = (a["digest"] == a2["digest"] and
                     [r["loss"] for r in a["steps"]] ==
                     [r["loss"] for r in a2["steps"]])
    log(f"[resume] run A losses {[r['loss'] for r in a['steps']]} seqlens "
        f"{[r['seqlen'] for r in a['steps']]}; run A again bit-equal to A "
        f"(losses and all {len(a['digest'])} state leaves): {deterministic}")
    if not deterministic:
        raise SystemExit("phase 15: two uninterrupted runs differ on the "
                         "card; the resume gate is bitwise")
    if [r["seqlen"] for r in a["steps"]] != [1024, 1280, 1536, 2048]:
        raise SystemExit("phase 15: the curriculum did not drive the steps")

    # run B: save after RESUME_SAVE_AT steps, drop, rebuild, load, continue;
    # the counts are set to 0 before its first step and read after its last
    ckdir = tempfile.mkdtemp(prefix="dstt_resume_", dir=tempfile.gettempdir())
    try:
        eng = engine(cfg)
        _zero(fns.values())
        first = steps(eng, batches[:RESUME_SAVE_AT])
        resident = torch.cuda.memory_allocated() / 1e9
        ts = time.perf_counter()
        eng.save_checkpoint(ckdir, async_save=True)
        snap_s = time.perf_counter() - ts
        eng.wait_for_checkpoint()
        save_s = time.perf_counter() - ts
        written = sum(os.path.getsize(os.path.join(dp, fn))
                      for dp, _, files in os.walk(ckdir) for fn in files)
        free = shutil.disk_usage(ckdir).free
        del eng
        gc.collect()
        eng = engine(cfg)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ts = time.perf_counter()
        path, _ = eng.load_checkpoint(ckdir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - ts
        load_extra = (torch.cuda.max_memory_allocated() - base) / 1e9
        second = steps(eng, batches[RESUME_SAVE_AT:])
        b_launches = {n: f.launches for n, f in fns.items()}
        _check_bodies("resumed training")
        b_digest = _state_digest(eng.state)
        del eng
        gc.collect()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    b_losses = [r["loss"] for r in first + second]
    resumed_ok = (b_losses == [r["loss"] for r in a["steps"]]
                  and b_digest == a["digest"])
    log(f"[resume] run B: saved after {RESUME_SAVE_AT} steps to "
        f"{tempfile.gettempdir()} ({written} bytes, {resident:.2f} GB "
        f"resident), save_checkpoint returned in {snap_s:.2f} s (host "
        f"snapshot), on disk after {save_s:.2f} s; {free / 1e9:.1f} GB free "
        f"after; engine dropped and rebuilt; load_checkpoint {load_s:.2f} s, "
        f"peak card memory above the rebuilt engine's during the load "
        f"{load_extra:.3f} GB; losses {b_losses}; equal to run A bit for bit "
        f"(losses and every state leaf): {resumed_ok}")
    if not resumed_ok or path is None:
        raise SystemExit("phase 15: the resumed run differs from run A")
    launches = {"packed training A": a["launches"],
                "packed training A again": a2["launches"],
                "resumed training": b_launches}

    n = run(dataclasses.replace(cfg, remat="none"), "packed training remat=none")
    launches["packed training remat=none"] = n["launches"]
    rel = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
              for x, y in zip(n["steps"], a["steps"]))
    for name, r in (("A (remat=full)", a), ("N (remat=none)", n)):
        log(f"[resume] run {name}: ms/step {[round(x['ms'], 1) for x in r['steps']]}"
            f" peak GB {[round(x['peak_gb'], 2) for x in r['steps']]}; "
            f"ThroughputTimer over the last step (T={T}): "
            f"{r['tput']['tokens_per_sec']:.1f} tokens/s, "
            f"{r['tput']['tflops']:.1f} TFLOP/s, MFU {r['tput']['mfu']:.4f} "
            f"on {card_line}")
    log(f"[resume] remat=none vs full: max rel loss diff {rel:.3e} (tol "
        f"{REMAT_LOSS_RTOL}); state bit-equal {n['digest'] == a['digest']}; "
        f"launches A {a['launches']} B {launches['resumed training']} N "
        f"{n['launches']}")
    if rel > REMAT_LOSS_RTOL:
        raise SystemExit("phase 15: remat=none and remat=full disagree")
    want = {"packed training A": 2 * 2 * RESUME_STEPS * cfg.n_layers,
            "packed training A again": 2 * 2 * RESUME_STEPS * cfg.n_layers,
            "resumed training": 2 * 2 * RESUME_STEPS * cfg.n_layers,
            "packed training remat=none": 2 * RESUME_STEPS * cfg.n_layers}
    for p, fwd in want.items():
        c = launches[p]
        exp = {"flash_fwd": fwd,
               "flash_bwd_dq": 2 * RESUME_STEPS * cfg.n_layers,
               "flash_bwd_dkv": 2 * RESUME_STEPS * cfg.n_layers,
               "fused_adam": RESUME_STEPS * a["leaves"]}
        if any(c[k] != v for k, v in exp.items()) or any(
                c[k] for k in c if k not in exp):
            raise SystemExit(f"phase 15: {p} launches {c}, expected {exp}")
    log(f"[resume] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches, {"A": a["steps"], "B": first + second,
                      "N": n["steps"], "save_s": save_s, "load_s": load_s,
                      "bytes": written}


# ------------------------------------------------------------ phase 16
def phase_gpt2_kernels(gen):
    """The serving and training kernels at GPT-2's shapes, each exact or
    within its gate against the plain version and timed on the device
    clock: B6 at V = 50257 on ``logits[:, -1]`` rows of [8, 2, V] (each row
    4 bytes further off a 16-byte boundary than the one before, ties
    planted across the spans); B5's Hopper body at G = 1 (GPT-2 1.3B: 16
    heads of 128; small: 12 of 64), decode over lens up to 1024 and a
    C = 256 chunk; B1 at H = KV, T = 1024, causal, at both head dims; B2
    and B3 at the training shape [8, 1024, H = KV, D], at both head dims.
    Returns {kernel name: its GPT-2 cases}."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_body, paged_chunk_attention, paged_chunk_attention_reference)
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_fwd,
                                                        flash_fwd_body,
                                                        flash_fwd_reference)
    from deepspeed_tpu_torch.ops.sampling_cuda import (fused_greedy_rows,
                                                       greedy_rows_reference)

    out = {"greedy_argmax": {}, "paged_attention": {}, "flash_fwd": {},
           "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    ok = True
    V = 50257
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((8, 2, V), generator=gen, device="cuda").to(dtype)
        last = x[:, -1]
        for b in range(8):              # ties across the row's spans
            last[b, [b, V // 3 + b, V // 2, V - 1 - b]] = 30.0
        fused_greedy_rows.body_launches = dict.fromkeys(
            fused_greedy_rows.body_launches, 0)
        got = fused_greedy_rows(last)
        exact = bool(torch.equal(got, greedy_rows_reference(last))
                     and torch.equal(got.long(), torch.argmax(last, -1))
                     and got.tolist() == list(range(8))
                     and fused_greedy_rows.body_launches["row"] == 0)
        case = _greedy_case(fused_greedy_rows, last.contiguous())
        case["exact"] = exact
        key = f"B8 V{V} {str(dtype)[6:]} rows logits[:, -1]"
        out["greedy_argmax"][key] = case
        log(f"[gpt2 kernels] greedy {key}: exact {exact} (tol: exact), "
            f"cluster body; from HBM device {case['device_ms']} ms (bound "
            f"{case['bound_ms']:.5f} ms, share {case['bound_share']}); argmax"
            f" device {case['library_device_ms']} ms; plain "
            f"{case['plain_ms']:.4f} ms")
        ok = ok and exact
    for H, D in ((16, 128), (12, 64)):
        dt = torch.bfloat16
        for C, starts in ((1, [0, 127, 255, 399, 511, 699, 899, 1023]),
                          (256, [0, 128, 256, 300, 512, 600, 700, 768])):
            kp, vp, table = _paged_inputs(gen, starts, C, H=H, KV=H, D=D)
            st = torch.tensor(starts, dtype=torch.int32, device="cuda")
            q = torch.randn((8, C, H, D), generator=gen,
                            device="cuda").to(dt)
            sm90 = paged_body(q) == "sm90"
            o = paged_chunk_attention(q, kp, vp, table, st)
            r = paged_chunk_attention_reference(q, kp, vp, table, st)
            torch.cuda.synchronize()
            err = (o.float() - r.float()).abs().max().item()
            tol = PAGED_DECODE_TOL if C == 1 else PAGED_CHUNK_TOL
            dev = device_ms(lambda: paged_chunk_attention(q, kp, vp, table,
                                                          st))
            plain = time_ms(lambda: paged_chunk_attention_reference(
                q, kp, vp, table, st), iters=3, warmup=1)
            live = sum(s + C for s in starts)
            pairs = sum(s * C + C * (C + 1) // 2 for s in starts)
            b_ms, b_by = bound(2 * live * H * D * 2 + 2 * 2 * 8 * C * H * D,
                               4 * pairs * H * D, BF16_FLOPS_PER_S)
            key = f"G1 H{H} D{D} C{C}"
            out["paged_attention"][key] = {
                "max_abs_err": err, "tol": tol, "sm90": sm90,
                "device_ms": dev, "plain_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "bound_share": _share(b_ms, dev)}
            log(f"[gpt2 kernels] paged {key} B=8 starts={starts}: max_abs_err"
                f" {err:.3e} (tol {tol}) Hopper body {sm90}; device {dev} ms"
                f" (bound {b_ms:.5f} ms {b_by}, share {_share(b_ms, dev)}); "
                f"plain {plain:.4f} ms")
            ok = ok and sm90 and err <= tol
        q, k, v = (torch.randn((2, 1024, H, D), generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        wgmma = flash_fwd_body(q) == "wgmma"
        o, lse = flash_fwd(q, k, v)
        ro, rlse = flash_fwd_reference(q, k, v)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        dev = device_ms(lambda: flash_fwd(q, k, v))
        plain = time_ms(lambda: flash_fwd_reference(q, k, v), iters=3,
                        warmup=1)
        sdpa = _sdpa(q, k, v)
        lib = sdpa and device_ms(sdpa)
        b_ms, b_by = _flash_bound(2, 1024, H, H, D, 1024 * 1025 // 2)
        key = f"B2 T1024 H=KV={H} D{D} causal"
        out["flash_fwd"][key] = {
            "max_abs_err": err, "lse_err": lse_err, "wgmma": wgmma,
            "device_ms": dev, "plain_ms": plain, "library_device_ms": lib,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": _share(b_ms, dev)}
        log(f"[gpt2 kernels] flash {key}: max_abs_err {err:.3e} (tol "
            f"{FLASH_TOL}) lse_err {lse_err:.3e}; tensor-core body {wgmma}; "
            f"device {dev} ms, plain {plain:.4f} ms, sdpa device {lib} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
        ok = ok and wgmma and err <= FLASH_TOL and lse_err <= 1e-3
        for name, case in _gpt2_flash_bwd(gen, H, D).items():
            out[name][f"B8 T1024 H=KV={H} D{D} causal"] = case
            ok = ok and case["wgmma"] and case["over_gate_faithful"] and \
                case.get("delta_rel", 0) <= FLASH_DELTA_REL_TOL
    if not ok:
        raise SystemExit("phase 16: a kernel disagrees at GPT-2's shapes")
    return out


def _gpt2_flash_bwd(gen, H, D, B=8, T=1024, KV=None, tag="gpt2 kernels"):
    """B2 and B3 at a training shape (GPT-2's: micro 8 x 1024, causal, one
    query head per kv head; ``KV`` kv heads for GQA) against the plain
    backward: B2's delta against ``flash_delta``, dq, dk and dv at the flash
    backward gate, where every element over it must be a bf16 neighbour of
    the f64 oracle (C-f6); each timed on the device clock beside its
    bound.  Returns {kernel name: case}."""
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd_body, flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference,
        flash_delta, flash_fwd)

    dt = torch.bfloat16
    KV = KV or H
    q, k, v, do = (torch.randn((B, T, n, D), generator=gen,
                               device="cuda").to(dt) for n in (H, KV, KV, H))
    wgmma = flash_bwd_body(q) == "wgmma"
    o, lse = flash_fwd(q, k, v)
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    want = flash_bwd_reference(q, k, v, o, lse, do)
    want_delta = flash_delta(o, do)
    torch.cuda.synchronize()
    got = {"dq": dq, "dk": dk, "dv": dv}
    err = {n: ((g.float() - w.float()).abs().max().item(), _rel(g, w))
           for (n, g), w in zip(got.items(), want)}
    delta_rel = _rel(delta, want_delta)
    # an element over the gate must be a faithful rounding of the exact
    # value, as C-f6 settled; counted and logged
    over = dict.fromkeys(got, (0, True))
    if any(e[1] > FLASH_BWD_REL_TOL for e in err.values()):
        dq64, dq_spec, dk64, dv64 = flash_bwd_f64_oracle(q, k, v, o, lse, do,
                                                         None)
        exact = {"dq": (dq64, dq_spec), "dk": (dk64,), "dv": (dv64,)}
        del dq64, dq_spec, dk64, dv64
        over = {n: _faithful_over_gate(got[n], w, exact[n],
                                       FLASH_BWD_REL_TOL)
                for n, w in zip(got, want)}
        del exact
    del dq, dk, dv, got, want, want_delta
    plain = time_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do),
                    iters=3, warmup=1)
    sdpa = _sdpa_bwd(q, k, v, do)
    lib = sdpa and device_ms(sdpa, iters=10)
    del sdpa
    pairs = T * (T + 1) // 2
    # q, do, k, v read, two tensors more each (B2 reads O and writes dq, B3
    # writes dk and dv), and lse and delta in f32
    io = (2 * B * T * D * (2 * H + 2 * KV) + 2 * B * T * D * (H + KV)
          + 8 * B * H * T)
    bounds = {"flash_bwd_dq": bound(io, 6 * D * pairs * H * B
                                    + 2 * B * T * H * D, BF16_FLOPS_PER_S),
              "flash_bwd_dkv": bound(io, 8 * D * pairs * H * B,
                                     BF16_FLOPS_PER_S)}
    fns = {"flash_bwd_dq": lambda: flash_bwd_dq(q, k, v, o, do, lse),
           "flash_bwd_dkv": lambda: flash_bwd_dkv(q, k, v, do, lse, delta)}
    out = {}
    for name, grads in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        dev = device_ms(fns[name], iters=10)
        b_ms, b_by = bounds[name]
        case = {"wgmma": wgmma,
                "max_abs_err": max(err[n][0] for n in grads),
                "rel_err": max(err[n][1] for n in grads),
                "tol_rel": FLASH_BWD_REL_TOL,
                "over_gate": sum(over[n][0] for n in grads),
                "over_gate_faithful": all(over[n][1] for n in grads),
                "device_ms": dev,
                "plain_ms": plain, "library_device_ms": lib,
                "library": "sdpa backward (dq, dk, dv together)",
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": _share(b_ms, dev)}
        if name == "flash_bwd_dq":
            case["delta_rel"] = delta_rel
        out[name] = case
        log(f"[{tag}] {name} B={B} T={T} H={H} KV={KV} D={D} bf16 causal:"
            f" tensor-core body {wgmma}; rel err {case['rel_err']:.3e} (tol "
            f"{FLASH_BWD_REL_TOL}) max_abs_err {case['max_abs_err']:.3e}; "
            f"{case['over_gate']} elements over the gate, each a bf16 "
            f"neighbour of the f64 oracle: {case['over_gate_faithful']}"
            + (f" delta rel {delta_rel:.3e} (tol {FLASH_DELTA_REL_TOL})"
               if name == "flash_bwd_dq" else "")
            + f"; device {dev} ms (bound {b_ms:.5f} ms {b_by}, share "
            f"{_share(b_ms, dev)}); plain bwd {plain:.4f} ms; sdpa bwd "
            f"device {lib} ms")
    del o, lse, delta, fns
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 17
def _gpt2_params(cfg, seed, dtype=torch.bfloat16):
    from deepspeed_tpu_torch.weights import init_params

    return init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                       device="cuda", dtype=dtype)


def phase_gpt2_identity(fns):
    """Kernel arms vs plain arms on a tiny f32 GPT-2: the engine (flash, B5
    and B6 on the card) against the same engine on the CPU (every plain
    version) with whole-prompt and chunked prefill; ``gpt2_generator`` (B6)
    and ``gpt2_paged_generator`` (B1, B5, B6) on the card against the same
    generators on the CPU; then the engine's tokens against
    ``gpt2_paged_generator``'s on the same prompts.  Greedy tokens
    identical on every pair, no leaks."""
    from deepspeed_tpu_torch._tree import tree_map
    from deepspeed_tpu_torch.inference.generation import (gpt2_generator,
                                                          gpt2_paged_generator)
    from deepspeed_tpu_torch.inference.serving import gpt2_serving_engine
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.tiny()
    params = _gpt2_params(cfg, 2, torch.float32)
    host = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(16)
    prompts = {f"r{i}": rng.integers(1, cfg.vocab_size,
                                     rng.integers(3, 40)).tolist()
               for i in range(6)}
    opts = dict(max_batch=3, page_size=8, num_pages=48, max_seq=96,
                prefill_bucket=8, cache_dtype=torch.float32)

    def counts():
        return {n: f.launches for n, f in fns.items()}

    for chunk in (0, 8):
        outs, used = [], []
        for p, dev in ((params, "cuda"), (host, "cpu")):
            _zero(fns.values())
            eng = gpt2_serving_engine(p, cfg, device=dev,
                                      prefill_chunk=chunk, **opts)
            for rid, prompt in prompts.items():
                eng.submit(rid, prompt, max_new_tokens=12)
            outs.append(eng.run())
            used.append(counts())
            _check_bodies(f"gpt2 identity chunk={chunk}", hopper=False,
                          record=False)
            if eng.check_leaks():
                raise SystemExit(f"gpt2 identity: leaks {eng.check_leaks()}")
        same = outs[0] == outs[1]
        log(f"[gpt2 identity] engine gpt2-tiny f32 prefill_chunk={chunk}: "
            f"card (kernels) == CPU (plain versions): {same} "
            f"({len(outs[0])} requests); launches card {used[0]} CPU "
            f"{used[1]}")
        if not same or any(used[1].values()):
            raise SystemExit("gpt2 identity: the engine's arms differ")
        _check_launches(f"gpt2 identity chunk={chunk}", used[0],
                        [n for n in SERVING_KERNELS
                         if chunk == 0 or n != "flash_fwd"])
    toks = rng.integers(1, cfg.vocab_size, (3, 11))
    gen_out = {}
    for label, build, want in (
            ("gpt2_generator", gpt2_generator, ("greedy_argmax",)),
            ("gpt2_paged_generator", gpt2_paged_generator, SERVING_KERNELS)):
        kw = {"page_size": 8} if label == "gpt2_paged_generator" else {}
        _zero(fns.values())
        card_out = build(params, cfg, cache_dtype=torch.float32,
                         device="cuda", **kw).generate(
                             toks, max_new_tokens=12).cpu()
        used = counts()
        _check_bodies(f"gpt2 identity {label}", hopper=False, record=False)
        cpu_out = build(host, cfg, cache_dtype=torch.float32, device="cpu",
                        **kw).generate(toks, max_new_tokens=12)
        same = torch.equal(card_out, cpu_out)
        log(f"[gpt2 identity] {label} gpt2-tiny f32 B=3 T=11 new=12: card "
            f"(kernels) == CPU (plain versions): {same}; launches {used}")
        if not same:
            raise SystemExit(f"gpt2 identity: {label} differs from its "
                             "plain arm")
        _check_launches(f"gpt2 identity {label}", used, want)
        gen_out[label] = card_out
    eng = gpt2_serving_engine(params, cfg, **opts)
    for i, p in enumerate(toks):
        eng.submit(i, p.tolist(), max_new_tokens=12)
    out = eng.run()
    same = all(out[i] == gen_out["gpt2_paged_generator"][i].tolist()
               for i in range(3)) and eng.check_leaks() == []
    log(f"[gpt2 identity] engine == gpt2_paged_generator on the same 3 "
        f"prompts: {same}")
    if not same:
        raise SystemExit("gpt2 identity: the engine and the paged "
                         "generator differ")


# ------------------------------------------------------------ phase 18
GPT2_NEW = 32


def _gpt2_generate(build, params, cfg, toks, path, fns, card_line,
                   tag="gpt2 serving", **kw):
    """One generator's greedy run of ``toks`` on the card: tokens/s, the
    ms per token step (host clock ending in a sync), launches and the
    first new tokens."""
    gen = build(params, cfg, device="cuda", **kw)
    _zero(fns.values())
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gen.generate(toks, max_new_tokens=GPT2_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    used = {n: f.launches for n, f in fns.items()}
    _check_bodies(path)
    B, T = toks.shape
    ok = (tuple(out.shape) == (B, T + GPT2_NEW)
          and torch.equal(out[:, :T].cpu(), torch.from_numpy(toks).int())
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    m = {"wall_s": wall, "tokens_per_s": B * GPT2_NEW / wall,
         "ms_per_step": wall * 1e3 / GPT2_NEW,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[{tag}] {path} B={B} T={T} new={GPT2_NEW}: valid {ok}; "
        f"{m['tokens_per_s']:.2f} tokens/s, {m['ms_per_step']:.2f} ms per "
        f"token step (prefill included), peak_mem {m['peak_mem_gb']:.2f} GB "
        f"on {card_line}; kernel launches {used}")
    if not ok:
        raise SystemExit(f"{path} failed")
    return out[:, T:].cpu(), used, m


def phase_gpt2_serving(fns, card_line):
    """GPT-2 1.3B at full width (24 layers, 16 heads of 128, V 50257),
    seeded bf16 weights: the engine (max_batch 8, pages of 16, max_seq
    1024) over 8 prompts of 64-768 tokens, 32 new tokens each, whole-prompt
    and ``prefill_chunk=256``; ``gpt2_generator`` and
    ``gpt2_paged_generator`` on 8 prompts of 128 tokens; then int8 weights
    (``weight_dtype="int8"``, B9 at build, the bf16 tree freed) on the
    engine's traffic, and one ``init_inference(dtype="int8")`` forward.
    The tied head's product takes ``wte.T`` as it is (no copy)."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.generation import (gpt2_generator,
                                                          gpt2_paged_generator)
    from deepspeed_tpu_torch.inference.quantized import param_bytes
    from deepspeed_tpu_torch.inference.serving import gpt2_serving_engine
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.losses import f32_matmul

    cfg = gpt2.GPT2Config.gpt2_1_3b()
    t0 = time.perf_counter()
    params = _gpt2_params(cfg, 12)
    torch.cuda.synchronize()
    log(f"[gpt2 serving] gpt2_1_3b layers={cfg.n_layers} dim={cfg.dim} "
        f"heads={cfg.n_heads} head_dim={cfg.head_dim} vocab={cfg.vocab_size}"
        f" params={gpt2.param_count(cfg)} bf16 random seeded weights, init "
        f"{time.perf_counter() - t0:.1f} s")
    # the tied head: f32_matmul over the transposed view, no copy of wte
    h = torch.randn((8, cfg.dim), device="cuda").to(torch.bfloat16)
    head = gpt2.lm_head(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    f32_matmul(h, head)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    wte_bytes = params["wte"].numel() * 2
    log(f"[gpt2 serving] tied head f32_matmul([8, {cfg.dim}], wte.T "
        f"stride {head.stride()}): peak above resident {extra} bytes (wte "
        f"{wte_bytes} bytes; a copy would add them)")
    del h, head
    if extra >= wte_bytes // 10:
        raise SystemExit("gpt2: the tied head copies wte")
    rng = np.random.default_rng(17)
    prompts = _queue18(cfg.vocab_size, rng)
    lens = [len(p) for p in prompts.values()]
    opts = dict(max_batch=8, page_size=16, max_seq=1024, num_pages=513,
                cache_dtype=torch.bfloat16)
    launches, results, outs = {}, {}, {}
    for chunk in (0, 256):
        path = f"gpt2-1.3b serving prefill_chunk={chunk}"
        torch.cuda.reset_peak_memory_stats()
        _zero(fns.values())
        out, leaks, m = serve(params, cfg, prompts, GPT2_NEW,
                              prefill_chunk=chunk, **opts)
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        done = _valid(out, prompts, GPT2_NEW, cfg.vocab_size)
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[gpt2 serving] prefill_chunk={chunk} prompts={lens} "
            f"new={GPT2_NEW}: finished {len(out)}/8 all_valid {done} "
            f"check_leaks {leaks}; tokens/s {m['tokens_per_s']:.2f} "
            f"ttft_mean {m['ttft_s_mean'] * 1e3:.1f} ms ttft_max "
            f"{m['ttft_s_max'] * 1e3:.1f} ms ms/decode_step "
            f"{m['ms_per_decode_step']} peak_mem {m['peak_mem_gb']:.2f} GB "
            f"on {card_line}; kernel launches {launches[path]}")
        if not done or leaks:
            raise SystemExit(f"{path} failed")
        _check_launches(path, launches[path],
                        [n for n in SERVING_KERNELS
                         if chunk == 0 or n != "flash_fwd"])
        results[path], outs[chunk] = m, out
    same = sum(outs[0][r] == outs[256][r] for r in prompts)
    log(f"[gpt2 serving] whole-prompt and chunked runs agree on {same}/8 "
        "requests (informational: bf16 sums in another order)")

    toks = rng.integers(1, cfg.vocab_size, (8, 128))
    gens = {}
    for label, build, want in (
            ("gpt2_generator", gpt2_generator, ("greedy_argmax",)),
            ("gpt2_paged_generator", gpt2_paged_generator, SERVING_KERNELS)):
        path = f"gpt2-1.3b {label}"
        gens[label], launches[path], results[path] = _gpt2_generate(
            build, params, cfg, toks, path, fns, card_line)
        _check_launches(path, launches[path], want)
    agree = float((gens["gpt2_generator"] == gens["gpt2_paged_generator"])
                  .float().mean())
    log(f"[gpt2 serving] the two generators' new tokens agree on {agree:.4f}"
        " (informational: dense f32 cached attention vs B1/B5 in bf16)")

    # int8 weights on the same weights: B9 quantizes the 5 matrix leaves
    # (wte, qkv_w, proj_w, fc_w, out_w); the bf16 tree is then freed
    bf16_bytes = param_bytes(params)
    torch.cuda.reset_peak_memory_stats()
    _zero(fns.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = gpt2_serving_engine(params, cfg, weight_dtype="int8", **opts)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    launches["gpt2-1.3b int8 build"] = {n: f.launches for n, f in fns.items()}
    _check_bodies("gpt2-1.3b int8 build")
    del params
    torch.cuda.empty_cache()
    int8_bytes = param_bytes(eng.params)
    log(f"[gpt2 int8] build {build_ms:.1f} ms, B9 launches "
        f"{launches['gpt2-1.3b int8 build']['quantize']} (5 matrix leaves); "
        f"resident weights {int8_bytes / 1e9:.4f} GB vs {bf16_bytes / 1e9:.4f}"
        f" GB bf16 ({int8_bytes / bf16_bytes:.4f}x) on {card_line}")
    _check_launches("gpt2-1.3b int8 build", launches["gpt2-1.3b int8 build"],
                    ("quantize",))
    if launches["gpt2-1.3b int8 build"]["quantize"] != 5:
        raise SystemExit("gpt2 int8 build: wrong B9 launch count")
    for chunk in (0, 256):
        path = f"gpt2-1.3b int8 serving prefill_chunk={chunk}"
        if chunk:
            qparams = eng.params
            del eng
            eng = gpt2_serving_engine(qparams, cfg, weight_dtype="int8",
                                      prefill_chunk=chunk, **opts)
            del qparams
        torch.cuda.reset_peak_memory_stats()
        _zero(fns.values())
        out, m = drive(eng, prompts, GPT2_NEW)
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        leaks = eng.check_leaks()
        done = _valid(out, prompts, GPT2_NEW, cfg.vocab_size)
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[gpt2 int8] prefill_chunk={chunk}: finished {len(out)}/8 "
            f"all_valid {done} check_leaks {leaks}; tokens/s "
            f"{m['tokens_per_s']:.2f} ttft_mean {m['ttft_s_mean'] * 1e3:.1f}"
            f" ms ms/decode_step {m['ms_per_decode_step']} peak_mem "
            f"{m['peak_mem_gb']:.2f} GB on {card_line}; kernel launches "
            f"{launches[path]}")
        if not done or leaks:
            raise SystemExit(f"{path} failed")
        _check_launches(path, launches[path],
                        [n for n in SERVING_KERNELS
                         if chunk == 0 or n != "flash_fwd"])
        results[path] = m
    qparams = eng.params
    del eng
    torch.cuda.empty_cache()
    # init_inference(dtype="int8") over the int8 tree: the exact leaves
    # quantize there (wpe and the 8 stacked vectors: 9 B9 launches)
    rid = max(prompts, key=lambda r: len(prompts[r]))
    toks1 = torch.tensor([prompts[rid]], dtype=torch.long, device="cuda")
    path = "gpt2-1.3b int8 init_inference"
    torch.cuda.reset_peak_memory_stats()
    _zero(fns.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ie = init_inference(apply_fn=functools.partial(gpt2.forward, cfg=cfg),
                        params=qparams, dtype="int8")
    logits = ie(toks1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches[path] = {n: f.launches for n, f in fns.items()}
    _check_bodies(path)
    ok = (tuple(logits.shape) == (1, toks1.shape[1], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()))
    log(f"[gpt2 int8] init_inference(dtype=int8) with gpt2.forward, one "
        f"forward of [1, {toks1.shape[1]}]: {ms:.1f} ms (build included), "
        f"logits finite of shape {ok}, peak_mem "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; B9 launches "
        f"{launches[path]['quantize']} on {card_line}; kernel launches "
        f"{launches[path]}")
    del ie, logits, qparams
    torch.cuda.empty_cache()
    if not ok or launches[path]["quantize"] != 9:
        raise SystemExit(f"{path} failed")
    _check_launches(path, launches[path], ("flash_fwd", "quantize"))
    return launches, results


def phase_gpt2_small(fns, card_line):
    """GPT-2 small at its published widths (768, 12 layers, 12 heads of
    64): the engine over 8 prompts of 32-512 tokens, 16 new tokens,
    whole-prompt and ``prefill_chunk=256``, so the head_dim-64 Hopper
    bodies of B1 and B5 carry a main path."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config()
    params = _gpt2_params(cfg, 18)
    rng = np.random.default_rng(18)
    lens = np.linspace(32, 512, 8).astype(int).tolist()
    prompts = {f"s{i}": rng.integers(1, cfg.vocab_size, n).tolist()
               for i, n in enumerate(lens)}
    opts = dict(max_batch=8, page_size=16, max_seq=1024, num_pages=513,
                cache_dtype=torch.bfloat16)
    launches, results = {}, {}
    for chunk in (0, 256):
        path = f"gpt2-small serving prefill_chunk={chunk}"
        torch.cuda.reset_peak_memory_stats()
        _zero(fns.values())
        out, leaks, m = serve(params, cfg, prompts, 16, prefill_chunk=chunk,
                              **opts)
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        done = _valid(out, prompts, 16, cfg.vocab_size)
        log(f"[gpt2 small] d={cfg.dim} layers={cfg.n_layers} heads="
            f"{cfg.n_heads} head_dim={cfg.head_dim} prefill_chunk={chunk} "
            f"prompts={lens} new=16: all_valid {done} check_leaks {leaks}; "
            f"tokens/s {m['tokens_per_s']:.2f} ttft_mean "
            f"{m['ttft_s_mean'] * 1e3:.1f} ms ms/decode_step "
            f"{m['ms_per_decode_step']} on {card_line}; kernel launches "
            f"{launches[path]}")
        if not done or leaks:
            raise SystemExit(f"{path} failed")
        _check_launches(path, launches[path],
                        [n for n in SERVING_KERNELS
                         if chunk == 0 or n != "flash_fwd"])
        results[path] = m
    del params
    torch.cuda.empty_cache()
    return launches, results


# ------------------------------------------------------------ phase 19
# GPT-2 1.3B at all 24 layers: train batch 8 (micro 8, no accumulation) of
# 1024 (+1) tokens, three steps per remat policy
GPT2_TRAIN_STEPS, GPT2_TRAIN_B, GPT2_TRAIN_T = 3, 8, 1024
GPT2_REMATS = ("none", "save_attn", "offload_attn")


def _gpt2_flops_per_sample(cfg, T):
    """Model FLOPs of one training sample of T tokens (3x the forward; the
    recompute not counted): the weight products, the tied head, and causal
    attention."""
    d, L, V = cfg.dim, cfg.n_layers, cfg.vocab_size
    weights = 2 * T * (L * 12 * d * d + d * V)
    attn = L * 2 * 2 * cfg.n_heads * cfg.head_dim * (T * (T + 1) // 2)
    return 3 * (weights + attn)


def phase_gpt2_train(fns, card_line):
    """GPT-2 1.3B trained at full depth on one card: bf16 compute, f32
    master, fused Adam (B4), WarmupLR, clipping 1.0; three steps under
    ``remat="none"``, ``"save_attn"`` and ``"offload_attn"``, each from the
    same seeded weights on the same batch, then one profiled step.  The
    offload run's state after its steps equals ``save_attn``'s bit for bit
    (its gradients are those of its twin), it moves the named stage outputs
    (attn_out, mlp_out of every layer) to pinned host memory each step, and
    its peak card memory is lower by about those bytes."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import initialize, remat
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, loss_fn,
                                                 param_count)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.timers import ThroughputTimer
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    base = GPT2Config.gpt2_1_3b()
    B, T = GPT2_TRAIN_B, GPT2_TRAIN_T
    rng = np.random.default_rng(19)
    batch = {"tokens": rng.integers(0, base.vocab_size, (B, T + 1)).astype(
        np.int32)}
    conf = _train_config(B, 1, {"bf16": {"enabled": True}})
    flops = _gpt2_flops_per_sample(base, T)
    named = base.n_layers * B * T * (base.dim + 4 * base.dim) * 2
    log(f"[gpt2 train] gpt2_1_3b params={param_count(base)} layers="
        f"{base.n_layers} (all) f32 master, bf16 compute, fused_adam wd=0.1,"
        f" micro {B} x {T} tokens, clip=1.0 WarmupLR; {flops:.4e} "
        f"flops/sample; the named stage outputs are {named} bytes a step")

    def run(policy):
        cfg = dataclasses.replace(base, remat=policy)
        torch.cuda.empty_cache()
        params = _gpt2_params(cfg, 19, torch.float32)
        eng = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                         optimizer=fused_adam(lr=_warmup(),
                                              weight_decay=0.1))[0]
        del params
        torch.cuda.synchronize()
        timer = ThroughputTimer(batch_size=B, seq_len=T,
                                flops_per_sample=flops,
                                start_step=GPT2_TRAIN_STEPS - 1,
                                device="cuda")
        _zero(fns.values())
        rows = []
        for _ in range(GPT2_TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            remat.offload.reset()
            timer.start()
            ts = time.perf_counter()
            loss = float(eng.train_batch(batch))
            ms = (time.perf_counter() - ts) * 1e3
            timer.stop()
            rows.append({"loss": loss, "ms": ms,
                         "grad_norm": eng.get_global_grad_norm(),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "offloaded_bytes": remat.offload.bytes,
                         "offloaded_tensors": remat.offload.tensors})
        path = f"gpt2-1.3b training remat={policy}"
        used = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        digest = _state_digest(eng.state)
        leaves = len(tree_leaves(eng.state.params))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            float(eng.train_batch(batch))
            traced = (time.perf_counter() - ts) * 1e3
        evs = _device_events(prof)
        copies = sum(e.self_device_time_total for e in evs
                     if "Memcpy" in e.key) / 1e3
        kernels = sum(e.self_device_time_total for e in evs
                      if "Memcpy" not in e.key) / 1e3
        out = {"steps": rows, "launches": used, "digest": digest,
               "leaves": leaves, "tput": timer.summary(),
               "traced_ms": traced, "kernel_busy_ms": kernels,
               "copy_ms": copies,
               "idle_share": 1.0 - kernels / traced if kernels else None,
               "top": [(e.key[:60], e.count,
                        round(e.self_device_time_total / 1e3, 2))
                       for e in sorted(evs, key=lambda e:
                                       -e.self_device_time_total)[:8]]}
        log(f"[gpt2 train] remat={policy}: losses "
            f"{[r['loss'] for r in rows]} ms/step "
            f"{[round(r['ms'], 1) for r in rows]} peak GB "
            f"{[round(r['peak_gb'], 3) for r in rows]} offloaded bytes/step "
            f"{[r['offloaded_bytes'] for r in rows]} ({rows[-1]['offloaded_tensors']}"
            f" tensors); ThroughputTimer over the last step: "
            f"{out['tput']['tokens_per_sec']:.1f} tokens/s, "
            f"{out['tput']['tflops']:.1f} TFLOP/s, MFU {out['tput']['mfu']:.4f};"
            f" profiled step {traced:.1f} ms host clock, kernels {kernels:.1f}"
            f" ms, copies {copies:.1f} ms on the device, idle share "
            f"{out['idle_share']}; top device time {out['top']} on "
            f"{card_line}; launches {used}")
        del eng, prof
        gc.collect()
        torch.cuda.empty_cache()
        return out

    runs = {p: run(p) for p in GPT2_REMATS}
    L, S = base.n_layers, GPT2_TRAIN_STEPS
    launches = {}
    for p, r in runs.items():
        want = {"flash_fwd": (1 if p == "none" else 2) * L * S,
                "flash_bwd_dq": L * S, "flash_bwd_dkv": L * S,
                "fused_adam": S * r["leaves"]}
        c = r["launches"]
        if any(c[k] != v for k, v in want.items()) or any(
                c[k] for k in c if k not in want):
            raise SystemExit(f"phase 19: remat={p} launches {c}, expected "
                             f"{want}")
        if not all(np.isfinite(x["loss"]) for x in r["steps"]):
            raise SystemExit(f"phase 19: remat={p} loss is not finite")
        launches[f"gpt2-1.3b training remat={p}"] = c
    sa, off, no = runs["save_attn"], runs["offload_attn"], runs["none"]
    equal = (off["digest"] == sa["digest"] and [x["loss"] for x in
                                                off["steps"]]
             == [x["loss"] for x in sa["steps"]])
    none_equal = no["digest"] == sa["digest"]
    moved = [x["offloaded_bytes"] for x in off["steps"]]
    saved = [s["peak_gb"] - o["peak_gb"] for s, o in zip(sa["steps"],
                                                          off["steps"])]
    log(f"[gpt2 train] offload_attn vs save_attn: state after {S} steps "
        f"bit-equal (so are the gradients) {equal}; moved {moved} bytes a "
        f"step (the named outputs: {named}); peak lower by "
        f"{[round(x, 3) for x in saved]} GB; ms/step "
        f"{[round(x['ms'], 1) for x in off['steps']]} against "
        f"{[round(x['ms'], 1) for x in sa['steps']]}; remat=none bit-equal "
        f"to save_attn {none_equal} (informational); phase 19 took "
        f"{time.perf_counter() - t_phase:.1f} s on {card_line}")
    if not equal:
        raise SystemExit("phase 19: offload_attn differs from save_attn")
    if any(m != named for m in moved) or min(saved) * 1e9 < named / 2:
        raise SystemExit("phase 19: offload_attn did not move the named "
                         "outputs off the card")
    return launches, runs


# ------------------------------------------------------------ phase 20
# Mixtral-8x7B: full width (4096, 32 heads of 128, 8 kv heads, 8 experts,
# top-2, V 32000); bf16 serving cut to 8 layers (the 93.4 GB bf16 model
# does not fit the card), int8 serving at all 32, training at 2
# phase 21's bf16 engine at 4 layers (8 before phases 62-64, 16 before
# phases 48-52: the smoke's time; int8 stays at all 32)
MIXTRAL_BF16_LAYERS, MIXTRAL_TRAIN_LAYERS = 4, 2
# new tokens a request (32 until PR 20: the smoke's time)
# phase 21's new tokens a request (16 before phases 60-61: the smoke's
# time; an int8 decode step at 32 layers takes ~0.4 s)
MIXTRAL_NEW = 8
# phase 21's first prefill, the kernel arm's logits against the plain
# arm's (B1 and B5 against the reference attention and the xla paged arm,
# bf16, 8 layers), on the rows whose own top-2 routing agrees in every
# layer: the largest |difference| over the largest |logit|.  A bf16
# near-tie flip (C-w2) moves its row by O(1); it is counted, not gated
MIXTRAL_LOGITS_REL_TOL = 5e-2
# gate values on the card against the CPU's: f32 softmax / logsumexp of
# two devices, a few ulps apart
GATE_TOL = 1e-6


def phase_mixtral_kernels(gen):
    """The kernels at Mixtral's new shapes, each against its plain version
    and timed on the device clock beside its bound and library call: B6 at
    V = 32000 on ``logits[:, -1]`` rows of [8, 2, V] (ties planted); B9 on
    one layer's expert stack ``w1[l]`` = [8, 4096, 14336] bf16 (what the
    int8 build quantizes a launch at a time), bit for bit; B4 on the
    training run's largest leaf, ``w1`` at 2 layers = [2, 8, 4096, 14336]
    f32 (939.5 M elements), beside ``_fused_adamw_``; B2/B3 at the training
    shape [4, 1024, 32 / 8 heads, 128] causal.  Returns {kernel name: its
    Mixtral cases}."""
    from deepspeed_tpu_torch.ops.adam_cuda import (adam_scalars, adam_update,
                                                   adam_update_reference)
    from deepspeed_tpu_torch.ops.quant_cuda import (quant_body, quantize_rows,
                                                    quantize_rows_reference)
    from deepspeed_tpu_torch.ops.sampling_cuda import (fused_greedy_rows,
                                                       greedy_rows_reference)

    out = {"greedy_argmax": {}, "quantize": {}, "fused_adam": {},
           "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    ok = True
    V = 32000
    for dtype in (torch.float32, torch.bfloat16):
        last = torch.randn((8, 2, V), generator=gen, device="cuda").to(
            dtype)[:, -1]
        for b in range(8):
            last[b, [b, V // 3 + b, V // 2, V - 1 - b]] = 30.0
        _zero([fused_greedy_rows])
        got = fused_greedy_rows(last)
        exact = bool(torch.equal(got, greedy_rows_reference(last))
                     and torch.equal(got.long(), torch.argmax(last, -1))
                     and got.tolist() == list(range(8))
                     and fused_greedy_rows.body_launches["row"] == 0)
        case = _greedy_case(fused_greedy_rows, last.contiguous())
        case["exact"] = exact
        key = f"B8 V{V} {str(dtype)[6:]} rows logits[:, -1]"
        out["greedy_argmax"][key] = case
        log(f"[mixtral kernels] greedy {key}: exact {exact} (tol: exact), "
            f"cluster body; from HBM device {case['device_ms']} ms (bound "
            f"{case['bound_ms']:.5f} ms, share {case['bound_share']}); argmax"
            f" device {case['library_device_ms']} ms; plain "
            f"{case['plain_ms']:.4f} ms")
        ok = ok and exact

    E, d, f = 8, 4096, 14336
    w = torch.empty((E, d, f), dtype=torch.bfloat16, device="cuda")
    for m in w:
        m.normal_(generator=gen)
    rows = w.view(-1, 128)
    G, n = rows.shape[0], w.numel()
    vec = quant_body(rows) == "vec"
    q, sc = quantize_rows(rows)
    exact = True
    for lo in range(0, G, 1 << 22):      # plain version in slices (memory)
        rq, rs = quantize_rows_reference(rows[lo:lo + (1 << 22)])
        exact = exact and torch.equal(q[lo:lo + (1 << 22)], rq) \
            and torch.equal(sc[lo:lo + (1 << 22)], rs)
        del rq, rs
    del q, sc
    dev = device_ms(lambda: quantize_rows(rows), iters=10)
    plain = time_ms(lambda: quantize_rows_reference(rows), iters=2, warmup=1)
    b_ms, b_by = bound(n * 2 + n + G * 4, 5 * n, F32_FLOPS_PER_S)
    key = "expert slice w1[l] [8, 4096, 14336] bf16"
    out["quantize"][key] = {"exact": exact, "vec": vec, "device_ms": dev,
                            "plain_ms": plain, "bound_ms": b_ms,
                            "bound_by": b_by, "bound_share": _share(b_ms, dev),
                            "library_ms": None}
    log(f"[mixtral kernels] B9 {key}: bit-equal to the plain version {exact}"
        f", vector body {vec}; device {dev} ms (bound {b_ms:.4f} ms {b_by},"
        f" share {_share(b_ms, dev)}); plain {plain:.2f} ms")
    ok = ok and exact and vec
    del w, rows
    torch.cuda.empty_cache()

    n = MIXTRAL_TRAIN_LAYERS * E * d * f
    c1, c2 = adam_scalars(0.9, 0.999, 9)
    g = torch.randn((n,), generator=gen, device="cuda")
    p = torch.randn((n,), generator=gen, device="cuda")
    m = torch.randn((n,), generator=gen, device="cuda") * 0.1
    v = torch.rand((n,), generator=gen, device="cuda") * 0.01
    got = adam_update(g, m, v, p, c1, c2, 1e-3, wd=0.1)
    err = 0.0
    for lo in range(0, n, 1 << 28):     # plain version in slices (memory)
        sl = slice(lo, lo + (1 << 28))
        want = adam_update_reference(g[sl], m[sl], v[sl], p[sl], c1, c2,
                                     1e-3, wd=0.1)
        err = max(err, max((a[sl] - b).abs().max().item()
                           for a, b in zip(got, want)))
        del want
    del got
    fn = functools.partial(adam_update, g, m, v, p, c1, c2, 1e-3, wd=0.1)
    dev = device_ms(fn, iters=5)
    plain = time_ms(lambda: adam_update_reference(g, m, v, p, c1, c2, 1e-3,
                                                  wd=0.1), iters=2, warmup=1)
    del fn, g, p, m, v
    torch.cuda.empty_cache()
    library, library_dev = _fused_adamw_ms(n, gen, device_clock=True)
    torch.cuda.empty_cache()
    b_ms, b_by = bound(n * (4 + 4 * 3 + 4 * 3), 15 * n, F32_FLOPS_PER_S)
    key = "w1 at 2 layers [2, 8, 4096, 14336] f32"
    out["fused_adam"][key] = {
        "max_abs_err": err, "tol": ADAM_TOL, "device_ms": dev,
        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "bound_share": _share(b_ms, dev),
        "library_ms": library, "library_device_ms": library_dev}
    log(f"[mixtral kernels] B4 {key} ({n} elements): max_abs_err {err:.3e} "
        f"(tol {ADAM_TOL}); device {dev} ms (bound {b_ms:.4f} ms {b_by}, "
        f"share {_share(b_ms, dev)}); plain {plain:.2f} ms; _fused_adamw_ "
        f"{library} ms (device {library_dev})")
    ok = ok and err <= ADAM_TOL

    for name, case in _gpt2_flash_bwd(gen, 32, 128, B=4, T=1024, KV=8,
                                      tag="mixtral kernels").items():
        out[name]["B4 T1024 H32 KV8 D128 causal"] = case
        ok = ok and case["wgmma"] and case["over_gate_faithful"] and \
            case.get("delta_rel", 0) <= FLASH_DELTA_REL_TOL
    if not ok:
        raise SystemExit("phase 20: a kernel disagrees at Mixtral's shapes")
    return out


def phase_mixtral_identity(fns):
    """Kernel arms vs plain arms on a tiny f32 Mixtral (dim 64, 4 experts,
    top-2; card against CPU):
    the engine with whole-prompt prefill, ``prefill_chunk`` and
    ``decode_chunk``; ``mixtral_generator`` (B6) and
    ``mixtral_paged_generator`` (B1, B5, B6); the engine against the paged
    generator; greedy tokens identical on every pair, no leaks.  Then the
    capacity gate at the training shape (4096 tokens, 8 experts, top-2,
    C = 1280): the dispatch on the card equal to the CPU's, the combine and
    the losses at ``GATE_TOL``."""
    from deepspeed_tpu_torch._tree import tree_map
    from deepspeed_tpu_torch.inference.generation import (
        mixtral_generator, mixtral_paged_generator)
    from deepspeed_tpu_torch.inference.serving import mixtral_serving_engine
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    from deepspeed_tpu_torch.parallel.moe import capacity, top_k_gating
    from deepspeed_tpu_torch.weights import init_params

    # dim 64: head_dim 16, the smallest the CUDA attention kernels take
    # (the JAX preset's dim 32 gives 8, which the CPU tests run)
    cfg = MixtralConfig.tiny(dim=64)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(20),
                         device="cuda", dtype=torch.float32)
    host = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(20)
    prompts = {f"m{i}": rng.integers(1, cfg.vocab_size,
                                     rng.integers(3, 40)).tolist()
               for i in range(6)}
    opts = dict(max_batch=3, page_size=8, num_pages=48, max_seq=64,
                prefill_bucket=8, cache_dtype=torch.float32)

    def counts():
        return {n: f.launches for n, f in fns.items()}

    for label, extra in (("whole prompt", {}),
                         ("prefill_chunk=8", {"prefill_chunk": 8}),
                         ("decode_chunk=4", {"decode_chunk": 4})):
        outs, used = [], []
        for p, dev in ((params, "cuda"), (host, "cpu")):
            _zero(fns.values())
            eng = mixtral_serving_engine(p, cfg, device=dev, **extra, **opts)
            for rid, prompt in prompts.items():
                eng.submit(rid, prompt, max_new_tokens=12)
            outs.append(eng.run())
            used.append(counts())
            _check_bodies(f"mixtral identity {label}", hopper=False,
                          record=False)
            if eng.check_leaks():
                raise SystemExit(f"mixtral identity: leaks "
                                 f"{eng.check_leaks()}")
        same = outs[0] == outs[1]
        log(f"[mixtral identity] engine mixtral-tiny f32 {label}: card "
            f"(kernels) == CPU (plain versions): {same} ({len(outs[0])} "
            f"requests); launches card {used[0]} CPU {used[1]}")
        if not same or any(used[1].values()):
            raise SystemExit("mixtral identity: the engine's arms differ")
        _check_launches(f"mixtral identity {label}", used[0],
                        [n for n in SERVING_KERNELS
                         if "prefill_chunk" not in extra or n != "flash_fwd"])
    toks = rng.integers(1, cfg.vocab_size, (3, 11))
    gen_out = {}
    for label, build, want in (
            ("mixtral_generator", mixtral_generator, ("greedy_argmax",)),
            ("mixtral_paged_generator", mixtral_paged_generator,
             SERVING_KERNELS)):
        kw = {"page_size": 8} if label == "mixtral_paged_generator" else {}
        _zero(fns.values())
        card_out = build(params, cfg, cache_dtype=torch.float32,
                         device="cuda", **kw).generate(
                             toks, max_new_tokens=12).cpu()
        used = counts()
        _check_bodies(f"mixtral identity {label}", hopper=False,
                      record=False)
        cpu_out = build(host, cfg, cache_dtype=torch.float32, device="cpu",
                        **kw).generate(toks, max_new_tokens=12)
        same = torch.equal(card_out, cpu_out)
        log(f"[mixtral identity] {label} mixtral-tiny f32 B=3 T=11 new=12: "
            f"card (kernels) == CPU (plain versions): {same}; launches "
            f"{used}")
        if not same:
            raise SystemExit(f"mixtral identity: {label} differs from its "
                             "plain arm")
        _check_launches(f"mixtral identity {label}", used, want)
        gen_out[label] = card_out
    eng = mixtral_serving_engine(params, cfg, **opts)
    for i, p in enumerate(toks):
        eng.submit(i, p.tolist(), max_new_tokens=12)
    out = eng.run()
    same = all(out[i] == gen_out["mixtral_paged_generator"][i].tolist()
               for i in range(3)) and eng.check_leaks() == []
    log(f"[mixtral identity] engine == mixtral_paged_generator on the same "
        f"3 prompts: {same}")
    if not same:
        raise SystemExit("mixtral identity: the engine and the paged "
                         "generator differ")

    N, E = 4096, 8
    cap = capacity(N, E, 2, 1.25)
    logits = torch.randn((N, E), generator=torch.Generator("cuda")
                         .manual_seed(20), device="cuda") * 2.0
    logits[:, 0] += 1.0                 # a skew, so an expert overflows
    got = top_k_gating(logits, 2, cap)
    want = top_k_gating(logits.cpu(), 2, cap)
    dispatch_equal = torch.equal(got.dispatch.cpu(), want.dispatch)
    errs = {name: (getattr(got, name).cpu() - getattr(want, name)).abs()
            .max().item()
            for name in ("combine", "aux_loss", "z_loss", "expert_load")}
    kept = int(want.dispatch.sum().item())
    log(f"[mixtral identity] capacity gate N={N} E={E} top-2 C={cap}: "
        f"dispatch card == CPU {dispatch_equal} ({kept} of {2 * N} choices "
        f"kept); max |card - CPU| {errs} (tol {GATE_TOL})")
    if not dispatch_equal or max(errs.values()) > GATE_TOL or kept >= 2 * N:
        raise SystemExit("mixtral identity: the gate on the card differs "
                         "from the CPU's")


def _record(module, name, label):
    """Wrap ``module.name`` so that each call runs under a profiler range
    ``label``; returns a function that puts the original back."""
    from torch.profiler import record_function

    orig = getattr(module, name)

    def wrapped(*a, **k):
        with record_function(label):
            return orig(*a, **k)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, orig)


def _range_ms(prof, label) -> float:
    """Device time of the kernels launched inside the ranges ``label`` (the
    host-side ranges: each holds its kernels' device time)."""
    from torch.autograd import DeviceType

    total = 0.0
    for e in prof.key_averages():
        if e.key == label and e.device_type == DeviceType.CPU:
            total += getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
    return total / 1e3


def _mixtral_decode_split(params, cfg, tag, card_line):
    """One decode step of 8 rows (histories of 128-896 tokens) through
    ``mixtral.forward_paged`` under ``torch.profiler``: the device time of
    the step and of its parts, dequantization (``quantized.take``: every
    layer's leaves, to bf16), the MoE FFN (router, the 8 experts' products
    on every token, the combine) and attention (K/V page writes and B5)."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference import kernels
    from deepspeed_tpu_torch.inference.kernels import PagedKVCache
    from deepspeed_tpu_torch.models import llama, mixtral

    B, ps, max_seq = 8, 16, 1024
    cache = PagedKVCache.alloc(cfg.n_layers, cfg.n_kv_heads,
                               B * (max_seq // ps) + 1, ps, cfg.head_dim, B,
                               max_seq, device="cuda")
    cache.seq_lens.copy_(torch.arange(128, 1024, 112, dtype=torch.int32))
    tok = torch.randint(1, cfg.vocab_size, (B, 1), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
    with torch.inference_mode():
        mixtral.forward_paged(params, tok, cfg, cache)      # warm
        torch.cuda.synchronize()
        undo = [_record(llama, "take", "dequant"),
                _record(mixtral, "_moe_ffn_dense", "moe"),
                _record(kernels, "paged_attention_step", "attention")]
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                ts = time.perf_counter()
                mixtral.forward_paged(params, tok, cfg, cache)
                torch.cuda.synchronize()
                host = (time.perf_counter() - ts) * 1e3
        finally:
            for u in undo:
                u()
    labels = ("dequant", "moe", "attention")
    split = {k: _range_ms(prof, k) for k in labels}
    # the device-side entries of the ranges themselves span their kernels
    # and the gaps between them: only the kernels, copies and sets count
    evs = [e for e in _device_events(prof) if e.key not in labels]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    out = {"host_ms": host, "device_ms": busy, **{f"{k}_ms": v
                                                  for k, v in split.items()},
           "launches": sum(e.count for e in evs),
           "top": [(e.key[:50], e.count,
                    round(e.self_device_time_total / 1e3, 3))
                   for e in sorted(evs, key=lambda e:
                                   -e.self_device_time_total)[:6]]}
    log(f"[mixtral split] {tag} decode step B=8: host {host:.2f} ms, device "
        f"{busy:.2f} ms ({out['launches']} kernels): dequantization "
        f"{split['dequant']:.2f} ms, MoE FFN {split['moe']:.2f} ms, "
        f"attention {split['attention']:.2f} ms, the rest "
        f"{busy - sum(split.values()):.2f} ms; top device time {out['top']} "
        f"on {card_line}")
    del cache
    return out


def _first_prefill_check(params, cfg, prompt):
    """The first prefill through both arms: the kernels (B1 prefill, the
    paged writes) against the plain arm (the reference attention, the
    ``xla`` paged arm), bf16.  Returns the relative error over the rows
    whose own routing agrees in every layer, that over every row, and the
    (token, layer) routings that differ."""
    import dataclasses

    from deepspeed_tpu_torch.inference.kernels import PagedKVCache
    from deepspeed_tpu_torch.models import mixtral

    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    T = toks.shape[1]
    logits, routes = [], []
    top_k = mixtral._top_k
    for arm_cfg, pk in ((cfg, None),
                        (dataclasses.replace(cfg, attn_impl="reference"),
                         "xla")):
        picks = []
        mixtral._top_k = lambda lg, k: picks.append(top_k(lg, k)) or picks[-1]
        try:
            cache = PagedKVCache.alloc(cfg.n_layers, cfg.n_kv_heads,
                                       -(-T // 16) + 1, 16, cfg.head_dim, 1,
                                       T, device="cuda")
            with torch.inference_mode():
                out, _ = mixtral.forward_paged(params, toks, arm_cfg, cache,
                                               paged_kernel=pk)
            logits.append(out[0].float())
        finally:
            mixtral._top_k = top_k
        routes.append(torch.stack(picks).sort(-1).values)     # [L, T, k]
        del cache
    differ = (routes[0] != routes[1]).any(-1)                 # [L, T]
    clean = ~differ.any(0)
    diff = (logits[0] - logits[1]).abs()
    scale = logits[1].abs().max().item()
    rel_clean = (diff[clean].max().item() / scale) if clean.any() else None
    return rel_clean, diff.max().item() / scale, int(differ.sum()), \
        int(clean.sum()), T


def phase_mixtral_serving(fns, card_line):
    """Mixtral-8x7B at full width, seeded weights.  bf16 at 8 layers
    (23.5 GB): the first prefill's logits through the kernel arm against
    the plain arm; the engine (max_batch 8, pages of 16, max_seq 1024) over 8
    prompts of 64-768 tokens, MIXTRAL_NEW new tokens each, whole-prompt and
    ``prefill_chunk=256``; ``mixtral_generator`` and
    ``mixtral_paged_generator`` on 8 prompts of 128; a decode step's
    split.  Then int8 at all 32 layers (48.2 GB), built a layer at a time
    by ``weights.init_quantized_params`` (B9 per layer and leaf), the
    router kept exact: the engine's traffic whole and chunked, a decode
    step's split, and one ``init_inference(dtype="int8")`` forward over
    ``mixtral.forward_eval``."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.generation import (
        mixtral_generator, mixtral_paged_generator)
    from deepspeed_tpu_torch.inference.quantized import (QuantizedTensor,
                                                         param_bytes)
    from deepspeed_tpu_torch.inference.serving import (MIXTRAL_INT8_SKIP,
                                                       mixtral_serving_engine)
    from deepspeed_tpu_torch.models import mixtral
    from deepspeed_tpu_torch.weights import (init_params,
                                             init_quantized_params)

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                              n_layers=MIXTRAL_BF16_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(21),
                         device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[mixtral serving] mixtral_8x7b layers={cfg.n_layers} (of 32) dim="
        f"{cfg.dim} heads={cfg.n_heads}/{cfg.n_kv_heads} experts="
        f"{cfg.num_experts} top_k={cfg.top_k} vocab={cfg.vocab_size} params="
        f"{mixtral.param_count(cfg)} bf16 random seeded weights "
        f"({param_bytes(params) / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(21)
    lens = np.linspace(64, 768, 8).astype(int).tolist()
    prompts = {f"x{i}": rng.integers(1, cfg.vocab_size, n).tolist()
               for i, n in enumerate(lens)}
    rel_clean, rel_all, flips, clean, T = _first_prefill_check(
        params, cfg, prompts["x7"])
    log(f"[mixtral serving] first prefill T={T}, kernel arm vs plain arm: "
        f"max |diff| / max |logit| {rel_clean} over the {clean} rows routed "
        f"alike in every layer (tol {MIXTRAL_LOGITS_REL_TOL}), {rel_all:.4e} "
        f"over all rows; {flips} of {T * cfg.n_layers} (token, layer) top-2 "
        f"routings differ between the arms (bf16 near-ties, counted)")
    if rel_clean is None or rel_clean > MIXTRAL_LOGITS_REL_TOL:
        raise SystemExit("phase 21: the kernel arm's first prefill differs "
                         "from the plain arm's")
    opts = dict(max_batch=8, page_size=16, max_seq=1024, num_pages=513,
                cache_dtype=torch.bfloat16)
    launches, results = {}, {"first_prefill": {
        "rel_err_clean_rows": rel_clean, "rel_err_all_rows": rel_all,
        "routing_flips": flips, "clean_rows": clean, "T": T}}
    for chunk in (0, 256):
        path = (f"mixtral-8x7b-{MIXTRAL_BF16_LAYERS}L bf16 serving "
                f"prefill_chunk={chunk}")
        torch.cuda.reset_peak_memory_stats()
        _zero(fns.values())
        out, leaks, m = serve(params, cfg, prompts, MIXTRAL_NEW,
                              prefill_chunk=chunk, **opts)
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        done = _valid(out, prompts, MIXTRAL_NEW, cfg.vocab_size)
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[mixtral serving] bf16 prefill_chunk={chunk} prompts={lens} "
            f"new={MIXTRAL_NEW}: finished {len(out)}/8 all_valid {done} "
            f"check_leaks {leaks}; tokens/s {m['tokens_per_s']:.2f} "
            f"ttft_mean {m['ttft_s_mean'] * 1e3:.1f} ms ms/decode_step "
            f"{m['ms_per_decode_step']} peak_mem {m['peak_mem_gb']:.2f} GB "
            f"on {card_line}; kernel launches {launches[path]}")
        if not done or leaks:
            raise SystemExit(f"{path} failed")
        _check_launches(path, launches[path],
                        [n for n in SERVING_KERNELS
                         if chunk == 0 or n != "flash_fwd"])
        results[path] = m
    toks = rng.integers(1, cfg.vocab_size, (8, 128))
    for label, build, want in (
            ("mixtral_generator", mixtral_generator, ("greedy_argmax",)),
            ("mixtral_paged_generator", mixtral_paged_generator,
             SERVING_KERNELS)):
        path = f"mixtral-8x7b-{MIXTRAL_BF16_LAYERS}L {label}"
        _, launches[path], results[path] = _gpt2_generate(
            build, params, cfg, toks, path, fns, card_line,
            tag="mixtral serving")
        _check_launches(path, launches[path], want)
    results["bf16 decode split"] = _mixtral_decode_split(
        params, cfg, f"bf16 {MIXTRAL_BF16_LAYERS} layers", card_line)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = mixtral.MixtralConfig.mixtral_8x7b()
    path = "mixtral-8x7b int8 build"
    torch.cuda.reset_peak_memory_stats()
    _zero(fns.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = init_quantized_params(
        cfg, torch.Generator("cuda").manual_seed(21), MIXTRAL_INT8_SKIP,
        device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches[path] = {n: f.launches for n, f in fns.items()}
    _check_bodies(path)
    gates_exact = not isinstance(qparams["blocks"]["gate"], QuantizedTensor)
    w1 = qparams["blocks"]["w1"]
    stacked = 7 * cfg.n_layers + 2       # 7 matrix leaves a layer, 2 tables
    results[path] = {"build_s": build_s,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "resident_gb": param_bytes(qparams) / 1e9}
    log(f"[mixtral int8] mixtral_8x7b all {cfg.n_layers} layers, params "
        f"{mixtral.param_count(cfg)}: built a layer at a time in {build_s:.1f}"
        f" s, peak {results[path]['peak_gb']:.2f} GB, resident "
        f"{results[path]['resident_gb']:.2f} GB (w1 codes {tuple(w1.q.shape)}"
        f" = {w1.q.numel()} elements, scales {tuple(w1.scale.shape)}); "
        f"router (gate) exact {gates_exact}; B9 launches "
        f"{launches[path]['quantize']} (expected {stacked}) on {card_line}")
    if not gates_exact or launches[path]["quantize"] != stacked:
        raise SystemExit("phase 21: the int8 build is wrong")
    _check_launches(path, launches[path], ("quantize",))
    eng = None
    for chunk in (0, 256):
        path = f"mixtral-8x7b int8 serving prefill_chunk={chunk}"
        eng = mixtral_serving_engine(qparams, cfg, weight_dtype="int8",
                                     prefill_chunk=chunk, **opts)
        if isinstance(eng.params["blocks"]["gate"], QuantizedTensor):
            raise SystemExit("phase 21: the int8 engine quantized the router")
        torch.cuda.reset_peak_memory_stats()
        _zero(fns.values())
        out, m = drive(eng, prompts, MIXTRAL_NEW)
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        leaks = eng.check_leaks()
        done = _valid(out, prompts, MIXTRAL_NEW, cfg.vocab_size)
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[mixtral int8] prefill_chunk={chunk}: finished {len(out)}/8 "
            f"all_valid {done} check_leaks {leaks}; tokens/s "
            f"{m['tokens_per_s']:.2f} ttft_mean {m['ttft_s_mean'] * 1e3:.1f}"
            f" ms ms/decode_step {m['ms_per_decode_step']} peak_mem "
            f"{m['peak_mem_gb']:.2f} GB on {card_line}; kernel launches "
            f"{launches[path]}")
        if not done or leaks:
            raise SystemExit(f"{path} failed")
        _check_launches(path, launches[path],
                        [n for n in SERVING_KERNELS
                         if chunk == 0 or n != "flash_fwd"])
        results[path] = m
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    results["int8 decode split"] = _mixtral_decode_split(
        qparams, cfg, "int8 32 layers", card_line)
    torch.cuda.empty_cache()
    # init_inference(dtype="int8") over the int8 tree: the leaves the
    # engine keeps exact quantize there, as JAX's engine quantizes every
    # ndim >= 2 leaf (gate, attn_norm, mlp_norm: 3 B9 launches)
    toks1 = torch.tensor([prompts["x7"]], dtype=torch.long, device="cuda")
    path = "mixtral-8x7b int8 init_inference"
    torch.cuda.reset_peak_memory_stats()
    _zero(fns.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ie = init_inference(apply_fn=functools.partial(mixtral.forward_eval,
                                                   cfg=cfg),
                        params=qparams, dtype="int8")
    logits = ie(toks1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches[path] = {n: f.launches for n, f in fns.items()}
    _check_bodies(path)
    ok = (tuple(logits.shape) == (1, toks1.shape[1], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()))
    log(f"[mixtral int8] init_inference(dtype=int8) with mixtral.forward_eval"
        f", one forward of [1, {toks1.shape[1]}]: {ms:.1f} ms (build "
        f"included), logits finite of shape {ok}, peak_mem "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; B9 launches "
        f"{launches[path]['quantize']} on {card_line}; kernel launches "
        f"{launches[path]}; phase 21 took {time.perf_counter() - t_phase:.1f}"
        " s")
    del ie, logits, qparams, w1
    gc.collect()
    torch.cuda.empty_cache()
    if not ok or launches[path]["quantize"] != 3:
        raise SystemExit(f"{path} failed")
    _check_launches(path, launches[path], ("flash_fwd", "quantize"))
    return launches, results


# ------------------------------------------------------------ phase 22
# Mixtral-8x7B widths at 2 layers: micro 4 x 1024 (+1) tokens, capacity
# factor 1.25 (C = 1280 of 4096 tokens), remat="save_attn"
MIXTRAL_TRAIN_STEPS, MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_T = 5, 4, 1024


def _mixtral_flops_per_sample(cfg, T):
    """Active model FLOPs of one training sample of T tokens (3x the
    forward; the remat recompute not counted): per token and layer the
    attention projections, the router and the top-k experts' three
    products (k of E, not the E x C rows the capacity dispatch computes,
    nor the dispatch and combine products), the LM head, and causal
    attention over the row."""
    d, f, L, V = cfg.dim, cfg.ffn_dim, cfg.n_layers, cfg.vocab_size
    kvd = cfg.n_kv_heads * cfg.head_dim
    per_token = L * (2 * d * d + 2 * d * kvd + d * cfg.num_experts
                     + cfg.top_k * 3 * d * f) + d * V
    attn = L * 2 * 2 * cfg.n_heads * cfg.head_dim * (T * (T + 1) // 2)
    return 3 * (2 * T * per_token + attn)


def _moe_product_ms(cfg, N, cap):
    """Device ms a ``save_attn`` training step spends in the MoE layer's
    products, each timed alone on the device clock at the step's shapes
    and multiplied by its count a step: the dispatch and combine products
    (2-D, [N, E*C] against [.., d]: per layer two in the forward, two in
    the recompute, three in the backward, the dispatch tensor taking no
    gradient) and the expert products (batched over E, [E, C, d] against
    [E, d, f] or [E, f, d]: three, three and six)."""
    E, d, f, L = cfg.num_experts, cfg.dim, cfg.ffn_dim, cfg.n_layers
    dt = torch.bfloat16
    a = torch.randn((N, E * cap), device="cuda").to(dt)
    x = torch.randn((N, d), device="cuda").to(dt)
    h = torch.randn((E, cap, d), device="cuda").to(dt)
    w = torch.randn((E, d, f), device="cuda").to(dt)
    one = device_ms(lambda: a.T @ x, iters=10)
    expert = device_ms(lambda: torch.bmm(h, w), iters=10)
    del a, x, h, w
    torch.cuda.empty_cache()
    return (None if one is None else 7 * L * one,
            None if expert is None else 12 * L * expert)


def phase_mixtral_train(fns, card_line):
    """Mixtral-8x7B at full width cut to 2 layers (3.16 B params: f32
    master, m and v, the bf16 copy and the f32 gradients), trained through
    the capacity-limited top-2 gate: bf16 compute, fused Adam (B4),
    WarmupLR, clipping 1.0, ``remat="save_attn"``, micro 4 x 1024 on one
    seeded batch, ``has_aux=True``.  The loss must fall; each step's aux
    and z losses and expert load are logged; ms/step, peak memory,
    ``ThroughputTimer`` tokens/s and MFU over the active top-2 FLOPs; a
    profiled step's idle share and the shares of its dispatch / combine
    products and of the expert products."""
    import dataclasses
    import gc

    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.mixtral import (MixtralConfig, loss_fn,
                                                    param_count)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.parallel.moe import capacity
    from deepspeed_tpu_torch.timers import ThroughputTimer
    from deepspeed_tpu_torch.weights import init_params

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(MixtralConfig.mixtral_8x7b(),
                              n_layers=MIXTRAL_TRAIN_LAYERS,
                              remat="save_attn")
    B, T, S = MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_T, MIXTRAL_TRAIN_STEPS
    cap = capacity(B * T, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
    rng = np.random.default_rng(22)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    flops = _mixtral_flops_per_sample(cfg, T)
    log(f"[mixtral train] mixtral_8x7b widths, layers={cfg.n_layers} params="
        f"{param_count(cfg)} f32 master, bf16 compute, fused_adam wd=0.1, "
        f"micro {B} x {T} tokens, capacity factor {cfg.capacity_factor} (C="
        f"{cap}), remat={cfg.remat}, clip=1.0 WarmupLR; {flops:.4e} active "
        "flops/sample")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(22),
                         device="cuda", dtype=torch.float32)
    eng = initialize(loss_fn=loss_fn(cfg), params=params,
                     config=_train_config(B, 1, {"bf16": {"enabled": True}}),
                     optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
                     has_aux=True)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    timer = ThroughputTimer(batch_size=B, seq_len=T, flops_per_sample=flops,
                            start_step=S - 1, device="cuda")
    _zero(fns.values())
    rows = []
    for _ in range(S):
        torch.cuda.reset_peak_memory_stats()
        timer.start()
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        ms = (time.perf_counter() - ts) * 1e3
        timer.stop()
        aux = eng.metrics["aux"]
        rows.append({"loss": loss, "ms": ms,
                     "lm_loss": float(aux["lm_loss"]),
                     "moe_aux_loss": float(aux["moe_aux_loss"]),
                     "moe_z_loss": float(aux["moe_z_loss"]),
                     "moe_expert_load": [round(x, 4) for x in
                                         aux["moe_expert_load"].tolist()],
                     "grad_norm": eng.get_global_grad_norm(),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        log(f"[mixtral train] step {len(rows)}: {rows[-1]}")
    path = "mixtral-8x7b-2L training remat=save_attn"
    used = {n: f.launches for n, f in fns.items()}
    _check_bodies(path)
    leaves = len(tree_leaves(eng.state.params))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        float(eng.train_batch(batch))
        traced = (time.perf_counter() - ts) * 1e3
    evs = _device_events(prof)
    kernels = sum(e.self_device_time_total for e in evs) / 1e3
    dispatch_ms, expert_ms = _moe_product_ms(cfg, B * T, cap)
    out = {"steps": rows, "launches": used, "leaves": leaves,
           "tput": timer.summary(), "traced_ms": traced,
           "kernel_busy_ms": kernels,
           "idle_share": 1.0 - kernels / traced if kernels else None,
           "dispatch_combine_ms": dispatch_ms, "expert_ms": expert_ms,
           "flops_per_sample": flops, "capacity": cap,
           "top": [(e.key[:60], e.count, round(e.self_device_time_total / 1e3,
                                                 2))
                   for e in sorted(evs, key=lambda e:
                                   -e.self_device_time_total)[:8]]}
    log(f"[mixtral train] losses {[r['loss'] for r in rows]} ms/step "
        f"{[round(r['ms'], 1) for r in rows]} peak GB "
        f"{[round(r['peak_gb'], 3) for r in rows]}; ThroughputTimer over the "
        f"last step: {out['tput']['tokens_per_sec']:.1f} tokens/s, "
        f"{out['tput']['tflops']:.1f} TFLOP/s (active), MFU "
        f"{out['tput']['mfu']:.4f}; profiled step {traced:.1f} ms host "
        f"clock, kernels {kernels:.1f} ms, idle share {out['idle_share']}; "
        f"dispatch/combine products {dispatch_ms:.1f} ms "
        f"({dispatch_ms / traced:.3f} of the step), expert products "
        f"{expert_ms:.1f} ms ({expert_ms / traced:.3f}) (each timed alone at "
        f"the step's shapes, times its count a step); top device time "
        f"{out['top']} on {card_line}; launches {used}; phase 22 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del eng, prof
    gc.collect()
    torch.cuda.empty_cache()
    L = cfg.n_layers
    want = {"flash_fwd": 2 * L * S, "flash_bwd_dq": L * S,
            "flash_bwd_dkv": L * S, "fused_adam": S * leaves}
    if any(used[k] != v for k, v in want.items()) or any(
            used[k] for k in used if k not in want):
        raise SystemExit(f"phase 22: launches {used}, expected {want}")
    losses = [r["loss"] for r in rows]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"phase 22: the loss did not fall: {losses}")
    return {path: used}, out


# ------------------------------------------------------------ phase 23
# BERT-large (the encoder families' main paths): lots of 8 rows at the
# default buckets; its attention is bidirectional over 16 heads of 64
# (H = KV), with the attention mask passed as segment ids
BERT_B, BERT_BUCKETS = 8, (32, 64, 512)
# phase 24, tiny BERT on the card against its plain arm, set before the
# first card reading: f32 (head_dim 16, the scalar bodies) the same sums in
# another order, 1e-4 of the largest value; bf16 (head_dim 64, the
# tensor-core bodies) a bf16 ulp of o (3.9e-3 of it) carried through two
# post-LN layers and the heads: 5e-2 of the largest value.  The card (an
# NVIDIA H100 80GB HBM3 at 700.00 W) read f32 9e-8 to 4.7e-7 and bf16
# 5.1e-3 to 7.4e-3 (tiny, two layers), and at
# BERT-large's 24 layers on phase 25's queue 0.041 / 0.022 / 0.027 (pooled /
# MLM / hidden): bf16 roundings that differ once per attention grow through
# 24 post-LN layers
BERT_F32_REL_TOL = 1e-4
BERT_BF16_REL_TOL = 5e-2
# the int8 engine's pooled vectors against bf16's: the JAX test's bound
BERT_INT8_POOLED_ABS = 0.15
# phase 25: 64 requests of 8-512 tokens; BERT-large's kernel arm against
# its plain arm (reference attention) on the same queue, at phase 24's bf16
# bound; the int8 engine's pooled vectors hold a cosine of 0.95 or more
# against bf16's (set before the first card reading)
BERT_REQUESTS = 64
BERT_INT8_MIN_COSINE = 0.95
# phase 26: BERT-large at all 24 layers, MLM at T = 512, micro 8 x
# accumulation 2, 5 steps on one batch of rows 128-512 tokens long, 15 % of
# the real positions labelled
BERT_TRAIN_STEPS, BERT_TRAIN_MICRO, BERT_TRAIN_ACCUM, BERT_TRAIN_T = \
    5, 8, 2, 512
# phase 27: the CIFAR CNN, 64 images in lots of 8 against the CPU engine
# (f32, TF32 off: the same convolutions summed in another order), and 5
# train steps at batch 128 with the lr warmed up to 1e-4 (at 1e-3, Adam's
# first steps overshoot on one fixed batch: an NVIDIA H100 80GB HBM3 at
# 700.00 W read 2.66 -> 3.82 -> 3.66 -> 3.08 -> 2.72); then 3 f32 steps on
# the card against the same on
# the CPU, at test_torch_train.py's 1e-4 relative on the losses
CNN_IMAGES, CNN_TOL, CNN_TRAIN_B, CNN_TRAIN_STEPS = 64, 1e-4, 128, 5
CNN_LR, CNN_TRAIN_RTOL = 1e-4, 1e-4
def _pad_seg(lens, T):
    """[len(lens), T] int32: row b is 1 on its first lens[b] positions and
    0 after (BERT's attention mask as segment ids: ids that descend); a
    length of 0 is a filler row, all padding."""
    seg = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        seg[b, :n] = 1
    return torch.from_numpy(seg).to("cuda")


def _pad_pairs(lens, T):
    """Live (query, key) pairs of one head under pad ids: a row's real
    tokens see each other, its pads its pads."""
    return sum(n * n + (T - n) * (T - n) for n in lens)


def _bert_flash_bwd(gen, q, k, v, do, seg, lens, tag, causal=False,
                    tol=FLASH_BWD_REL_TOL, pairs=None):
    """B2 and B3 at BERT's training shape, bidirectional with pad ids (or
    ``causal`` without ids, ``seg`` and ``lens`` None; or causal with packed
    ids and their live ``pairs``), against the plain backward: B2's delta
    against ``flash_delta``, dq, dk and dv at the flash backward gate
    ``tol`` (an element over it must be a neighbour of the f64 oracle in
    q's dtype, C-f6), each timed on the device clock beside its bound (over
    the live pairs) and SDPA's backward under the same mask."""
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd_body, flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference,
        flash_delta, flash_fwd)

    B, T, H, D = q.shape
    KV = k.shape[2]
    wgmma = flash_bwd_body(q) == "wgmma"
    o, lse = flash_fwd(q, k, v, causal=causal, seg=seg)
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, seg, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seg, causal=causal)
    want = flash_bwd_reference(q, k, v, o, lse, do, seg, causal=causal)
    want_delta = flash_delta(o, do)
    torch.cuda.synchronize()
    got = {"dq": dq, "dk": dk, "dv": dv}
    err = {n: ((g.float() - w.float()).abs().max().item(), _rel(g, w))
           for (n, g), w in zip(got.items(), want)}
    delta_rel = _rel(delta, want_delta)
    over = dict.fromkeys(got, (0, True))
    if any(e[1] > tol for e in err.values()):
        dq64, dq_spec, dk64, dv64 = flash_bwd_f64_oracle(
            q, k, v, o, lse, do, seg, causal=causal)
        exact = {"dq": (dq64, dq_spec), "dk": (dk64,), "dv": (dv64,)}
        del dq64, dq_spec, dk64, dv64
        over = {n: _faithful_over_gate(got[n], w, exact[n], tol)
                for n, w in zip(got, want)}
        del exact
    del dq, dk, dv, got, want, want_delta
    plain = time_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do, seg,
                                                causal=causal),
                    iters=3, warmup=1)
    sdpa = _sdpa_bwd(q, k, v, do, seg, causal=causal)
    lib = sdpa and device_ms(sdpa, iters=10)
    del sdpa
    if pairs is None:
        pairs = (B * T * (T + 1) // 2 if causal else _pad_pairs(lens, T))
    io = (2 * B * T * D * (2 * H + 2 * KV) + 2 * B * T * D * (H + KV)
          + 8 * B * H * T + 4 * B * T)
    bounds = {"flash_bwd_dq": bound(io, 6 * D * pairs * H
                                    + 2 * B * T * H * D, BF16_FLOPS_PER_S),
              "flash_bwd_dkv": bound(io, 8 * D * pairs * H,
                                     BF16_FLOPS_PER_S)}
    fns = {"flash_bwd_dq": lambda: flash_bwd_dq(q, k, v, o, do, lse, seg,
                                                causal=causal),
           "flash_bwd_dkv": lambda: flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  seg, causal=causal)}
    out = {}
    for name, grads in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        dev = device_ms(fns[name], iters=10)
        b_ms, b_by = bounds[name]
        case = {"wgmma": wgmma, "causal": causal, "T": T, "lens": lens,
                "max_abs_err": max(err[n][0] for n in grads),
                "rel_err": max(err[n][1] for n in grads),
                "tol_rel": tol,
                "over_gate": sum(over[n][0] for n in grads),
                "over_gate_faithful": all(over[n][1] for n in grads),
                "device_ms": dev, "plain_ms": plain,
                "library_device_ms": lib,
                "library": "sdpa backward under the same mask",
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": _share(b_ms, dev)}
        if name == "flash_bwd_dq":
            case["delta_rel"] = delta_rel
        out[name] = case
        log(f"[{tag}] {name} B={B} T={T} H={H} KV={KV} D={D} "
            f"{str(q.dtype)[6:]} "
            + ("causal" if causal else "non-causal, pad ids")
            + (" + segments" if causal and seg is not None else "")
            + f": tensor-core body {wgmma}; rel err "
            f"{case['rel_err']:.3e} (tol {tol}) max_abs_err "
            f"{case['max_abs_err']:.3e}; {case['over_gate']} elements over "
            f"the gate, each a neighbour of the f64 oracle: "
            f"{case['over_gate_faithful']}"
            + (f" delta rel {delta_rel:.3e} (tol {FLASH_DELTA_REL_TOL})"
               if name == "flash_bwd_dq" else "")
            + f"; device {dev} ms (bound {b_ms:.5f} ms {b_by}, share "
            f"{_share(b_ms, dev)}); plain bwd {plain:.4f} ms; sdpa bwd "
            f"device {lib} ms")
    del o, lse, delta, fns
    return out


def phase_bert_kernels(gen):
    """B1 at BERT-large's serving shapes (lots of 8 rows at T = 32, 64 and
    512; 16 heads of 64, H = KV; bidirectional; pad ids from seeded lengths,
    one filler row of padding) and B2 / B3 at its training shape (T = 512),
    on the tensor-core bodies, against their plain versions; each timed on
    the device clock beside its bound (over this data's live pairs) and
    SDPA under the pad mask."""
    from deepspeed_tpu_torch.models.bert import BertConfig
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_fwd,
                                                        flash_fwd_body,
                                                        flash_fwd_reference)

    cfg = BertConfig.large()
    H, D, B = cfg.n_heads, cfg.head_dim, BERT_B
    dt = torch.bfloat16
    rng = np.random.default_rng(23)
    fwd, bwd, ok = {}, {}, True
    for T in BERT_BUCKETS:
        T = min(T, cfg.max_seq_len)
        lens = [int(n) for n in rng.integers(max(1, T // 4), T + 1,
                                             B - 1)] + [0]
        seg = _pad_seg(lens, T)
        q, k, v, do = (torch.randn((B, T, H, D), generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        if flash_fwd_body(q) != "wgmma":
            raise SystemExit("phase 23: BERT's shape does not take the "
                             "tensor-core body")
        o, lse = flash_fwd(q, k, v, causal=False, seg=seg)
        ro, rlse = flash_fwd_reference(q, k, v, causal=False, seg=seg)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lerr = (lse - rlse).abs().max().item()
        fn = functools.partial(flash_fwd, q, k, v, causal=False, seg=seg)
        dev = device_ms(fn)
        plain = time_ms(lambda: flash_fwd_reference(q, k, v, causal=False,
                                                    seg=seg),
                        iters=3, warmup=1)
        sdpa = _sdpa(q, k, v, seg, causal=False)
        lib = sdpa and device_ms(sdpa)
        lib_err = sdpa and (sdpa().transpose(1, 2).float()
                            - ro.float()).abs().max().item()
        # _flash_bound counts pairs of one row and head: the rows' mean
        pairs = _pad_pairs(lens, T)
        b_ms, b_by = _flash_bound(B, T, H, H, D, pairs / B)
        full_ms = _flash_bound(B, T, H, H, D, T * T)[0]
        ok = ok and err <= FLASH_TOL and lerr <= 1e-3
        fwd[f"T{T}"] = {"causal": False, "lens": lens, "max_abs_err": err,
                        "lse_err": lerr, "device_ms": dev, "plain_ms": plain,
                        "library_device_ms": lib,
                        "library": "sdpa under the pad mask",
                        "library_max_abs_err": lib_err, "bound_ms": b_ms,
                        "bound_by": b_by, "bound_full_tt_ms": full_ms,
                        "bound_share": _share(b_ms, dev)}
        log(f"[bert kernels] flash_fwd B={B} T={T} H=KV={H} D={D} bf16 "
            f"non-causal, pad ids (lengths {lens}): tensor-core body; "
            f"max_abs_err {err:.3e} (tol {FLASH_TOL}) lse_err {lerr:.3e} "
            f"(tol 1e-3); device {dev} ms, bound {b_ms:.5f} ms ({b_by}, "
            f"live pairs; {full_ms:.5f} over the full T.S), share "
            f"{_share(b_ms, dev)}; plain {plain:.4f} ms; sdpa device {lib} "
            f"ms (o vs plain {lib_err})")
        del o, ro, lse, rlse, fn
        if T == min(BERT_TRAIN_T, cfg.max_seq_len):
            for name, case in _bert_flash_bwd(gen, q, k, v, do, seg, lens,
                                              "bert kernels").items():
                bwd[name] = {f"T{T}": case}
                ok = (ok and case["wgmma"]
                      and case.get("delta_rel", 0.0) <= FLASH_DELTA_REL_TOL
                      and (case["rel_err"] <= FLASH_BWD_REL_TOL
                           or case["over_gate_faithful"]))
        del q, k, v, do
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("phase 23: a flash kernel disagrees at BERT's "
                         "shapes")
    return {"flash_fwd": fwd, **bwd}


# ------------------------------------------------------------ phase 24
def _drive_encoder(eng, reqs):
    """Submits ``reqs`` and runs the engine once -> (results, seconds,
    per-lot host ms, elements of the lots' first input): a lot's time runs
    from its forward's call to the next lot's (the last to the end of
    ``run``), its result's copy to the host and slicing included; a BERT
    lot's first input is its tokens, rows x bucket positions."""
    starts, shipped = [], [0]
    fn = eng._fn

    def timed(*a):
        starts.append(time.perf_counter())
        shipped[0] += a[1].numel()
        return fn(*a)

    eng._fn = timed
    for rid, toks in reqs.items():
        eng.submit(rid, toks)
    t0 = time.perf_counter()
    out = eng.run()
    t1 = time.perf_counter()
    eng._fn = fn
    lot_ms = np.diff(starts + [t1]) * 1e3
    return out, t1 - t0, lot_ms, shipped[0]


def _rel_np(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def phase_bert_identity(fns):
    """Tiny BERT on the card, the kernel arm against the plain arm
    (``attn_impl="reference"``, plain attention on the card) through
    ``bert_serving_engine``, for the pooled, MLM and hidden heads, on a
    queue of 11 requests in lots of 4 (buckets 32 and 64): in f32 at
    head_dim 16 (the scalar bodies; also against the engine on the CPU)
    and in bf16 at head_dim 64 (the tensor-core bodies); equal ``stats``.
    Then the int8 engine built on the card (B9) against the same on the
    CPU (equal codes, f32) and against the bf16 engine (pooled vectors
    within the JAX test's bound)."""
    import dataclasses

    from deepspeed_tpu_torch._tree import tree_map
    from deepspeed_tpu_torch.inference.encoder_serving import (
        bert_serving_engine)
    from deepspeed_tpu_torch.inference.quantized import (QuantizedTensor,
                                                         _leaves)
    from deepspeed_tpu_torch.models.bert import BertConfig
    from deepspeed_tpu_torch.weights import init_params

    rng = np.random.default_rng(24)
    reqs = {f"r{i}": rng.integers(1, 256, int(rng.integers(3, 65))).tolist()
            for i in range(11)}
    worst = {}
    for label, cfg, dtype, tol, hopper in (
            ("f32", BertConfig.tiny(), torch.float32, BERT_F32_REL_TOL,
             False),
            ("bf16", BertConfig.tiny(dim=256), torch.bfloat16,
             BERT_BF16_REL_TOL, True)):
        params = init_params(cfg, torch.Generator("cuda").manual_seed(24),
                             device="cuda", dtype=dtype)
        host = tree_map(lambda t: t.cpu(), params)
        plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
        for head in ("pooled", "mlm", "hidden"):
            _zero(fns.values())
            eng = bert_serving_engine(params, cfg, head=head, max_batch=4,
                                      device="cuda")
            got = _drive_encoder(eng, reqs)[0]
            used = {n: f.launches for n, f in fns.items()}
            _check_bodies(f"bert identity {label} {head}", hopper=hopper,
                          record=False)
            arms = {"plain": (params, plain_cfg, "cuda")}
            if dtype == torch.float32:
                arms["cpu"] = (host, cfg, "cpu")
            errs = {}
            for arm, (p, c, d) in arms.items():
                _zero(fns.values())
                other = bert_serving_engine(p, c, head=head, max_batch=4,
                                            device=d)
                want = _drive_encoder(other, reqs)[0]
                if any(f.launches for f in fns.values()):
                    raise SystemExit(f"bert identity: the {arm} arm launched "
                                     "a kernel")
                if other.stats != eng.stats:
                    raise SystemExit(f"bert identity: stats {eng.stats} "
                                     f"against {other.stats}")
                errs[arm] = max(_rel_np(got[r], want[r]) for r in reqs)
                if set(got) != set(want) or any(
                        got[r].shape != want[r].shape for r in reqs):
                    raise SystemExit(f"bert identity: {head} shapes differ")
            if dtype == torch.float32:
                # isolation: a request alone (no lot-mates, no padding)
                solo = _solo_rows(params, cfg, reqs, list(reqs), head)
                errs["alone"] = max(_rel_np(got[r], solo[r]) for r in reqs)
            worst[f"{label} {head}"] = errs
            log(f"[bert identity] bert-tiny {label} (head_dim "
                f"{cfg.head_dim}) head={head}: card kernel arm against "
                f"{errs} (rel, tol {tol}); stats {eng.stats}; launches "
                f"{used}")
            if max(errs.values()) > tol:
                raise SystemExit(f"bert identity: {label} {head} differs")
            _check_launches(f"bert identity {label} {head}", used,
                            ["flash_fwd"])
        del params, host
    # int8, f32 tiny: built on the card (B9) against the CPU's plain build
    cfg = BertConfig.tiny()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(25),
                         device="cuda", dtype=torch.float32)
    host = tree_map(lambda t: t.cpu(), params)
    _zero(fns.values())
    q_card = bert_serving_engine(params, cfg, weight_dtype="int8",
                                 device="cuda")
    built = fns["quantize"].launches
    q_cpu = bert_serving_engine(host, cfg, weight_dtype="int8", device="cpu")
    same_codes = all(
        torch.equal(a.q.cpu(), b.q) and torch.equal(a.scale.cpu(), b.scale)
        for a, b in zip(_leaves(q_card.params), _leaves(q_cpu.params))
        if isinstance(b, QuantizedTensor))
    outs = [_drive_encoder(e, reqs)[0] for e in (
        q_card, q_cpu, bert_serving_engine(params, cfg, device="cuda"))]
    cpu_err = max(_rel_np(outs[0][r], outs[1][r]) for r in reqs)
    bf16_abs = max(float(np.max(np.abs(outs[0][r] - outs[2][r])))
                   for r in reqs)
    log(f"[bert identity] int8 bert-tiny: built on the card with {built} B9 "
        f"launches, codes and scales equal to the CPU build {same_codes}; "
        f"pooled card vs CPU rel {cpu_err:.3e} (tol {BERT_F32_REL_TOL}); "
        f"against the unquantized engine max abs {bf16_abs:.4f} (tol "
        f"{BERT_INT8_POOLED_ABS}); stats {q_card.stats}")
    if not same_codes or cpu_err > BERT_F32_REL_TOL or built != 6 \
            or bf16_abs > BERT_INT8_POOLED_ABS:
        raise SystemExit("bert identity: the int8 engine is wrong")
    return worst


# ------------------------------------------------------------ phase 25
def _solo_rows(params, cfg, reqs, rids, head):
    """The requests ``rids`` each run alone through ``cfg``'s forward at
    its own length (no lot-mates, no padding) -> {rid: float32 row}."""
    from deepspeed_tpu_torch.models import bert

    out = {}
    with torch.no_grad():
        for rid in rids:
            t = torch.tensor([reqs[rid]], dtype=torch.int32, device="cuda")
            h = bert.forward(params, t, cfg,
                             attention_mask=torch.ones_like(t))
            row = (bert.pooled_output(params, h) if head == "pooled" else
                   bert.mlm_logits(params, h, cfg) if head == "mlm" else h)
            out[rid] = row[0].float().cpu().numpy()
    return out


def _one_per_bucket(reqs):
    picked, seen = [], set()
    for rid, toks in reqs.items():
        b = next(x for x in BERT_BUCKETS if len(toks) <= x)
        if b not in seen:
            seen.add(b)
            picked.append(rid)
    return picked


def phase_bert_serving(fns, card_line):
    """BERT-large at full width (24 layers, 16 heads of 64, V 30522; seeded
    bf16 weights) through ``bert_serving_engine`` with ``max_batch=8`` and
    the default buckets (32, 64, 512): 64 requests of seeded lengths 8-512,
    each head (pooled, MLM, hidden) in bf16, then int8 weights (built on the
    card by B9, a skip list as JAX's) for the pooled and MLM heads.  Each
    run is a main path: sequences/s and real tokens/s, per-lot host ms,
    the padding's share of rows and positions, peak memory; the kernel arm
    against the plain arm (reference attention) on the same queue, and a
    request per bucket run alone; int8's resident bytes, build seconds and
    pooled cosine against bf16."""
    import dataclasses

    from deepspeed_tpu_torch.inference.encoder_serving import (
        bert_serving_engine)
    from deepspeed_tpu_torch.inference.quantized import param_bytes
    from deepspeed_tpu_torch.models.bert import BertConfig, param_count
    from deepspeed_tpu_torch.weights import init_params

    t_phase = time.perf_counter()
    cfg = BertConfig.large()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(25),
                         device="cuda")
    reqs = _queue25(cfg)
    lens = np.array([len(r) for r in reqs.values()])
    real = int(lens.sum())
    log(f"[bert serving] bert-large params={param_count(cfg)} "
        f"({param_bytes(params)} bytes bf16) layers={cfg.n_layers} "
        f"{BERT_REQUESTS} requests of {int(lens.min())}-{int(lens.max())} "
        f"tokens ({real} real), max_batch {BERT_B}, buckets "
        f"{tuple(min(b, cfg.max_seq_len) for b in BERT_BUCKETS)}")
    # warm-up: one short lot per bucket (first-use costs), not a main path
    warm = bert_serving_engine(params, cfg, device="cuda")
    _drive_encoder(warm, {f"w{b}": list(range(1, min(b, cfg.max_seq_len)))
                          for b in BERT_BUCKETS})
    del warm
    launches, metrics, outs = {}, {}, {}

    def one(path, eng, head, check_params):
        _zero(fns.values())
        torch.cuda.reset_peak_memory_stats()
        out, secs, lot_ms, shipped = _drive_encoder(eng, reqs)
        torch.cuda.synchronize()
        used = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        lots = eng.stats["lots"]
        slots = lots * BERT_B
        want = {"flash_fwd": lots * cfg.n_layers}
        if any(used[k] != v for k, v in want.items()) or any(
                used[k] for k in used if k not in want):
            raise SystemExit(f"{path}: launches {used}, expected {want}")
        bad = [r for r, x in out.items() if not np.isfinite(x).all()
               or x.shape != ((cfg.dim,) if head == "pooled" else (
                   len(reqs[r]), cfg.vocab_size if head == "mlm"
                   else cfg.dim))]
        if bad or set(out) != set(reqs):
            raise SystemExit(f"{path}: wrong or missing results {bad[:4]}")
        err = alone = None
        if check_params is not None:
            # the plain arm (reference attention) on the same queue: the
            # same lots and products, the attention aside
            plain = bert_serving_engine(
                check_params, dataclasses.replace(cfg, attn_impl="reference"),
                head=head, max_batch=BERT_B, device="cuda")
            want = _drive_encoder(plain, reqs)[0]
            err = max(_rel_np(out[r], want[r]) for r in reqs)
            del plain, want
            # a request alone (informational: other product shapes, so
            # other bf16 roundings over 24 layers)
            rids = _one_per_bucket(reqs)
            solo = _solo_rows(check_params, cfg, reqs, rids, head)
            alone = max(_rel_np(out[r], solo[r]) for r in rids)
        m = {"seqs_per_s": len(reqs) / secs, "real_tokens_per_s": real / secs,
             "seconds": secs, "lots": lots,
             "lot_host_ms_p50": float(np.median(lot_ms)),
             "lot_host_ms_max": float(np.max(lot_ms)),
             "rows_padding_share": eng.stats["rows_padded"] / slots,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "positions_padding_share": 1.0 - real / shipped,
             "plain_arm_rel_err": err, "alone_rel_err": alone,
             "stats": dict(eng.stats)}
        launches[path], metrics[path] = used, m
        log(f"[bert serving] {path}: {m['seqs_per_s']:.2f} sequences/s, "
            f"{m['real_tokens_per_s']:.1f} real tokens/s over {secs:.3f} s; "
            f"{lots} lots, per-lot host ms p50 {m['lot_host_ms_p50']:.2f} "
            f"max {m['lot_host_ms_max']:.2f}; padding: rows "
            f"{m['rows_padding_share']:.3f}, positions "
            f"{m['positions_padding_share']:.3f}; peak {m['peak_gb']} GB; kernel "
            f"arm vs plain arm on the same queue rel {err} (tol "
            f"{BERT_BF16_REL_TOL}); a request alone vs in its lot rel {alone}"
            f" (informational); launches {used} on {card_line}")
        if err is not None and err > BERT_BF16_REL_TOL:
            raise SystemExit(f"{path}: the kernel arm differs from the "
                             "plain arm")
        return out

    for head in ("pooled", "mlm", "hidden"):
        eng = bert_serving_engine(params, cfg, head=head, max_batch=BERT_B,
                                  device="cuda")
        path = f"bert-large serve bf16 {head}"
        outs[head] = one(path, eng, head, params)
        if head == "pooled":
            # where a pooled run's time goes: the same queue once more,
            # profiled (after the path's counts were read)
            idle, top, traced = _profiled(lambda: _drive_encoder(eng, reqs))
            metrics[path].update(profiled_ms=traced, idle_share=idle, top=top)
            log(f"[bert serving] {path} profiled: {traced:.1f} ms host "
                f"clock, device idle share {idle}; top device time {top}")
        del eng
        if head != "pooled":
            outs.pop(head)
        torch.cuda.empty_cache()
    # int8: built on the card (B9), then served; the MLM engine reuses the
    # built tree (quantized leaves pass through)
    _zero(fns.values())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_eng = bert_serving_engine(params, cfg, head="pooled", max_batch=BERT_B,
                                weight_dtype="int8", device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    used = {n: f.launches for n, f in fns.items()}
    _check_bodies("bert-large int8 build")
    launches["bert-large int8 build"] = used
    resident = param_bytes(q_eng.params)
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[bert serving] int8 build: {build_s:.3f} s, {used['quantize']} B9 "
        f"launches, resident {resident} bytes (bf16 {param_bytes(params)}), "
        f"peak {build_peak} GB; launches {used}")
    if used["quantize"] != 6 or any(v for k, v in used.items()
                                    if k != "quantize"):
        raise SystemExit("bert-large int8 build: launches wrong")
    q_out = one("bert-large serve int8 pooled", q_eng, "pooled", None)
    cos = []
    for r in reqs:
        a, b = q_out[r].astype(np.float64), outs["pooled"][r].astype(
            np.float64)
        cos.append(float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b),
                                     1e-30)))
    m_eng = bert_serving_engine(q_eng.params, cfg, head="mlm",
                                max_batch=BERT_B, weight_dtype="int8",
                                device="cuda")
    one("bert-large serve int8 mlm", m_eng, "mlm", None)
    metrics["int8"] = {"build_s": build_s, "resident_bytes": resident,
                       "bf16_bytes": param_bytes(params),
                       "build_peak_gb": build_peak,
                       "pooled_cosine_min": min(cos),
                       "pooled_cosine_mean": float(np.mean(cos))}
    log(f"[bert serving] int8 pooled against bf16: cosine min {min(cos):.5f} "
        f"mean {np.mean(cos):.5f} (min >= {BERT_INT8_MIN_COSINE}); phase 25 "
        f"took {time.perf_counter() - t_phase:.1f} s on {card_line}")
    if min(cos) < BERT_INT8_MIN_COSINE:
        raise SystemExit("bert-large int8: pooled vectors far from bf16's")
    del q_eng, m_eng, params, outs
    torch.cuda.empty_cache()
    return launches, metrics


# ------------------------------------------------------------ phase 26
def _bert_flops_per_sample(cfg, T):
    """Model FLOPs of one BERT training sample of T positions (3x the
    forward): per position and layer the four d x d and two d x ffn
    products, bidirectional attention over all T keys (4 T d), and the MLM
    head's tied decoder (2 d V) at every position."""
    d, L, f, V = cfg.dim, cfg.n_layers, cfg.ffn_dim, cfg.vocab_size
    per_token = 2 * L * (4 * d * d + 2 * d * f) + 4 * T * d * L + 2 * d * V
    return 3 * T * per_token


def _bert_batch(rng, B, T, vocab):
    """Rows of seeded lengths 128-T (tokens past a row's length are 0),
    their attention mask, token types (the second half of a row's real
    tokens is type 1) and 15 % of the real positions labelled."""
    lens = rng.integers(min(128, T), T + 1, B)
    live = np.arange(T)[None] < lens[:, None]
    tokens = np.where(live, rng.integers(1, vocab, (B, T)), 0)
    types = live & (np.arange(T)[None] >= (lens // 2)[:, None])
    labels = np.where(live & (rng.random((B, T)) < 0.15), tokens, -100)
    return {"tokens": tokens.astype(np.int32),
            "attention_mask": live.astype(np.int32),
            "token_type_ids": types.astype(np.int32),
            "mlm_labels": labels.astype(np.int32)}, lens


def phase_bert_train(fns, card_line):
    """BERT-large trained at all 24 layers on one card: MLM at T = 512,
    micro 8 x accumulation 2, bf16 compute with an f32 master, fused Adam
    (B4), WarmupLR, clipping 1.0; 5 steps on one batch of padded rows with
    their attention mask (B1-B3 bidirectional with pad ids), then one
    profiled step.  The loss falls."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.bert import (BertConfig, loss_fn,
                                                 param_count)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.timers import ThroughputTimer
    from deepspeed_tpu_torch.weights import init_params

    t_phase = time.perf_counter()
    cfg = BertConfig.large()
    M, A = BERT_TRAIN_MICRO, BERT_TRAIN_ACCUM
    B, T = M * A, min(BERT_TRAIN_T, cfg.max_seq_len)
    batch, lens = _bert_batch(np.random.default_rng(26), B, T,
                              cfg.vocab_size)
    labelled = int((batch["mlm_labels"] >= 0).sum())
    flops = _bert_flops_per_sample(cfg, T)
    log(f"[bert train] bert-large params={param_count(cfg)} layers="
        f"{cfg.n_layers} (all) f32 master, bf16 compute, fused_adam wd=0.01,"
        f" micro {M} x accumulation {A} x T {T} (rows of "
        f"{int(lens.min())}-{int(lens.max())} real tokens, {int(lens.sum())}"
        f" real, {labelled} labelled), clip=1.0 WarmupLR; {flops:.4e} "
        f"flops/sample")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(26),
                         device="cuda", dtype=torch.float32)
    eng = initialize(loss_fn=loss_fn(cfg), params=params,
                     config=_train_config(B, A, {"bf16": {"enabled": True}}),
                     optimizer=fused_adam(lr=_warmup(), weight_decay=0.01),
                     device="cuda")[0]
    del params
    torch.cuda.synchronize()
    timer = ThroughputTimer(batch_size=B, seq_len=T, flops_per_sample=flops,
                            start_step=BERT_TRAIN_STEPS - 1, device="cuda")
    _zero(fns.values())
    rows = []
    for _ in range(BERT_TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        timer.start()
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        ms = (time.perf_counter() - ts) * 1e3
        timer.stop()
        rows.append({"loss": loss, "ms": ms,
                     "grad_norm": eng.get_global_grad_norm(),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    path = "bert-large training"
    used = {n: f.launches for n, f in fns.items()}
    _check_bodies(path)
    leaves = len(tree_leaves(eng.state.params))
    L, S = cfg.n_layers, BERT_TRAIN_STEPS
    want = {"flash_fwd": L * A * S, "flash_bwd_dq": L * A * S,
            "flash_bwd_dkv": L * A * S, "fused_adam": leaves * S}
    idle, top, traced = _profiled(lambda: float(eng.train_batch(batch)))
    tput = timer.summary()
    losses = [r["loss"] for r in rows]
    ms_steady = float(np.median([r["ms"] for r in rows[1:]]))
    out = {"steps": rows, "launches": used, "tput": tput, "idle_share": idle,
           "traced_ms": traced, "top": top,
           "real_tokens_per_s": float(lens.sum()) / ms_steady * 1e3,
           "ms_per_step": ms_steady}
    log(f"[bert train] losses {losses} ms/step "
        f"{[round(r['ms'], 1) for r in rows]} peak GB "
        f"{[r['peak_gb'] and round(r['peak_gb'], 3) for r in rows]}; "
        f"real tokens/s {out['real_tokens_per_s']:.1f} (steady median); "
        f"ThroughputTimer over the last step: {tput['tokens_per_sec']:.1f} "
        f"tokens/s (padding included), {tput['tflops']:.1f} TFLOP/s, MFU "
        f"{tput['mfu']:.4f}; profiled step {traced:.1f} ms host clock, idle "
        f"share {idle}; top device time {top} on {card_line}; launches "
        f"{used}; phase 26 took {time.perf_counter() - t_phase:.1f} s")
    if any(used[k] != v for k, v in want.items()) or any(
            used[k] for k in used if k not in want):
        raise SystemExit(f"phase 26: launches {used}, expected {want}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise SystemExit(f"phase 26: the loss did not fall: {losses}")
    del eng
    torch.cuda.empty_cache()
    return {path: used}, out


def _profiled(fn):
    """``fn()`` once under ``torch.profiler`` -> (device idle share, the
    top device kernels, the host ms of the call)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - ts) * 1e3
    busy = _device_busy_ms(prof)
    evs = _device_events(prof)
    top = [(e.key[:60], e.count, round(e.self_device_time_total / 1e3, 2))
           for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]]
    return (1.0 - busy / traced if busy else None), top, traced


# ------------------------------------------------------------ phase 27
def phase_cnn(fns, card_line):
    """The CIFAR CNN (``CNNConfig()``, seeded f32 weights): 64 images served
    through ``serving_engine`` in lots of 8 against the same engine on the
    CPU (TF32 off), then 5 train steps at batch 128 (bf16 compute, f32
    master, fused Adam: B4) on one batch, the loss falling, and 3 f32 steps
    against the same on the CPU; then ``stochastic_round_bf16`` on a card
    tensor."""
    from deepspeed_tpu_torch._tree import tree_leaves, tree_map
    from deepspeed_tpu_torch.inference.serving import serving_engine
    from deepspeed_tpu_torch.models import cnn
    from deepspeed_tpu_torch.weights import init_params

    cfg = cnn.CNNConfig()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(27),
                         device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(27)
    imgs = {f"i{k}": rng.normal(size=(32, 32, 3)).astype(np.float32)
            for k in range(CNN_IMAGES)}
    launches, out = {}, {}
    warm = serving_engine(params, cfg, device="cuda")
    warm.submit("w", imgs["i0"])
    warm.run()
    eng = serving_engine(params, cfg, device="cuda")
    _zero(fns.values())
    got, secs, lot_ms, _ = _drive_encoder(eng, imgs)
    launches["cnn serve"] = {n: f.launches for n, f in fns.items()}
    host = serving_engine(tree_map(lambda t: t.cpu(), params), cfg,
                          device="cpu")
    want = _drive_encoder(host, imgs)[0]
    err = max(float(np.max(np.abs(got[r] - want[r]))) for r in imgs)
    out["serve"] = {"images_per_s": len(imgs) / secs, "seconds": secs,
                    "lot_host_ms_p50": float(np.median(lot_ms)),
                    "lot_host_ms_max": float(np.max(lot_ms)),
                    "max_abs_err_vs_cpu": err, "stats": dict(eng.stats)}
    log(f"[cnn] serve {len(imgs)} images in lots of 8: "
        f"{out['serve']['images_per_s']:.1f} images/s, per-lot host ms p50 "
        f"{out['serve']['lot_host_ms_p50']:.3f} max "
        f"{out['serve']['lot_host_ms_max']:.3f}; card vs CPU max abs "
        f"{err:.3e} (tol {CNN_TOL}); stats {eng.stats}; launches "
        f"{launches['cnn serve']} (the convolutions are cuDNN's, as the JAX "
        f"package leaves them to XLA: no kernel of the repo)")
    if err > CNN_TOL or eng.stats != {"lots": CNN_IMAGES // 8,
                                      "requests": CNN_IMAGES}:
        raise SystemExit("phase 27: CNN serving differs from the CPU engine")
    B = CNN_TRAIN_B
    batch = {"images": rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, cfg.num_classes, B).astype(np.int32)}
    tr = _cnn_engine(params, B, True, "cuda")
    _zero(fns.values())
    rows = []
    for _ in range(CNN_TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        loss = float(tr.train_batch(batch))
        rows.append({"loss": loss, "ms": (time.perf_counter() - ts) * 1e3,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    used = {n: f.launches for n, f in fns.items()}
    launches["cnn training"] = used
    losses = [r["loss"] for r in rows]
    leaves = len(tree_leaves(tr.state.params))
    out["train"] = {"steps": rows}
    log(f"[cnn] train batch {B} bf16 compute, fused_adam, {CNN_TRAIN_STEPS} "
        f"steps: losses {losses} ms/step {[round(r['ms'], 2) for r in rows]}"
        f" peak GB {[r['peak_gb'] for r in rows]}; launches {used}")
    if used["fused_adam"] != leaves * CNN_TRAIN_STEPS or any(
            v for k, v in used.items() if k != "fused_adam"):
        raise SystemExit(f"phase 27: CNN training launches {used}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise SystemExit(f"phase 27: the CNN loss did not fall: {losses}")
    # f32, the card's engine against the CPU's (plain versions)
    arms = [_cnn_engine(p, B, False, d) for p, d in (
        (params, "cuda"), (tree_map(lambda t: t.cpu(), params), "cpu"))]
    traj = [[float(e.train_batch(batch)) for _ in range(3)] for e in arms]
    rel = max(abs(a - b) / abs(b) for a, b in zip(*traj))
    out["train"]["f32_card_vs_cpu_rel"] = rel
    log(f"[cnn] f32 train, card against CPU over 3 steps: losses {traj[0]} /"
        f" {traj[1]}, rel {rel:.3e} (tol {CNN_TRAIN_RTOL})")
    if rel > CNN_TRAIN_RTOL:
        raise SystemExit("phase 27: CNN training on the card differs from "
                         "the CPU's")
    del arms
    out["rounding"] = _rounding_on_card()
    del eng, tr, params
    return launches, out


def _cnn_engine(params, B, bf16, device):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.lr_schedules import warmup_lr
    from deepspeed_tpu_torch.models import cnn
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam

    lr = warmup_lr(warmup_min_lr=0.0, warmup_max_lr=CNN_LR,
                   warmup_num_steps=3)
    return initialize(loss_fn=cnn.loss_fn, params=params,
                      config=_train_config(B, 1, {"bf16": {"enabled": bf16}}),
                      optimizer=fused_adam(lr=lr, weight_decay=0.1),
                      device=device)[0]


def _rounding_on_card():
    """``stochastic_round_bf16`` on a tensor on the card: only the two bf16
    neighbours appear, values bf16 holds are unchanged, NaN and +-inf take
    the plain cast, the mean of 2^20 draws of one value is within 5
    standard errors of it, and on the same random bits the card's result
    equals the CPU's bit for bit.  For one seed PyTorch's CUDA generator
    (Philox) and CPU generator (mt19937) give different bits, so the
    results on the same seed are compared and reported, not required
    equal."""
    from deepspeed_tpu_torch.ops.rounding import (random_bits,
                                                  round_with_bits,
                                                  stochastic_round_bf16)

    g = torch.Generator("cuda").manual_seed(5)
    n = 1 << 20
    x = (torch.randn(n, generator=g, device="cuda")
         * torch.pow(10.0, torch.randint(-20, 20, (n,), generator=g,
                                         device="cuda").float()))
    y = stochastic_round_bf16(x, g)
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    yb = y.view(torch.int16).to(torch.int64) & 0xFFFF
    neighbours = bool(((yb == u >> 16) | (yb == (u >> 16) + 1)).all())
    held = x.to(torch.bfloat16)
    unchanged = torch.equal(stochastic_round_bf16(held.float(), g), held)
    special = torch.tensor([float("nan"), float("inf"), -float("inf")],
                           device="cuda")
    s = stochastic_round_bf16(special, g).float().cpu()
    plain_cast = bool(torch.isnan(s[0]) and s[1] == float("inf")
                      and s[2] == -float("inf"))
    v = 1.0 + 3 * 2 ** -9                          # rounds up with p = 0.75
    m = stochastic_round_bf16(torch.full((n,), v, device="cuda"), g).double()
    se = 2 ** -7 * (0.75 * 0.25 / n) ** 0.5
    mean_dev = abs(float(m.mean()) - v) / se
    bits = random_bits((n,), torch.Generator().manual_seed(6))
    same_bits = torch.equal(round_with_bits(x, bits.to("cuda")).cpu(),
                            round_with_bits(x.cpu(), bits))
    seed_equal = torch.equal(
        stochastic_round_bf16(x, torch.Generator("cuda").manual_seed(7)).cpu(),
        stochastic_round_bf16(x.cpu(), torch.Generator().manual_seed(7)))
    res = {"neighbours_only": neighbours, "held_unchanged": unchanged,
           "non_finite_plain_cast": plain_cast,
           "mean_deviation_in_se": mean_dev, "same_bits_equal_cpu": same_bits,
           "same_seed_equal_cpu": seed_equal}
    log(f"[rounding] stochastic_round_bf16 on the card, {n} values: only the "
        f"two bf16 neighbours {neighbours}; bf16 values unchanged "
        f"{unchanged}; NaN/inf plain cast {plain_cast}; mean of {n} draws of "
        f"{v} off by {mean_dev:.2f} standard errors (limit 5); on the same "
        f"bits equal to the CPU's {same_bits}; on the same seed equal to the "
        f"CPU's {seed_equal}"
        + ("" if seed_equal else " (PyTorch's CUDA generator, Philox, and "
           "its CPU generator, mt19937, give different bits for one seed)"))
    if not (neighbours and unchanged and plain_cast and mean_dev <= 5
            and same_bits):
        raise SystemExit("phase 27: stochastic rounding on the card is wrong")
    return res



# ------------------------------------------------------- phases 28-32
# ZeRO-Inference, speculative decoding and the KV tier's NVMe rung.  The
# "NVMe" directories live under the system temp dir; their reads of a
# freshly written file come from the page cache (cache-warm rates)
ZI_LLAMA_OPTS = dict(max_batch=8, page_size=16, max_seq=2048,
                     num_pages=1025, cache_dtype=torch.bfloat16)
ZI_MIXTRAL_OPTS = dict(max_batch=8, page_size=16, max_seq=1024,
                       num_pages=1025, cache_dtype=torch.bfloat16)
# phase 31 (b): Mixtral-8x7B's bf16 image cut to 4 of 32 layers (11.7 GB;
# 8 under 16 GB before phases 60-61, 16 under 32 GB before phases 53-59,
# all 32 under 64 GB before phases 48-52: the smoke's time; 16 layers' two
# draws took 34 of the phase's 75 s) under a device budget cut with it,
# 11 GB: one layer resident, three streamed a sweep (3 / 5 at 8 layers,
# 8 / 8 at 16, 19 / 13 at 32)
ZI_MIXTRAL_LAYERS, ZI_MIXTRAL_BUDGET = 4, int(11e9)
# phases 29 and 31: new tokens a Llama-3-8B request (32 until PR 20: the
# smoke's time)
ZI_LLAMA_NEW = 16
# phase 31 (b): new tokens a request (8, not 16: the smoke's time)
ZI_MIXTRAL_NEW = 8
SPEC = {"draft_tokens": 4}
# phase 29's cut of the NVMe-tier check and of Mixtral's identity queue:
# the smoke's time
ZI_NVME_LAYERS, ZI_NVME_PROMPTS, ZI_NVME_NEW = 2, 4, 8
# phase 29's int8 arm, resident against streamed: 16 of 32 layers (the
# smoke's time; the bf16 arm keeps all 32 for phase 31's reading)
ZI_INT8_LAYERS = 16
ZI_MIXTRAL_ID_LAYERS, ZI_MIXTRAL_ID_NEW = 4, 4
# phase 32: the host pool that sends wave A's pages down to NVMe
KV_NVME_HOST_POOL = 16 << 20


def _nvme_dir(tag: str) -> str:
    import tempfile

    return tempfile.mkdtemp(prefix=f"dstt_{tag}_")


def _phase_line(phase, card_line, **fields):
    log(json.dumps({"phase": phase, "card": card_line, **fields}))


def _queue5(vocab):
    """Phase 5's traffic: 8 prompts of 128..1024 tokens (seed 0)."""
    rng = np.random.default_rng(0)
    lens = np.linspace(128, 1024, 8).astype(int).tolist()
    return {f"req{i}": rng.integers(1, vocab, n).tolist()
            for i, n in enumerate(lens)}


def _queue21(vocab, n=8):
    """Phase 21's traffic: prompts of 64..768 tokens (seed 21)."""
    rng = np.random.default_rng(21)
    lens = np.linspace(64, 768, 8).astype(int).tolist()[:n]
    return {f"m{i}": rng.integers(1, vocab, k).tolist()
            for i, k in enumerate(lens)}


def _capture_first(eng):
    """Keep the logits of the engine's first whole-prompt prefill and of
    its first decode step (their forwards wrapped; measurement only)."""
    got = {}
    for name in ("_prefill", "_decode"):
        def wrapped(*a, _fn=getattr(eng, name), _n=name):
            logits, cache = _fn(*a)
            if _n not in got:
                got[_n] = logits.clone()
            return logits, cache
        setattr(eng, name, wrapped)
    return got


def _zi_stats(eng, out, prompts, m, link_gbps):
    """The streamed engine's counts over one drive: sweeps, streamed bytes
    per emitted token, ms per sweep beside the link bound, the exposed
    wait's share, acceptance."""
    gen = sum(len(v) - len(prompts[k]) for k, v in out.items())
    waits = eng.prefetch_wait_seconds()
    sweeps = eng.zi_layer_sweeps
    streamed = eng.plan["n_streamed"] * eng.plan["layer_bytes"]
    st = {"plan": {k: eng.plan[k] for k in (
              "n_resident", "n_streamed", "layer_bytes", "cache_bytes",
              "stem_head_bytes", "weight_image_bytes",
              "hbm_working_set_bytes")},
          "sweeps": sweeps, "h2d_uploads": eng.zi_layer_h2d_uploads,
          "bytes_uploaded": eng.zi_bytes_uploaded,
          "generated_tokens": gen,
          "streamed_bytes_per_token": eng.zi_bytes_uploaded / max(gen, 1),
          "ms_per_sweep": m["wall_s"] * 1e3 / max(sweeps, 1),
          "link_bound_ms_per_sweep": streamed / (link_gbps * 1e9) * 1e3,
          "exposed_wait_s": float(sum(waits)),
          "exposed_wait_share": float(sum(waits)) / m["wall_s"],
          "reader_hits": eng._reader.hits,
          "reader_stalls": eng._reader.stalls,
          "tokens_per_s": m["tokens_per_s"], "wall_s": m["wall_s"],
          "ttft_s_mean": m["ttft_s_mean"]}
    if eng._spec_on:
        st.update(spec_sweeps=eng.spec_verify_sweeps,
                  mean_accept_len=eng.spec_emitted_tokens
                  / max(eng.spec_verify_slots, 1),
                  drafted=eng.spec_drafted_tokens,
                  accepted=eng.spec_accepted_tokens)
    return st


def _run(build, prompts, new, fns, path, launches, want, hopper=True,
         capture=False, stats=None):
    """One main path: counts to 0, build the engine and serve ``prompts``
    (build included: an int8 build launches B9), counts read; returns the
    outputs, the first logits when ``capture``, the metrics (``stats(eng,
    out, m)`` added) and the build's seconds."""
    import gc

    _zero(fns.values())
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got = _capture_first(eng) if capture else None
    out, m = drive(eng, prompts, new)
    launches[path] = {n: f.launches for n, f in fns.items()}
    _check_bodies(path, hopper=hopper)
    _check_launches(path, launches[path], want)
    m["build_s"] = build_s
    m["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    m["leaks"] = eng.check_leaks()
    if stats is not None:
        m.update(stats(eng, out, m))
    for name in ("_prefill", "_decode"):
        vars(eng).pop(name, None)
    if m["leaks"] or not all(
            isinstance(v, list) and len(v) == len(prompts[r]) + new
            for r, v in out.items()):
        raise SystemExit(f"{path}: outputs invalid or leaks {m['leaks']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out, got, m


def _same_logits(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in ("_prefill", "_decode"))


# ------------------------------------------------------------ phase 28
def _mixtral_layer_bytes(cfg) -> int:
    d, f, E = cfg.dim, cfg.ffn_dim, cfg.num_experts
    kvd = cfg.n_kv_heads * cfg.head_dim
    return 2 * (2 * d * d + 2 * d * kvd + 3 * E * d * f + d * E + 2 * d)


def phase_aio(card_line):
    """The port's aio pool on the temp dir's file system: a round trip
    (``native`` must be True), 10,000 submit / wait cycles of four racing
    small reads bounded by a joined worker (the lost-wakeup stress), 1 GB
    written and read back (cache-warm), and the pinned host -> device rate
    for one Mixtral-8x7B layer (2.90 GB): the link bound of the streamed
    phases."""
    import shutil
    import threading

    from deepspeed_tpu_torch.infinity import PinnedBuffer
    from deepspeed_tpu_torch.io.aio import AioHandle
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    d = _nvme_dir("aio")
    try:
        h = AioHandle(8)
        if not h.native:
            raise SystemExit("phase 28: the aio pool took its pure-Python "
                             "arm (no g++ build)")
        src = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(28))
        path = os.path.join(d, "roundtrip.bin")
        fd = h.open(path, write=True)
        h.pwrite(fd, src)
        werr = h.wait()
        h.close(fd)
        dst = torch.empty_like(src)
        fd = h.open(path)
        h.pread(fd, dst)
        rerr = h.wait()
        roundtrip = werr == 0 and rerr == 0 and torch.equal(src, dst)
        small = [np.empty(512, np.uint8) for _ in range(4)]
        state = {"cycles": 0, "errors": 0}

        def stress():
            for _ in range(10000):
                for j, b in enumerate(small):
                    h.pread(fd, b, 512 * j)
                state["errors"] += h.wait()
                state["cycles"] += 1

        t0 = time.perf_counter()
        worker = threading.Thread(target=stress, daemon=True)
        worker.start()
        worker.join(timeout=120)
        stress_s = time.perf_counter() - t0
        if worker.is_alive():
            raise SystemExit(f"phase 28: submit/wait stress stuck after "
                             f"{state['cycles']} cycles (a lost wakeup)")
        h.close(fd)
        n = 1 << 30
        chunk = n // 8
        buf = torch.full((n,), 7, dtype=torch.uint8)
        path = os.path.join(d, "rate.bin")
        fd = h.open(path, write=True)
        t0 = time.perf_counter()
        for i in range(8):
            h.pwrite(fd, buf[i * chunk:(i + 1) * chunk], i * chunk)
        werr = h.wait()
        write_s = time.perf_counter() - t0
        h.close(fd)
        buf.zero_()
        fd = h.open(path)
        t0 = time.perf_counter()
        for i in range(8):
            h.pread(fd, buf[i * chunk:(i + 1) * chunk], i * chunk)
        rerr += h.wait()
        read_s = time.perf_counter() - t0
        h.close(fd)
        read_ok = bool((buf == 7).all()) and werr == 0
        del buf
        layer = _mixtral_layer_bytes(MixtralConfig.mixtral_8x7b())
        t0 = time.perf_counter()
        pinned = PinnedBuffer(layer)
        register_s = time.perf_counter() - t0
        dev = torch.empty((layer,), dtype=torch.uint8, device="cuda")
        side = torch.cuda.Stream()
        ms = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                e0.record(side)
                dev.copy_(pinned.tensor, non_blocking=True)
                e1.record(side)
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        link_gbps = layer / (float(np.median(ms)) / 1e3) / 1e9
        del dev, pinned
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ok = roundtrip and read_ok and state["cycles"] == 10000 \
        and state["errors"] == 0 and rerr == 0
    _phase_line("28 aio", card_line, native=True, roundtrip=roundtrip,
                stress_cycles=state["cycles"], stress_errors=state["errors"],
                stress_s=stress_s, write_gbps=n / write_s / 1e9,
                read_gbps_cache_warm=n / read_s / 1e9,
                pinned_register_s=register_s, h2d_layer_bytes=layer,
                h2d_ms=ms, h2d_gbps=link_gbps)
    if not ok:
        raise SystemExit("phase 28: aio round trip, stress or 1 GB check "
                         "failed")
    RATES["link_gbps"] = link_gbps
    return link_gbps


# ------------------------------------------------------------ phase 29
def phase_zi_identity(fns, card_line, link_gbps):
    """Streamed against resident, bitwise: Llama-3-8B (32 layers, bf16,
    seeded) on phase 5's queue, resident and with every layer streamed from
    the host tier (identical tokens, the first prefill's and first decode
    step's logits bitwise equal); the same in int8 at ZI_INT8_LAYERS;
    Mixtral-8x7B bf16 at ZI_MIXTRAL_ID_LAYERS on 3 of phase 21's prompts;
    and the NVMe tier against the host tier at ZI_NVME_LAYERS.  Returns
    the launches, the Llama-3-8B weights (phases 30-32, 34 and 35 use
    them), the streamed bf16 run's counts
    (phase 31's spec-off reading) and the resident bf16 run's outputs and
    first logits (phase 34's reference)."""
    import dataclasses
    import shutil

    from deepspeed_tpu_torch.inference.serving import serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    from deepspeed_tpu_torch.weights import init_params

    cfg = LlamaConfig.llama3_8b()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda", dtype=torch.bfloat16)
    prompts = _queue5(cfg.vocab_size)
    launches, res = {}, {}
    dense = SERVING_KERNELS
    stats = functools.partial(_zi_stats, prompts=prompts,
                              link_gbps=link_gbps)

    def zi_stats(eng, out, m):
        return stats(eng, out, m=m)

    for wd in ("bfloat16", "int8"):
        want = dense + (("quantize",) if wd == "int8" else ())
        depth = cfg.n_layers if wd == "bfloat16" else ZI_INT8_LAYERS
        wcfg = dataclasses.replace(cfg, n_layers=depth)
        wp = dict(params, blocks={k: v[:depth]
                                  for k, v in params["blocks"].items()})
        r_out, r_logits, r_m = _run(
            lambda: serving_engine(wp, wcfg, weight_dtype=wd,
                                   **ZI_LLAMA_OPTS),
            prompts, ZI_LLAMA_NEW, fns, f"zi resident llama {wd}", launches,
            want,
            capture=True)
        s_out, s_logits, s_m = _run(
            lambda: serving_engine(wp, wcfg, weight_dtype=wd,
                                   zero_inference={"hbm_budget_bytes": None},
                                   **ZI_LLAMA_OPTS),
            prompts, ZI_LLAMA_NEW, fns, f"zi streamed llama {wd}", launches,
            want,
            capture=True, stats=zi_stats)
        res[wd] = {"layers": depth, "tokens_equal": s_out == r_out,
                   "logits_bitwise": _same_logits(s_logits, r_logits),
                   "resident_tokens_per_s": r_m["tokens_per_s"],
                   "streamed": {k: s_m[k] for k in s_m if k != "leaks"}}
        if wd == "bfloat16":
            streamed_bf16, resident_bf16 = s_m, (r_out, r_logits)
        del wp
    # the NVMe tier against the host tier, depth cut to ZI_NVME_LAYERS
    cfg8 = dataclasses.replace(cfg, n_layers=ZI_NVME_LAYERS)
    p8 = dict(params, blocks={k: v[:ZI_NVME_LAYERS]
                              for k, v in params["blocks"].items()})
    q8 = dict(list(prompts.items())[:ZI_NVME_PROMPTS])
    stats8 = functools.partial(_zi_stats, prompts=q8, link_gbps=link_gbps)
    d = _nvme_dir("zi")
    try:
        outs = {}
        for tier in ("host", "nvme"):
            outs[tier], _, m8 = _run(
                lambda: serving_engine(p8, cfg8, zero_inference={
                    "hbm_budget_bytes": None, "tier": tier,
                    "nvme_path": d}, **ZI_LLAMA_OPTS),
                q8, ZI_NVME_NEW, fns,
                f"zi {tier} tier llama {ZI_NVME_LAYERS} layers",
                launches, dense, stats=lambda e, o, m: stats8(e, o, m=m))
            res[f"{tier}_tier_{ZI_NVME_LAYERS}_layers"] = {
                k: m8[k] for k in ("sweeps", "reader_hits", "reader_stalls",
                                   "tokens_per_s", "ms_per_sweep",
                                   "build_s")}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res["nvme_tokens_equal_host"] = outs["nvme"] == outs["host"]
    del p8
    # Mixtral-8x7B bf16 at ZI_MIXTRAL_ID_LAYERS (the smoke's time; 16 fit
    # resident)
    mcfg = dataclasses.replace(MixtralConfig.mixtral_8x7b(),
                               n_layers=ZI_MIXTRAL_ID_LAYERS)
    mq = _queue21(mcfg.vocab_size, n=3)
    holder = [init_params(mcfg, torch.Generator("cuda").manual_seed(21),
                          device="cuda", dtype=torch.bfloat16)]
    mstats = functools.partial(_zi_stats, prompts=mq, link_gbps=link_gbps)
    r_out, r_logits, _ = _run(
        lambda: serving_engine(holder[0], mcfg, **ZI_MIXTRAL_OPTS), mq,
        ZI_MIXTRAL_ID_NEW, fns, "zi resident mixtral bf16", launches, dense,
        capture=True)
    s_out, s_logits, s_m = _run(
        lambda: serving_engine(holder[0], mcfg, zero_inference={
            "hbm_budget_bytes": None}, **ZI_MIXTRAL_OPTS), mq,
        ZI_MIXTRAL_ID_NEW, fns, "zi streamed mixtral bf16", launches, dense,
        capture=True, stats=lambda e, o, m: mstats(e, o, m=m))
    del holder[:]
    torch.cuda.empty_cache()
    res["mixtral"] = {"layers": ZI_MIXTRAL_ID_LAYERS,
                      "tokens_equal": s_out == r_out,
                      "logits_bitwise": _same_logits(s_logits, r_logits),
                      "streamed": {k: s_m[k] for k in (
                          "sweeps", "ms_per_sweep",
                          "link_bound_ms_per_sweep", "exposed_wait_share",
                          "build_s", "peak_mem_gb")}}
    _phase_line("29 zi identity", card_line, **res)
    ok = all(res[w]["tokens_equal"] and res[w]["logits_bitwise"]
             for w in ("bfloat16", "int8", "mixtral")) \
        and res["nvme_tokens_equal_host"]
    if not ok:
        raise SystemExit("phase 29: streamed serving differs from resident "
                         "(or the NVMe tier from the host tier)")
    return launches, params, streamed_bf16, resident_bf16


# ------------------------------------------------------------ phase 30
def _first_divergence(a, b, prompts):
    """(requests whose outputs differ, the first generated position where
    any does)."""
    bad = [r for r in prompts if a[r] != b[r]]
    pos = [next(i for i, (x, y) in enumerate(zip(a[r], b[r])) if x != y)
           - len(prompts[r]) for r in bad]
    return len(bad), (min(pos) if pos else None)


def phase_spec(fns, card_line, params, gen):
    """Speculative decoding on the card.  f32 Llama-3-8B widths at 2
    layers, kernels on: the n-gram drafter and a ``ModelDrafter`` drafting
    with the same weights against plain greedy, tokens identical; bf16 at
    32 layers (phase 29's weights): divergent requests reported, not
    gated (C-w2); B5 at the verify shape C = K+1 (4 and 5, and C = 1)
    against its plain version; ``verify_accept`` on the card against the
    CPU on greedy rows."""
    import dataclasses

    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        DECODE_ROWS, paged_chunk_attention, paged_chunk_attention_reference)
    from deepspeed_tpu_torch.inference.serving import serving_engine
    from deepspeed_tpu_torch.inference.speculative import (ModelDrafter,
                                                           verify_accept)
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.weights import init_params

    launches, res = {}, {}
    dense = SERVING_KERNELS
    cfg2 = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    p32 = init_params(cfg2, torch.Generator("cuda").manual_seed(30),
                      device="cuda", dtype=torch.float32)
    prompts = _queue5(cfg2.vocab_size)
    opts = dict(ZI_LLAMA_OPTS, cache_dtype=torch.float32)
    plain, _, pm = _run(lambda: serving_engine(p32, cfg2, **opts), prompts,
                        32, fns, "spec f32 plain", launches, dense,
                        hopper=False)

    def spec_stats(eng, out, m):
        return {"spec_sweeps": eng.spec_verify_sweeps,
                "mean_accept_len": eng.spec_emitted_tokens
                / max(eng.spec_verify_slots, 1),
                "decode_steps": eng.decode_steps}

    ngram, _, nm = _run(lambda: serving_engine(p32, cfg2, speculative=SPEC,
                                               **opts),
                        prompts, 32, fns, "spec f32 ngram", launches, dense,
                        hopper=False, stats=spec_stats)
    drafter = ModelDrafter(p32, cfg2, draft_tokens=4, window=64,
                           cache_dtype=torch.float32)
    model, _, mm = _run(lambda: serving_engine(
        p32, cfg2, speculative=dict(SPEC, drafter="model"), drafter=drafter,
        **opts), prompts, 32, fns, "spec f32 model drafter", launches,
        dense, hopper=False, stats=spec_stats)
    del drafter, p32
    torch.cuda.empty_cache()
    res["f32_2_layers"] = {
        "ngram_tokens_equal": ngram == plain,
        "model_tokens_equal": model == plain,
        "plain_tokens_per_s": pm["tokens_per_s"],
        "ngram": {k: nm[k] for k in ("tokens_per_s", "spec_sweeps",
                                     "mean_accept_len")},
        "model": {k: mm[k] for k in ("tokens_per_s", "spec_sweeps",
                                     "mean_accept_len")}}
    cfg = LlamaConfig.llama3_8b()
    prompts = _queue5(cfg.vocab_size)
    b_plain, _, bpm = _run(lambda: serving_engine(params, cfg,
                                                  **ZI_LLAMA_OPTS),
                           prompts, 32, fns, "spec bf16 plain", launches,
                           dense)
    b_spec, _, bsm = _run(lambda: serving_engine(
        params, cfg, speculative=SPEC, **ZI_LLAMA_OPTS), prompts, 32, fns,
        "spec bf16 ngram", launches, dense, stats=spec_stats)
    n_div, first = _first_divergence(b_spec, b_plain, prompts)
    res["bf16_32_layers"] = {
        "off_path_divergences": n_div, "first_divergence_position": first,
        "plain_tokens_per_s": bpm["tokens_per_s"],
        "spec_tokens_per_s": bsm["tokens_per_s"],
        "mean_accept_len": bsm["mean_accept_len"],
        "spec_sweeps": bsm["spec_sweeps"]}
    # B5 at the verify window, the Llama-3-8B decode shape's heads
    H, KV, D = 32, 8, 128
    lens = [0, 128, 256, 400, 512, 700, 900, 1024]
    cases = {}
    for C in (1, 4, 5):
        # pages cover each row's frontier + C keys (C = 5 at 1024 needs a
        # 65th page)
        kp, vp, table = _paged_inputs(gen, [n + C for n in lens], 1, mp=72)
        st = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn((8, C, H, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = paged_chunk_attention(q, kp, vp, table, st)
        ref = paged_chunk_attention_reference(q, kp, vp, table, st)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        regime = ("split-key decode" if C * (H // KV) <= DECODE_ROWS
                  else "one block per (row, kv head)")
        tol = PAGED_DECODE_TOL if C * (H // KV) <= DECODE_ROWS \
            else PAGED_CHUNK_TOL
        ms = time_ms(lambda: paged_chunk_attention(q, kp, vp, table, st))
        dev = device_ms(lambda: paged_chunk_attention(q, kp, vp, table, st))
        plain_ms = time_ms(lambda: paged_chunk_attention_reference(
            q, kp, vp, table, st), iters=5)
        live = sum(n + C for n in lens)
        pairs = sum(n * C + C * (C + 1) // 2 for n in lens)
        b_ms, b_by = bound(2 * live * KV * D * 2 + 2 * 2 * 8 * C * H * D,
                           4 * pairs * H * D, BF16_FLOPS_PER_S)
        cases[f"C={C}"] = {"max_abs_err": err, "tol": tol, "ms": ms,
                           "device_ms": dev, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "bound_share": _share(b_ms, dev),
                           "regime": regime}
        if err > tol:
            raise SystemExit(f"phase 30: B5 at C={C} disagrees with its "
                             f"plain version ({err:.3e} > {tol})")
    res["b5_verify_shapes"] = cases
    V = cfg.vocab_size
    logits = torch.randn((8, 5, V), generator=gen, device="cuda")
    am = logits.argmax(-1)
    drafts = torch.randint(0, V, (8, 4), generator=gen, device="cuda")
    drafts[:4] = am[:4, :4]                 # half the rows accept all
    drafts[4, :2] = am[4, :2]               # one accepts two
    dl = torch.tensor([4, 3, 0, 2, 4, 4, 1, 4], device="cuda")
    n_c, s_c = verify_accept(logits, drafts, dl)
    n_h, s_h = verify_accept(logits.cpu(), drafts.cpu(), dl.cpu())
    res["verify_accept_card_equals_cpu"] = bool(
        torch.equal(n_c.cpu(), n_h) and torch.equal(s_c.cpu(), s_h))
    res["verify_accept_n_acc"] = n_c.tolist()
    _phase_line("30 spec", card_line, **res)
    if not (res["f32_2_layers"]["ngram_tokens_equal"]
            and res["f32_2_layers"]["model_tokens_equal"]
            and res["verify_accept_card_equals_cpu"]):
        raise SystemExit("phase 30: speculative greedy differs from plain "
                         "greedy in f32, or verify_accept from the CPU")
    return launches, cases


# ------------------------------------------------------------ phase 31
class _SeededLayers:
    """A model's layers drawn one at a time on the card, each from its own
    seed (a lazy sequence of per-layer trees for the streamed engine's
    ingest: neither the card nor the host ever holds the whole image)."""

    def __init__(self, cfg, seed: int):
        import dataclasses

        self.one = dataclasses.replace(cfg, n_layers=1)
        self.n, self.seed = cfg.n_layers, seed

    def __len__(self):
        return self.n

    def __getitem__(self, l):
        from deepspeed_tpu_torch.weights import init_params

        p = init_params(self.one, torch.Generator("cuda").manual_seed(
            self.seed * 1000 + l), device="cuda", dtype=torch.bfloat16)
        return {k: v[0] for k, v in p["blocks"].items()}


def phase_zi_serving(fns, card_line, holder, llama_off, link_gbps):
    """The headline: (a) Llama-3-8B at 32 layers, every layer streamed from
    the host tier, on phase 5's traffic with n-gram speculation (K = 4;
    speculation off is phase 29's streamed run); (b) Mixtral-8x7B in bf16
    at ZI_MIXTRAL_LAYERS of 32 layers under ZI_MIXTRAL_BUDGET, the
    layers drawn one at a time, on 8 of phase 21's prompts with
    ``ZI_MIXTRAL_NEW`` new tokens, speculation off and on.  Each: sweeps, streamed bytes per
    emitted token, ms per sweep beside the link bound (phase 28's rate),
    the exposed-wait share, tokens/s, acceptance, peak memory, launches.
    ``holder`` hands over the only reference to Llama-3-8B's weights, freed
    before Mixtral's layers are drawn."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch.inference.serving import serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    from deepspeed_tpu_torch.weights import init_params

    launches, res = {}, {}
    dense = SERVING_KERNELS
    keys = ("sweeps", "streamed_bytes_per_token", "ms_per_sweep",
            "link_bound_ms_per_sweep", "exposed_wait_share", "tokens_per_s",
            "peak_mem_gb", "build_s", "wall_s", "ttft_s_mean",
            "reader_hits", "reader_stalls")
    cfg = LlamaConfig.llama3_8b()
    prompts = _queue5(cfg.vocab_size)
    stats = functools.partial(_zi_stats, prompts=prompts,
                              link_gbps=link_gbps)
    _, _, m = _run(lambda: serving_engine(
        holder[0], cfg, zero_inference={"hbm_budget_bytes": None},
        speculative=SPEC, **ZI_LLAMA_OPTS), prompts, ZI_LLAMA_NEW, fns,
        "zi streamed llama bf16 spec", launches, dense,
        stats=lambda e, o, mm: stats(e, o, m=mm))
    res["llama3_8b_32_layers"] = {
        "plan": llama_off["plan"],
        "spec_off": {k: llama_off[k] for k in keys},
        "spec_on": {k: m[k] for k in keys + ("mean_accept_len",
                                            "spec_sweeps")}}
    del holder[:]
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = dataclasses.replace(MixtralConfig.mixtral_8x7b(),
                               n_layers=ZI_MIXTRAL_LAYERS)
    one = dataclasses.replace(mcfg, n_layers=1)
    sh = init_params(one, torch.Generator("cuda").manual_seed(31),
                     device="cuda", dtype=torch.bfloat16)
    mparams = {"embed": sh["embed"], "final_norm": sh["final_norm"],
               "lm_head": sh["lm_head"], "blocks": _SeededLayers(mcfg, 31)}
    del sh
    mq = _queue21(mcfg.vocab_size)
    mstats = functools.partial(_zi_stats, prompts=mq, link_gbps=link_gbps)
    outs = {}
    for tag, extra in (("spec_off", {}), ("spec_on", {"speculative": SPEC})):
        outs[tag], _, m = _run(lambda: serving_engine(
            mparams, mcfg, zero_inference={
                "hbm_budget_bytes": ZI_MIXTRAL_BUDGET},
            **extra, **ZI_MIXTRAL_OPTS), mq, ZI_MIXTRAL_NEW, fns,
            f"zi mixtral {ZI_MIXTRAL_LAYERS} layers bf16 {tag}", launches,
            dense,
            stats=lambda e, o, mm: mstats(e, o, m=mm))
        res.setdefault(f"mixtral_8x7b_{ZI_MIXTRAL_LAYERS}_layers", {"plan": m["plan"]})
        res[f"mixtral_8x7b_{ZI_MIXTRAL_LAYERS}_layers"][tag] = {
            k: m[k] for k in keys + (("mean_accept_len", "spec_sweeps")
                                     if tag == "spec_on" else ())}
        gc.collect()
    n_div, first = _first_divergence(outs["spec_on"], outs["spec_off"], mq)
    res[f"mixtral_8x7b_{ZI_MIXTRAL_LAYERS}_layers"].update(
        spec_off_path_divergences=n_div,
        first_divergence_position=first)
    res["launches"] = {p: {k: n for k, n in c.items() if n}
                       for p, c in launches.items()}
    _phase_line("31 zi serving", card_line, **res)
    return launches


# ------------------------------------------------------------ phase 32
def phase_kv_nvme(fns, card_line, params):
    """Phase 11's two waves (Llama-3-8B, a 1024-token shared prefix,
    int8-resident pages, ``prefill_chunk=256``) with speculation on, served
    twice: with the host tier only, and with ``nvme_dir`` set under a host
    pool small enough that wave A's pages cascade to NVMe, so wave B
    promotes from NVMe.  Tokens identical; pages per location, admission
    waits, deferrals and TTFT per wave reported; B7 runs the verify window
    at C = K+1."""
    import gc
    import shutil

    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b()
    waves = _tier_waves(np.random.default_rng(1), cfg.vocab_size,
                        TIER_PREFIX, TIER_SUFFIX, 8)
    launches, res, outs = {}, {}, {}
    d = _nvme_dir("kv")
    try:
        for arm, extra in (("host", {}),
                           ("nvme", {"nvme_dir": d,
                                     "host_pool_bytes": KV_NVME_HOST_POOL})):
            eng = llama_serving_engine(
                params, cfg, prefix_cache={},
                kv_tier=dict(TIER_KV, **extra), speculative=SPEC,
                prefill_chunk=256, **ZI_LLAMA_OPTS)
            pool, al = eng._kv_pool, eng.allocator
            arm_res = {}
            for w, wave in zip("AB", waves):
                path = f"kv {arm} wave {w} spec"
                before = (al.promoted, eng.kv_tier_admit_waits,
                          eng.kv_tier_promote_deferrals)
                _zero(fns.values())
                out, m = drive(eng, wave, TIER_NEW)
                launches[path] = {n: f.launches for n, f in fns.items()}
                _check_bodies(path)
                _check_launches(path, launches[path],
                                ("paged_attention_quant", "greedy_argmax",
                                 "quantize"))
                if w == "A":
                    eng.step()     # idle step: the watermark sweep demotes
                outs[(arm, w)] = out
                arm_res[w] = {
                    "ttft_s_mean": m["ttft_s_mean"],
                    "ttft_s_max": m["ttft_s_max"],
                    "tokens_per_s": m["tokens_per_s"],
                    "promoted": al.promoted - before[0],
                    "admit_waits": eng.kv_tier_admit_waits - before[1],
                    "deferrals": eng.kv_tier_promote_deferrals - before[2],
                    "occupancy": pool.occupancy(),
                    "b7_launches": launches[path]["paged_attention_quant"],
                    "valid": _valid(out, wave, TIER_NEW, cfg.vocab_size)}
            arm_res["leaks"] = eng.check_leaks()
            arm_res["mean_accept_len"] = eng.spec_emitted_tokens / max(
                eng.spec_verify_slots, 1)
            res[arm] = arm_res
            del eng, pool, al
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res["nvme_tokens_equal_host"] = all(
        outs[("nvme", w)] == outs[("host", w)] for w in "AB")
    _phase_line("32 kv nvme", card_line, **res)
    nv = res["nvme"]
    if not (res["nvme_tokens_equal_host"] and not res["host"]["leaks"]
            and not nv["leaks"] and nv["A"]["occupancy"]["nvme_pages"] > 0
            and nv["B"]["promoted"] > 0
            and all(res[a][w]["valid"] for a in ("host", "nvme")
                    for w in "AB")):
        raise SystemExit("phase 32: NVMe-promoted tokens differ from the "
                         "host tier's, or nothing cascaded / promoted")
    return launches


# ------------------------------------------------------- phases 33-36
# The host natives, HF checkpoints in and out, LoRA at all 32 layers, the
# hybrid engine, distillation and the Trainer bridge
CPU_ADAM_N = 128256 * 4096           # Llama-3-8B's embedding leaf
CPU_ADAM_SLICE = 1 << 24             # the slice held to the plain mirror
# the native step against the plain mirror on the slice, for each of p, m
# and v: the norm of the difference over the norm of the plain step (new
# minus old).  The C++ forms 1 - b1 and 1 - b2 in f32, the mirror rounds
# them from f64 (2.4e-7 and 4.7e-5 apart; the JAX package's two arms
# differ the same way), which moves the step by up to ~5e-5 of itself; an
# element-wise bound fails where m or p land near 0 by cancellation.  A
# CPU rehearsal at these scales read 4.0e-6 / 2.5e-7 / 1.8e-5
CPU_ADAM_STEP_RTOL = 1e-4
SHUFFLE_N, SHUFFLE_EPOCHS = 100_000, 3
# phase 34's tiny Mixtral, card against CPU in f32 (the scalar attention
# body sums in another order): 1e-4 of the largest |logit|, phase 24's f32
# bound
HF_MIXTRAL_REL_TOL = 1e-4
# phase 34's export depth: 4 of 32 layers (8 before phases 62-64, 16
# before phases 60-61, all 32 before phases 48-52: the smoke's time)
HF_LAYERS = 4
# phase 35: merge_lora's forward (the f32 master A, B folded into the bf16
# base) against apply_lora's over the engine's bf16 compute copy of A, B:
# the two round A, B differently, which moves an element of W_eff across a
# bf16 rounding boundary now and then (one bf16 ulp, 2^-8 of it).  Set
# before the first card reading, at 5e-2 of the largest |logit|: a CPU
# rehearsal on a 3-layer tiny model read 1.6e-2 with ~4 % of W_eff's
# elements one ulp apart, and deep bf16 stacks read up to 4.1e-2 between
# two arms that round once per attention (phase 24's BERT-large, 24
# layers), below phase 21's 5e-2
LORA_MERGE_REL_TOL = 5e-2
LORA_STEPS = 4
# phase 36: rollouts of 8 prompts of 128 tokens, 32 new; distillation 3
# steps; the Trainer 2 steps over rows of 1025 tokens
HYBRID_PROMPTS, HYBRID_PROMPT_LEN, HYBRID_NEW = 8, 128, 32
DISTILL_STEPS, TRAINER_STEPS, TRAINER_ROW = 3, 2, 1025


class _RssPeak:
    """The peak resident set size of this process over a ``with`` block
    (``VmRSS`` sampled every 10 ms on a thread; mapped file pages count)."""

    def __init__(self):
        import threading

        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, self._rss())

    def gb(self) -> dict:
        return {"base_gb": self.base / 1e9, "peak_gb": self.peak / 1e9,
                "rise_gb": (self.peak - self.base) / 1e9}


# ------------------------------------------------------------ phase 33
def phase_host_natives(fns, card_line):
    """The port's host natives, built by g++ from ``csrc/host``: the buffer
    pool and the shuffle service on their native arms (a get -> put -> get
    hits the pool; the native shuffle equals the pure-Python mirror at n =
    100,000 for 3 epochs); the fused CPU Adam (``emit_bf16``) over
    Llama-3-8B's embedding leaf, 525,336,576 f32 elements, two steps timed
    (seconds, and GB/s over the 30 bytes an element moves), the first
    step's 16 M-element slice held to the plain mirror and its bf16 image
    to round-to-nearest-even of its p; the env report's host rows.  The
    report is the phase's main path (its CUDA probe launches B10)."""
    import unittest.mock

    from deepspeed_tpu_torch import env_report
    from deepspeed_tpu_torch.infinity import PinnedBuffer
    from deepspeed_tpu_torch.io import native
    from deepspeed_tpu_torch.ops import cpu_adam

    t0 = time.perf_counter()
    built = {"hostruntime": native._ensure_lib() is not None,
             "cpu_adam": cpu_adam.native_available()}
    build_s = time.perf_counter() - t0
    pool = native.HostBufferPool()
    view, h = pool.get(64 << 20)
    view[:] = 1
    del view
    pool.put(h)
    _, h2 = pool.get(64 << 20)
    pool_stats = pool.stats()
    pool.put(h2)
    pool.close()
    pool_ok = pool_stats["native"] and h2 == h and pool_stats["hits"] == 1
    svc = native.ShuffleIndexService(SHUFFLE_N, seed=33)
    t0 = time.perf_counter()
    orders = [svc.epoch_order(e) for e in range(SHUFFLE_EPOCHS)]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shuffle_ok = svc.native and all(
        np.array_equal(o, native._splitmix64_shuffle(SHUFFLE_N, 33, e))
        for e, o in enumerate(orders))
    mirror_s = time.perf_counter() - t0
    svc.close()

    gen = torch.Generator("cuda").manual_seed(33)

    def draw(scale):
        return (torch.randn(CPU_ADAM_N, generator=gen, device="cuda")
                * scale).cpu()

    # one registration, undone when the buffer goes (torch's pinned cache
    # would keep 2.1 GB of host memory for the rest of the run)
    pinned = PinnedBuffer(4 * CPU_ADAM_N)
    p = pinned.view(0, (CPU_ADAM_N,), torch.float32)
    p.copy_(torch.randn(CPU_ADAM_N, generator=gen, device="cuda") * 0.02)
    m, g = draw(1e-3), draw(1e-3)
    v = draw(1e-3).square_()
    ref = [t[:CPU_ADAM_SLICE].clone() for t in (p, m, v, g)]
    old = [t.clone() for t in ref[:3]]
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.1, adamw=True,
              emit_bf16=True)
    steps = []
    for t in (1, 2):
        t0 = time.perf_counter()
        img = cpu_adam.cpu_adam_step(p, m, v, g, t=t, **kw)
        s = time.perf_counter() - t0
        steps.append({"t": t, "s": s, "gb_per_s": 30 * CPU_ADAM_N / s / 1e9})
        if t == 1:
            got = [x[:CPU_ADAM_SLICE].clone() for x in (p, m, v, img)]
    with unittest.mock.patch.object(cpu_adam, "_ensure_lib", lambda: None):
        plain_img = cpu_adam.cpu_adam_step(*ref, t=1, **kw)
    err = {name: float((a.double() - b.double()).norm()
                       / (b.double() - o.double()).norm())
           for name, a, b, o in zip("pmv", got[:3], ref[:3], old)}
    image_rne = torch.equal(got[3], got[0].to(torch.bfloat16))
    image_vs_plain = float((got[3] != plain_img).float().mean())
    del p, m, v, g, img, ref, old, got, plain_img, pinned

    _zero(fns.values())
    r = env_report.report()
    launches = {n: f.launches for n, f in fns.items()}
    _check_launches("host natives env report", launches, ("env_probe",))
    host_rows = {k: r["ops"][k]["ok"] for k in (
        "csrc (aio/hostruntime)", "csrc (cpu_adam)", "g++")}
    log("[host natives] " + "; ".join(
        ln.strip() for ln in env_report.render(r)
        if ln.strip().startswith(("csrc", "g++"))))
    _phase_line("33 host natives", card_line, built=built,
                build_s=build_s, pool=pool_stats, pool_hit=pool_ok,
                shuffle_n=SHUFFLE_N, shuffle_epochs=SHUFFLE_EPOCHS,
                shuffle_equal_mirror=shuffle_ok, shuffle_native_s=native_s,
                shuffle_mirror_s=mirror_s, cpu_adam_elements=CPU_ADAM_N,
                cpu_adam_bytes_per_element=30,
                cpu_adam_threads=cpu_adam.N_THREADS,
                host_cpus=os.cpu_count(), cpu_adam_steps=steps,
                slice_elements=CPU_ADAM_SLICE,
                slice_err_over_step=err, slice_tol=CPU_ADAM_STEP_RTOL,
                bf16_image_is_rne_of_p=image_rne,
                bf16_image_share_unlike_plain=image_vs_plain,
                env_report_host_rows=host_rows,
                env_report_probe_ok=r["ops"]["cuda probe"]["ok"])
    ok = (all(built.values()) and pool_ok and shuffle_ok and image_rne
          and max(err.values()) <= CPU_ADAM_STEP_RTOL
          and all(host_rows.values())
          and r["ops"]["cuda probe"]["ok"])
    if not ok:
        raise SystemExit("phase 33: host natives failed")
    RATES["cpu_adam_gbps"] = min(st["gb_per_s"] for st in steps)
    return {"host natives env report": launches}


# ------------------------------------------------------------ phase 34
def _mixtral_hf_state(cfg, seed=34):
    """A synthetic HF Mixtral checkpoint: HF names, ``[out, in]`` f32
    matrices (numpy, seeded), and its ``config.json`` dict."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.dim, cfg.ffn_dim, cfg.num_experts
    kvd = cfg.n_kv_heads * cfg.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, d),
          "model.norm.weight": 1 + w(d),
          "lm_head.weight": w(cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        sd.update({pre + "input_layernorm.weight": 1 + w(d),
                   pre + "post_attention_layernorm.weight": 1 + w(d),
                   pre + "self_attn.q_proj.weight": w(d, d),
                   pre + "self_attn.k_proj.weight": w(kvd, d),
                   pre + "self_attn.v_proj.weight": w(kvd, d),
                   pre + "self_attn.o_proj.weight": w(d, d),
                   pre + "block_sparse_moe.gate.weight": w(E, d)})
        for e in range(E):
            moe = pre + f"block_sparse_moe.experts.{e}."
            sd.update({moe + "w1.weight": w(f, d), moe + "w3.weight": w(f, d),
                       moe + "w2.weight": w(d, f)})
    hf = {"architectures": ["MixtralForCausalLM"],
          "vocab_size": cfg.vocab_size, "hidden_size": d,
          "num_hidden_layers": cfg.n_layers,
          "num_attention_heads": cfg.n_heads,
          "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": f,
          "num_local_experts": E, "num_experts_per_tok": cfg.top_k,
          "max_position_embeddings": cfg.max_seq_len,
          "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps}
    return sd, hf


def phase_hf_roundtrip(fns, card_line, params, resident):
    """Llama-3-8B's seeded bf16 weights (phase 5's seed, drawn in phase 29)
    exported with ``save_pretrained`` to the temp dir (f32, HF names, 32.1
    GB at 32 layers; the depth is cut, and the cut printed, only when the
    file system cannot hold it), loaded back with ``from_pretrained(device=
    "cuda", dtype=bfloat16)`` (the tree bit for bit, the spec tree
    Llama's ``param_specs``), and the loaded tree
    served on phase 5's traffic: tokens identical to the seeded tree's
    (phase 29's resident run) and the first prefill's and decode step's
    logits bitwise equal.  Save and load seconds, bytes and the peak host
    RSS.  Then a tiny f32 Mixtral through ``inject("MixtralForCausalLM")``
    on the card against the same on the CPU (leaves exact, ``forward_eval``
    logits at HF_MIXTRAL_REL_TOL)."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.inference.injection import inject
    from deepspeed_tpu_torch.inference.serving import serving_engine
    from deepspeed_tpu_torch.integrations.hf import (from_pretrained,
                                                     save_pretrained)
    from deepspeed_tpu_torch.models.llama import (LlamaConfig, param_count,
                                                  param_specs)
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    cfg = LlamaConfig.llama3_8b()
    prompts = _queue5(cfg.vocab_size)
    launches = {}
    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    fixed = 4 * param_count(dataclasses.replace(cfg, n_layers=0))
    per_layer = 4 * param_count(dataclasses.replace(cfg, n_layers=1)) - fixed
    # HF_LAYERS of 32 layers; fewer when the file system cannot hold them
    layers = HF_LAYERS
    if free < 1.1 * (fixed + layers * per_layer):
        layers = int((free / 1.1 - fixed) // per_layer)
        log(f"[hf] {root} has {free / 1e9:.1f} GB free: the export is cut "
            f"from {HF_LAYERS} to {layers} layers")
        if layers < 1:
            raise SystemExit("phase 34: no room for the export")
    cut = dataclasses.replace(cfg, n_layers=layers)
    tree = params if layers == cfg.n_layers else dict(
        params, blocks={k: v[:layers] for k, v in params["blocks"].items()})
    if layers == cfg.n_layers:
        r_out, r_logits = resident
    else:
        r_out, r_logits, _ = _run(
            lambda: serving_engine(tree, cut, **ZI_LLAMA_OPTS), prompts, 32,
            fns, f"hf seeded llama {layers} layers", launches,
            SERVING_KERNELS, capture=True)
    d = tempfile.mkdtemp(prefix="dstt_hf_")
    try:
        torch.cuda.synchronize()
        with _RssPeak() as save_rss:
            t0 = time.perf_counter()
            nbytes = save_pretrained(tree, cut, d)
            save_s = time.perf_counter() - t0
        with _RssPeak() as load_rss:
            t0 = time.perf_counter()
            _, loaded, lcfg, specs = from_pretrained(
                d, device="cuda", dtype=torch.bfloat16)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same_tree = lcfg == cut and specs == param_specs(cut) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(loaded),
                                          tree_leaves(tree)))
    l_out, l_logits, l_m = _run(
        lambda: serving_engine(loaded, lcfg, **ZI_LLAMA_OPTS), prompts, 32,
        fns, "hf loaded llama bf16", launches, SERVING_KERNELS,
        capture=True)
    tokens_equal = l_out == r_out
    logits_bitwise = _same_logits(l_logits, r_logits)
    del loaded, l_logits, r_logits
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = MixtralConfig.tiny(dim=64)
    sd, hf = _mixtral_hf_state(mcfg)
    toks = torch.from_numpy(np.random.default_rng(34).integers(
        0, mcfg.vocab_size, (2, 40)).astype(np.int32))
    path = "hf injected mixtral tiny f32"
    _zero(fns.values())
    fn, on_card, _, _ = inject("MixtralForCausalLM", hf, sd,
                               dtype=torch.float32, device="cuda")
    card_logits = fn(on_card, toks.cuda()).cpu()
    launches[path] = {n: f.launches for n, f in fns.items()}
    _check_bodies(path, hopper=False)
    _check_launches(path, launches[path], ("flash_fwd",))
    fn_h, on_host, _, _ = inject("MixtralForCausalLM", hf, sd,
                                 dtype=torch.float32, device="cpu")
    host_logits = fn_h(on_host, toks)
    mixtral_leaves_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(on_card), tree_leaves(on_host)))
    mixtral_rel = float((card_logits - host_logits).abs().max()
                        / host_logits.abs().max())
    _phase_line("34 hf round trip", card_line, layers=layers,
                temp_dir_free_gb=free / 1e9, file_bytes=nbytes,
                save_s=save_s, save_gb_per_s=nbytes / save_s / 1e9,
                load_s=load_s, load_gb_per_s=nbytes / load_s / 1e9,
                save_rss=save_rss.gb(), load_rss=load_rss.gb(),
                loaded_tree_bitwise=same_tree, tokens_equal=tokens_equal,
                logits_bitwise=logits_bitwise,
                loaded_tokens_per_s=l_m["tokens_per_s"],
                loaded_peak_mem_gb=l_m["peak_mem_gb"],
                mixtral_leaves_equal=mixtral_leaves_equal,
                mixtral_logits_rel=mixtral_rel,
                mixtral_tol=HF_MIXTRAL_REL_TOL)
    if not (same_tree and tokens_equal and logits_bitwise
            and mixtral_leaves_equal and mixtral_rel <= HF_MIXTRAL_REL_TOL):
        raise SystemExit("phase 34: the HF round trip differs from the "
                         "seeded tree (or the injected Mixtral card from "
                         "CPU)")
    return launches


# ------------------------------------------------------------ phase 35
def phase_lora(fns, card_line, params):
    """LoRA of Llama-3-8B at all 32 layers: the seeded bf16 base frozen,
    ``LoRAConfig()`` (r 8, alpha 32, wq/wk/wv/wo), f32 adapter master, bf16
    compute, fused Adam, micro 1 x accumulation 2 x 2048 tokens (phase 8's
    batch), 4 steps on the one batch, ``remat="none"`` (memory allows it).
    Gates: step 1's loss equals the base model's own ``loss_fn`` bit for
    bit (B = 0); the loss falls; the base's digest is unchanged; the engine
    holds and moved only adapters; B1-B3 ran on their tensor-core bodies
    only and B4 launched once per adapter leaf a step; ``merge_lora``'s
    forward is within LORA_MERGE_REL_TOL of ``apply_lora``'s.  Then a
    profiled step's idle share."""
    import gc

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves, tree_map
    from deepspeed_tpu_torch.lora import (LoRAConfig, apply_lora,
                                          count_trainable, init_lora,
                                          lora_loss_fn, merge_lora)
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from torch.profiler import ProfilerActivity, profile

    cfg = llama.LlamaConfig.llama3_8b()
    lcfg = LoRAConfig()
    base_digest = _tree_digest(params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adapters = init_lora(torch.Generator("cuda").manual_seed(35), params,
                         lcfg)
    n_train, train_bytes = count_trainable(adapters)
    n_leaves = len(tree_leaves(adapters))
    eng, _, _, _ = initialize(
        loss_fn=lora_loss_fn(llama.loss_fn(cfg), params, lcfg),
        params=adapters,
        config=_train_config(2, 2, {"bf16": {"enabled": True}}),
        optimizer=fused_adam(lr=_warmup(), weight_decay=0.1))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2048)).astype(
        np.int32)}
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    with torch.no_grad():
        base_loss = sum(llama.loss_fn(cfg)(params, {
            "tokens": tokens[i:i + 1]}).float() for i in (0, 1)) / 2
    path = "lora llama3_8b 32 layers"
    _zero(fns.values())
    steps = []
    for i in range(LORA_STEPS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        loss = eng.train_batch(batch)
        lossf = float(loss)
        ms = (time.perf_counter() - ts) * 1e3
        if i == 0:
            first_bitwise = torch.equal(loss, base_loss)
        steps.append({"loss": lossf, "ms": ms,
                      "tokens_per_s": 2 * 2047 / ms * 1e3,
                      "grad_norm": eng.get_global_grad_norm()})
    launches = {n: f.launches for n, f in fns.items()}
    _check_bodies(path)
    _check_launches(path, launches, ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv", "fused_adam"))
    adam_per_leaf = launches["fused_adam"] == n_leaves * LORA_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trained = eng.module_params()
    only_adapters = sorted(trained) == sorted(adapters) and any(
        bool(torch.any(v["B"] != 0)) for v in trained.values())
    base_unchanged = _tree_digest(params) == base_digest
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        float(eng.train_batch(batch))
        traced_ms = (time.perf_counter() - ts) * 1e3
    busy = _device_busy_ms(prof)
    idle = None if busy is None else 1.0 - busy / traced_ms
    del prof
    trained = eng.module_params()
    with torch.no_grad():
        toks = tokens[:1, :-1]
        cast = tree_map(lambda x: x.to(torch.bfloat16), trained)
        eff = apply_lora(params, cast, lcfg)
        merged = merge_lora(params, trained, lcfg)
        w_eff_differ = {k: float((merged["blocks"][k] != eff["blocks"][k])
                                 .float().mean())
                        for k in lcfg.target_modules}
        want = llama.forward(eff, toks, cfg)
        del eff
        got = llama.forward(merged, toks, cfg)
        merge_rel = float((got - want).abs().max() / want.abs().max())
        del merged, got, want
    del eng, adapters, trained, cast
    gc.collect()
    torch.cuda.empty_cache()
    falls = steps[-1]["loss"] < steps[0]["loss"]
    _phase_line("35 lora llama3_8b", card_line, layers=cfg.n_layers,
                lora={"r": lcfg.lora_r, "alpha": lcfg.lora_alpha,
                      "targets": list(lcfg.target_modules)},
                trainable_params=n_train, trainable_bytes=train_bytes,
                adapter_leaves=n_leaves, remat=cfg.remat, micro=1, accum=2,
                seq=2048, steps=steps, base_loss=float(base_loss),
                first_step_equals_base_bitwise=first_bitwise,
                loss_falls=falls, base_unchanged=base_unchanged,
                only_adapters_moved=only_adapters,
                fused_adam_once_per_leaf_a_step=adam_per_leaf,
                launches=launches, peak_mem_gb=peak_gb,
                traced_ms=traced_ms, device_busy_ms=busy,
                device_idle_share=idle, merge_rel=merge_rel,
                merge_tol=LORA_MERGE_REL_TOL,
                w_eff_share_differing=w_eff_differ)
    if not (first_bitwise and falls and base_unchanged and only_adapters
            and adam_per_leaf and merge_rel <= LORA_MERGE_REL_TOL):
        raise SystemExit("phase 35: LoRA gates failed")
    return {path: launches}


# ------------------------------------------------------------ phase 36
def phase_rlhf_distill_trainer(fns, card_line):
    """At phase 8's widths (Llama-3-8B, 4 layers): (a) the hybrid engine
    over a full-parameter engine (f32 master, bf16 compute, fused Adam):
    greedy rollouts of 8 prompts of 128 tokens, 32 new, over its paged
    cache (B1 prefill, B5 decode), then one ``train_batch`` on phase 8's
    batch, then rollouts again, each identical to a standalone
    ``llama_paged_generator`` over the engine's params cast to bf16 at that
    moment; (b) distillation of a seeded bf16 4-layer
    teacher into a 2-layer student (alpha 0.5, T 2), 3 steps on the batch:
    the loss falls, the teacher is unchanged; (c) the Trainer bridge: a
    2-layer model exported with ``save_pretrained``, ``Trainer(model_dir=
    ...)`` 2 steps, ``save_model``, ``from_pretrained`` in f32 equal to the
    engine's master bit for bit.  The Trainer's config names ``adamw``,
    which is the plain Adam (as in the JAX package), so B4 does not run
    there."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves, tree_map
    from deepspeed_tpu_torch.distill import Distiller
    from deepspeed_tpu_torch.hybrid import init_hybrid_engine
    from deepspeed_tpu_torch.inference.generation import llama_paged_generator
    from deepspeed_tpu_torch.integrations.hf import (from_pretrained,
                                                     save_pretrained)
    from deepspeed_tpu_torch.integrations.trainer import (Trainer,
                                                          TrainingArguments)
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=4)
    train_kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2048)).astype(
        np.int32)}
    launches, res = {}, {}

    # (a) the hybrid engine
    conf = _train_config(2, 2, {"bf16": {"enabled": True}})
    conf["hybrid_engine"] = {"enabled": True, "max_out_tokens": 160}
    eng, _, _, _ = initialize(
        loss_fn=llama.loss_fn(cfg),
        params=init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           device="cuda", dtype=torch.float32),
        config=conf, optimizer=fused_adam(lr=_warmup(), weight_decay=0.1))
    hyb = init_hybrid_engine(eng, cfg)
    prompts = np.random.default_rng(36).integers(
        1, cfg.vocab_size, (HYBRID_PROMPTS, HYBRID_PROMPT_LEN)).astype(
        np.int32)
    outs = []
    for tag in ("before step", "after step"):
        p = f"hybrid rollout {tag}"
        _zero(fns.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hyb.generate(prompts, max_new_tokens=HYBRID_NEW,
                           temperature=0.0)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches[p] = {n: f.launches for n, f in fns.items()}
        _check_bodies(p)
        _check_launches(p, launches[p], ("flash_fwd", "paged_attention",
                                         "greedy_argmax"))
        with torch.no_grad():
            ref = llama_paged_generator(
                tree_map(lambda x: x.to(torch.bfloat16),
                         eng.module_params()), cfg).generate(
                prompts, HYBRID_NEW, max_seq=hyb.max_out_tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cast = hyb.compute_params()        # the mode switch, timed alone
        torch.cuda.synchronize()
        cast_ms = (time.perf_counter() - t0) * 1e3
        del cast
        res[p] = {"identical_to_generator": torch.equal(out, ref),
                  "tokens_per_s": HYBRID_PROMPTS * HYBRID_NEW / s,
                  "rollout_s": s, "cast_ms": cast_ms}
        outs.append(out)
        del ref
        if tag == "before step":
            p = "hybrid train step"
            _zero(fns.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[p] = {"loss": float(hyb.train_batch(batch))}
            res[p]["ms"] = (time.perf_counter() - t0) * 1e3
            launches[p] = {n: f.launches for n, f in fns.items()}
            _check_bodies(p)
            _check_launches(p, launches[p], train_kernels + ("fused_adam",))
    res["rollouts_differ_after_step"] = not torch.equal(*outs)
    del hyb, eng, outs
    gc.collect()
    torch.cuda.empty_cache()

    # (b) distillation
    scfg = dataclasses.replace(cfg, n_layers=2)
    teacher = init_params(cfg, torch.Generator("cuda").manual_seed(1),
                          device="cuda", dtype=torch.bfloat16)
    teacher_digest = _tree_digest(teacher)
    dist = Distiller(lambda p, x: llama.forward(p, x, cfg), teacher,
                     alpha=0.5, temperature=2.0)
    eng, _, _, _ = initialize(
        loss_fn=dist.loss_fn(lambda p, x: llama.forward(p, x, scfg),
                             has_aux=True),
        params=init_params(scfg, torch.Generator("cuda").manual_seed(2),
                           device="cuda", dtype=torch.float32),
        config=_train_config(2, 2, {"bf16": {"enabled": True}}),
        optimizer=fused_adam(lr=_warmup(), weight_decay=0.1), has_aux=True)
    p = "distillation"
    _zero(fns.values())
    dsteps = []
    for _ in range(DISTILL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(eng.train_batch(batch))
        aux = eng.metrics["aux"]
        dsteps.append({"loss": loss, "hard_loss": float(aux["hard_loss"]),
                       "kd_loss": float(aux["kd_loss"]),
                       "ms": (time.perf_counter() - t0) * 1e3})
    launches[p] = {n: f.launches for n, f in fns.items()}
    _check_bodies(p)
    _check_launches(p, launches[p], train_kernels + ("fused_adam",))
    res[p] = {"steps": dsteps,
              "loss_falls": dsteps[-1]["loss"] < dsteps[0]["loss"],
              "teacher_unchanged": _tree_digest(teacher) == teacher_digest}
    del eng, dist, teacher
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the Trainer bridge
    d = tempfile.mkdtemp(prefix="dstt_trainer_")
    try:
        base = init_params(scfg, torch.Generator("cuda").manual_seed(3),
                           device="cuda", dtype=torch.bfloat16)
        save_pretrained(base, scfg, os.path.join(d, "base"))
        del base
        auto = {"train_micro_batch_size_per_gpu": "auto",
                "gradient_accumulation_steps": "auto",
                "gradient_clipping": "auto",
                "optimizer": {"type": "adamw", "params": {
                    "lr": "auto", "betas": "auto", "eps": "auto",
                    "weight_decay": "auto"}},
                "scheduler": {"type": "WarmupLR", "params": {
                    "warmup_max_lr": "auto", "warmup_min_lr": "auto",
                    "warmup_num_steps": "auto"}},
                "bf16": {"enabled": True}}
        args = TrainingArguments(output_dir=os.path.join(d, "out"),
                                 deepspeed=auto,
                                 per_device_train_batch_size=1,
                                 learning_rate=1e-4,
                                 max_steps=TRAINER_STEPS, warmup_steps=1,
                                 logging_steps=0)
        rows = [{"input_ids": r.tolist()} for r in
                np.random.default_rng(3).integers(
                    1, cfg.vocab_size, (4, TRAINER_ROW))]
        p = "trainer"
        _zero(fns.values())
        t0 = time.perf_counter()
        tr = Trainer(model_dir=os.path.join(d, "base"), args=args,
                     train_dataset=rows)
        out = tr.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches[p] = {n: f.launches for n, f in fns.items()}
        _check_bodies(p)
        _check_launches(p, launches[p], train_kernels)
        t0 = time.perf_counter()
        outdir = tr.save_model()
        save_s = time.perf_counter() - t0
        _, back, bcfg, _ = from_pretrained(outdir, device="cuda",
                                           dtype=torch.float32)
        master = tr.engine.module_params()
        res[p] = {"train": out, "train_and_load_s": train_s,
                  "save_s": save_s, "config_equal": bcfg == scfg,
                  "saved_equals_master_bitwise": all(
                      torch.equal(a, b) for a, b in zip(
                          tree_leaves(back), tree_leaves(master)))}
        del tr, back, master
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    _phase_line("36 hybrid distill trainer", card_line, layers=cfg.n_layers,
                **res)
    ok = (all(res[f"hybrid rollout {t}"]["identical_to_generator"]
              for t in ("before step", "after step"))
          and np.isfinite(res["hybrid train step"]["loss"])
          and res["distillation"]["loss_falls"]
          and res["distillation"]["teacher_unchanged"]
          and res["trainer"]["config_equal"]
          and res["trainer"]["saved_equals_master_bitwise"]
          and res["trainer"]["train"]["train_steps"] == TRAINER_STEPS)
    if not ok:
        raise SystemExit("phase 36: hybrid, distillation or Trainer gates "
                         "failed")
    return launches


# ------------------------------------------------------------ phases 37-40
# phase 37: tiny bf16 models (JAX's param-stream test shape), 4 steps.
# Tolerances: the card's engine (B1-B3) against the CPU's (plain
# attention), both bf16: the card read 2.3e-4, so about 9x room; the stream against the stage-0 engine: JAX's own test bound
# (test_trajectory_matches_plain_engine, 2e-2); the layered Mixtral against
# the stage-0 engine: JAX's MoE bound (5e-3); Infinity's host update
# (native Adam) against its device update (plain Adam): 2e-3, the CPU
# test's bound
PSTREAM_CARD_CPU_RTOL = 2e-3
PSTREAM_PLAIN_RTOL = 2e-2
PSTREAM_MOE_RTOL = 5e-3
INFINITY_HOST_DEVICE_RTOL = 2e-3
TINY_STEPS = 4
# phases 38-40: Llama-3-8B widths cut to 2 of 32 layers (1.49 B params;
# 32 hold ~110 GB of host state, more than the host's 101 GiB, and 2, not
# 8, for the smoke's time, which phases 48-52 raised: phase 50 trains the
# same depth over two ranks with phase 38 as its oracle), phase 8's traffic (micro 1 x accumulation
# 2 x 2048 tokens); 39, 40 and 51 at 1 layer (2 until PR 20: the smoke's
# time, which phases 48-52 raised)
OFFLOAD_LAYERS, OFFLOAD_NVME_LAYERS = 2, 1
# phases 39 and 40 take one step an arm (2 until PR 20: the smoke's time;
# phase 40's gate reads step 1)
OFFLOAD_STEPS, OFFLOAD_NVME_STEPS, INFINITY_STEPS = 3, 1, 1
# phase 40's step 1 against phase 38's: the same bf16 weights, batch and
# forward; the two engines average the micro-batch losses in f64 (param
# stream) and f32 (Infinity)
INFINITY_VS_PSTREAM_RTOL = 1e-6
# an engine that stayed alive would hold >= 24 GB of host state
RSS_LEAK_GB = 10.0


def _offload_config(zero, clip=0.0, batch=2, accum=2):
    """Phase 8's optimizer and schedule (adamw, WarmupLR) with a ZeRO
    block; no clipping unless asked (clipping forces the strict path)."""
    conf = _train_config(batch, accum, {"bf16": {"enabled": True}})
    conf["gradient_clipping"] = clip
    conf["zero_optimization"] = {"stage": 0, **zero}
    return conf


def _drop():
    """gc, then empty the card's allocator, torch's page-locked host cache
    (where torch has the call) and malloc's free lists; returns (card GB
    allocated, host RSS GB)."""
    import ctypes
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass
    return torch.cuda.memory_allocated() / 1e9, _RssPeak._rss() / 1e9


def _tiny_batches(rng, n, rows, vocab, T=33):
    return [{"tokens": rng.integers(0, vocab, (rows, T)).astype(np.int32)}
            for _ in range(n)]


def phase_offload_identity(fns, card_line):
    """Phase 37: tiny bf16 models, 4 steps each.  The param-stream engine
    on the card (B1-B3) against the same engine on the CPU (plain arms);
    on the card: RAM tier against NVMe tier and overlap against strict mode
    bit for bit (losses and masters), the stream against the stage-0
    engine, Infinity's device update against its host update, the layered
    Mixtral against the stage-0 engine, and the unscheduled
    ``offload_optimizer: {device: cpu}`` engine (fused Adam, B4) against
    the plain one bit for bit."""
    import shutil

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models import llama, mixtral
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    cfg = llama.LlamaConfig.tiny(dim=64, n_layers=3, n_heads=4,
                                 n_kv_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(37),
                         device="cpu", dtype=torch.float32)
    batches = _tiny_batches(np.random.default_rng(37), TINY_STEPS, 4,
                            cfg.vocab_size)
    sched = {"device": "cpu", "scheduled": True}
    launches, res = {}, {}
    attn = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    d = _nvme_dir("pstream_tiny")

    def run(path, build, device="cuda", want=attn):
        _zero(fns.values())
        eng = build(device)
        losses = [float(eng.train_batch(b)) for b in batches]
        master = eng.module_params()
        if device == "cuda":
            launches[path] = {n: f.launches for n, f in fns.items()}
            # head_dim 16: the flash kernels' scalar body
            _check_bodies(path, hopper=False)
            _check_launches(path, launches[path], want)
        del eng
        return losses, [t.detach().cpu() for t in tree_leaves(master)]

    def stream(zero):
        return lambda dev: initialize(
            params=llama.layered_model(cfg, params),
            config=_offload_config(zero), device=dev)[0]

    try:
        runs = {
            "ram": run("pstream tiny card", stream({"offload_param": sched})),
            "cpu": run("pstream tiny cpu", stream({"offload_param": sched}),
                       device="cpu"),
            "nvme": run("pstream tiny nvme", stream({"offload_param": {
                "device": "nvme", "nvme_path": d}})),
            "strict": run("pstream tiny strict", stream({"offload_param": {
                **sched, "overlap_step": False}})),
            "plain": run("stage0 tiny", lambda dev: initialize(
                loss_fn=llama.loss_fn(cfg), params=params,
                config=_offload_config({}), device=dev)[0]),
            "inf_dev": run("infinity tiny device", lambda dev: initialize(
                loss_fn=llama.loss_fn(cfg), params=params,
                config=_offload_config({"offload_optimizer": sched}),
                device=dev)[0]),
            "inf_host": run("infinity tiny host", lambda dev: initialize(
                loss_fn=llama.loss_fn(cfg), params=params,
                config=_offload_config({"offload_optimizer": {
                    **sched, "update": "host"}}), device=dev)[0])}
    finally:
        shutil.rmtree(d, ignore_errors=True)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(x, y)
                                    for x, y in zip(a[1], b[1]))

    res["card_vs_cpu_rel"] = rel(runs["ram"][0], runs["cpu"][0])
    res["nvme_equals_ram_bitwise"] = same(runs["nvme"], runs["ram"])
    res["strict_equals_overlap_bitwise"] = same(runs["strict"], runs["ram"])
    res["stream_vs_stage0_rel"] = rel(runs["ram"][0], runs["plain"][0])
    res["infinity_host_vs_device_rel"] = rel(runs["inf_host"][0],
                                             runs["inf_dev"][0])
    res["losses"] = {k: v[0] for k, v in runs.items()}

    # the layered Mixtral (per-layer aux, cotangent 1) against stage 0
    mcfg = mixtral.MixtralConfig.tiny(dim=64, n_layers=2, n_heads=4,
                                      n_kv_heads=2, num_experts=4)
    mparams = init_params(mcfg, torch.Generator().manual_seed(38),
                          device="cpu", dtype=torch.float32)
    mbatches = _tiny_batches(np.random.default_rng(38), TINY_STEPS, 4,
                             mcfg.vocab_size)
    mruns = {}
    for arm, build in (
            ("pstream", lambda: initialize(
                params=mixtral.layered_model(mcfg, mparams),
                config=_offload_config({"offload_param": sched}))[0]),
            ("stage0", lambda: initialize(
                loss_fn=mixtral.loss_fn(mcfg), params=mparams, has_aux=True,
                config=_offload_config({}))[0])):
        path = f"mixtral tiny {arm}"
        _zero(fns.values())
        eng = build()
        mruns[arm] = [float(eng.train_batch(b)) for b in mbatches]
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path, hopper=False)
        _check_launches(path, launches[path], attn)
        del eng
    res["mixtral_stream_vs_stage0_rel"] = rel(mruns["pstream"],
                                              mruns["stage0"])
    res["mixtral_losses"] = mruns

    # the unscheduled host placement (fused Adam: B4 on each visiting leaf)
    oruns = {}
    for arm, zero in (("plain", {}),
                      ("offload", {"offload_optimizer": {"device": "cpu"}})):
        path = f"stage0 tiny {arm} fused_adam"
        _zero(fns.values())
        eng = initialize(loss_fn=llama.loss_fn(cfg), params=params,
                         config=_offload_config(zero, clip=1.0),
                         optimizer=fused_adam(lr=_warmup(),
                                              weight_decay=0.1))[0]
        losses = [float(eng.train_batch(b)) for b in batches]
        st = [t.detach().cpu() for t in tree_leaves(
            (eng.state.params, eng.state.opt_state[1:]))]
        on_host = all(t.device.type == "cpu" and t.is_pinned() for t in
                      tree_leaves(eng.state.opt_state[1:])) \
            if zero else None
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path, hopper=False)
        _check_launches(path, launches[path], attn + ("fused_adam",))
        oruns[arm] = (losses, st, on_host)
        del eng
    res["unscheduled_offload_equals_plain_bitwise"] = same(
        oruns["offload"][:2], oruns["plain"][:2])
    res["unscheduled_state_pinned_on_host"] = oruns["offload"][2]
    _drop()
    _phase_line("37 offload identity", card_line, layers=cfg.n_layers,
                steps=TINY_STEPS, tolerances={
                    "card_vs_cpu": PSTREAM_CARD_CPU_RTOL,
                    "stream_vs_stage0": PSTREAM_PLAIN_RTOL,
                    "mixtral_stream_vs_stage0": PSTREAM_MOE_RTOL,
                    "infinity_host_vs_device": INFINITY_HOST_DEVICE_RTOL},
                launches=launches, **res)
    ok = (res["card_vs_cpu_rel"] <= PSTREAM_CARD_CPU_RTOL
          and res["nvme_equals_ram_bitwise"]
          and res["strict_equals_overlap_bitwise"]
          and res["stream_vs_stage0_rel"] <= PSTREAM_PLAIN_RTOL
          and res["infinity_host_vs_device_rel"]
          <= INFINITY_HOST_DEVICE_RTOL
          and res["mixtral_stream_vs_stage0_rel"] <= PSTREAM_MOE_RTOL
          and res["unscheduled_offload_equals_plain_bitwise"]
          and res["unscheduled_state_pinned_on_host"])
    if not ok:
        raise SystemExit("phase 37: offload identity gates failed")
    return launches


def _state_reckoning(cfg) -> dict:
    """Host and card bytes of the offloaded state at ``cfg``'s depth."""
    from deepspeed_tpu_torch.models.llama import param_count

    n = param_count(cfg)
    d, V = cfg.dim, cfg.vocab_size
    stem_head = 2 * V * d + d
    per_layer = (n - stem_head) // cfg.n_layers
    return {"params": n, "per_layer_params": per_layer,
            "host_tier_gb": cfg.n_layers * per_layer * 14 / 1e9,
            "host_stem_head_state_gb": stem_head * 12 / 1e9,
            "host_grad_accumulators_gb": n * 4 / 1e9,
            "stage0_card_gb": n * (2 + 4 + 8 + 4) / 1e9}


def _lazy_at_depth(lm, L):
    """The lazy model ``lm`` cut to ``L`` layers (the same seeded draws:
    layer l's generator depends on l only)."""
    import dataclasses

    return dataclasses.replace(lm, n_layers=L, blocks_spec={
        k: torch.empty((L,) + tuple(v.shape[1:]), dtype=v.dtype,
                       device="meta") for k, v in lm.blocks_spec.items()})


def _profiled_step(eng, batch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        float(eng.train_batch(batch))
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - ts) * 1e3
    busy = _device_busy_ms(prof)
    return traced_ms, busy, None if busy is None else 1.0 - busy / traced_ms


def phase_pstream_headline(fns, card_line, cfg, lm, batch):
    """Phase 38: Llama-3-8B widths at 8 layers (2.79 B params, seed 0,
    ``layered_model_lazy``) trained by ``ParamStreamEngine`` on the RAM
    tier, ``overlap_step`` on, phase 8's traffic, 3 steps (the third
    under the profiler): ms/step, tokens/s, peak card memory against stage 0's need,
    host RSS, link bytes, the phase split, the bound (host Adam, link,
    FLOPs) and the idle share.  Gates: the loss falls; every B1-B3 launch
    on the tensor-core body, 2 x (L + L) forward and 2 x L backward
    launches a step; the native host Adam ran."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops import cpu_adam

    reck = _state_reckoning(cfg)
    card0, rss0 = _drop()
    torch.cuda.reset_peak_memory_stats()
    path = f"pstream llama3_8b {cfg.n_layers} layers"
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        eng = initialize(params=lm, config=_offload_config(
            {"offload_param": {"device": "cpu", "scheduled": True}}))[0]
        init_s = time.perf_counter() - t0
        log(f"[pstream] llama3_8b widths, {cfg.n_layers} of 32 layers "
            f"(cut: 32 layers hold ~110 GB of host state, the host has "
            f"101 GiB), {reck['params']} params; host tier "
            f"{reck['host_tier_gb']:.1f} GB + stem/head state "
            f"{reck['host_stem_head_state_gb']:.1f} GB + grad accumulators "
            f"{reck['host_grad_accumulators_gb']:.1f} GB; stage 0 would "
            f"need {reck['stage0_card_gb']:.1f} GB on the card; init "
            f"{init_s:.1f} s on {card_line}")
        _zero(fns.values())
        steps = []
        for i in range(OFFLOAD_STEPS):
            # the last step runs under the profiler (the idle share)
            profiled = i == OFFLOAD_STEPS - 1
            torch.cuda.synchronize()
            ts = time.perf_counter()
            if profiled:
                traced_ms, busy, idle = _profiled_step(eng, batch)
                loss = float(eng.metrics["loss"])
                # the step itself, not the profiler's teardown after it
                s = traced_ms / 1e3
            else:
                loss = float(eng.train_batch(batch))
                s = time.perf_counter() - ts
            steps.append({"loss": loss, "s": s, "profiled": profiled,
                          "tokens_per_s": 2 * 2047 / s,
                          "grad_norm": eng.get_global_grad_norm(),
                          "link_bytes": dict(eng.link_bytes),
                          "phases": eng.phase_report()})
            log(f"[pstream] step {i}: loss {loss:.4f} {s * 1e3:.0f} ms "
                f"{2 * 2047 / s:.1f} tokens/s phases {eng.phase_report()}")
        launches = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        _check_launches(path, launches, ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv"))
        L = cfg.n_layers
        want = {"flash_fwd": OFFLOAD_STEPS * 2 * 2 * L,
                "flash_bwd_dq": OFFLOAD_STEPS * 2 * L,
                "flash_bwd_dkv": OFFLOAD_STEPS * 2 * L}
        counts_ok = all(fns[n].body_launches == {"wgmma": k, "scalar": 0}
                        for n, k in want.items())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        working_set = eng.hbm_param_working_set_bytes()
        n_params = eng.total_param_count()
        del eng
        card1, rss1 = _drop()
    last = steps[-2]                   # the last step off the profiler
    link = last["link_bytes"]["up"] + last["link_bytes"]["down"]
    flops = 2 * _train_flops_per_sample(cfg, 2047)
    terms = {"host_adam_s": n_params * 30 / (RATES["cpu_adam_gbps"] * 1e9),
             "link_s": max(last["link_bytes"]["up"],
                           last["link_bytes"]["down"])
             / (RATES["link_gbps"] * 1e9),
             "flops_s": flops / BF16_FLOPS_PER_S}
    bound_s = max(terms.values())
    native = cpu_adam.native_available()
    falls = steps[-1]["loss"] < steps[0]["loss"]
    _phase_line("38 pstream llama3_8b", card_line, layers=cfg.n_layers,
                cut=f"{cfg.n_layers} of 32 layers: host memory (32), the "
                "smoke's time (8)", reckoning=reck,
                params=n_params, micro=1, accum=2, seq=2048, steps=steps,
                init_s=init_s, peak_mem_gb=peak_gb,
                hbm_param_working_set_gb=working_set / 1e9,
                rss=rss.gb(), rss_before_gb=rss0, rss_after_drop_gb=rss1,
                card_gb_before=card0, card_gb_after_drop=card1,
                link_bytes_per_step=link, bound_terms_s=terms,
                bound_s=bound_s, bound_share=bound_s / last["s"],
                rates=RATES, model_flops_per_step=flops,
                traced_ms=traced_ms, device_busy_ms=busy,
                device_idle_share=idle, launches=launches,
                launches_as_expected=counts_ok, native_cpu_adam=native,
                loss_falls=falls)
    if not (falls and counts_ok and native
            and card1 <= card0 + 0.1 and rss1 <= rss0 + RSS_LEAK_GB):
        raise SystemExit("phase 38: param-stream headline gates failed")
    return {path: launches}, [st["loss"] for st in steps]


def phase_pstream_nvme(fns, card_line, lm, batch):
    """Phase 39: the same widths at 1 layer (the smoke's time): the NVMe
    tier against the RAM tier, 2 steps each, bit for bit (losses and
    masters), the tier's bytes and GB/s over the step; the tier directory
    deleted.  Its ``save_checkpoint`` -> ``zero_to_fp32`` round trip is the
    CPU test's (``tests/test_torch_param_stream.py``): the smoke's time."""
    import shutil

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch._tree import tree_leaves_with_path

    lm4 = _lazy_at_depth(lm, OFFLOAD_NVME_LAYERS)
    card0, rss0 = _drop()
    d = _nvme_dir("pstream_nvme")
    launches, runs = {}, {}
    try:
        for arm, off in (("ram", {"device": "cpu", "scheduled": True}),
                         ("nvme", {"device": "nvme",
                                   "nvme_path": os.path.join(d, "swap")})):
            path = f"pstream llama3_8b {OFFLOAD_NVME_LAYERS} layers {arm}"
            t0 = time.perf_counter()
            eng = initialize(params=lm4, config=_offload_config(
                {"offload_param": off}))[0]
            init_s = time.perf_counter() - t0
            _zero(fns.values())
            tier = eng.tier
            r0 = getattr(tier, "bytes_read", 0)
            w0 = getattr(tier, "bytes_written", 0) + getattr(
                eng._utier, "bytes_written", 0)
            steps = []
            for _ in range(OFFLOAD_NVME_STEPS):
                ts = time.perf_counter()
                loss = float(eng.train_batch(batch))
                steps.append({"loss": loss, "s": time.perf_counter() - ts,
                              "phases": eng.phase_report()})
            launches[path] = {n: f.launches for n, f in fns.items()}
            _check_bodies(path)
            _check_launches(path, launches[path], (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
            run_s = sum(st["s"] for st in steps)
            io = {}
            if arm == "nvme":
                rd = tier.bytes_read + eng._utier.bytes_read - r0
                wr = tier.bytes_written + eng._utier.bytes_written - w0
                io = {"bytes_read": rd, "bytes_written": wr,
                      "read_gbps_over_steps": rd / run_s / 1e9,
                      "write_gbps_over_steps": wr / run_s / 1e9}
            runs[arm] = {"steps": steps, "init_s": init_s, **io,
                         "master": eng.master_params()}
            del eng
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ram, nvme = runs["ram"], runs["nvme"]
    bitwise = ([s["loss"] for s in nvme["steps"]]
               == [s["loss"] for s in ram["steps"]]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves_with_path(nvme.pop("master")),
            tree_leaves_with_path(ram.pop("master"))))
    card1, rss1 = _drop()
    _phase_line("39 pstream nvme", card_line, layers=OFFLOAD_NVME_LAYERS,
                cut=f"{OFFLOAD_NVME_LAYERS} layers: the smoke's time",
                ram=ram, nvme=nvme,
                nvme_equals_ram_bitwise=bitwise, card_gb_before=card0,
                card_gb_after_drop=card1,
                rss_before_gb=rss0, rss_after_drop_gb=rss1,
                launches=launches)
    if not (bitwise and card1 <= card0 + 0.1
            and rss1 <= rss0 + RSS_LEAK_GB):
        raise SystemExit("phase 39: NVMe tier gates failed")
    return launches, ram["steps"][0]["loss"]


def phase_infinity(fns, card_line, cfg, lm, batch, pstream_step1):
    """Phase 40: ``InfinityEngine`` on phase 39's 1-layer cut of phase 38's
    model (the smoke's time) and phase 38's traffic, RAM tier, ``update:
    "device"`` then ``"host"``, 2 steps each: ms/step, peak card memory,
    ``hbm_state_bytes``, state bytes over the link.  Gate: step 1's loss
    equals phase 39's 1-layer RAM run's step 1 within
    INFINITY_VS_PSTREAM_RTOL (same weights, same batch, two engines)."""
    import dataclasses

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import llama

    cfg = dataclasses.replace(cfg, n_layers=OFFLOAD_NVME_LAYERS)
    lm = _lazy_at_depth(lm, OFFLOAD_NVME_LAYERS)
    keys = sorted(lm.blocks_spec)
    with ThreadPoolExecutor(4) as ex:
        layers = list(ex.map(lm.blocks, range(cfg.n_layers)))
    tree = lm.assemble(lm.stem, {k: torch.stack([x[k] for x in layers])
                                 for k in keys}, lm.head)
    del layers
    card0, rss0 = _drop()
    launches, res = {}, {}
    for mode in ("device", "host"):
        path = f"infinity llama3_8b {cfg.n_layers} layers {mode}"
        torch.cuda.reset_peak_memory_stats()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            eng = initialize(loss_fn=llama.loss_fn(cfg), params=tree,
                             config=_offload_config({"offload_optimizer": {
                                 "device": "cpu", "scheduled": True,
                                 "update": mode}}))[0]
            init_s = time.perf_counter() - t0
            _zero(fns.values())
            steps = []
            for _ in range(INFINITY_STEPS):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                loss = float(eng.train_batch(batch))
                s = time.perf_counter() - ts
                steps.append({"loss": loss, "s": s,
                              "tokens_per_s": 2 * 2047 / s,
                              "link_bytes": dict(eng.link_bytes),
                              "phases": eng.phase_report()})
                log(f"[infinity {mode}] loss {loss:.4f} {s * 1e3:.0f} ms "
                    f"{eng.phase_report()}")
            launches[path] = {n: f.launches for n, f in fns.items()}
            _check_bodies(path)
            _check_launches(path, launches[path], (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
            res[mode] = {"init_s": init_s, "steps": steps,
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9, "hbm_state_bytes": eng.hbm_state_bytes(),
                         "tier_bytes": eng.tier_local_bytes(),
                         "groups": len(eng.groups)}
            del eng
            card1, rss1 = _drop()
        res[mode].update(rss=rss.gb(), card_gb_after_drop=card1,
                         rss_after_drop_gb=rss1)
    del tree
    rels = {m: abs(res[m]["steps"][0]["loss"] - pstream_step1)
            / abs(pstream_step1) for m in res}
    _phase_line("40 infinity llama3_8b", card_line, layers=cfg.n_layers,
                cut=f"{OFFLOAD_NVME_LAYERS} layers: the smoke's time",
                micro=1, accum=2, seq=2048, step1_vs_pstream_rel=rels,
                tol=INFINITY_VS_PSTREAM_RTOL, pstream_step1=pstream_step1,
                card_gb_before=card0, rss_before_gb=rss0, launches=launches,
                **res)
    ok = all(r <= INFINITY_VS_PSTREAM_RTOL for r in rels.values()) and all(
        res[m]["card_gb_after_drop"] <= card0 + 0.1
        and res[m]["rss_after_drop_gb"] <= rss0 + RSS_LEAK_GB for m in res)
    if not ok:
        raise SystemExit("phase 40: Infinity gates failed")
    return launches, res["device"]["steps"][0]["loss"]


def train_beyond_the_card(fns, card_line):
    """Phases 37-40.  Phase 38's lazy model (its stem and head drawn once)
    serves 39 (cut to 1 layer) and 40.  Returns every main path's
    launches, phase 38's losses and phase 40's step-1 loss (phases 50 and
    51's oracles)."""
    import dataclasses

    from deepspeed_tpu_torch.models import llama

    launches = phase_offload_identity(fns, card_line)
    _lap("phase_offload_identity")
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=OFFLOAD_LAYERS)
    t0 = time.perf_counter()
    lm = llama.layered_model_lazy(cfg, seed=0)
    log(f"[offload] stem and head drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2048)).astype(
        np.int32)}
    got, losses38 = phase_pstream_headline(fns, card_line, cfg, lm, batch)
    launches.update(got)
    _lap("phase_pstream_headline (stem / head draws included)")
    got, step1_4 = phase_pstream_nvme(fns, card_line, lm, batch)
    launches.update(got)
    _lap("phase_pstream_nvme")
    got, step1_40 = phase_infinity(fns, card_line, cfg, lm, batch, step1_4)
    launches.update(got)
    _lap("phase_infinity")
    return launches, {"phase38_losses": losses38, "phase40_step1": step1_40}


def serve_beyond_the_card(fns, card_line, gen, rows):
    """Phases 28-32, 34 and 35 (Llama-3-8B's weights drawn once, in phase
    29, and used by 30, 32, 34, 35 and 31; 31 runs last, since
    Mixtral-8x7B's 64 GB budget needs the card free of them); B5's
    verify-window cases join its row.  Returns every main path's
    launches and the file holding phase 29's first prefill logits (bf16,
    bitwise the streamed engine's: phase 52's reference)."""
    link = phase_aio(card_line)
    _lap("phase_aio")
    launches, params, llama_off, resident = phase_zi_identity(fns, card_line,
                                                              link)
    _lap("phase_zi_identity")
    spec_launches, cases = phase_spec(fns, card_line, params, gen)
    launches.update(spec_launches)
    _lap("phase_spec")
    launches.update(phase_kv_nvme(fns, card_line, params))
    _lap("phase_kv_nvme")
    launches.update(phase_hf_roundtrip(fns, card_line, params, resident))
    _lap("phase_hf_roundtrip")
    prefill29 = os.path.join(_nvme_dir("zi_ref"), "prefill.pt")
    torch.save(resident[1]["_prefill"].cpu(), prefill29)
    del resident
    launches.update(phase_lora(fns, card_line, params))
    _lap("phase_lora")
    holder = [params]
    del params
    launches.update(phase_zi_serving(fns, card_line, holder, llama_off,
                                     link))
    _lap("phase_zi_serving")
    rows["paged_attention"]["verify_shapes"] = cases
    return launches, prefill29


# ------------------------------------------------------------ phases 41-42
# both run in one rank that the port's launcher starts: one NCCL group of
# one rank (the card is one GPU), every ZeRO collective on it
ZERO_CHILD_FLAG = "--zero-child"
ZERO_CHILD_TIMEOUT_S = 900
# phase 41: one flat f32 gradient of GPT-2 1.3B (its parameter count), on
# qwZ's flat grid of 512-element groups
WIRE_ELEMS, WIRE_GROUP = 1_313_626_112, 512
ZERO_STEPS = 3
# phases 42, 48, 49 and 54: GPT-2 1.3B cut to 2 of 24 layers (the smoke's
# time; phase 19 trains all 24)
ZERO_LAYERS = 2


def _kernel_fns():
    """Each kernel's wrapper, whose ``launches`` the main paths read."""
    from deepspeed_tpu_torch.replica_child import kernel_wrappers

    return kernel_wrappers()


@contextlib.contextmanager
def _plain_b9():
    """B9's plain version in the place of its kernel inside ``ops/quant``
    (the comparison arm of phase 41; it launches no B9)."""
    from deepspeed_tpu_torch.ops import quant
    from deepspeed_tpu_torch.ops.quant_cuda import quantize_rows_reference

    real, quant.quantize_rows = quant.quantize_rows, quantize_rows_reference
    try:
        yield
    finally:
        quant.quantize_rows = real


def phase_wire(fns, card_line):
    """Phase 41: the int8 wire of qgZ / qwZ / hpZ at a world of one over
    NCCL, on a seeded flat f32 gradient of GPT-2 1.3B's elements.  Each
    function runs on B9 (the main path, counts set to 0 before it and read
    after) and again over B9's plain version on the card; the outputs, and
    the codes and scales, must be equal bit for bit.  Then B9 alone at this
    flat shape on the device clock, beside its plain version and its bytes
    bound."""
    from deepspeed_tpu_torch.comm import collectives as hc
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, param_count
    from deepspeed_tpu_torch.ops import quant
    from deepspeed_tpu_torch.ops.quant_cuda import (quantize_rows,
                                                    quantize_rows_reference)
    from deepspeed_tpu_torch.topology import current_mesh

    n = WIRE_ELEMS
    if n != param_count(GPT2Config.gpt2_1_3b()):
        raise SystemExit("phase 41: the wire is not GPT-2 1.3B's size")
    groups = n // WIRE_GROUP
    g = torch.randn(n, generator=torch.Generator("cuda").manual_seed(41),
                    device="cuda")
    gp = quant.block_pad(g)             # the blockwise codec's 4096 grid
    h = hc.resolve_hierarchy(1, 0, ms=current_mesh())
    cases = {
        "quantized_reduce_scatter": lambda: quant.quantized_reduce_scatter(
            g, "data", groups_per_shard=groups),
        "quantized_all_gather": lambda: quant.quantized_all_gather(
            g, "data", num_groups=groups),
        "hierarchical_all_reduce": lambda: hc.hierarchical_all_reduce(
            gp, "data", h, codec="blockwise"),
        "quantize (qgZ's codes and scales)": lambda: quant.quantize(
            g, num_groups=groups)[:2],
    }
    main = ("quantized_reduce_scatter", "quantized_all_gather",
            "hierarchical_all_reduce")
    same, wall = {}, {}
    _zero(fns.values())
    for name, fn in cases.items():
        count = name in main
        before = {k: f.launches for k, f in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3
        if not count:           # the comparison's own launches do not count
            for k, f in fns.items():
                f.launches = before[k]
        with _plain_b9():
            want = fn()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        same[name] = all(torch.equal(a, b) for a, b in pairs)
        del got, want
        torch.cuda.empty_cache()
    launches = {n_: f.launches for n_, f in fns.items()}
    _check_bodies("wire W1")
    _check_launches("wire W1", launches, ("quantize",))
    # qrs 1, qag 1, the flat hierarchy's reduce-scatter and gather 2
    want_b9 = 4
    rows = g.view(groups, WIRE_GROUP)
    dev = device_ms(lambda: quantize_rows(rows))
    plain = device_ms(lambda: quantize_rows_reference(rows))
    nbytes = n * 4 + n + groups * 4
    bnd, by = bound(nbytes, 0, F32_FLOPS_PER_S)
    row = {"shape": [groups, WIRE_GROUP], "dtype": "float32",
           "ms": dev, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
           "bound_share": None if not dev else bnd / dev,
           "launches": launches["quantize"], "nbytes": nbytes}
    del g, gp, rows
    torch.cuda.empty_cache()
    _phase_line("41 wire W1", card_line, elements=n, group=WIRE_GROUP,
                bit_for_bit_vs_plain_b9=same, host_ms=wall, b9=row,
                launches=launches)
    if not all(same.values()) or launches["quantize"] != want_b9:
        raise SystemExit(f"phase 41: wire differs from B9's plain version "
                         f"{same} or B9 launched {launches['quantize']} "
                         f"times, expected {want_b9}")
    return {"wire W1": launches}, row


def _zero_comm_expected(stage, leaves, n):
    """{op: (calls, bytes)} a step at a world of one: the grads (all-reduced
    or reduce-scattered, f32), the new params all-gathered (stages 1-2,
    f32) or the compute tree gathered (stage 3, bf16), and three small
    all-reduces (the loss, the vector of sums of squares, the overflow
    flag)."""
    small = (3, 4 + 4 * leaves + 4)
    if stage <= 1:
        out = {"all_reduce": (leaves + 3, 4 * n + small[1])}
    else:
        out = {"all_reduce": small, "reduce_scatter": (leaves, 4 * n)}
    if stage in (1, 2):
        out["all_gather"] = (leaves, 4 * n)
    if stage == 3:
        out["all_gather"] = (leaves, 2 * n)
    return out


def phase_zero_stages(fns, card_line, phase19_ms):
    """Phase 42: GPT-2 1.3B at ZERO_LAYERS (2) of 24 layers (phase 19's
    config under
    ``save_attn``: micro 8 x 1024, bf16 compute, f32 master, fused Adam,
    clipping 1.0) through ZeRO stages 0-3 in this rank, 3 steps each from
    the same seeded weights on the same batch.  Gates: losses and every
    master leaf equal stage 0's bit for bit; the comms logger's calls and
    bytes a step equal what the stage moves; B1-B4 launch counts; qwZ at a
    world of one warns and runs the plain path (its step 1 equals stage
    3's); a stage-3 save loaded into a stage-1 engine equals it bit for bit
    (masters and moments)."""
    import dataclasses
    import gc
    import logging
    import shutil

    from deepspeed_tpu_torch import comm, initialize, zero
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, loss_fn,
                                                 param_count)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam

    cfg = dataclasses.replace(GPT2Config.gpt2_1_3b(), remat="save_attn",
                              n_layers=ZERO_LAYERS)
    B, T = GPT2_TRAIN_B, GPT2_TRAIN_T
    n = param_count(cfg)
    rng = np.random.default_rng(19)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    log_ = comm.comms_logger()

    def engine(zero_block):
        conf = _train_config(B, 1, {"bf16": {"enabled": True}})
        conf["zero_optimization"] = zero_block
        torch.cuda.empty_cache()
        params = _gpt2_params(cfg, 19, torch.float32)
        eng = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                         optimizer=fused_adam(lr=_warmup(),
                                              weight_decay=0.1))[0]
        del params
        torch.cuda.synchronize()
        return eng

    runs, launches, ref = {}, {}, None
    for stage in range(4):
        path = f"gpt2-1.3b-{ZERO_LAYERS}L ZeRO-{stage} W1"
        eng = engine({"stage": stage})
        leaves = len(tree_leaves(eng.state.params))
        _zero(fns.values())
        log_.reset()
        rows = []
        for _ in range(ZERO_STEPS):
            torch.cuda.reset_peak_memory_stats()
            ts = time.perf_counter()
            loss = float(eng.train_batch(batch))
            rows.append({"loss": loss,
                         "ms": (time.perf_counter() - ts) * 1e3,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        got = {k: f.launches for k, f in fns.items()}
        _check_bodies(path)
        L = cfg.n_layers
        want = {"flash_fwd": 2 * L * ZERO_STEPS,
                "flash_bwd_dq": L * ZERO_STEPS,
                "flash_bwd_dkv": L * ZERO_STEPS,
                "fused_adam": leaves * ZERO_STEPS}
        if any(got[k] != v for k, v in want.items()) or any(
                got[k] for k in got if k not in want):
            raise SystemExit(f"phase 42: {path} launches {got}, expected "
                             f"{want}")
        launches[path] = got
        summ = log_.summary()
        per_step = {op: (s["count"] / ZERO_STEPS, s["bytes"] / ZERO_STEPS)
                    for op, s in summ.items()}
        expected = _zero_comm_expected(stage, leaves, n)
        masters = [t.detach().cpu() for t in
                   tree_leaves(eng.module_params())]
        if ref is None:
            ref = {"losses": [r["loss"] for r in rows], "masters": masters}
        equal = ([r["loss"] for r in rows] == ref["losses"] and all(
            torch.equal(a, b) for a, b in zip(masters, ref["masters"])))
        del masters
        runs[stage] = {"steps": rows, "comm_per_step": per_step,
                       "comm_expected": expected,
                       "comm_ok": per_step == {k: (float(c), float(b))
                                               for k, (c, b) in
                                               expected.items()},
                       "bitwise_vs_stage0": equal, "leaves": leaves}
        log(f"[zero] stage {stage}: losses {[r['loss'] for r in rows]} "
            f"ms/step {[round(r['ms'], 1) for r in rows]} (phase 19 "
            f"save_attn: {phase19_ms}) peak GB "
            f"{[round(r['peak_gb'], 3) for r in rows]} comm/step {per_step}"
            f" bit-equal to stage 0 {equal}; launches {got}")
        del eng
        gc.collect()
    # qwZ at a world of one: JAX's warning, the plain stage-3 path
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    logging.getLogger("deepspeed_tpu_torch.comm_compress").addHandler(
        handler)
    try:
        eq = engine({"stage": 3, "zero_quantized_weights": True})
    finally:
        logging.getLogger("deepspeed_tpu_torch.comm_compress") \
            .removeHandler(handler)
    qwz = {"mode": eq.grad_comm_mode, "warned": any(
        "data-parallel world is 1" in m for m in seen),
        "step1": float(eq.train_batch(batch))}
    qwz["step1_equals_stage3"] = qwz["step1"] == runs[3]["steps"][0]["loss"]
    del eq
    gc.collect()
    # a stage-3 save loaded into a stage-1 engine
    d = _nvme_dir("zero_ckpt")
    try:
        e3 = engine({"stage": 3})
        e3.train_batch(batch)
        t0 = time.perf_counter()
        e3.save_checkpoint(d, tag="z3")
        save_s = time.perf_counter() - t0
        e1 = engine({"stage": 1})
        t0 = time.perf_counter()
        e1.load_checkpoint(d, tag="z3")
        load_s = time.perf_counter() - t0
        # leaf by leaf on the card: stage 3's gathered against stage 1's
        pdims, odims = e3.state_layout()[1:3]
        pairs = [(tree_leaves(e3.state.params), tree_leaves(e1.state.params),
                  pdims)] + [
            (tree_leaves(getattr(e3.state.opt_state, f)),
             tree_leaves(getattr(e1.state.opt_state, f)), odims)
            for f in ("mu", "nu")]
        ckpt_equal, ckpt_bytes = e1.state.step == e3.state.step, 0
        for mine, theirs, dims in pairs:
            for a, b, dim in zip(mine, theirs, dims):
                full = zero.gather_shard(a, dim)
                ckpt_equal = ckpt_equal and torch.equal(full, b)
                ckpt_bytes += full.numel() * full.element_size()
                del full
        del e1, e3, pairs
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    _phase_line("42 gpt2-1.3b ZeRO stages W1", card_line, layers=cfg.n_layers,
                micro=B, seq=T, remat="save_attn", params=n, stages=runs,
                phase19_save_attn_ms=phase19_ms, qwz_world1=qwz,
                ckpt={"stage3_to_stage1_bitwise": ckpt_equal,
                      "bytes": ckpt_bytes, "save_s": save_s,
                      "load_s": load_s},
                launches=launches)
    ok = all(r["bitwise_vs_stage0"] and r["comm_ok"] for r in runs.values())
    if not (ok and ckpt_equal and qwz["mode"] is None and qwz["warned"]
            and qwz["step1_equals_stage3"]):
        raise SystemExit(f"phase 42: gates failed: stages "
                         f"{ {s: (r['bitwise_vs_stage0'], r['comm_ok']) for s, r in runs.items()} }"
                         f" qwZ {qwz} checkpoint {ckpt_equal}")
    return launches, runs


def _offload_comm_expected(eng):
    """{op: (calls, bytes)} a ZeRO-Offload step at stage 2 or 3 moves on
    this rank: the three small all-reduces, each split leaf's f32 grad
    reduce-scattered and its bf16 shard all-gathered (into the compute
    copy at stage 2, the compute tree at stage 3), each whole leaf's grad
    all-reduced.  Host-staged calls (two ranks on one card) count as
    their op."""
    W = eng.dp
    ar, rs, ag = [3, 4 + 4 * len(eng._shapes) + 4], [0, 0], [0, 0]
    for shape, d in zip(eng._shapes, eng._dims):
        n = int(np.prod(shape))
        if d is None:
            ar[0] += 1
            ar[1] += 4 * n
        else:
            rs[0] += 1
            rs[1] += 4 * n
            ag[0] += 1
            ag[1] += 2 * n // W
    out = {"all_reduce": tuple(ar)}
    if rs[0]:
        out["reduce_scatter"] = tuple(rs)
        out["all_gather"] = tuple(ag)
    return out


def _comm_per_step(summ, steps):
    """The comms logger's summary as {op: (calls, bytes)} a step, a
    host-staged call (``op:host``) counted as its op."""
    out = {}
    for op, s in summ.items():
        c, b = out.get(op.split(":")[0], (0.0, 0.0))
        out[op.split(":")[0]] = (c + s["count"] / steps,
                                 b + s["bytes"] / steps)
    return out


def _digest_expected(expected):
    """An {op: (calls, bytes)} expectation as the digest's ``per_kind``."""
    kinds = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter"}
    return {kinds[op]: {"count": int(c), "bytes": int(b)}
            for op, (c, b) in expected.items()}


def _host_placed(eng) -> bool:
    """Every master and moment leaf of ``eng`` in page-locked host
    memory."""
    from deepspeed_tpu_torch._tree import tree_leaves

    leaves = tree_leaves(eng.state.params) + tree_leaves(
        eng.state.opt_state.mu) + tree_leaves(eng.state.opt_state.nu)
    return all(t.device.type == "cpu" and t.is_pinned() for t in leaves)


def phase_zero_offload(fns, card_line, stage_runs):
    """Phase 48: ZeRO-Offload in phase 42's world-1 rank: GPT-2 1.3B at
    phase 42's 6 layers (``save_attn``, its seeded weights and batch, fused
    Adam) at stage 2 with ``offload_optimizer: cpu`` and at stage 3 with
    ``offload_optimizer`` and ``offload_param`` on ``cpu``, 3 steps each.
    Gates: the losses equal phase 42's stage-2 / stage-3 losses bit for
    bit; the state is this rank's shards in page-locked host memory; the
    comms logger's calls and bytes a step and ``comms_digest`` equal what
    the stage moves; B1-B4 launch counts.  Records the peak card memory
    beside phase 42's, ms/step and the host bytes moved a step."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, loss_fn
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam

    cfg = dataclasses.replace(GPT2Config.gpt2_1_3b(), remat="save_attn",
                              n_layers=ZERO_LAYERS)
    B, T = GPT2_TRAIN_B, GPT2_TRAIN_T
    rng = np.random.default_rng(19)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    log_ = comm.comms_logger()
    launches, res = {}, {}
    for stage, block in ((2, {"offload_optimizer": {"device": "cpu"}}),
                         (3, {"offload_optimizer": {"device": "cpu"},
                              "offload_param": {"device": "cpu"}})):
        path = f"gpt2-1.3b-{ZERO_LAYERS}L ZeRO-Offload-{stage} W1"
        conf = _train_config(B, 1, {"bf16": {"enabled": True}})
        conf["zero_optimization"] = {"stage": stage, **block}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = _gpt2_params(cfg, 19, torch.float32)
        eng = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                         optimizer=fused_adam(lr=_warmup(),
                                              weight_decay=0.1))[0]
        del params
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = len(tree_leaves(eng.state.params))
        _zero(fns.values())
        log_.reset()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for _ in range(ZERO_STEPS):
            ts = time.perf_counter()
            loss = float(eng.train_batch(batch))
            rows.append({"loss": loss,
                         "ms": (time.perf_counter() - ts) * 1e3,
                         "host_bytes": dict(eng.link_bytes)})
        peak = torch.cuda.max_memory_allocated() / 1e9
        got = {k: f.launches for k, f in fns.items()}
        _check_bodies(path)
        L = cfg.n_layers
        want = {"flash_fwd": 2 * L * ZERO_STEPS,
                "flash_bwd_dq": L * ZERO_STEPS,
                "flash_bwd_dkv": L * ZERO_STEPS,
                "fused_adam": leaves * ZERO_STEPS}
        if any(got[k] != v for k, v in want.items()) or any(
                got[k] for k in got if k not in want):
            raise SystemExit(f"phase 48: {path} launches {got}, expected "
                             f"{want}")
        launches[path] = got
        per_step = _comm_per_step(log_.summary(), ZERO_STEPS)
        expected = _offload_comm_expected(eng)
        digest = eng.comms_digest(batch)
        plain = [r["loss"] for r in stage_runs[stage]["steps"]]
        res[stage] = {
            "steps": rows, "init_s": init_s, "peak_mem_gb": peak,
            "phase42_peak_mem_gb": max(r["peak_gb"] for r in
                                       stage_runs[stage]["steps"]),
            "phase42_ms": [r["ms"] for r in stage_runs[stage]["steps"]],
            "losses_bitwise_vs_phase42": [r["loss"] for r in rows] == plain,
            "host_placed": _host_placed(eng),
            "comm_per_step": per_step, "comm_expected": expected,
            "comm_ok": per_step == {k: (float(c), float(b))
                                    for k, (c, b) in expected.items()},
            "digest": digest,
            "digest_ok": digest["per_kind"] == _digest_expected(expected),
            "leaves": leaves}
        log(f"[zero] offload stage {stage}: losses "
            f"{[r['loss'] for r in rows]} (phase 42 {plain}) ms/step "
            f"{[round(r['ms'], 1) for r in rows]} peak {peak:.2f} GB")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    _phase_line("48 gpt2-1.3b ZeRO-Offload W1", card_line,
                layers=cfg.n_layers, micro=B, seq=T, remat="save_attn",
                stages=res, launches=launches,
                host_bytes="up / down a step: the offloaded state's "
                "visits to the card (page-locked host memory)")
    for stage, r in res.items():
        if not (r["losses_bitwise_vs_phase42"] and r["host_placed"]
                and r["comm_ok"] and r["digest_ok"]):
            raise SystemExit(f"phase 48: stage {stage} gates failed: "
                             f"{ {k: r[k] for k in ('losses_bitwise_vs_phase42', 'host_placed', 'comm_ok', 'digest_ok')} }"
                             f" comm {r['comm_per_step']} expected "
                             f"{r['comm_expected']} digest {r['digest']}")
    return launches, [r["loss"] for r in res[2]["steps"]]


def zero_child(out_path: str, phase19_ms) -> int:
    """Phases 41, 42 and 48 in a rank the port's launcher started: join its
    NCCL group, run them, write their launches, rows and phase 42's
    stage-2 / stage-3 losses to ``out_path``."""
    from deepspeed_tpu_torch import comm, topology
    from deepspeed_tpu_torch.ops import _build

    comm.init_distributed()                  # nccl, the launcher's env
    topology.set_current_mesh(topology.default_mesh())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    fns = _kernel_fns()
    card_line = card()
    log(f"[zero] rank {comm.get_rank()} of {comm.get_world_size()} on "
        f"{torch.cuda.get_device_name()} (LOCAL_RANK "
        f"{comm.get_local_rank()}, backend "
        f"{torch.distributed.get_backend()})")
    t0 = time.perf_counter()
    launches, b9_row = phase_wire(fns, card_line)
    wire_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, runs = phase_zero_stages(fns, card_line, phase19_ms)
    launches.update(got)
    zero_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, plain_losses = phase_zero_offload(fns, card_line, runs)
    launches.update(got)
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "b9_wire": b9_row,
                   "phase48_losses": plain_losses,
                   "bodies": {k: {p: c for p, c in v.items()
                                  if p in launches}
                              for k, v in BODIES.items()},
                   "laps": {"phase_wire": wire_s,
                            "phase_zero_stages": zero_s,
                            "phase_zero_offload":
                                time.perf_counter() - t0}}, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_zero_launcher(card_line, rows, phase19_ms):
    """Phases 41, 42 and 48 through ``python -m deepspeed_tpu_torch.
    launcher --nproc_per_node 1``: the child's code is checked (a failing
    child fails the smoke) and its launches, B9's wire row and phase 42's
    stage-2 / stage-3 losses come back."""
    out = os.path.join(_nvme_dir("zero_child"), "result.json")
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher",
           "--nproc_per_node", "1", os.path.join(ROOT, "chip_smoke.py"),
           ZERO_CHILD_FLAG, out, json.dumps(phase19_ms)]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=ROOT, env=env,
                        timeout=ZERO_CHILD_TIMEOUT_S).returncode
    if rc != 0:
        raise SystemExit(f"phases 41, 42, 48: the launched rank exited {rc}")
    with open(out) as f:
        res = json.load(f)
    log(f"[zero] launcher and rank: {time.perf_counter() - t0:.1f} s, "
        f"phases {res['laps']}")
    rows["quantize"]["wire_shape"] = res["b9_wire"]
    for name, paths in res["bodies"].items():
        BODIES.setdefault(name, {}).update(paths)
    return res["launches"], res["phase48_losses"]


# ------------------------------------------------------------ phases 43-47
# the model-parallel mesh axes, run by two ranks the port's launcher starts
# on the one card (``--local_hosts 2``: both ranks on cuda:0, one gloo
# group; gloo stages every collective but all_reduce and broadcast of a
# CUDA tensor through host memory, so their times are host-staged gloo's)
MP_CHILD_FLAG = "--mp-child"
MP_CHILD_TIMEOUT_S = 1000
# phase 43: phase 5's queue, new tokens a request, and the depth of the
# Llama-3-8B it serves (and phase 56 reuses): 4 of 32 layers (the smoke's
# time)
MP_SERVE_NEW, MP_TP_SERVE_LAYERS = 8, 4
# phase 45: Ulysses at T = 8192 (4096 a rank), ring at T = 4096 (its f32
# score blocks at 8192 would not fit beside both ranks' state)
MP_ULYSSES_T, MP_RING_T = 8192, 4096
# phase 46: n_micro 4 over pipe 2, micro rows of 1024 tokens
MP_PIPE_B, MP_PIPE_T, MP_PIPE_MICRO = 4, 1024, 4
# phase 47: Mixtral trained at 1 layer (2 layers of experts split over two
# ranks on one card would not fit beside each other), served at 8
MP_EP_TRAIN_LAYERS, MP_EP_SERVE_LAYERS, MP_EP_NEW, MP_EP_PROMPTS = 1, 8, 8, 4
MP_STEPS = 3
# bounds, each set from the first reading of its quantity on an NVIDIA H100
# 80GB HBM3 at 700 W, with 2.5x-5x room; every one compares two orders of bf16
# summation (the ranks' partial sums reduced, against one product).  The
# first prefill's logits relative to their largest |value|: tp read
# 0.0234 (bf16) / 0.0238 (int8); ep 0.115, the seeded near-uniform routers
# flipping a position's top-2 (C-w2), with every served token equal.
# Losses relative: tp 7.9e-4 / 2.1e-3 (two calls), pipe 2.0e-5, ep
# 1.7e-3, seq 0 (Ulysses) / 6.3e-6 (ring); grads' largest error over
# their largest |value|, the worst leaf: Ulysses 5.4e-3, ring 1.3e-2
MP_TP_LOGITS_REL = 6e-2
MP_TP_TRAIN_LOSS_REL = 5e-3
MP_SEQ_LOSS_REL = 5e-5
MP_SEQ_GRAD_REL = 4e-2
MP_PIPE_LOSS_REL = 1e-4
MP_EP_LOSS_REL = 5e-3
MP_EP_LOGITS_REL = 0.25


def _rank_sum(counts: dict) -> dict:
    """``counts`` summed over every rank (the gloo group, on the host)."""
    keys = sorted(counts)
    t = torch.tensor([int(counts[k]) for k in keys], dtype=torch.int64)
    torch.distributed.all_reduce(t)
    return dict(zip(keys, t.tolist()))


def _mp_path(fns, path, launches, want, hopper=True):
    """A main path of two ranks: this rank's counts checked (bodies, every
    kernel in ``want`` launched, no other), then both ranks' summed."""
    mine = {n: f.launches for n, f in fns.items()}
    _check_bodies(path, hopper=hopper)
    _check_launches(path, mine, want)
    launches[path] = _rank_sum(mine)
    for name in BODIES:
        if path in BODIES[name]:
            BODIES[name][path] = _rank_sum(BODIES[name][path])


def _in_turn(fn):
    """Run ``fn`` on rank 0, then on rank 1 (each rank's whole-tree draw
    needs the card to itself), both ranks past a barrier at the end."""
    from deepspeed_tpu_torch import comm

    out = None
    for r in range(comm.get_world_size()):
        if comm.get_rank() == r:
            out = fn()
            torch.cuda.synchronize()
        comm.barrier()
    return out


def _hold(name, got, want, tol, rel=False):
    """One kernel launch held to its plain version on the same inputs:
    max |err| (or its share of the plain version's max |value|)."""
    if isinstance(got, tuple):
        errs = [_hold(name, g, w, tol, rel)[1] for g, w in zip(got, want)]
        return name, max(errs)
    if got.dtype in (torch.int8, torch.int32, torch.int64):
        err = float((got.long() - want.long()).abs().max().item())
    else:
        err = (_rel(got, want) if rel else
               (got.float() - want.float()).abs().max().item())
    if not err <= tol:
        raise SystemExit(f"{name}: {err:.3e} against its plain version "
                         f"(tol {tol})")
    return name, err


def _held_bwd(name, got, want, args):
    """One flash backward output against its plain version: its error's
    share of the plain version's largest |value|, held to
    ``FLASH_BWD_REL_TOL`` save for elements the kernel holds at a bf16
    neighbour of the f64 oracle (a faithful rounding, ROADMAP C-f6), which
    is evaluated a KV head at a time (a rank's T = 8192 at once would not
    fit)."""
    rel = _rel(got, want)
    if rel <= FLASH_BWD_REL_TOL:
        return rel
    q, k, v, o, lse, do = args
    over = (got.float() - want.float()).abs() \
        > FLASH_BWD_REL_TOL * want.float().abs().max()
    G = q.shape[2] // k.shape[2]
    ok = True
    for g in range(k.shape[2]):
        hs, ks = slice(g * G, (g + 1) * G), slice(g, g + 1)
        dq64, dq_spec, dk64, dv64 = flash_bwd_f64_oracle(
            q[:, :, hs], k[:, :, ks], v[:, :, ks], o[:, :, hs], lse[:, hs],
            do[:, :, hs], None)
        heads, exacts = {"dq": (hs, (dq64, dq_spec)), "dk": (ks, (dk64,)),
                         "dv": (ks, (dv64,))}[name]
        m = over[:, :, heads]
        if m.any():
            g_ = got[:, :, heads]
            ok = ok and any(bool(bf16_neighbour(g_[m], x[m]).all())
                            for x in exacts)
        del dq64, dq_spec, dk64, dv64
    if not ok:
        raise SystemExit(f"flash backward {name}: {rel:.3e} against its "
                         f"plain version (tol {FLASH_BWD_REL_TOL}), not all "
                         "over the gate at a bf16 neighbour of the f64 "
                         "oracle")
    return rel


def _hold_attention(gen, B, T, H, KV, D=128, bwd=True, causal=True,
                    seg=None):
    """B1 (and B2 / B3) at one rank's shape, causal or not, with pad or
    segment ids ``seg`` [B, T], against the plain versions (B2 / B3 under
    the C-f6 rule of :func:`_held_bwd`); each kernel's device ms there
    (:func:`_bert_flash_bwd` holds B2 / B3 beside SDPA's backward)."""
    from deepspeed_tpu_torch.ops.attention_cuda import (
        flash_bwd_dkv, flash_bwd_dq, flash_bwd_reference, flash_fwd,
        flash_fwd_reference)

    dt = torch.bfloat16
    kw = dict(causal=causal, seg=seg)
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(dt)
    o, lse = flash_fwd(q, k, v, **kw)
    ro, _ = flash_fwd_reference(q, k, v, **kw)
    held = dict([_hold("flash_fwd", o, ro, FLASH_TOL)])
    ms = {"flash_fwd": device_ms(lambda: flash_fwd(q, k, v, **kw), iters=3)}
    if bwd:
        do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dt)
        dq, delta = flash_bwd_dq(q, k, v, o, do, lse, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        want = flash_bwd_reference(q, k, v, o, lse, do, **kw)
        args = (q, k, v, o, lse, do)
        if seg is not None or not causal:
            raise ValueError("_hold_attention's backward is causal without "
                             "ids (_bert_flash_bwd holds the other case)")
        held["flash_bwd_dq"] = _held_bwd("dq", dq, want[0], args)
        held["flash_bwd_dkv"] = max(_held_bwd("dk", dk, want[1], args),
                                    _held_bwd("dv", dv, want[2], args))
        del want
        ms["flash_bwd_dq"] = device_ms(
            lambda: flash_bwd_dq(q, k, v, o, do, lse, **kw), iters=3)
        ms["flash_bwd_dkv"] = device_ms(
            lambda: flash_bwd_dkv(q, k, v, do, lse, delta, **kw), iters=3)
    return {"shape": [B, T, H, KV, D], "causal": causal,
            "pad_ids": seg is not None, "max_abs_err": held, "ms": ms}


def _hold_serving(gen, H, KV, V, rows=8):
    """B5 at decode with a rank's heads, and B6 on the gathered logits,
    against their plain versions."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_attention_reference, paged_decode_attention)
    from deepspeed_tpu_torch.ops.sampling_cuda import (fused_greedy_rows,
                                                       greedy_rows_reference)

    lens = np.linspace(128, 1024, rows).astype(int).tolist()
    kp, vp, table = _paged_inputs(gen, lens, 1, H=H, KV=KV)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((rows, H, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    logits = torch.randn((rows, V), generator=gen, device="cuda")
    held = dict([
        _hold("paged_attention", paged_decode_attention(q, kp, vp, table, seq),
              paged_attention_reference(q, kp, vp, table, seq),
              PAGED_DECODE_TOL),
        _hold("greedy_argmax", fused_greedy_rows(logits),
              greedy_rows_reference(logits), 0)])
    ms = {"paged_attention": device_ms(
        lambda: paged_decode_attention(q, kp, vp, table, seq), iters=5),
        "greedy_argmax": device_ms(lambda: fused_greedy_rows(logits),
                                   iters=5)}
    return {"decode_rows": rows, "heads": [H, KV], "vocab": V,
            "max_abs_err": held, "ms": ms}


def _hold_leaf(leaf, adam=True, quant=False):
    """B4 (an Adam step) and / or B9 (its int8 codes) on one rank's leaf,
    against their plain versions."""
    from deepspeed_tpu_torch.ops.adam_cuda import (adam_scalars, adam_update,
                                                   adam_update_reference)
    from deepspeed_tpu_torch.ops.quant_cuda import (quantize_rows,
                                                    quantize_rows_reference)

    held, ms = {}, {}
    x = leaf.detach().reshape(-1)
    if adam:
        g = torch.randn_like(x, dtype=torch.float32)
        p = x.float()
        m = torch.zeros_like(p)
        v = torch.zeros_like(p)
        c1, c2 = adam_scalars(0.9, 0.999, 1)
        held.update([_hold("fused_adam",
                           adam_update(g, m, v, p, c1, c2, 1e-3, wd=0.1),
                           adam_update_reference(g, m, v, p, c1, c2, 1e-3,
                                                 wd=0.1), ADAM_TOL)])
        ms["fused_adam"] = device_ms(lambda: adam_update(
            g, m, v, p, c1, c2, 1e-3, wd=0.1), iters=3)
        del g, p, m, v
    if quant:
        rows = x.view(-1, 128)
        held.update([_hold("quantize", quantize_rows(rows),
                           quantize_rows_reference(rows), 0)])
        ms["quantize"] = device_ms(lambda: quantize_rows(rows), iters=3)
    return {"leaf": list(leaf.shape), "max_abs_err": held, "ms": ms}


def _mesh(sizes):
    from deepspeed_tpu_torch import topology

    ms = topology.MeshSpec.build(sizes)
    topology.set_current_mesh(ms)
    return ms


def _serve_tp_engine(fns, path, launches, eng, prompts, want, built=None):
    """Drive a two-rank engine built beforehand: counts set to 0, the
    first prefill's logits kept, the queue served, the build's own counts
    (``built``: B9 for int8) added; both ranks' counts."""
    got = _capture_first(eng)
    _zero(fns.values())
    out, m = drive(eng, prompts, MP_SERVE_NEW)
    if built is not None:
        for n, f in fns.items():
            f.launches += built[0][n]
            for b, c in built[1].get(n, {}).items():
                f.body_launches[b] += c
    _mp_path(fns, path, launches, want)
    for name in ("_prefill", "_decode"):
        vars(eng).pop(name, None)
    return out, got, m


def _tiny_identity(fns, launches, family, build_sharded, build_one):
    """The f32 tiny model on the card: the sharded engine's greedy tokens
    equal the one-rank engine's (C-w2: the gate runs in f32)."""
    prompts = {f"t{i}": list(range(3 + i, 12 + 3 * i)) for i in range(4)}
    eng = build_one()
    want, _ = drive(eng, prompts, 12)
    del eng
    eng = build_sharded()
    _zero(fns.values())
    out, _ = drive(eng, prompts, 12)
    _mp_path(fns, f"{family} tiny f32 sharded", launches,
             ("flash_fwd", "paged_attention", "greedy_argmax"), hopper=False)
    if out != want:
        raise SystemExit(f"{family} tiny f32: the sharded engine's tokens "
                         f"differ from the one-rank engine's")
    return True


def phase_tp_serving(fns, card_line, gen):
    """Phase 43: tensor-parallel serving over model 2.  Llama-3-8B bf16 at
    MP_TP_SERVE_LAYERS of 32 layers (~3 GB of weights a rank, each rank's
    cache 4 of 8 KV heads) on phase 5's queue: the first prefill's logits against the
    one-rank engine on the same weights, ms per decode step and tokens/s;
    then int8 weights over the mesh against the unsharded int8 engine the
    same way; the f32 tiny model's tokens identical to the one-rank
    engine's; B1, B5, B6 and B9 held at a rank's shapes."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.weights import init_params

    ms = _mesh({"model": 2})
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              n_layers=MP_TP_SERVE_LAYERS)
    prompts = _queue5(cfg.vocab_size)
    opts = dict(max_batch=8, page_size=16, max_seq=2048, num_pages=1025,
                cache_dtype=torch.bfloat16)
    launches, res, engines, ref = {}, {}, {}, {}

    def build():
        params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             device="cuda", dtype=torch.bfloat16)
        if comm.get_rank() == 0:
            for wd in ("bfloat16", "int8"):
                e = llama_serving_engine(params, cfg, weight_dtype=wd,
                                         **opts)
                first = _capture_first(e)
                out, m = drive(e, prompts, MP_SERVE_NEW)
                ref[wd] = (out, {k: v.cpu() for k, v in first.items()}, m)
                del e
                gc.collect()
            # phase 56's one-rank int8-resident engine on these weights
            _MP["kvq_ref"] = _kvq_one_rank(params, cfg)
        # phase 56's int8-resident engine over the mesh, from this draw
        _MP["kvq"] = llama_serving_engine(params, cfg, mesh=ms,
                                          **_kvq_opts())
        for wd in ("bfloat16", "int8"):
            _zero(fns.values())
            t0 = time.perf_counter()
            engines[wd] = llama_serving_engine(params, cfg, mesh=ms,
                                               weight_dtype=wd, **opts)
            torch.cuda.synchronize()
            engines[wd].build_s = time.perf_counter() - t0
            engines[wd].built = (
                {n: f.launches for n, f in fns.items()},
                {n: dict(f.body_launches) for n, f in fns.items()
                 if hasattr(f, "body_launches")})
        del params
        gc.collect()
        torch.cuda.empty_cache()

    _in_turn(build)
    for wd in ("bfloat16", "int8"):
        eng = engines.pop(wd)
        path = f"llama3_8b tp2 serving {wd}"
        want = SERVING_KERNELS + (("quantize",) if wd == "int8" else ())
        out, got, m = _serve_tp_engine(fns, path, launches, eng, prompts,
                                       want, built=eng.built)
        decode_ms = m.get("ms_per_decode_step")
        row = {"build_s": eng.build_s, "wall_s": m["wall_s"],
               "tokens_per_s": m["tokens_per_s"],
               "ttft_s_mean": m["ttft_s_mean"],
               "decode_step_ms": decode_ms,
               "cache_kv_heads_a_rank": int(eng.cache.k.shape[1]),
               "peak_mem_gb_rank": torch.cuda.max_memory_allocated() / 1e9}
        if comm.get_rank() == 0:
            r_out, r_first, r_m = ref[wd]
            # the first decode step reads the token each engine sampled,
            # which a bf16 near-tie can flip (C-w2): the prefill is the
            # same input on both
            rel = {"_prefill": _rel(got["_prefill"].float().cpu(),
                                    r_first["_prefill"].float())}
            same = sum(out[k] == r_out[k] for k in prompts)
            row.update(first_logits_rel=rel, same_outputs=same,
                       one_rank_tokens_per_s=r_m["tokens_per_s"],
                       one_rank_decode_step_ms=r_m.get("ms_per_decode_step"))
            if max(rel.values()) > MP_TP_LOGITS_REL:
                raise SystemExit(f"phase 43: {path} first logits {rel} "
                                 f"past {MP_TP_LOGITS_REL} of the one-rank "
                                 "engine's")
        res[wd] = row
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    from deepspeed_tpu_torch.models.llama import LlamaConfig as LC

    tiny = LC.tiny(dim=64)
    tp = init_params(tiny, torch.Generator("cuda").manual_seed(43),
                     device="cuda", dtype=torch.float32)
    kw = dict(max_batch=2, page_size=8, num_pages=64, max_seq=64,
              prefill_bucket=8, cache_dtype=torch.float32)
    res["tiny_f32_tokens_identical"] = _tiny_identity(
        fns, launches, "llama", lambda: llama_serving_engine(
            tp, tiny, mesh=ms, **kw),
        lambda: llama_serving_engine(tp, tiny, **kw))
    res["held"] = {"attention": _hold_attention(gen, 1, 1024, 16, 4,
                                                bwd=False),
                   "serving": _hold_serving(gen, 16, 4, cfg.vocab_size),
                   "int8_leaf": _hold_leaf(torch.randn(
                       (4096, 2048), generator=gen, device="cuda").to(
                       torch.bfloat16), adam=False, quant=True)}
    if comm.get_rank() == 0:
        _phase_line("43 llama3_8b tp2 serving", card_line, **res,
                    launches=launches, mesh={"model": 2},
                    collectives="host-staged gloo, two ranks on one card")
    return launches


def phase_tp_train(fns, card_line, phase8_losses, gen):
    """Phase 44: tensor-parallel training over model 2 at phase 8's config
    (Llama-3-8B widths at 4 layers, ~0.96 B parameters a rank, seed 0,
    micro 1 x accumulation 2 x 2048, bf16 compute, fused Adam): losses
    against phase 8's one-rank run; B1-B4 held at a rank's shapes.  Before
    the last step the hybrid engine (``inference_tp_size`` 2, phase 57's
    gate) rolls out from the live training layout, and again after it.
    The stage-0 checkpoint's round trip over this layout is held on the
    CPU (tests/test_torch_tensor_parallel.py) and, with the fused QKV's
    placement, on the card by phase 54: its 23 GB gather over gloo took 70
    of this phase's 91 s (the smoke's time)."""
    import gc

    from deepspeed_tpu_torch import comm, init_hybrid_engine, initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.llama import (LlamaConfig, loss_fn,
                                                  param_specs)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    import dataclasses

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4)
    conf = dict(_train_config(2, 2, {"bf16": {"enabled": True}}),
                mesh={"model": 2},
                hybrid_engine={"enabled": True, "inference_tp_size": 2})
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2048)).astype(
        np.int32)}
    prompts = torch.from_numpy(np.random.default_rng(57).integers(
        1, cfg.vocab_size, (MP_HYBRID_ROWS, MP_HYBRID_T)).astype(np.int32))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    # phase 57's reference: one rank's model over the same weights in the
    # compute dtype, kept on rank 0 until the first rollout is scored
    one_rank = (_cast_tree(params, torch.bfloat16) if comm.get_rank() == 0
                else None)
    eng = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                     optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
                     param_specs=param_specs(cfg), dist_init_required=False)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    launches, rows = {}, []
    path = "llama3_8b-4L tp2 training"
    _zero(fns.values())
    comm.comms_logger().reset()

    def step():
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        rows.append({"loss": loss, "grad_norm": eng.get_global_grad_norm(),
                     "ms": (time.perf_counter() - ts) * 1e3,
                     "peak_gb_rank": torch.cuda.max_memory_allocated() / 1e9})

    # the hybrid engine over the training layout before any step (the
    # reference's weights): a rollout, the first step, a rollout; its
    # launches go to a path of their own
    hyb = init_hybrid_engine(eng, cfg)
    seen = _capture_rollout(hyb)
    ts = time.perf_counter()
    before = hyb.generate(prompts, max_new_tokens=MP_HYBRID_NEW,
                          temperature=0.0)
    hybrid = {"rollout_before_ms": (time.perf_counter() - ts) * 1e3}
    rollouts = _snap(fns)
    hyb._prefill, hyb._decode = seen.pop("steps")
    hybrid.update(cache_kv_heads_a_rank=seen["cache_kv_heads"],
                  cache_kv_heads_want=cfg.n_kv_heads // 2)
    if comm.get_rank() == 0:
        hybrid.update(_score_rollout(one_rank, cfg, before, seen["logits"]))
    del one_rank, seen
    _zero(fns.values())
    step()
    trained = _snap(fns)
    _zero(fns.values())
    ts = time.perf_counter()
    after = hyb.generate(prompts, max_new_tokens=MP_HYBRID_NEW,
                         temperature=0.0)
    hybrid["rollout_after_ms"] = (time.perf_counter() - ts) * 1e3
    del hyb
    _add(fns, rollouts)
    # the generator attends in plain PyTorch and samples through B6
    _mp_path(fns, "llama3_8b-4L tp2 hybrid rollouts", launches,
             ("greedy_argmax",), hopper=False)
    _zero(fns.values())
    _add(fns, trained)
    for _ in range(3):
        step()
    _mp_path(fns, path, launches, ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "fused_adam"))
    hybrid.update(new_tokens=before.shape[1] - prompts.shape[1],
                  tokens_changed_by_the_step=int((before != after).sum()))
    _MP["hybrid"] = hybrid
    comms = comm.comms_logger().summary()
    rel = [abs(r["loss"] - w) / abs(w) for r, w in zip(rows, phase8_losses)]
    local = sum(t.numel() for t in tree_leaves(eng.state.params))
    held = {"attention": _hold_attention(gen, 1, 2048, 16, 4),
            "adam_leaf": _hold_leaf(eng.state.params["embed"])}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if comm.get_rank() == 0:
        _phase_line("44 llama3_8b-4L tp2 training", card_line, steps=rows,
                    phase8_losses=phase8_losses, loss_rel=rel,
                    bound=MP_TP_TRAIN_LOSS_REL, init_s=init_s,
                    params_a_rank=local, comms=comms, held=held,
                    launches=launches,
                    collectives="host-staged gloo, two ranks on one card")
        if max(rel) > MP_TP_TRAIN_LOSS_REL:
            raise SystemExit(f"phase 44: losses {rel} (bound "
                             f"{MP_TP_TRAIN_LOSS_REL})")
    return launches


def _capture_rollout(hyb):
    """Wrap the hybrid engine's own prefill and decode steps: every logits
    they return (cloned) and the head count of the cache its allocator
    made; ``"steps"`` holds the unwrapped pair to put back."""
    seen = {"logits": [], "steps": (hyb._prefill, hyb._decode)}

    def wrap(fn):
        def step(params, tokens, cache):
            logits, cache = fn(params, tokens, cache)
            seen["logits"].append(logits.float().clone())
            seen["cache_kv_heads"] = int(cache.k.shape[-2])
            return logits, cache
        return step

    hyb._prefill, hyb._decode = (wrap(f) for f in seen["steps"])
    return seen


def _score_rollout(params, cfg, rollout, logits):
    """The hybrid engine's rollout against one rank's model over
    ``params``: one rank's prefill over the same tokens gives the logits
    of every step the rollout took (prefill and decodes, ``logits``);
    their rel, and whether each generated token is one rank's greedy
    choice up to the two runs' difference at its position (a token ``c``
    with ``one[argmax] - one[c] <= 2 * max |tp - one|``: what any greedy
    pick over logits within that difference satisfies)."""
    tp = torch.cat(logits, dim=1)
    T = tp.shape[1] - len(logits) + 1
    one = _prefill_logits(params, cfg, rollout[:, :tp.shape[1]], tp=1)
    pos = slice(T - 1, tp.shape[1])
    chosen = rollout[:, T:tp.shape[1] + 1].long()
    err = (tp[:, pos] - one[:, pos]).abs().amax(-1)
    short = one[:, pos].amax(-1) - one[:, pos].gather(
        -1, chosen[..., None])[..., 0]
    return {"logits_rel": _rel(tp, one),
            "finite": bool(torch.isfinite(tp).all()),
            "tokens_one_rank_greedy": int((one[:, pos].argmax(-1)
                                           == chosen).sum()),
            "tokens_scored": chosen.numel(),
            "tokens_within_error": bool((short <= 2 * err + 1e-5).all())}


def _digest(t: torch.Tensor):
    """Exact digest of a tensor's bits: the sum of its 32-bit words and
    their sum weighted by position (mod 65521), as Python ints."""
    w = t.detach().contiguous().view(-1).view(torch.int32).long()
    pos = torch.arange(w.numel(), device=w.device) % 65521
    return (int(w.sum()), int((w * pos).sum()))


def _block(full, spec, r, ways):
    """Block ``r`` of ``ways`` of a whole leaf along its ``model`` dim (a
    fused spec's slice of each part, as the placement cuts it)."""
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.topology import fused_parts

    for d, entry in enumerate(spec):
        if entry == "model":
            runs = zero._split_runs(full.shape[d], ways, r, fused_parts(spec))
            return torch.cat([full.narrow(d, a, c) for a, c in runs], d)
    return full


def _state_digests(eng, specs, r):
    """Digests of the master params and both moments, leaf by leaf: of
    this rank's blocks (``r`` None), or of block ``r`` of the whole leaves
    a one-rank engine holds."""
    from deepspeed_tpu_torch._tree import tree_leaves

    out = []
    for tree in (eng.state.params, eng.state.opt_state.mu,
                 eng.state.opt_state.nu):
        for t, sp in zip(tree_leaves(tree), specs):
            out.append(_digest(t if r is None else _block(t, sp, r, 2)))
    return out


def _bcast_str(s):
    """Rank 0's string on every rank."""
    obj = [s]
    torch.distributed.broadcast_object_list(obj, src=0)
    return obj[0]


def _one_mesh():
    from deepspeed_tpu_torch import topology

    return topology.MeshSpec(sizes={a: 1 for a in topology.AXES})


def _loss_and_grads(cfg, params, batch):
    """The loss and every leaf's grad (f32) of one ``llama.loss_fn`` call;
    under a seq axis each rank's grads are summed over it."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.llama import loss_fn

    leaves = tree_leaves(params)
    for t in leaves:
        t.grad = None
    loss = loss_fn(cfg)(params, batch)
    loss.backward()
    grads = []
    for t in leaves:
        g = t.grad.float()
        t.grad = None
        if comm._axis_live("seq"):
            comm.all_reduce_(g, "seq")
        grads.append(g)
    return float(loss), grads


def phase_seq(fns, card_line, gen):
    """Phase 45: sequence parallelism over seq 2, Llama-3-8B widths at 2
    layers (bf16 weights, replicated over seq).  Ulysses at T = 8192 (4096
    positions a rank; B1-B3 at the whole T with 16 heads a rank) and ring
    at T = 4096: the loss and every leaf's grad against one rank over the
    same tokens (flash attention)."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import comm, topology
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.weights import init_params

    base = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    params = init_params(base, torch.Generator("cuda").manual_seed(45),
                         device="cuda", dtype=torch.bfloat16)
    for t in (params["embed"], params["final_norm"], params["lm_head"],
              *params["blocks"].values()):
        t.requires_grad_(True)
    launches, res = {}, {}
    for impl, T in (("ulysses", MP_ULYSSES_T), ("ring", MP_RING_T)):
        rng = np.random.default_rng(45)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, base.vocab_size, (1, T + 1)).astype(np.int64)).cuda()}
        cfg = dataclasses.replace(base, attn_impl=impl)
        path = f"llama3_8b-2L seq2 {impl} T{T}"
        _mesh({"seq": 2})
        torch.cuda.reset_peak_memory_stats()
        _zero(fns.values())
        ts = time.perf_counter()
        loss, grads = _loss_and_grads(cfg, params, batch)
        wall = (time.perf_counter() - ts) * 1e3
        want = (("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                if impl == "ulysses" else ())
        _mp_path(fns, path, launches, want)
        row = {"T": T, "positions_a_rank": T // 2, "loss": loss,
               "ms": wall,
               "peak_gb_rank": torch.cuda.max_memory_allocated() / 1e9}
        topology.set_current_mesh(None)
        ref = {}

        def one_rank():
            ref["loss"], ref["grads"] = _loss_and_grads(
                dataclasses.replace(base, attn_impl="flash"), params, batch)

        if comm.get_rank() == 0:
            one_rank()
            rel = max(_rel(g, w) for g, w in zip(grads, ref["grads"]))
            row.update(one_rank_loss=ref["loss"],
                       loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                       grad_rel_max=rel)
            if row["loss_rel"] > MP_SEQ_LOSS_REL or rel > MP_SEQ_GRAD_REL:
                raise SystemExit(f"phase 45: {impl} loss {row['loss_rel']} "
                                 f"(bound {MP_SEQ_LOSS_REL}) or grads {rel} "
                                 f"(bound {MP_SEQ_GRAD_REL})")
        comm.barrier()
        res[impl] = row
        del grads, ref
        gc.collect()
        torch.cuda.empty_cache()
    del params
    res["held"] = {"ulysses_attention": _hold_attention(
        gen, 1, MP_ULYSSES_T, 16, 4)}
    if comm.get_rank() == 0:
        _phase_line("45 llama3_8b-2L seq2 ulysses / ring", card_line, **res,
                    bounds={"loss_rel": MP_SEQ_LOSS_REL,
                            "grad_rel": MP_SEQ_GRAD_REL},
                    launches=launches,
                    collectives="host-staged gloo, two ranks on one card")
    return launches


def phase_pipe(fns, card_line, gen):
    """Phase 46: pipeline parallelism over pipe 2, n_micro 4, Llama-3-8B
    widths at 4 layers (2 a stage), micro 1 x 1024 tokens: the losses
    against one rank with 4 accumulation steps on the same batch (run first
    on rank 0 alone); B1-B4 held at a stage's shapes."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch.models.llama import (LlamaConfig, loss_fn,
                                                  param_specs)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4)
    B, T, M = MP_PIPE_B, MP_PIPE_T, MP_PIPE_MICRO
    rng = np.random.default_rng(46)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    conf = _train_config(B, M, {"bf16": {"enabled": True}})
    ref = {}

    def one_rank():
        params = init_params(cfg, torch.Generator("cuda").manual_seed(46),
                             device="cuda", dtype=torch.float32)
        e = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                       optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
                       dist_init_required=False, mesh=_one_mesh())[0]
        del params
        ref["losses"] = [float(e.train_batch(batch)) for _ in range(MP_STEPS)]
        del e
        gc.collect()
        torch.cuda.empty_cache()

    if comm.get_rank() == 0:
        one_rank()
    comm.barrier()
    _mesh({"pipe": 2})

    def build():
        params = init_params(cfg, torch.Generator("cuda").manual_seed(46),
                             device="cuda", dtype=torch.float32)
        e = initialize(loss_fn=loss_fn(cfg, n_micro=M), params=params,
                       config=dict(conf, mesh={"pipe": 2},
                                   pipeline={"stages": 2}),
                       optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
                       param_specs=param_specs(cfg, pipeline=True),
                       dist_init_required=False)[0]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return e

    eng = _in_turn(build)
    launches, rows = {}, []
    path = "llama3_8b-4L pipe2 n_micro4 training"
    _zero(fns.values())
    for _ in range(MP_STEPS):
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        rows.append({"loss": float(eng.train_batch(batch)),
                     "ms": (time.perf_counter() - ts) * 1e3,
                     "peak_gb_rank":
                         torch.cuda.max_memory_allocated() / 1e9})
    _mp_path(fns, path, launches, ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "fused_adam"))
    held = {"attention": _hold_attention(gen, 1, T, 32, 8),
            "adam_leaf": _hold_leaf(eng.state.params["blocks"]["w1"])}
    stage_layers = int(eng.state.params["blocks"]["wq"].shape[0])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if comm.get_rank() == 0:
        rel = [abs(r["loss"] - w) / abs(w)
               for r, w in zip(rows, ref["losses"])]
        _phase_line("46 llama3_8b-4L pipe2 training", card_line, steps=rows,
                    one_rank_accum4_losses=ref["losses"], loss_rel=rel,
                    bound=MP_PIPE_LOSS_REL, layers_a_stage=stage_layers,
                    held=held, launches=launches,
                    collectives="host-staged gloo, two ranks on one card")
        if max(rel) > MP_PIPE_LOSS_REL:
            raise SystemExit(f"phase 46: losses {rel} past "
                             f"{MP_PIPE_LOSS_REL} of one rank's")
    return launches


def phase_ep(fns, card_line, gen):
    """Phase 47: expert parallelism over expert 2.  Mixtral-8x7B widths
    trained at 1 layer (4 of 8 experts a rank, the batch's rows split
    over the ranks, the gate global) against one rank's run on the same
    weights and batch; Mixtral served at 8 layers (bf16) against the
    one-rank engine on the same weights (first logits; tokens reported,
    C-w2), and the f32 tiny Mixtral's tokens identical; B1-B6 held at a
    rank's shapes."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch.inference.serving import mixtral_serving_engine
    from deepspeed_tpu_torch.models.mixtral import (MixtralConfig, loss_fn,
                                                    param_specs)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    launches, res = {}, {}
    cfg = dataclasses.replace(MixtralConfig.mixtral_8x7b(),
                              n_layers=MP_EP_TRAIN_LAYERS,
                              remat="save_attn")
    B, T = MIXTRAL_TRAIN_B, MIXTRAL_TRAIN_T
    rng = np.random.default_rng(47)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    conf = _train_config(B, 1, {"bf16": {"enabled": True}})
    ref = {}

    def one_rank():
        params = init_params(cfg, torch.Generator("cuda").manual_seed(47),
                             device="cuda", dtype=torch.float32)
        e = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                       optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
                       has_aux=True, dist_init_required=False,
                       mesh=_one_mesh())[0]
        del params
        ref["losses"] = [float(e.train_batch(batch)) for _ in range(MP_STEPS)]
        del e
        gc.collect()
        torch.cuda.empty_cache()

    if comm.get_rank() == 0:
        one_rank()
    comm.barrier()
    ms = _mesh({"expert": 2})

    def build():
        params = init_params(cfg, torch.Generator("cuda").manual_seed(47),
                             device="cuda", dtype=torch.float32)
        e = initialize(loss_fn=loss_fn(cfg), params=params,
                       config=dict(conf, mesh={"expert": 2}),
                       optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
                       has_aux=True, param_specs=param_specs(cfg),
                       dist_init_required=False)[0]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return e

    eng = _in_turn(build)
    rows = []
    path = "mixtral-8x7b-1L ep2 training"
    _zero(fns.values())
    for _ in range(MP_STEPS):
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        aux = eng.metrics["aux"]
        rows.append({"loss": loss, "ms": (time.perf_counter() - ts) * 1e3,
                     "moe_aux_loss": float(aux["moe_aux_loss"]),
                     "peak_gb_rank":
                         torch.cuda.max_memory_allocated() / 1e9})
    _mp_path(fns, path, launches, ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "fused_adam"))
    experts_a_rank = int(eng.state.params["blocks"]["w1"].shape[1])
    held = {"attention": _hold_attention(gen, B // 2, T, 32, 8),
            "adam_leaf": _hold_leaf(eng.state.params["blocks"]["w2"])}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if comm.get_rank() == 0:
        rel = [abs(r["loss"] - w) / abs(w)
               for r, w in zip(rows, ref["losses"])]
        res["train"] = {"steps": rows, "one_rank_losses": ref["losses"],
                        "loss_rel": rel, "bound": MP_EP_LOSS_REL,
                        "experts_a_rank": experts_a_rank}
        if max(rel) > MP_EP_LOSS_REL:
            raise SystemExit(f"phase 47: training losses {rel} past "
                             f"{MP_EP_LOSS_REL} of one rank's")
    # serving at 8 layers
    scfg = dataclasses.replace(MixtralConfig.mixtral_8x7b(),
                               n_layers=MP_EP_SERVE_LAYERS)
    prompts = _queue21(scfg.vocab_size, n=MP_EP_PROMPTS)
    opts = dict(max_batch=4, page_size=16, max_seq=1024, num_pages=257,
                cache_dtype=torch.bfloat16)
    sref, holder = {}, {}

    def serve_build():
        params = init_params(scfg, torch.Generator("cuda").manual_seed(47),
                             device="cuda", dtype=torch.bfloat16)
        if comm.get_rank() == 0:
            e = mixtral_serving_engine(params, scfg, **opts)
            first = _capture_first(e)
            sref["out"], sref["m"] = drive(e, prompts, MP_EP_NEW)
            sref["first"] = {k: v.cpu() for k, v in first.items()}
            del e
            gc.collect()
        holder["eng"] = mixtral_serving_engine(params, scfg, mesh=ms, **opts)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    _in_turn(serve_build)
    eng = holder.pop("eng")
    spath = f"mixtral-8x7b-{MP_EP_SERVE_LAYERS}L ep2 serving bf16"
    got = _capture_first(eng)
    _zero(fns.values())
    out, m = drive(eng, prompts, MP_EP_NEW)
    _mp_path(fns, spath, launches, SERVING_KERNELS)
    for name in ("_prefill", "_decode"):
        vars(eng).pop(name, None)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    serve = {"wall_s": m["wall_s"], "tokens_per_s": m["tokens_per_s"],
             "decode_step_ms": m.get("ms_per_decode_step")}
    if comm.get_rank() == 0:
        rel = {"_prefill": _rel(got["_prefill"].float().cpu(),
                                sref["first"]["_prefill"].float())}
        n_div, first_pos = _first_divergence(out, sref["out"], prompts)
        serve.update(first_logits_rel=rel, divergent_requests=n_div,
                     first_divergence_position=first_pos,
                     one_rank_tokens_per_s=sref["m"]["tokens_per_s"])
        if max(rel.values()) > MP_EP_LOGITS_REL:
            raise SystemExit(f"phase 47: served first logits {rel} past "
                             f"{MP_EP_LOGITS_REL}")
    res["serve"] = serve
    tiny = MixtralConfig.tiny(dim=64)
    tp = init_params(tiny, torch.Generator("cuda").manual_seed(47),
                     device="cuda", dtype=torch.float32)
    kw = dict(max_batch=2, page_size=8, num_pages=64, max_seq=64,
              prefill_bucket=8, cache_dtype=torch.float32)
    res["tiny_f32_tokens_identical"] = _tiny_identity(
        fns, launches, "mixtral", lambda: mixtral_serving_engine(
            tp, tiny, mesh=ms, **kw),
        lambda: mixtral_serving_engine(tp, tiny, **kw))
    res["held"] = held
    res["held"]["serving"] = _hold_serving(gen, 32, 8, scfg.vocab_size,
                                           rows=4)
    if comm.get_rank() == 0:
        _phase_line("47 mixtral-8x7b ep2", card_line, **res,
                    launches=launches,
                    collectives="host-staged gloo, two ranks on one card")
    return launches


# ------------------------------------------------------------ phases 49-52
# the offload engines over the two ranks of phases 43-47 (gloo on one card:
# every collective time is host-staged gloo's)
# phase 49: phase 48's GPT-2 1.3B cut (ZERO_LAYERS), 2 steps (the smoke's
# time: each step reduce-scatters the f32 grads through host-staged gloo);
# its oracle is phase 48's stage-2 run
MP_OFFLOAD_STEPS = 2
# phase 50: 1 step (2 before phases 53-59: the smoke's time; a step read
# 17.7 s, 12.9 of them the backward's host-staged gloo reductions)
MP_PSTREAM_STEPS = 1
# phase 50: phase 38's model at its depth (OFFLOAD_LAYERS), the global
# batch's 2 rows a row a rank; phase 51: phase 40's depth
# phase 52: new tokens a request (8 before phases 60-61: the smoke's time;
# a streamed sweep over two ranks read 2.6 s)
MP_ZI_NEW = 4
# bounds against the one-rank runs, from the first readings on an NVIDIA
# H100 80GB HBM3 at 700 W: phase 49 read 1.09e-5 (two ranks' f32 grad
# sums against one rank's), bound with 4.6x room; phases 50 and 51 read
# 0.0 (the loss depends on the bf16 images only), bound at INFINITY_VS_
# PSTREAM_RTOL's 1e-6 (the f32 mean over ranks against the one-rank mean
# may differ by ulps on other data)
MP_OFFLOAD_LOSS_REL = 5e-5
MP_PSTREAM_LOSS_REL = 1e-6
MP_INFINITY_LOSS_REL = 1e-6


def _rel_losses(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_offload_ranks(fns, card_line, refs):
    """Phase 49: ZeRO-Offload over data 2: phase 48's stage-2 config
    (GPT-2 1.3B at ZERO_LAYERS, ``offload_optimizer: cpu``) and global
    batch (8 x 1024, 4 rows a rank), 2 steps.  Gates: the losses against
    phase 48's one-rank stage-2 losses (the same weights and batch) under
    MP_OFFLOAD_LOSS_REL, each rank's shards in page-locked host memory,
    the comms logger and ``comms_digest`` against the stage's expectation
    (host-staged gloo).  Records each rank's peak card memory and
    ms/step."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, loss_fn
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam

    _mesh({"data": 2})
    cfg = dataclasses.replace(GPT2Config.gpt2_1_3b(), remat="save_attn",
                              n_layers=ZERO_LAYERS)
    B, T = GPT2_TRAIN_B, GPT2_TRAIN_T
    rng = np.random.default_rng(19)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    conf = _train_config(B, 1, {"bf16": {"enabled": True}})
    conf["zero_optimization"] = {"stage": 2,
                                 "offload_optimizer": {"device": "cpu"}}
    path = f"gpt2-1.3b-{ZERO_LAYERS}L ZeRO-Offload-2 dp2"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _gpt2_params(cfg, 19, torch.float32)
    eng = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                     optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
                     device="cuda")[0]
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = len(tree_leaves(eng.state.params))
    log_ = comm.comms_logger()
    _zero(fns.values())
    log_.reset()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(MP_OFFLOAD_STEPS):
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        rows.append({"loss": loss, "ms": (time.perf_counter() - ts) * 1e3,
                     "host_bytes": dict(eng.link_bytes)})
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {}
    _mp_path(fns, path, launches, ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "fused_adam"))
    summ = log_.summary()
    per_step = _comm_per_step(summ, MP_OFFLOAD_STEPS)
    expected = _offload_comm_expected(eng)
    wall = {op: s["time_s"] / MP_OFFLOAD_STEPS for op, s in summ.items()}
    digest = eng.comms_digest(batch)
    want = refs["phase48_losses"][:MP_OFFLOAD_STEPS]
    rel = _rel_losses([r["loss"] for r in rows], want)
    res = {"steps": rows, "init_s": init_s, "peak_mem_gb_rank": peak,
           "leaves": leaves, "loss_rel_vs_phase48": rel,
           "tol": MP_OFFLOAD_LOSS_REL, "host_placed": _host_placed(eng),
           "comm_per_step": per_step, "comm_expected": expected,
           "comm_wall_s_per_step": wall,
           "comm_ok": per_step == {k: (float(c), float(b))
                                   for k, (c, b) in expected.items()},
           "digest": digest,
           "digest_ok": digest["per_kind"] == _digest_expected(expected)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    every = _gather_rows_json(res)
    if comm.get_rank() == 0:
        _phase_line("49 gpt2-1.3b ZeRO-Offload dp2", card_line,
                    layers=cfg.n_layers, micro=B // 2, seq=T, ranks=every,
                    phase48_losses=want, launches=launches,
                    collectives="host-staged gloo, two ranks on one card")
    for r in every:
        if not (r["loss_rel_vs_phase48"] <= MP_OFFLOAD_LOSS_REL
                and r["host_placed"] and r["comm_ok"] and r["digest_ok"]):
            raise SystemExit(f"phase 49: gates failed: {r}")
    return launches


def _gather_rows_json(row):
    """Every rank's ``row`` (JSON-able), in rank order."""
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, row)
    return out


def phase_pstream_ranks(fns, card_line, refs, lm):
    """Phase 50: ``ParamStreamEngine`` over data 2 at Llama-3-8B widths x 2
    layers (phase 38's lazy model and depth, seed 0), the RAM tier, phase
    38's global batch (2 rows x 2048, a row a rank), MP_PSTREAM_STEPS
    steps.  Gate: the losses against phase 38's one-rank steps under
    MP_PSTREAM_LOSS_REL.
    Records each rank's host RSS rise, ms/step beside the rank's host-Adam
    bound, and the row all-gathers' bytes (host-staged gloo)."""
    from deepspeed_tpu_torch import comm, initialize

    _mesh({"data": 2})
    rng = np.random.default_rng(0)
    vocab = int(lm.head["lm_head"].shape[-1])
    batch = {"tokens": rng.integers(0, vocab, (2, 2048)).astype(np.int32)}
    path = f"pstream llama3_8b {lm.n_layers} layers dp2"
    log_ = comm.comms_logger()
    card0, rss0 = _drop()
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        eng = initialize(params=lm, config=_offload_config(
            {"offload_param": {"device": "cpu", "scheduled": True}},
            accum=1))[0]
        init_s = time.perf_counter() - t0
        _zero(fns.values())
        log_.reset()
        steps = []
        for _ in range(MP_PSTREAM_STEPS):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            loss = float(eng.train_batch(batch))
            steps.append({"loss": loss, "s": time.perf_counter() - ts,
                          "phases": eng.phase_report(),
                          "link_bytes": dict(eng.link_bytes)})
        summ = log_.summary()
        n_params = eng.total_param_count()
        row_elems = eng.L * sum(eng._schunks)
        stem_head = sum(s["w"].numel() for s in eng._stem_state
                        + eng._head_state)
        overlap = eng.overlap_step
        del eng
        _drop()
    launches = {}
    _mp_path(fns, path, launches, ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"))
    # each rank's host Adam: its row slices and the whole stem and head
    adam_s = (row_elems + stem_head) * 30 / (refs["rates"]["cpu_adam_gbps"]
                                             * 1e9)
    want = refs["phase38_losses"][:MP_PSTREAM_STEPS]
    res = {"init_s": init_s, "steps": steps, "rss": rss.gb(),
           "params": n_params, "row_elems_rank": row_elems,
           "stem_head_elems": stem_head, "overlap_step": overlap,
           "host_adam_bound_s": adam_s,
           "comm_per_step": _comm_per_step(summ, MP_PSTREAM_STEPS),
           "comm_wall_s_per_step": {op: s["time_s"] / MP_PSTREAM_STEPS
                                    for op, s in summ.items()},
           "loss_rel_vs_phase38": _rel_losses(
               [s["loss"] for s in steps], want)}
    every = _gather_rows_json(res)
    if comm.get_rank() == 0:
        _phase_line("50 pstream llama3_8b dp2", card_line,
                    layers=lm.n_layers, ranks=every,
                    phase38_losses=want, tol=MP_PSTREAM_LOSS_REL,
                    launches=launches, card_gb_before=card0,
                    rss_before_gb=rss0,
                    collectives="host-staged gloo, two ranks on one card; "
                    "the f32 grads and rows on the host")
    for r in every:
        if not (r["loss_rel_vs_phase38"] <= MP_PSTREAM_LOSS_REL
                and not r["overlap_step"]):
            raise SystemExit(f"phase 50: gates failed: {r}")
    return launches


def phase_infinity_ranks(fns, card_line, refs, lm):
    """Phase 51: ``InfinityEngine`` over data 2 on phase 40's cut of phase
    38's model (1 layer), the RAM tier, ``update: "device"``, phase 38's
    global batch (a row a rank), one step (its gate's).  Gate: step 1 against phase 40's
    step 1 under MP_INFINITY_LOSS_REL.  Records each rank's rows and tier
    bytes."""
    import dataclasses

    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch.models import llama

    _mesh({"data": 2})
    L = OFFLOAD_NVME_LAYERS
    sub = _lazy_at_depth(lm, L)
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=L)
    keys = sorted(sub.blocks_spec)
    layers = [sub.blocks(l) for l in range(L)]
    tree = sub.assemble(sub.stem, {k: torch.stack([x[k] for x in layers])
                                   for k in keys}, sub.head)
    del layers
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2048)).astype(
        np.int32)}
    path = f"infinity llama3_8b {L} layers dp2"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = initialize(loss_fn=llama.loss_fn(cfg), params=tree,
                     config=_offload_config({"offload_optimizer": {
                         "device": "cpu", "scheduled": True,
                         "update": "device"}}, accum=1))[0]
    del tree
    init_s = time.perf_counter() - t0
    _zero(fns.values())
    torch.cuda.synchronize()
    ts = time.perf_counter()
    loss = float(eng.train_batch(batch))
    steps = [{"loss": loss, "s": time.perf_counter() - ts,
              "link_bytes": dict(eng.link_bytes)}]
    launches = {}
    _mp_path(fns, path, launches, ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"))
    res = {"init_s": init_s, "steps": steps,
           "rows": [1, sum(eng._chunks)],
           "tier_bytes_rank": eng.tier_local_bytes(),
           "peak_mem_gb_rank": torch.cuda.max_memory_allocated() / 1e9,
           "step1_rel_vs_phase40": abs(steps[0]["loss"]
                                       - refs["phase40_step1"])
           / abs(refs["phase40_step1"])}
    del eng
    _drop()
    every = _gather_rows_json(res)
    if comm.get_rank() == 0:
        _phase_line("51 infinity llama3_8b dp2", card_line, layers=L,
                    ranks=every, phase40_step1=refs["phase40_step1"],
                    tol=MP_INFINITY_LOSS_REL, launches=launches,
                    collectives="host-staged gloo, two ranks on one card")
    for r in every:
        if not r["step1_rel_vs_phase40"] <= MP_INFINITY_LOSS_REL:
            raise SystemExit(f"phase 51: gates failed: {r}")
    return launches


def phase_zi_tp(fns, card_line, gen, refs):
    """Phase 52: ZeRO-Inference over model 2: Llama-3-8B bf16 at all 32
    layers, every layer streamed from each rank's host tier (its block of
    each layer), phase 5's queue, MP_ZI_NEW new tokens.  Gate: the first
    prefill's logits within MP_TP_LOGITS_REL of phase 29's one-rank
    engine's on the same weights.  Records each rank's bytes a sweep, ms
    per sweep beside the link bound (both ranks share one card's link),
    tokens/s; the f32 tiny model's tokens identical to one rank's; B5 and
    B6 held at a rank's shapes."""
    import gc

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.weights import init_params

    ms = _mesh({"model": 2})
    cfg = LlamaConfig.llama3_8b()
    prompts = _queue5(cfg.vocab_size)
    zi = {"enabled": True, "hbm_budget_bytes": None}
    holder = {}

    def build():
        params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             device="cuda", dtype=torch.bfloat16)
        t0 = time.perf_counter()
        holder["eng"] = llama_serving_engine(params, cfg, mesh=ms,
                                             zero_inference=zi,
                                             **ZI_LLAMA_OPTS)
        holder["build_s"] = time.perf_counter() - t0
        del params
        gc.collect()
        torch.cuda.empty_cache()

    _in_turn(build)
    eng = holder.pop("eng")
    launches = {}
    path = "zi llama3_8b tp2 streamed bf16"
    got = _capture_first(eng)
    _zero(fns.values())
    torch.cuda.reset_peak_memory_stats()
    out, m = drive(eng, prompts, MP_ZI_NEW)
    _mp_path(fns, path, launches, SERVING_KERNELS)
    for name in ("_prefill", "_decode"):
        vars(eng).pop(name, None)
    link = refs["rates"]["link_gbps"]
    st = _zi_stats(eng, out, prompts, m, link)
    row = {k: st[k] for k in ("plan", "sweeps", "bytes_uploaded",
                              "ms_per_sweep", "link_bound_ms_per_sweep",
                              "exposed_wait_share", "tokens_per_s",
                              "wall_s")}
    # the card's one link carries both ranks' streams
    row["link_bound_ms_per_sweep_two_ranks"] = \
        2 * row["link_bound_ms_per_sweep"]
    row["bytes_a_sweep_rank"] = st["plan"]["n_streamed"] \
        * st["plan"]["layer_bytes"]
    row["cache_kv_heads_a_rank"] = int(eng.cache.k.shape[1])
    row["build_s"] = holder["build_s"]
    row["peak_mem_gb_rank"] = torch.cuda.max_memory_allocated() / 1e9
    if comm.get_rank() == 0:
        want = torch.load(refs["phase29_prefill"], weights_only=True)
        row["first_logits_rel"] = _rel(got["_prefill"].float().cpu(),
                                       want.float())
    del eng, got
    gc.collect()
    torch.cuda.empty_cache()
    tiny = LlamaConfig.tiny(dim=64)
    tp = init_params(tiny, torch.Generator("cuda").manual_seed(52),
                     device="cuda", dtype=torch.float32)
    kw = dict(max_batch=2, page_size=8, num_pages=64, max_seq=64,
              prefill_bucket=8, cache_dtype=torch.float32)
    res = {"tp": row, "tiny_f32_tokens_identical": _tiny_identity(
        fns, launches, "zi llama", lambda: llama_serving_engine(
            tp, tiny, mesh=ms, zero_inference=zi, **kw),
        lambda: llama_serving_engine(tp, tiny, zero_inference=zi, **kw)),
        "held": {"serving": _hold_serving(gen, 16, 4, cfg.vocab_size)}}
    every = _gather_rows_json(row)
    if comm.get_rank() == 0:
        _phase_line("52 zi llama3_8b tp2", card_line, ranks=every,
                    held=res["held"], tol=MP_TP_LOGITS_REL,
                    tiny_f32_tokens_identical=res[
                        "tiny_f32_tokens_identical"],
                    launches=launches, mesh={"model": 2},
                    collectives="host-staged gloo, two ranks on one card")
        if not row["first_logits_rel"] <= MP_TP_LOGITS_REL:
            raise SystemExit(f"phase 52: first logits {row['first_logits_rel']}"
                             f" past {MP_TP_LOGITS_REL} of phase 29's")
    return launches


# ------------------------------------------------------------ phases 53-59
# GPT-2's and BERT's tensor-parallel layouts (53-55), int8-resident KV
# under TP (56) and injection, the hybrid engine and an elastic batch over
# model 2 (57) in the two-rank child; sparse attention (58) and autotune
# (59) in the main process
_MP: dict = {}               # what one phase of the child hands a later one
# phase 54: GPT-2 1.3B at ZERO_LAYERS over model 2, steps on phase 42's
# batch; phase 55: BERT-large over model 2, steps on phase 26's batch
MP_GPT2_TRAIN_STEPS, MP_BERT_TRAIN_STEPS = 2, 2
# the depths phases 53 and 55 serve at: GPT-2 1.3B at 6 of 24 layers,
# BERT-large at 6 of 24 (12 each before phases 62-64, 24 before phases
# 60-61: the smoke's time; phase 55 serves phase 25's whole queue of 64 and
# trains at all 24)
MP_GPT2_SERVE_LAYERS, MP_BERT_SERVE_LAYERS = 6, 6
# phase 56: phase 11's two waves cut to the smoke's time (8 prompts of a
# 1024-token prefix, 128-token suffixes and 32 new tokens there)
MP_KVQ_PREFIX, MP_KVQ_SUFFIX, MP_KVQ_N, MP_KVQ_NEW = 256, 64, 4, 8
# phases 44 / 57: the hybrid engine's rollout rows, prompt length, tokens
MP_HYBRID_ROWS, MP_HYBRID_T, MP_HYBRID_NEW = 4, 64, 8
# phase 58: phase 8's model with block-sparse attention, blocks of 64
SPARSE_LAYOUTS = {"fixed": {"mode": "fixed", "block": 64},
                  "bigbird": {"mode": "bigbird", "block": 64}}
# bounds, each from the first card reading of its quantity on an NVIDIA
# H100 80GB HBM3 at 700 W with 2.5x-5x room; the tensor-parallel ones
# compare two orders of bf16 summation, as MP_TP_LOGITS_REL does.  Read:
# GPT-2 tp first logits 0.0201 (bf16) / 0.0176 (int8), losses 2.6e-5 /
# 4.9e-5; BERT over phase 25's 64 requests pooled 0.0418 / 0.0454 (bf16 /
# int8), MLM 0.0208 / 0.0221, hidden 0.0289 (bf16), losses 3.7e-5 /
# 1.5e-5; the int8-resident engine's first chunk 0.0209.  Each BERT head
# has its own bound
MP_GPT2_LOGITS_REL = 6e-2
MP_GPT2_TRAIN_LOSS_REL = 2e-4
MP_BERT_REL = {"pooled": 1.2e-1, "mlm": 6e-2, "hidden": 1e-1}
MP_BERT_TRAIN_LOSS_REL = 1.5e-4
MP_KVQ_LOGITS_REL = 6e-2
# layer 0 of a page both engines published reads the same input on both
# (the rank's column block of wk / wv against the whole product's
# columns): its codes and scales read bit for bit on both ranks, so the
# gate is equality
MP_KVQ_LAYER0_CODES = 0
# phase 58: every layer's rel 2.9e-3-3.9e-3; the dense layout's loss
# 4.7e-7 off the flash path's
SPARSE_ORACLE_REL = 1.2e-2
SPARSE_DENSE_LOSS_REL = 2e-6


def _snap(fns):
    """Every wrapper's launch count and per-body counts."""
    return {n: (f.launches, dict(getattr(f, "body_launches", {})))
            for n, f in fns.items()}


def _add(fns, snap):
    """Add a :func:`_snap` into the wrappers' counts."""
    for n, f in fns.items():
        f.launches += snap[n][0]
        for b, c in snap[n][1].items():
            f.body_launches[b] += c


def _cast_tree(tree, dtype):
    from deepspeed_tpu_torch._tree import tree_map

    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def _prefill_logits(params, cfg, prompts, tp):
    """The dense generator's prefill logits [B, T, V] f32 over ``params``
    (a rank's blocks at ``tp`` > 1), its cache of ``n_kv_heads / tp``
    heads."""
    from deepspeed_tpu_torch.inference.generation import llama_step_alloc

    step, alloc = llama_step_alloc(cfg, torch.bfloat16, device="cuda", tp=tp)
    with torch.inference_mode():
        logits, _ = step(params, prompts.to("cuda"),
                         alloc(prompts.shape[0], prompts.shape[1]))
    return logits.float()


def _queue18(vocab, rng=None):
    """Phase 18's traffic: 8 prompts of 64..768 tokens (seed 17; ``rng``
    given, drawn from it)."""
    rng = rng or np.random.default_rng(17)
    lens = np.linspace(64, 768, 8).astype(int).tolist()
    return {f"g{i}": rng.integers(1, vocab, n).tolist()
            for i, n in enumerate(lens)}


def _queue25(cfg):
    """Phase 25's traffic: BERT_REQUESTS requests of 8..512 tokens."""
    rng = np.random.default_rng(25)
    lens = rng.integers(8, cfg.max_seq_len + 1, BERT_REQUESTS)
    return {f"r{i}": rng.integers(1, cfg.vocab_size, int(n)).tolist()
            for i, n in enumerate(lens)}


def _built(fns):
    return ({n: f.launches for n, f in fns.items()},
            {n: dict(f.body_launches) for n, f in fns.items()
             if hasattr(f, "body_launches")})


def phase_gpt2_tp_serving(fns, card_line, gen):
    """Phase 53: GPT-2 1.3B served over model 2 at MP_GPT2_SERVE_LAYERS of
    24 layers (phase 18's seed, queue and options; each rank holds its 8 of
    16 heads of the fused QKV and of the cache), bf16 then int8 weights:
    the first prefill's logits against the one-rank engine on the same
    weights, ms per decode step and tokens/s beside it, each rank's
    weight bytes; the f32 tiny GPT-2's tokens identical to one rank's; B1,
    B5, B6 and B9 held at a rank's shapes."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.quantized import param_bytes
    from deepspeed_tpu_torch.inference.serving import gpt2_serving_engine
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    ms = _mesh({"model": 2})
    cfg = dataclasses.replace(GPT2Config.gpt2_1_3b(),
                              n_layers=MP_GPT2_SERVE_LAYERS)
    prompts = _queue18(cfg.vocab_size)
    opts = dict(max_batch=8, page_size=16, max_seq=1024, num_pages=513,
                cache_dtype=torch.bfloat16)
    launches, res, engines, ref = {}, {}, {}, {}

    def build():
        params = _gpt2_params(cfg, 12)
        if comm.get_rank() == 0:
            for wd in ("bfloat16", "int8"):
                e = gpt2_serving_engine(params, cfg, weight_dtype=wd, **opts)
                first = _capture_first(e)
                out, m = drive(e, prompts, MP_SERVE_NEW)
                ref[wd] = (out, {k: v.cpu() for k, v in first.items()}, m)
                del e
                gc.collect()
        for wd in ("bfloat16", "int8"):
            _zero(fns.values())
            t0 = time.perf_counter()
            engines[wd] = gpt2_serving_engine(params, cfg, mesh=ms,
                                              weight_dtype=wd, **opts)
            torch.cuda.synchronize()
            engines[wd].build_s = time.perf_counter() - t0
            engines[wd].built = _built(fns)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    _in_turn(build)
    for wd in ("bfloat16", "int8"):
        eng = engines.pop(wd)
        path = f"gpt2-1.3b tp2 serving {wd}"
        want = SERVING_KERNELS + (("quantize",) if wd == "int8" else ())
        out, got, m = _serve_tp_engine(fns, path, launches, eng, prompts,
                                       want, built=eng.built)
        row = {"build_s": eng.build_s, "wall_s": m["wall_s"],
               "tokens_per_s": m["tokens_per_s"],
               "ttft_s_mean": m["ttft_s_mean"],
               "decode_step_ms": m.get("ms_per_decode_step"),
               "cache_heads_a_rank": int(eng.cache.k.shape[1]),
               "weight_bytes_rank": param_bytes(eng.params),
               "peak_mem_gb_rank": torch.cuda.max_memory_allocated() / 1e9}
        if comm.get_rank() == 0:
            r_out, r_first, r_m = ref[wd]
            rel = _rel(got["_prefill"].float().cpu(),
                       r_first["_prefill"].float())
            row.update(first_logits_rel=rel,
                       same_outputs=sum(out[k] == r_out[k] for k in prompts),
                       one_rank_tokens_per_s=r_m["tokens_per_s"],
                       one_rank_decode_step_ms=r_m.get("ms_per_decode_step"))
            if not rel <= MP_GPT2_LOGITS_REL:
                raise SystemExit(f"phase 53: {path} first logits {rel} past "
                                 f"{MP_GPT2_LOGITS_REL} of the one-rank "
                                 "engine's")
        res[wd] = row
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    tiny = GPT2Config.tiny()
    tp = _gpt2_params(tiny, 53, torch.float32)
    kw = dict(max_batch=2, page_size=8, num_pages=64, max_seq=64,
              prefill_bucket=8, cache_dtype=torch.float32)
    res["tiny_f32_tokens_identical"] = _tiny_identity(
        fns, launches, "gpt2", lambda: gpt2_serving_engine(
            tp, tiny, mesh=ms, **kw),
        lambda: gpt2_serving_engine(tp, tiny, **kw))
    res["held"] = {"attention": _hold_attention(gen, 1, 1024, 8, 8,
                                                bwd=False),
                   "serving": _hold_serving(gen, 8, 8, cfg.vocab_size),
                   "int8_leaf": _hold_leaf(torch.randn(
                       (cfg.dim, 3 * cfg.dim // 2), generator=gen,
                       device="cuda").to(torch.bfloat16), adam=False,
                       quant=True)}
    if comm.get_rank() == 0:
        _phase_line("53 gpt2-1.3b tp2 serving", card_line, **res,
                    tol=MP_GPT2_LOGITS_REL, launches=launches,
                    mesh={"model": 2},
                    collectives="host-staged gloo, two ranks on one card")
    return launches


def _head_exchanges(wte, rows):
    """The tied head's two exchanges over ``model`` at a micro-step of
    ``rows`` rows, each timed once (host clock, synced on both sides):
    all-reducing the f32 partial logits [rows, V], or gathering the rank's
    bf16 block of ``wte`` whole (what the head does)."""
    from deepspeed_tpu_torch import comm

    out = {}
    for name, x, fn in (
            ("logits_all_reduce", torch.zeros((rows, wte.shape[0]),
                                              device="cuda"),
             lambda x: comm.reduce_from(x, "model")),
            ("wte_gather", wte.detach().to(torch.bfloat16),
             lambda x: comm.gather_from(x, "model", -1))):
        torch.cuda.synchronize()
        comm.barrier()
        t0 = time.perf_counter()
        y = fn(x)
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0,
                     "bytes_a_rank": x.numel() * x.element_size()}
        del x, y
    torch.cuda.empty_cache()
    return out


def phase_gpt2_tp_train(fns, card_line, refs, gen):
    """Phase 54: GPT-2 1.3B trained over model 2 at phase 42's config
    (ZERO_LAYERS of 24 layers, ``save_attn``, seed 19, micro 8 x 1024, bf16
    compute, fused Adam), MP_GPT2_TRAIN_STEPS steps: losses against phase
    42's one-rank losses; the stage-0 checkpoint written from the two
    ranks' blocks and read into one rank, whose whole leaves cut into
    each rank's blocks (the fused QKV's slice of q, k and v) must equal
    the ranks' state bit for bit; the steps' collectives, and the tied
    head's two exchanges timed alone (the partial logits' all-reduce it
    avoids, the ``wte`` gather it makes); B1-B3 at a rank's 8 heads of 128
    held to their plain versions (``phase_rank_shapes`` times B2 / B3
    beside SDPA's backward at this shape)."""
    import dataclasses
    import gc
    import shutil

    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, loss_fn,
                                                 param_specs)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam

    _mesh({"model": 2})
    cfg = dataclasses.replace(GPT2Config.gpt2_1_3b(), remat="save_attn",
                              n_layers=ZERO_LAYERS)
    B, T = GPT2_TRAIN_B, GPT2_TRAIN_T
    rng = np.random.default_rng(19)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    conf = dict(_train_config(B, 1, {"bf16": {"enabled": True}}),
                mesh={"model": 2})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = _gpt2_params(cfg, 19, torch.float32)
    eng = initialize(loss_fn=loss_fn(cfg), params=params, config=conf,
                     optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
                     param_specs=param_specs(cfg),
                     dist_init_required=False)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    launches, rows = {}, []
    path = f"gpt2-1.3b-{ZERO_LAYERS}L tp2 training"
    _zero(fns.values())
    comm.comms_logger().reset()
    for _ in range(MP_GPT2_TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        rows.append({"loss": loss, "ms": (time.perf_counter() - ts) * 1e3,
                     "peak_gb_rank": torch.cuda.max_memory_allocated() / 1e9})
    _mp_path(fns, path, launches, ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "fused_adam"))
    comms = comm.comms_logger().summary()
    head = _head_exchanges(eng.state.params["wte"], B * T)
    want = refs["phase48_losses"][:MP_GPT2_TRAIN_STEPS]
    rel = [abs(r["loss"] - w) / abs(w) for r, w in zip(rows, want)]
    specs = eng.state_layout()[3]
    mine = _state_digests(eng, specs, None)
    digests = [None] * comm.get_world_size()
    torch.distributed.all_gather_object(digests, mine)
    adam_leaf = _hold_leaf(eng.state.params["wte"])
    d = _bcast_str(_nvme_dir("gpt2_tp_ckpt") if comm.get_rank() == 0
                   else None)
    t0 = time.perf_counter()
    eng.save_checkpoint(d, tag="tp2")
    save_s = time.perf_counter() - t0
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = {"save_s": save_s}
    if comm.get_rank() == 0:
        one = initialize(loss_fn=loss_fn(cfg), params=_gpt2_params(
            cfg, 1, torch.float32), config=_train_config(
                B, 1, {"bf16": {"enabled": True}}),
            optimizer=fused_adam(lr=_warmup(), weight_decay=0.1),
            dist_init_required=False, mesh=_one_mesh())[0]
        t1 = time.perf_counter()
        one.load_checkpoint(d, tag="tp2")
        ckpt["load_s"] = time.perf_counter() - t1
        ckpt["bitwise"] = all(
            _state_digests(one, specs, r) == digests[r]
            for r in range(len(digests)))
        del one
        shutil.rmtree(d, ignore_errors=True)
    comm.barrier()
    gc.collect()
    torch.cuda.empty_cache()
    held = {"attention": _hold_attention(gen, B, T, 8, 8),
            "adam_leaf": adam_leaf}
    if comm.get_rank() == 0:
        _phase_line(f"54 gpt2-1.3b-{ZERO_LAYERS}L tp2 training", card_line,
                    steps=rows, phase42_losses=want, loss_rel=rel,
                    bound=MP_GPT2_TRAIN_LOSS_REL, init_s=init_s, ckpt=ckpt,
                    comms=comms, tied_head=head, held=held, launches=launches,
                    collectives="host-staged gloo, two ranks on one card")
        if not max(rel) <= MP_GPT2_TRAIN_LOSS_REL or not ckpt["bitwise"]:
            raise SystemExit(f"phase 54: losses {rel} (bound "
                             f"{MP_GPT2_TRAIN_LOSS_REL}) or checkpoint "
                             f"{ckpt} failed")
    return launches


def _pooled_witness(params, out, ref):
    """One rank's pooler (f32, on the card) over the [CLS] rows of two
    hidden-head results: the largest rel of a request's [CLS] row and of
    the pooled vector computed from it, as the pooled head's rel reads."""
    w = params["pooler"]["w"].float()
    b = params["pooler"]["b"].float()
    got, want = (torch.stack([torch.as_tensor(np.asarray(o[r][0],
                                                         np.float32))
                              for r in sorted(ref)]).cuda()
                 for o in (out, ref))

    def rel(a, z):
        return float(((a - z).abs().amax(-1) / z.abs().amax(-1)).max())

    return {"cls_rows_rel": rel(got, want),
            "pooled_from_cls_rows_rel": rel(torch.tanh(got @ w + b),
                                            torch.tanh(want @ w + b))}


def phase_bert_tp(fns, card_line, refs, gen):
    """Phase 55: BERT-large over model 2 (8 of 16 heads a rank), served at
    MP_BERT_SERVE_LAYERS of 24 layers and trained at all 24: phase 25's
    queue through the pooled and MLM heads, bf16 then
    int8 weights (quantized, then cut), each against the one-rank engine on
    the same weights, sequences/s beside it; then MP_BERT_TRAIN_STEPS
    steps on phase 26's batch and config against phase 26's one-rank
    losses.  The hidden head (bf16) is the pooled gap's second witness:
    one rank's pooler over each engine's [CLS] rows.  B1 at a rank's
    serving shape and B2 / B3 at its training shape
    (8 heads of 64, bidirectional with pad ids) held to their plain
    versions, beside SDPA's."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch.inference.encoder_serving import (
        bert_serving_engine)
    from deepspeed_tpu_torch.models.bert import (BertConfig, loss_fn,
                                                 param_specs)
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    ms = _mesh({"model": 2})
    cfg = BertConfig.large()
    scfg = dataclasses.replace(cfg, n_layers=MP_BERT_SERVE_LAYERS)
    reqs = _queue25(cfg)
    params = init_params(scfg, torch.Generator("cuda").manual_seed(25),
                         device="cuda")
    launches, res = {}, {}
    for head, wd in (("pooled", "bfloat16"), ("pooled", "int8"),
                     ("mlm", "bfloat16"), ("mlm", "int8"),
                     ("hidden", "bfloat16")):
        path = f"bert-large tp2 {head} {wd}"
        ref = None
        if comm.get_rank() == 0:
            e = bert_serving_engine(params, scfg, head=head,
                                    weight_dtype=wd, max_batch=BERT_B)
            ref, ref_s, _, _ = _drive_encoder(e, reqs)
            del e
        comm.barrier()
        _zero(fns.values())
        eng = bert_serving_engine(params, scfg, head=head, mesh=ms,
                                  weight_dtype=wd, max_batch=BERT_B)
        built = _snap(fns)
        _zero(fns.values())
        out, secs, _, _ = _drive_encoder(eng, reqs)
        _add(fns, built)
        _mp_path(fns, path, launches, ("flash_fwd",) + (
            ("quantize",) if wd == "int8" else ()))
        row = {"sequences_per_s": len(reqs) / secs,
               "lots": eng.stats["lots"], "tol": MP_BERT_REL[head]}
        if comm.get_rank() == 0:
            row["one_rank_sequences_per_s"] = len(reqs) / ref_s
            row["rel"] = max(_rel_np(out[r], ref[r]) for r in reqs)
            if head == "hidden":
                row.update(_pooled_witness(params, out, ref))
            if not row["rel"] <= MP_BERT_REL[head]:
                raise SystemExit(f"phase 55: {path} {row['rel']} past "
                                 f"{MP_BERT_REL[head]} of one rank's")
        res[f"{head}_{wd}"] = row
        del eng, out, ref
        gc.collect()
        torch.cuda.empty_cache()
    del params
    M, A = BERT_TRAIN_MICRO, BERT_TRAIN_ACCUM
    B, T = M * A, min(BERT_TRAIN_T, cfg.max_seq_len)
    batch, lens = _bert_batch(np.random.default_rng(26), B, T,
                              cfg.vocab_size)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(26),
                         device="cuda", dtype=torch.float32)
    eng = initialize(loss_fn=loss_fn(cfg), params=params, config=dict(
        _train_config(B, A, {"bf16": {"enabled": True}}), mesh={"model": 2}),
        optimizer=fused_adam(lr=_warmup(), weight_decay=0.01),
        param_specs=param_specs(cfg), dist_init_required=False)[0]
    del params
    _zero(fns.values())
    rows = []
    for _ in range(MP_BERT_TRAIN_STEPS):
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        rows.append({"loss": loss, "ms": (time.perf_counter() - ts) * 1e3})
    path = "bert-large tp2 training"
    _mp_path(fns, path, launches, ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "fused_adam"))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    want = refs["phase26_losses"][:MP_BERT_TRAIN_STEPS]
    rel = [abs(r["loss"] - w) / abs(w) for r, w in zip(rows, want)]
    H, D = cfg.n_heads // 2, cfg.head_dim
    slens = [int(n) for n in np.random.default_rng(55).integers(
        T // 4, T + 1, BERT_B - 1)] + [0]
    seg = _pad_seg(slens, T)
    q, k, v, do = (torch.randn((BERT_B, T, H, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    held = {"attention": _hold_attention(gen, BERT_B, T, H, H, D=D,
                                         bwd=False, causal=False, seg=seg),
            "backward": _bert_flash_bwd(gen, q, k, v, do, seg, slens,
                                        "phase 55")}
    del q, k, v, do
    ok = all(c["rel_err"] <= FLASH_BWD_REL_TOL or c["over_gate_faithful"]
             for c in held["backward"].values())
    if comm.get_rank() == 0:
        _phase_line("55 bert-large tp2", card_line, serving=res,
                    train=rows, phase26_losses=want,
                    loss_rel=rel, bound=MP_BERT_TRAIN_LOSS_REL, held=held,
                    launches=launches, mesh={"model": 2},
                    collectives="host-staged gloo, two ranks on one card")
    if not ok or not max(rel) <= MP_BERT_TRAIN_LOSS_REL:
        raise SystemExit(f"phase 55: losses {rel} (bound "
                         f"{MP_BERT_TRAIN_LOSS_REL}) or B2 / B3 failed")
    return launches


def _kvq_opts():
    return dict(max_batch=MP_KVQ_N, page_size=16, max_seq=512,
                num_pages=257, cache_dtype=torch.bfloat16, prefill_chunk=256,
                prefix_cache={}, kv_tier=dict(TIER_KV))


def _kvq_waves(vocab):
    return _tier_waves(np.random.default_rng(56), vocab, MP_KVQ_PREFIX,
                       MP_KVQ_SUFFIX, MP_KVQ_N)


def _kvq_drive(eng, waves):
    """Wave A, an idle step (the watermark demotes its warm pages), wave B;
    the first chunk forward's last-position logits -> (tokens, logits,
    metrics of wave B)."""
    got = {}
    fn = eng._chunk_prefill

    def wrapped(*a):
        logits, cache = fn(*a)
        if "first" not in got:
            got["first"] = logits[:, -1].float().clone()
        return logits, cache

    eng._chunk_prefill = wrapped
    out, _ = drive(eng, waves[0], MP_KVQ_NEW)
    eng.step()
    out_b, m = drive(eng, waves[1], MP_KVQ_NEW)
    out.update(out_b)
    eng._chunk_prefill = fn
    return out, got["first"], m


def _kvq_one_rank(params, cfg):
    """Phase 56's one-rank int8-resident engine on ``params``: its tokens,
    first logits and cache planes, on the host (written to a file the
    other rank reads)."""
    import gc

    from deepspeed_tpu_torch.inference.serving import llama_serving_engine

    eng = llama_serving_engine(params, cfg, **_kvq_opts())
    out, first, m = _kvq_drive(eng, _kvq_waves(cfg.vocab_size))
    c = eng.cache
    ref = {"out": out, "first": first.cpu(), "tokens_per_s":
           m["tokens_per_s"], "planes": {n: getattr(c, n).cpu() for n in (
               "k", "v", "k_scale", "v_scale")},
           "index": {key.hex(): int(p) for key, p in
                     eng.allocator.index.items()}}
    del eng, c
    gc.collect()
    path = os.path.join(_nvme_dir("kvq_ref"), "ref.pt")
    torch.save(ref, path)
    return path


def phase_tp_kvq(fns, card_line, gen):
    """Phase 56: phase 43's Llama-3-8B weights (drawn once there) served
    over model 2 with int8-resident pages (``kv_tier.quantized_resident``:
    each rank's 4 of 8 KV heads as int8 codes and f32 scales, written by
    B9's fused K/V write and read by B7) on phase 11's two waves cut to
    the smoke's time, beside the one-rank int8-resident engine: each
    rank's pages against the unsharded cache's slice of its heads, the
    first chunk's logits, tokens; the f32 tiny model's tokens identical to
    one rank's over both waves; B7 and the fused write held at 4 KV heads
    a rank."""
    import gc

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.kernels import (
        quantize_kv_rows, write_kv_quant, write_kv_quant_reference)
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_attention_quant_reference, paged_decode_attention_quant)
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig

    ms = _mesh({"model": 2})
    cfg = LlamaConfig.llama3_8b()
    eng = _MP.pop("kvq")
    r, path = comm.get_rank(), "llama3_8b tp2 int8-resident kv"
    launches = {}
    _zero(fns.values())
    out, first, m = _kvq_drive(eng, _kvq_waves(cfg.vocab_size))
    mine = {n: f.launches for n, f in fns.items()}
    _mp_path(fns, path, launches, ("paged_attention_quant", "quantize",
                                   "greedy_argmax"))
    ref = torch.load(_bcast_str(_MP.pop("kvq_ref", None)), weights_only=True)
    kv = eng.cache.k.shape[1]
    # the published pages both engines hold: the same tokens at the same
    # positions (content keys), so layer 0 reads the same input on both;
    # the later layers read a residual whose row-parallel sums were
    # reduced over ranks (two orders of bf16 summation)
    mine_index = {key.hex(): p for key, p in eng.allocator.index.items()}
    shared = sorted(set(mine_index) & set(ref["index"]))
    pm = torch.tensor([mine_index[k] for k in shared], dtype=torch.long)
    pr = torch.tensor([ref["index"][k] for k in shared], dtype=torch.long)
    pages = {"compared": len(shared)}
    for name in ("k", "v", "k_scale", "v_scale"):
        got = getattr(eng.cache, name).cpu()[:, :, pm]
        want = ref["planes"][name][:, r * kv:(r + 1) * kv][:, :, pr]
        if name in ("k", "v"):
            diff = (got.int() - want.int()).abs()
            pages[name] = {"layer0_equal": bool(diff[0].eq(0).all()),
                           "layer0_max_code_diff": int(diff[0].max()),
                           "layer0_share_equal":
                               float(diff[0].eq(0).float().mean()),
                           "max_code_diff": int(diff.max()),
                           "share_equal": float(diff.eq(0).float().mean())}
        else:
            pages[name] = {"layer0_equal": bool(got[0].eq(want[0]).all()),
                           "layer0_rel": _rel(got[0], want[0]),
                           "rel": _rel(got, want)}
    al = eng.allocator
    row = {"pages": pages, "cache_kv_heads_a_rank": int(kv),
           "first_logits_rel": _rel(first.cpu(), ref["first"]),
           "same_outputs": sum(out[k] == ref["out"][k] for k in ref["out"]),
           "tokens_per_s_wave_b": m["tokens_per_s"],
           "one_rank_tokens_per_s_wave_b": ref["tokens_per_s"],
           "demoted": al.demoted, "promoted": al.promoted,
           "quant_resident_promotes": eng.kv_tier_quant_resident_promotes,
           "b9_equals_b7": mine["quantize"] == mine["paged_attention_quant"],
           "leaks": eng.check_leaks()}
    del eng, ref
    gc.collect()
    torch.cuda.empty_cache()
    tiny = LlamaConfig.tiny(dim=64)
    tp = _gpt2_params(tiny, 56, torch.float32)
    waves = _tier_waves(np.random.default_rng(3), tiny.vocab_size, 40, 9, 3)
    kw = dict(max_batch=3, page_size=8, num_pages=64, max_seq=96,
              prefill_bucket=8, cache_dtype=torch.float32, prefix_cache={},
              kv_tier=dict(TIER_KV), prefill_chunk=8)
    outs = []
    for sharded in (False, True):
        e = llama_serving_engine(tp, tiny, mesh=ms if sharded else None,
                                 **kw)
        _zero(fns.values())
        o = {}
        for wave in waves:
            for rid, p in wave.items():
                e.submit(rid, p, max_new_tokens=10)
            o.update(e.run())
        outs.append(o)
        if sharded:
            _mp_path(fns, "llama tiny f32 tp2 int8-resident kv", launches,
                     ("paged_attention_quant", "quantize", "greedy_argmax"),
                     hopper=False)
            row["tiny_quant_resident_promotes"] = \
                e.kv_tier_quant_resident_promotes
        del e
    row["tiny_f32_tokens_identical"] = outs[0] == outs[1]
    # the fused write and B7 at a rank's 4 KV heads (16 query heads)
    planes, new, table, st = kv_write_inputs(
        gen, 1, KV_WRITE_CASES["decode"][1], KV=4)
    want = [p.clone() for p in planes]
    write_kv_quant(*planes, *new, table, st, 16)
    write_kv_quant_reference(*want, *new, table, st, 16)
    w_err = max(_quant_err((planes[i], planes[i + 1]),
                           (want[i], want[i + 1])) for i in (0, 2))
    held_ms = {"quantize_write_kv": device_ms(functools.partial(
        write_kv_quant, *planes, *new, table, st, 16), iters=5)}
    del planes, want, new
    # B7 over phase 9's decode rows, its pages quantised as the tier does
    lens = np.linspace(128, 1024, 8).astype(int).tolist()
    kp, vp, table = _paged_inputs(gen, lens, 1, H=16, KV=4)
    pq = (*quantize_kv_rows(kp), *quantize_kv_rows(vp))
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((len(lens), 16, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    held = dict([_hold("paged_attention_quant", paged_decode_attention_quant(
        q, *pq, table, seq), paged_attention_quant_reference(
        q, *pq, table, seq), PAGED_QUANT_DECODE_TOL)])
    held["quantize_write_kv"] = w_err
    held_ms["paged_attention_quant"] = device_ms(
        lambda: paged_decode_attention_quant(q, *pq, table, seq), iters=5)
    del kp, vp, pq
    every = _gather_rows_json(row)
    ok = all(x["first_logits_rel"] <= MP_KVQ_LOGITS_REL
             and x["pages"]["compared"] > 0
             and x["pages"]["k"]["layer0_max_code_diff"] <= MP_KVQ_LAYER0_CODES
             and x["pages"]["v"]["layer0_max_code_diff"] <= MP_KVQ_LAYER0_CODES
             and x["pages"]["k_scale"]["layer0_equal"]
             and x["pages"]["v_scale"]["layer0_equal"]
             and x["tiny_f32_tokens_identical"] and x["b9_equals_b7"]
             and x["quant_resident_promotes"] > 0 and x["leaks"] == []
             for x in every) and w_err == 0
    if r == 0:
        _phase_line("56 llama3_8b tp2 int8-resident kv", card_line,
                    ranks=every, tol=MP_KVQ_LOGITS_REL,
                    held={"max_abs_err": held, "ms": held_ms,
                          "kv_heads": 4, "q_heads": 16},
                    launches=launches, mesh={"model": 2},
                    collectives="host-staged gloo, two ranks on one card")
    if not ok:
        raise SystemExit("phase 56: the int8-resident engine over model 2 "
                         "failed a gate")
    return launches


def _mixtral_hf(cfg, gen):
    """A seeded HF-layout Mixtral state dict (host tensors) and config."""
    d, f, E, L = cfg.dim, cfg.ffn_dim, cfg.num_experts, cfg.n_layers
    kvd = cfg.n_kv_heads * cfg.head_dim

    def w(*shape):
        return torch.randn(shape, generator=gen) * 0.05

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, d),
          "model.norm.weight": torch.ones(d),
          "lm_head.weight": w(cfg.vocab_size, d)}
    for i in range(L):
        pre = f"model.layers.{i}."
        sd.update({pre + "input_layernorm.weight": torch.ones(d),
                   pre + "post_attention_layernorm.weight": torch.ones(d),
                   pre + "self_attn.q_proj.weight": w(d, d),
                   pre + "self_attn.k_proj.weight": w(kvd, d),
                   pre + "self_attn.v_proj.weight": w(kvd, d),
                   pre + "self_attn.o_proj.weight": w(d, d),
                   pre + "block_sparse_moe.gate.weight": w(E, d)})
        for e in range(E):
            moe = pre + f"block_sparse_moe.experts.{e}."
            sd.update({moe + "w1.weight": w(f, d), moe + "w3.weight": w(f, d),
                       moe + "w2.weight": w(d, f)})
    hf = {"architectures": ["MixtralForCausalLM"],
          "vocab_size": cfg.vocab_size, "hidden_size": d,
          "num_hidden_layers": L, "num_attention_heads": cfg.n_heads,
          "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": f,
          "num_local_experts": E, "num_experts_per_tok": cfg.top_k,
          "max_position_embeddings": cfg.max_seq_len,
          "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps}
    return sd, hf


def phase_inject_hybrid_elastic(fns, card_line):
    """Phase 57: over model 2, an injected tiny Llama (``save_pretrained``
    -> ``from_pretrained``) and tiny Mixtral (``inject`` of an HF state
    dict, also over expert 2) served by ``init_inference(mesh=,
    param_specs=specs)``, greedy tokens identical to one rank's; phase
    44's hybrid rollouts (``inference_tp_size`` 2 over its Llama-3-8B
    widths x 4 layers training state): the logits of every step of its
    first rollout, taken inside ``generate``, against one rank's over the
    same tokens within phase 43's bound, each generated token one rank's
    greedy choice up to that difference, and its cache at n_kv_heads / 2
    heads a rank; an engine whose batch an
    ``elasticity`` block resolves at world 2 takes one step."""
    import shutil

    from deepspeed_tpu_torch import (comm, from_pretrained, initialize,
                                     inject, save_pretrained, topology)
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.models.llama import LlamaConfig, loss_fn
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    r = comm.get_rank()
    launches, res = {}, {}
    tiny = LlamaConfig.tiny(dim=64)
    params = _gpt2_params(tiny, 57, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(57).integers(
        0, tiny.vocab_size, (2, 24)).astype(np.int64)).cuda()
    d = _nvme_dir(f"inject{r}")
    save_pretrained(params, tiny, d)
    fn, p, _, specs = from_pretrained(d, dtype=torch.float32)
    shutil.rmtree(d, ignore_errors=True)
    sd, hf = _mixtral_hf(MixtralConfig.tiny(dim=64),
                         torch.Generator().manual_seed(57))
    mfn, mp, _, mspecs = inject("MixtralForCausalLM", hf, sd,
                                dtype=torch.float32)
    for name, f_, p_, sp, axis in (
            ("llama", fn, p, specs, "model"),
            ("mixtral", mfn, mp, mspecs, "model"),
            ("mixtral", mfn, mp, mspecs, "expert")):
        topology.set_current_mesh(None)
        one = init_inference(apply_fn=f_, params=p_, dtype="float32")(toks)
        ms = _mesh({axis: 2})
        _zero(fns.values())
        got = init_inference(apply_fn=f_, params=p_, mesh=ms,
                             param_specs=sp, dtype="float32")(toks)
        _mp_path(fns, f"injected {name} tiny f32 {axis}2", launches,
                 ("flash_fwd",), hopper=False)
        res[f"{name}_{axis}"] = {
            "tokens_identical": bool((got.argmax(-1)
                                      == one.argmax(-1)).all()),
            "logits_rel": _rel(got, one)}
    del p, mp, sd
    hybrid = res["hybrid"] = dict(_MP.pop("hybrid"), tol=MP_TP_LOGITS_REL)
    conf = {"bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "elasticity": {"enabled": True, "max_train_batch_size": 8,
                           "micro_batch_sizes": [1, 2], "min_gpus": 1,
                           "max_gpus": 4}}
    _zero(fns.values())
    eng = initialize(loss_fn=loss_fn(tiny), params=params, config=conf,
                     dist_init_required=False)[0]
    c = eng.config
    rows = torch.from_numpy(np.random.default_rng(58).integers(
        0, tiny.vocab_size, (c.train_batch_size, 33)).astype(np.int64))
    loss = float(eng.train_batch({"tokens": rows}))
    _mp_path(fns, "elastic llama tiny f32 dp2", launches,
             ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), hopper=False)
    res["elastic"] = {"train_batch_size": c.train_batch_size,
                      "micro": c.train_micro_batch_size_per_gpu,
                      "accumulation": c.gradient_accumulation_steps,
                      "world": comm.get_world_size(), "loss": loss}
    del eng
    ok = (all(v["tokens_identical"] for k, v in res.items()
              if k.startswith(("llama", "mixtral")))
          and np.isfinite(loss) and c.train_micro_batch_size_per_gpu
          * c.gradient_accumulation_steps * 2 == c.train_batch_size
          and hybrid["cache_kv_heads_a_rank"] == hybrid["cache_kv_heads_want"])
    if r == 0:
        _phase_line("57 injection, hybrid and elasticity over 2 ranks",
                    card_line, **res, launches=launches,
                    collectives="host-staged gloo, two ranks on one card")
        ok = (ok and hybrid["finite"] and hybrid["tokens_within_error"]
              and hybrid["logits_rel"] <= MP_TP_LOGITS_REL)
    if not ok:
        raise SystemExit(f"phase 57 failed: {res}")
    return launches


def _dense_masked_attention(q, k, v, layout, block):
    """The oracle of phase 58, independent of the gather: dense f32 causal
    attention of q [1, T, H, D] over k / v [1, T, KV, D] under the block
    layout expanded to a token mask -> [1, T, H, D] f32."""
    H = q.shape[2]
    rep = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, 2).transpose(1, 2)
    lay = torch.from_numpy(layout).to(q.device)
    allow = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    allow = allow & torch.ones(allow.shape[-2:], dtype=torch.bool,
                               device=q.device).tril()
    out = torch.empty_like(qf)
    for h in range(H):                  # a head at a time: [T, T] f32
        s = qf[0, h] @ kf[0, h].T / math.sqrt(q.shape[-1])
        s = s.masked_fill(~allow[h], float("-inf"))
        out[0, h] = torch.softmax(s, -1) @ vf[0, h]
    return out.transpose(1, 2)


def phase_sparse(fns, card_line, phase8):
    """Phase 58: block-sparse attention at Llama-3-8B widths, phase 8's
    config (4 layers, seed 0, micro 1 x accumulation 2, bf16 compute, fused
    Adam) with ``attn_impl="sparse"`` on rows of T = 2048 (phase 8's 2047
    is no multiple of a block; the layouts need one).  Gates: every
    layer's sparse output in one forward against dense f32 attention under
    the layout expanded to a token mask (the "fixed" layout, blocks of
    64); the "dense" layout's first loss against the flash path's (phase
    8's engine) on the same rows; "fixed" and "bigbird" each two steps of
    finite, falling losses.  Records ms a step and peak memory beside the
    flash path's and phase 8's, and each layout's density.  The sparse
    path attends in plain PyTorch (no kernel of the reference's runs there
    either); B4 updates the weights."""
    import dataclasses
    import gc

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam
    from deepspeed_tpu_torch.weights import init_params

    base = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=4)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, base.vocab_size, (2, 2049)).astype(
        np.int32)}
    launches, res = {}, {}

    def engine(sparse):
        cfg = base if sparse is None else dataclasses.replace(
            base, attn_impl="sparse", sparse_config=sparse)
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             device="cuda", dtype=torch.float32)
        eng = initialize(loss_fn=llama.loss_fn(cfg), params=params,
                         config=_train_config(2, 2, {"bf16": {
                             "enabled": True}}),
                         optimizer=fused_adam(lr=_warmup(),
                                              weight_decay=0.1))[0]
        del params
        return cfg, eng

    def steps_of(eng, n):
        rows = []
        for _ in range(n):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            loss = float(eng.train_batch(batch))
            rows.append({"loss": loss,
                         "ms": (time.perf_counter() - ts) * 1e3,
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9})
        return rows

    # the flash path on these rows, then the dense layout (causal
    # attention over every block) against it
    cfg, eng = engine(None)
    res["flash"] = steps_of(eng, 2)
    del eng
    cfg, eng = engine({"mode": "dense", "block": 64})
    dense_loss = steps_of(eng, 1)[0]["loss"]
    del eng
    flash_loss = res["flash"][0]["loss"]
    res["dense_layout"] = {"loss": dense_loss, "flash_loss": flash_loss,
                           "rel": abs(dense_loss - flash_loss)
                           / abs(flash_loss), "tol": SPARSE_DENSE_LOSS_REL}
    for name, sparse in SPARSE_LAYOUTS.items():
        cfg, eng = engine(sparse)
        sa = llama._sparse_self_attention(cfg)
        row = {"density": sa.density(2048), "config": sparse}
        if name == "fixed":
            caught, orig = [], llama._sparse

            def spy(q, k, v, c, segment_ids=None):
                out = orig(q, k, v, c, segment_ids)
                caught.append((q, k, v, out))
                return out

            llama._sparse = spy
            try:
                with torch.no_grad():
                    llama.forward_hidden(
                        _cast_tree(eng.state.params, torch.bfloat16),
                        torch.from_numpy(batch["tokens"][:1, :-1]).cuda(), cfg)
            finally:
                llama._sparse = orig
            layout = sa.layout(2048)
            row["layer_rel"] = []
            for q, k, v, out in caught:
                want = _dense_masked_attention(q, k, v, layout,
                                               sa.config.block)
                row["layer_rel"].append(_rel(out, want))
                del want
            del caught
        _zero(fns.values())
        steps = steps_of(eng, 2)
        path = f"llama3_8b-4L sparse {name} training"
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        _check_launches(path, launches[path], ("fused_adam",))
        row["steps"] = steps
        res[name] = row
        del eng
    res["phase8_flash_T2047"] = [{k: r[k] for k in ("loss", "ms",
                                                    "peak_mem_gb")}
                                 for r in phase8[:2]]
    _phase_line("58 llama3_8b-4L sparse attention", card_line, **res,
                oracle_tol=SPARSE_ORACLE_REL, launches=launches)
    bad = [n for n in SPARSE_LAYOUTS
           if not (all(np.isfinite([s["loss"] for s in res[n]["steps"]]))
                   and res[n]["steps"][1]["loss"]
                   < res[n]["steps"][0]["loss"])]
    if bad or max(res["fixed"]["layer_rel"]) > SPARSE_ORACLE_REL \
            or res["dense_layout"]["rel"] > SPARSE_DENSE_LOSS_REL:
        raise SystemExit(f"phase 58 failed: {res}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_autotune(fns, card_line):
    """Phase 59: ``autotune_config`` over GPT-2 1.3B at 4 of 24 layers (the
    smoke's time; micro rows of 1024 tokens, train batch 4, bf16 compute)
    on one card: micro 1 / 2 x remat none / full, and an unknown remat
    policy (``loss_for`` hands each candidate's policy to the model), 2
    timed steps each.  Gates: the winner is the fastest measured
    candidate, the unknown policy's candidates are listed as failed, and a
    second call reads the cache and launches no kernel."""
    import dataclasses

    from deepspeed_tpu_torch.autotune import autotune_config
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, loss_fn

    cfg = dataclasses.replace(GPT2Config.gpt2_1_3b(), n_layers=4)
    params = _gpt2_params(cfg, 59, torch.float32)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(59).integers(
        0, cfg.vocab_size, (4, 1025)).astype(np.int64)).cuda()}
    base = {"train_batch_size": 4, "bf16": {"enabled": True},
            "gradient_clipping": 1.0,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-4}}}
    space = {"train_micro_batch_size_per_gpu": [1, 2],
             "activation_checkpointing.policy": ["none", "full",
                                                 "no_such_policy"]}
    cache = os.path.join(_nvme_dir("autotune"), "cache.json")
    launches = {}
    def loss_for(policy):
        return loss_fn(dataclasses.replace(cfg, remat=policy))

    _zero(fns.values())
    t0 = time.perf_counter()
    verdict = autotune_config(base, loss_fn(cfg), params, batch, space=space,
                              cache_path=cache, iters=2, loss_for=loss_for)
    sweep_s = time.perf_counter() - t0
    path = "gpt2-1.3b-4L autotune sweep"
    launches[path] = {n: f.launches for n, f in fns.items()}
    _check_bodies(path)
    _check_launches(path, launches[path],
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    _zero(fns.values())
    t0 = time.perf_counter()
    again = autotune_config(base, loss_fn(cfg), params, batch, space=space,
                            cache_path=cache, iters=2, loss_for=loss_for)
    cached_s = time.perf_counter() - t0
    relaunched = sum(f.launches for f in fns.values())
    timed = [r for r in verdict["results"] if "step_time_s" in r]
    failed = [r for r in verdict["results"] if "error" in r]
    row = {"candidates": [{"overrides": r["overrides"],
                           "ms": r.get("step_time_s", 0) * 1e3 or None,
                           "error": r.get("error")}
                          for r in verdict["results"]],
           "winner": verdict["overrides"],
           "winner_ms": verdict["step_time_s"] * 1e3, "sweep_s": sweep_s,
           "cached_call_s": cached_s, "cached_call_launches": relaunched}
    _phase_line("59 gpt2-1.3b-4L autotune", card_line, **row,
                launches=launches)
    ok = (len(timed) == 4 and len(failed) == 2
          and all("no_such_policy" in r["error"] for r in failed)
          and verdict["step_time_s"] == min(r["step_time_s"] for r in timed)
          and again["overrides"] == verdict["overrides"] and relaunched == 0)
    del params
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"phase 59 failed: {row}")
    return launches


def phase_rank_shapes(card_line, gen):
    """Phases 54-55's B2 / B3 at a tensor-parallel rank's shapes, timed in
    this one process beside SDPA's backward on the same inputs (the two
    ranks of the child share the card, so their times overlap): GPT-2
    1.3B's 8 heads of 128 at phase 42's micro 8 x 1024, causal; BERT-large's
    8 heads of 64 at phase 26's micro 8 x 512, bidirectional with pad
    ids."""
    q, k, v, do = (torch.randn((GPT2_TRAIN_B, GPT2_TRAIN_T, 8, 128),
                               generator=gen, device="cuda").to(
                                   torch.bfloat16) for _ in range(4))
    gpt2 = _bert_flash_bwd(gen, q, k, v, do, None, None, "phase 54 shapes",
                           causal=True)
    T = min(BERT_TRAIN_T, 512)
    lens = [int(n) for n in np.random.default_rng(55).integers(
        T // 4, T + 1, BERT_B - 1)] + [0]
    seg = _pad_seg(lens, T)
    q, k, v, do = (torch.randn((BERT_B, T, 8, 64), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    bert = _bert_flash_bwd(gen, q, k, v, do, seg, lens, "phase 55 shapes")
    del q, k, v, do
    torch.cuda.empty_cache()
    row = {"gpt2_rank": gpt2, "bert_rank": bert}
    for name, cases in (("gpt2", gpt2), ("bert", bert)):
        ms = [cases[n]["device_ms"] for n in cases]
        lib = cases["flash_bwd_dq"]["library_device_ms"]
        row[f"{name}_b2_b3_over_sdpa_bwd"] = (
            sum(ms) / lib if all(ms) and lib else None)
    _phase_line("54-55 B2 / B3 at a rank's shapes beside SDPA", card_line,
                **row)
    ok = all(c["rel_err"] <= FLASH_BWD_REL_TOL or c["over_gate_faithful"]
             for cases in (gpt2, bert) for c in cases.values())
    if not ok:
        raise SystemExit("phases 54-55: B2 / B3 disagree at a rank's "
                         "shape")
    return row


def mp_child(out_path: str, refs: dict) -> int:
    """Phases 43-47, 49-57 in one of two ranks the port's launcher started
    on the one card: join the gloo group, run each phase (a failing rank
    fails the launcher and so the smoke); rank 0 writes both ranks'
    launches."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import _build

    comm.init_distributed(dist_backend="gloo")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    fns = _kernel_fns()
    card_line = card()
    gen = torch.Generator("cuda").manual_seed(43 + comm.get_rank())
    log(f"[mp] rank {comm.get_rank()} of {comm.get_world_size()} on "
        f"{torch.cuda.get_device_name()} (LOCAL_RANK "
        f"{comm.get_local_rank()}, backend "
        f"{torch.distributed.get_backend()})")
    launches, laps = {}, {}
    lazy = []

    def lazy_model():
        import dataclasses

        from deepspeed_tpu_torch.models import llama

        if not lazy:
            # phase 38's model at its depth, drawn once for 50 and 51
            lazy.append(llama.layered_model_lazy(dataclasses.replace(
                llama.LlamaConfig.llama3_8b(), n_layers=OFFLOAD_LAYERS),
                seed=0))
        return lazy[0]

    for name, fn in (
            ("phase_tp_serving", lambda: phase_tp_serving(fns, card_line,
                                                          gen)),
            ("phase_tp_kvq", lambda: phase_tp_kvq(fns, card_line, gen)),
            ("phase_tp_train", lambda: phase_tp_train(
                fns, card_line, refs["phase8_losses"], gen)),
            ("phase_inject_hybrid_elastic",
             lambda: phase_inject_hybrid_elastic(fns, card_line)),
            ("phase_seq", lambda: phase_seq(fns, card_line, gen)),
            ("phase_pipe", lambda: phase_pipe(fns, card_line, gen)),
            ("phase_ep", lambda: phase_ep(fns, card_line, gen)),
            ("phase_offload_ranks", lambda: phase_offload_ranks(
                fns, card_line, refs)),
            ("phase_pstream_ranks", lambda: phase_pstream_ranks(
                fns, card_line, refs, lazy_model())),
            ("phase_infinity_ranks", lambda: phase_infinity_ranks(
                fns, card_line, refs, lazy_model())),
            ("phase_zi_tp", lambda: phase_zi_tp(fns, card_line, gen,
                                                refs)),
            ("phase_gpt2_tp_serving", lambda: phase_gpt2_tp_serving(
                fns, card_line, gen)),
            ("phase_gpt2_tp_train", lambda: phase_gpt2_tp_train(
                fns, card_line, refs, gen)),
            ("phase_bert_tp", lambda: phase_bert_tp(fns, card_line, refs,
                                                    gen))):
        if refs.get("only") and name not in refs["only"]:
            continue
        t0 = time.perf_counter()
        launches.update(fn())
        torch.cuda.synchronize()
        comm.barrier()
        laps[name] = time.perf_counter() - t0
        if comm.get_rank() == 0:
            log(f"[smoke] {name} (two ranks): {laps[name]:.1f} s")
    if comm.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump({"launches": launches, "laps": laps,
                       "bodies": {k: {p: c for p, c in v.items()
                                      if p in launches}
                                  for k, v in BODIES.items()}}, f)
    comm.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_mp_launcher(card_line, refs):
    """Phases 43-47, 49-57 through ``python -m deepspeed_tpu_torch.launcher
    --local_hosts 2``: two ranks on the one card over gloo; a failing rank
    fails the smoke; both ranks' launches come back."""
    out = os.path.join(_nvme_dir("mp_child"), "result.json")
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher",
           "--local_hosts", "2", os.path.join(ROOT, "chip_smoke.py"),
           MP_CHILD_FLAG, out, json.dumps(refs)]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=ROOT, env=env,
                        timeout=MP_CHILD_TIMEOUT_S).returncode
    if rc != 0:
        raise SystemExit(f"phases 43-57: a launched rank exited {rc}")
    with open(out) as f:
        res = json.load(f)
    log(f"[mp] launcher and two ranks: {time.perf_counter() - t0:.1f} s, "
        f"phases {res['laps']}")
    for name, paths in res["bodies"].items():
        BODIES.setdefault(name, {}).update(paths)
    return res["launches"]


# ------------------------------------------------------------ phases 62-64
# phase 62: three 512-token prefixes, eight prompts on each with 64..256
# unique suffix tokens, 16 new greedy tokens, on replicas of max_batch 8
FLEET_PREFIX, FLEET_LO, FLEET_HI, FLEET_NEW = 512, 64, 257, 16
# phase 5's first 8 layers (32 before phases 65-67: the smoke's time)
FLEET_LAYERS = 8
FLEET_OPTS = dict(max_batch=8, page_size=16, max_seq=1024, num_pages=1025,
                  prefill_bucket=128, cache_dtype=torch.bfloat16)


# a greedy token that differs between two bf16 runs of one request (the
# batch it ran in, how its prompt was prefilled: ROADMAP C-w2) is held at
# its first divergent step: in a dense forward of the common prefix the two
# tokens' logits lie within this share of the row's largest |logit| (the
# smoke's bf16 logits tolerance, MIXTRAL_LOGITS_REL_TOL)
FLEET_TIE_REL_TOL = 5e-2
# phase 63: Llama-3-8B at full width and 8 layers in each child
PROC_LAYERS, PROC_SEED, PROC_NEW = 8, 63, 32
PROC_MODEL = {"family": "llama", "preset": "llama3_8b",
              "n_layers": PROC_LAYERS}
# phase 64: GPT-2 1.3B's two weight versions, and the streamed replica's
ELASTIC_SEEDS, ELASTIC_NEW = (64, 65), 12
ELASTIC_FAST = dict(min_replicas=1, max_replicas=3, eval_interval_steps=1,
                    scale_up_queue_depth=2.0, scale_down_queue_depth=0.5,
                    up_after=1, down_after=3, cooldown_s=0.0)


def _fleet_prompts(vocab, seed=62):
    """Phase 62's 24 prompts: wave 1 one a prefix, wave 2 the next six of
    each and the eighth of the middle one, then two probes (``m0`` on the
    first prefix, ``c0`` on the third)."""
    rng = np.random.default_rng(seed)
    pre = [rng.integers(1, vocab, FLEET_PREFIX).tolist()
           for _ in range(3)]
    per = [[pre[j] + rng.integers(1, vocab, int(n)).tolist()
            for n in rng.integers(FLEET_LO, FLEET_HI, 8)] for j in range(3)]
    wave1 = {f"w{j}": per[j][0] for j in range(3)}
    wave2 = {f"q{j}{i}": per[j][i] for i in range(1, 7) for j in range(3)}
    wave2["q17"] = per[1][7]
    return wave1, wave2, {"m0": per[0][7]}, {"c0": per[2][7]}


def _split_wave(wave2):
    """Wave 2's first four a prefix, and the rest (submitted one router
    step later)."""
    late = {k: v for k, v in wave2.items() if k[-1] in "567"}
    return {k: v for k, v in wave2.items() if k not in late}, late


def _held_flips(params, cfg, forward, got, want, prompts, oracle="oracle"):
    """Requests whose finished tokens differ from the oracle's: each one is
    held at its first divergent step to FLEET_TIE_REL_TOL in a dense bf16
    forward of the common prefix (measurement only: its kernel launches are
    not a main path's).  Returns the flips; raises past the tolerance."""
    flips = []
    for rid, out in got.items():
        if not isinstance(out, list) or out == want[rid]:
            continue
        ref = want[rid]
        j = next(i for i, (a, b) in enumerate(zip(out, ref)) if a != b)
        toks = torch.tensor([ref[:j]], dtype=torch.int32,
                            device="cuda")
        with torch.inference_mode():
            row = forward(params, toks, cfg)[0, -1].float()
        gap = abs(row[ref[j]] - row[out[j]]).item() / row.abs().max().item()
        flips.append({"req": rid, "pos": j - len(prompts[rid]),
                      "gap_rel": gap})
        log(f"[fleet] near-tie flip {rid} against the {oracle} at "
            f"generated position {j - len(prompts[rid])}: tokens {ref[j]} / "
            f"{out[j]}, logit gap {gap:.3e} of the row's max |logit|")
        if gap > FLEET_TIE_REL_TOL:
            raise SystemExit(f"fleet: {rid} differs from the oracle at "
                             f"position {j} by {gap:.3e} > "
                             f"{FLEET_TIE_REL_TOL} (not a near-tie)")
    return flips


class _FleetClock:
    """Host seconds of each replica's ``step`` inside the router's steps
    (the replicas' step time, and the router's own host time beside it),
    and each request's first token."""

    def __init__(self, router):
        self.router, self.eng_s, self.eng_steps = router, 0.0, 0
        self.router_s, self.router_steps, self.ttft = 0.0, 0, {}
        self._wave, self._t0 = {}, 0.0
        for rep in router.replicas.values():
            self.wrap(rep.engine)

    def wrap(self, eng):
        if "step" in vars(eng):
            return
        real = eng.step

        def step():
            t = time.perf_counter()
            try:
                return real()
            finally:
                now = time.perf_counter()
                self.eng_s += now - t
                self.eng_steps += 1
                # a request's first token, read at the end of its own
                # replica's step (a child's proxy mirrors no slot objects:
                # there it is read when the request finishes)
                for s in getattr(eng, "slots", ()):
                    if getattr(s, "generated", None) and \
                            s.req.req_id in self._wave:
                        self.ttft.setdefault(s.req.req_id, now - self._t0)
        eng.step = step

    def drive(self, wave, new, arm=None):
        """Submit ``wave``, step the router until it is idle (``arm(n)``
        after the n-th step); returns each request's first placement."""
        r = self.router
        placed = {}
        self._wave, self._t0 = wave, time.perf_counter()
        t0 = self._t0
        for rid, p in wave.items():
            r.submit(rid, p, max_new_tokens=new)
            freq = r.requests.get(rid)
            placed[rid] = freq.replica if freq is not None else None
        n = 0
        while r.has_work:
            for rep in r.replicas.values():
                self.wrap(rep.engine)
            ts = time.perf_counter()
            r.step()
            now = time.perf_counter()
            self.router_s += now - ts
            self.router_steps += 1
            n += 1
            for rid in wave:
                if rid in r.finished:
                    self.ttft.setdefault(rid, now - t0)
            if arm is not None:
                arm(n)
            if n > 100_000:
                raise SystemExit("fleet: the router did not converge")
        return placed

    def unwrap(self):
        for rep in self.router.replicas.values():
            vars(rep.engine).pop("step", None)

    def summary(self):
        eng_ms = self.eng_s * 1e3 / max(self.eng_steps, 1)
        own = (self.router_s - self.eng_s) * 1e3 / max(self.router_steps, 1)
        return {"router_steps": self.router_steps,
                "router_host_ms_per_step": own,
                "replica_step_ms": eng_ms, "replica_steps": self.eng_steps}


def _oracle(build, waves, new):
    """One engine serving the waves in order (each to completion): the
    token oracle of a fleet path."""
    eng = build()
    out = {}
    for wave in waves:
        for rid, p in wave.items():
            eng.submit(rid, p, max_new_tokens=new)
        out.update(eng.run())
    leaks = eng.check_leaks()
    eng.shutdown()
    del eng
    torch.cuda.empty_cache()
    if leaks:
        raise SystemExit(f"fleet oracle leaks {leaks}")
    return {k: list(v) for k, v in out.items()}


def _two_leg_oracle(build, waves, new):
    """One engine serving each wave as the fleet's prefill -> decode handoff
    does, with no fabric: every prompt to its first token, then prompt plus
    that token again for the other ``new - 1``, so the second leg matches
    the prompt's full pages in the prefix cache and prefills only the tail
    past them (the decode replica's leg).  The yardstick that tells the
    handoff's own numerics from the fabric's bytes."""
    eng = build()
    out = {}
    for wave in waves:
        for rid, p in wave.items():
            eng.submit(rid, p, max_new_tokens=1)
        eng.run()
        first = eng.drain_finished()
        for rid in wave:
            eng.submit(rid, list(first[rid]), max_new_tokens=new - 1)
        eng.run()
        out.update(eng.drain_finished())
    leaks = eng.check_leaks()
    eng.shutdown()
    del eng
    torch.cuda.empty_cache()
    if leaks:
        raise SystemExit(f"fleet two-leg oracle leaks {leaks}")
    return {k: list(v) for k, v in out.items()}


def _typed_partition(out, submitted):
    ok = {k for k, v in out.items() if isinstance(v, list)}
    failed = {k: (v.reason, v.generated) for k, v in out.items()
              if type(v).__name__ == "RequestFailed"}
    shed = {k: v.reason for k, v in out.items()
            if type(v).__name__ == "RequestShed"}
    if len(ok) + len(failed) + len(shed) != len(submitted) or \
            set(out) != set(submitted):
        raise SystemExit(f"fleet: finished {len(ok)} + failed "
                         f"{len(failed)} + shed {len(shed)} != submitted "
                         f"{len(submitted)}")
    return ok, failed, shed


def _clean(router, tag):
    leaks, orphans = router.check_leaks(), router.orphaned()
    if leaks or orphans:
        raise SystemExit(f"{tag}: check_leaks {leaks} orphaned {orphans}")


def phase_fleet(params, cfg, kernels, card_line):
    """Phase 62: the in-process serving fleet at Llama-3-8B's full width on
    phase 5's weights (bf16) cut to their first FLEET_LAYERS layers (views
    of the stacked blocks), ONE weight tree for every replica.

    (a) Three replicas (``max_batch`` 8, prefix cache, a host KV tier with
    ``quantize_cold`` off, a KVFabric) serve 24 prompts: wave 1 one on each
    of three 512-token prefixes, wave 2 eighteen more (second-wave affinity
    hits) while a seeded ``replica`` rule kills r1 two router steps in;
    then ``drain("r0")`` and a probe on r0's prefix migrates to r2 through
    the fabric (``rejoin`` after), and ``drain("r2")`` with a seeded
    ``fabric`` corrupt-after-checksum rule sends a probe on r2's prefix to
    r0, whose promotion fails its crc and re-prefills.  (b) The same
    traffic through ``fleet.roles`` 1 prefill + 2 decode.  (c) The
    int8-resident arm (``quantized_resident``, ``quantize_cold``): r0's
    int8 chain migrates to r1 while r0 drains.  Gates: every finished
    request's tokens equal one engine's over the same weights and blocks
    serving the same prompts in the same order (a near-tie flip is held to
    FLEET_TIE_REL_TOL and counted); finished + failed + shed = submitted;
    ``check_leaks()`` and ``orphaned()`` empty; the replicas' weights are
    the one tree; B1, B5 and B6 launched on (a) and (b), B7, B9 and B6 on
    (c)."""
    from deepspeed_tpu_torch.faults import FaultPlan
    from deepspeed_tpu_torch.fleet import fleet_router
    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models import llama

    def zero():
        _zero(k["fn"] for k in kernels)

    def counts():
        return {k["name"]: k["fn"].launches for k in kernels}

    params, cfg = _first_layers(params, cfg, FLEET_LAYERS)
    wave1, wave2, probe_m, probe_c = _fleet_prompts(cfg.vocab_size)
    prompts = {**wave1, **wave2, **probe_m, **probe_c}
    tier = {"quantize_cold": False, "host_pool_bytes": 4 << 30}
    blocks = dict(prefix_cache={}, kv_tier=dict(tier), device="cuda",
                  **FLEET_OPTS)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    launches, res = {}, {}

    # ---- (a)
    plan = FaultPlan([
        {"subsystem": "replica", "mode": "error", "match": "r1",
         "after": 10 ** 9, "count": 1},
        {"subsystem": "fabric", "mode": "error", "match": "corrupt",
         "after": 10 ** 9, "count": 2}], seed=62)
    kill, corrupt = plan.rules
    torch.cuda.reset_peak_memory_stats()
    # phase 5's whole tree, resident before the fleet starts
    resident = torch.cuda.memory_allocated()
    path = "fleet (a) 3 replicas"
    zero()
    router = fleet_router(params, cfg, fleet={
        "replicas": 3, "digest_refresh_steps": 1, "retry_budget": 2},
        fabric={"capacity_bytes": 4 << 30}, faults=plan, **blocks)
    clock = _FleetClock(router)
    try:
        shared = all(
            a.data_ptr() == b.data_ptr()
            for rep in router.replicas.values()
            for a, b in zip(_leaves(rep.engine.params), _leaves(params)))
        if not shared:
            raise SystemExit("fleet: a replica holds its own weights")
        placed = clock.drive(wave1, FLEET_NEW)
        aff0 = router.statusz()["fleet"]["affinity"]["affinity_routed"]
        early, late = _split_wave(wave2)

        def arm_kill(n):
            # one router step into wave 2 the rest of it arrives and r1
            # dies at its next poll: its running requests (a token each)
            # fail typed, the ones it queued re-place
            if n == 1:
                for rid, p in late.items():
                    router.submit(rid, p, max_new_tokens=FLEET_NEW)
                    placed[rid] = router.requests[rid].replica
                kill.after = kill.seen
        placed.update(clock.drive(early, FLEET_NEW, arm=arm_kill))
        st = router.statusz()["fleet"]
        hits = st["affinity"]["affinity_routed"] - aff0
        fo = router.last_failover
        if router.replicas["r1"].state != "dead" or fo is None:
            raise SystemExit("fleet: the seeded kill of r1 did not fire")
        router.drain("r0")
        fab0 = dict(router.statusz()["fleet"]["fabric"])
        placed.update(clock.drive(probe_m, FLEET_NEW))
        fab1 = dict(router.statusz()["fleet"]["fabric"])
        if router.drained("r0") is not True:
            raise SystemExit("fleet: r0 did not finish draining")
        router.rejoin("r0")
        router.drain("r2")
        corrupt.after = corrupt.seen
        placed.update(clock.drive(probe_c, FLEET_NEW))
        fab2 = dict(router.statusz()["fleet"]["fabric"])
        router.rejoin("r2")
        out = {k: (list(v) if isinstance(v, list) else v)
               for k, v in router.finished.items()}
        ok, failed, shed = _typed_partition(out, prompts)
        launches[path] = counts()
        _check_bodies(path)
        _check_launches(path, launches[path], SERVING_KERNELS)
        _clean(router, path)
        crc_fail = sum(rep.engine.kv_tier_checksum_failures
                       for rep in router.replicas.values()
                       if rep.state != "dead")
        refills = sum(rep.engine.kv_tier_fallback_events
                      for rep in router.replicas.values()
                      if rep.state != "dead")
        peak = torch.cuda.max_memory_allocated()
        cache_bytes = 3 * router.replicas["r0"].engine.cache.k.numel() * 2 \
            * 2
        res["a"] = dict(
            clock.summary(), placed=placed, affinity_hits=hits,
            failover={"replica": fo["replica"],
                      "replaced": sorted(fo["resubmitted"]),
                      "failed_typed": sorted(fo["failed_typed"])},
            finished=len(ok), failed=len(failed), shed=len(shed),
            submitted=len(prompts),
            migration={"pages": fab1["migration_pages"]
                       - fab0["migration_pages"],
                       "migrations": fab1["migrations"] - fab0["migrations"],
                       "bytes": fab1["bytes_moved"] - fab0["bytes_moved"],
                       "ttft_ms": clock.ttft["m0"] * 1e3,
                       # the same prefix prefilled cold (wave 1, on its
                       # replica beside the two others' prefills)
                       "cold_prefill_ttft_ms": clock.ttft["w0"] * 1e3},
            corrupt={"reprefills": refills,
                     "corrupted": fab2["corrupted"],
                     "checksum_failures": crc_fail,
                     "ttft_ms": clock.ttft["c0"] * 1e3},
            peak_mem_gb=peak / 1e9, weight_gb=weight_bytes / 1e9,
            caches_gb=cache_bytes / 1e9)
        if res["a"]["migration"]["migrations"] < 1 or crc_fail < 1:
            raise SystemExit(f"fleet: migration {res['a']['migration']} / "
                             f"corrupt fallback {res['a']['corrupt']} "
                             "did not happen")
        if peak > resident + weight_bytes + cache_bytes:
            raise SystemExit(f"fleet: peak {peak / 1e9:.1f} GB counts the "
                             f"{weight_bytes / 1e9:.1f} GB of weights twice")
    finally:
        clock.unwrap()
        router.shutdown()
        del router, clock
        torch.cuda.empty_cache()
    want = _oracle(lambda: llama_serving_engine(params, cfg, **blocks),
                   [wave1, *_split_wave(wave2), probe_m, probe_c], FLEET_NEW)
    flips = _held_flips(params, cfg, llama.forward,
                        {k: v for k, v in out.items() if k in ok}, want,
                        prompts)
    res["a"]["flips"] = flips
    log(f"[fleet] (a) 3 replicas, one weight tree: finished "
        f"{res['a']['finished']} failed {res['a']['failed']} shed "
        f"{res['a']['shed']} of {res['a']['submitted']}; affinity hits "
        f"{hits}; failover {res['a']['failover']}; migration "
        f"{res['a']['migration']}; corrupt {res['a']['corrupt']}; router "
        f"host {res['a']['router_host_ms_per_step']:.2f} ms a step beside "
        f"replica steps of {res['a']['replica_step_ms']:.2f} ms; peak "
        f"{peak / 1e9:.1f} GB (weights {weight_bytes / 1e9:.1f} GB once, "
        f"caches {cache_bytes / 1e9:.1f} GB); near-tie flips {len(flips)} "
        f"on {card_line}; kernel launches {launches[path]}")

    # ---- (b) prefill -> decode handoff on the same traffic
    path = "fleet (b) roles 1 prefill + 2 decode"
    zero()
    router = fleet_router(params, cfg, fleet={
        "replicas": 3, "digest_refresh_steps": 1,
        "roles": {"prefill": 1, "decode": 2}},
        fabric={"capacity_bytes": 4 << 30}, **blocks)
    clock = _FleetClock(router)
    try:
        for wave in (wave1, *_split_wave(wave2), probe_m, probe_c):
            clock.drive(wave, FLEET_NEW)
        out_b = {k: (list(v) if isinstance(v, list) else v)
                 for k, v in router.finished.items()}
        ok_b, failed_b, shed_b = _typed_partition(out_b, prompts)
        launches[path] = counts()
        _check_bodies(path)
        _check_launches(path, launches[path], SERVING_KERNELS)
        _clean(router, path)
        fb = router.statusz()["fleet"]["fabric"]
        res["b"] = dict(clock.summary(), finished=len(ok_b),
                        failed=len(failed_b), shed=len(shed_b),
                        handoffs=fb["handoffs"], migrations=fb["migrations"],
                        migration_pages=fb["migration_pages"],
                        bytes_moved=fb["bytes_moved"],
                        ttft_ms_mean=float(np.mean(list(
                            clock.ttft.values()))) * 1e3)
        if fb["handoffs"] < 1 or failed_b or shed_b:
            raise SystemExit(f"{path}: {res['b']}")
    finally:
        clock.unwrap()
        router.shutdown()
        del router, clock
        torch.cuda.empty_cache()
    res["b"]["flips"] = _held_flips(params, cfg, llama.forward, out_b, want,
                                    prompts)
    # the same handoff on one engine with no fabric: (b)'s tokens against
    # it tell the decode leg's re-prefill of the tail (its own bf16
    # rounding) from the migrated bytes
    want_2 = _two_leg_oracle(
        lambda: llama_serving_engine(params, cfg, **blocks),
        [wave1, *_split_wave(wave2), probe_m, probe_c], FLEET_NEW)
    res["b"]["two_leg_vs_one_leg"] = sorted(
        k for k in prompts if want_2[k] != want[k])
    res["b"]["flips_two_leg"] = _held_flips(params, cfg, llama.forward,
                                            out_b, want_2, prompts,
                                            oracle="two-leg oracle")
    log(f"[fleet] (b) roles: finished {res['b']['finished']}/"
        f"{len(prompts)}, handoffs {res['b']['handoffs']}, migrations "
        f"{res['b']['migrations']} ({res['b']['migration_pages']} pages, "
        f"{res['b']['bytes_moved']} B through the fabric), ttft mean "
        f"{res['b']['ttft_ms_mean']:.1f} ms, router host "
        f"{res['b']['router_host_ms_per_step']:.2f} ms a step, near-tie "
        f"flips {len(res['b']['flips'])} against one engine, "
        f"{len(res['b']['flips_two_leg'])} against one engine serving both "
        f"legs (which differs from the one-leg engine on "
        f"{len(res['b']['two_leg_vs_one_leg'])}) on {card_line}; kernel "
        f"launches {launches[path]}")

    # ---- (c) the int8-resident arm: a migrated int8 chain is admitted
    path = "fleet (c) int8-resident migration"
    qblocks = dict(blocks, prefill_chunk=256, kv_tier={
        "quantize_cold": True, "quantized_resident": True,
        "host_pool_bytes": 4 << 30})
    qwave = {f"k{i}": p for i, p in enumerate(
        [wave1["w0"]] + [wave2[f"q0{i}"] for i in range(1, 4)])}
    first = {"k0": qwave.pop("k0")}
    zero()
    router = fleet_router(params, cfg, fleet={
        "replicas": 2, "digest_refresh_steps": 1},
        fabric={"capacity_bytes": 4 << 30}, **qblocks)
    clock = _FleetClock(router)
    try:
        clock.drive(first, FLEET_NEW)
        src = next(rid for rid, rep in router.replicas.items()
                   if rep.engine.warm_keys())
        router.drain(src)
        clock.drive(qwave, FLEET_NEW)
        router.rejoin(src)
        out_c = {k: (list(v) if isinstance(v, list) else v)
                 for k, v in router.finished.items()}
        _typed_partition(out_c, {**first, **qwave})
        launches[path] = counts()
        _check_bodies(path)
        _check_launches(path, launches[path],
                        ("paged_attention_quant", "greedy_argmax",
                         "quantize"))
        _clean(router, path)
        fb = router.statusz()["fleet"]["fabric"]
        promotes = sum(rep.engine.kv_tier_quant_resident_promotes
                       for rep in router.replicas.values())
        res["c"] = dict(migrations=fb["migrations"],
                        migration_pages=fb["migration_pages"],
                        bytes_moved=fb["bytes_moved"],
                        quant_resident_promotes=promotes)
        if fb["migrations"] < 1 or promotes < 1:
            raise SystemExit(f"{path}: no int8 chain was admitted "
                             f"{res['c']}")
    finally:
        clock.unwrap()
        router.shutdown()
        del router, clock
        torch.cuda.empty_cache()
    want_c = _oracle(lambda: llama_serving_engine(params, cfg, **qblocks),
                     [first, qwave], FLEET_NEW)
    res["c"]["flips"] = _held_flips(params, cfg, llama.forward, out_c,
                                    want_c, {**first, **qwave})
    log(f"[fleet] (c) int8-resident: {res['c']} on {card_line}; kernel "
        f"launches {launches[path]}")
    _phase_line(62, card_line, **{k: {kk: vv for kk, vv in v.items()
                                      if kk != "placed"}
                                  for k, v in res.items()})
    return launches


def _leaves(tree):
    from deepspeed_tpu_torch._tree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _proc_spec():
    return {"model": dict(PROC_MODEL),
            "engine": dict(max_batch=8, page_size=16, max_seq=1024,
                           num_pages=513, prefill_bucket=128,
                           cache_dtype="bfloat16", prefix_cache={},
                           kv_tier={"host_pool_bytes": 2 << 30}),
            "seed": PROC_SEED, "dtype": "bfloat16", "device": "cuda",
            "fabric": {"capacity_bytes": 2 << 30}}


def phase_proc_fleet(fns, card_line):
    """Phase 63: the out-of-process fleet.  Two children (``python -m
    deepspeed_tpu_torch.replica_child``) share the card, r0 over the shm
    ring pair and r1 over TCP; each builds Llama-3-8B at full width and 8
    layers from ``(config, seed)``.  The router (this process) sends 16
    prompts: a migration child -> router fabric -> child on an affinity
    miss, then a SIGKILL of r1 mid-traffic (the seconds from the signal to
    the failover recorded); ``RemoteReplica`` scrapes each child's
    ``/statusz``, ``/healthz`` and ``/tracez``, and the trace is merged
    with the estimated clock offset.  Gates: every request's tokens equal
    an in-process engine's built from the same ``(config, seed)`` (near
    ties held to FLEET_TIE_REL_TOL), or it failed typed; the survivor's
    ``check_leaks()`` is empty; no child is left running.  The children
    report their own launches (the ``launches`` verb), B1, B5 and B6 among
    them.  Returns the launches and phase 64's weights (this phase's
    in-process model)."""
    import signal

    from deepspeed_tpu_torch.inference.serving import llama_serving_engine
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.obs_wire import FRESH, merge_trace_segments
    from deepspeed_tpu_torch.proc_fleet import proc_fleet_router
    from deepspeed_tpu_torch.replica_child import model_config
    from deepspeed_tpu_torch.weights import init_params

    spec = _proc_spec()
    cfg = model_config(spec["model"])
    rng = np.random.default_rng(63)
    pref = rng.integers(1, cfg.vocab_size, 384).tolist()
    shared = [pref + rng.integers(1, cfg.vocab_size, int(n)).tolist()
              for n in rng.integers(32, 129, 4)]
    rest = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(64, 513, 12)]
    warm = {"p0": shared[0]}
    spread = {f"p{i}": shared[i] for i in (1, 2, 3)}
    tail = {f"u{i}": p for i, p in enumerate(rest)}
    prompts = {**warm, **spread, **tail}
    path = "proc fleet (2 children)"
    t0 = time.perf_counter()
    router = proc_fleet_router(
        spec, proc_fleet={"replicas": 2, "spawn_timeout_s": 400,
                          "poll_timeout_s": 60.0, "attach_scrape": True},
        # a migrated chain of 24 pages of 0.5 MiB crosses in one frame:
        # the rings hold 64 MiB a direction
        transport=[{"kind": "shm", "slot_bytes": 1 << 20, "ring_slots": 64},
                   {"kind": "tcp"}],
        fleet={"replicas": 2, "affinity": False, "digest_refresh_steps": 1,
               "retry_budget": 2}, fabric={"capacity_bytes": 2 << 30},
        tracing={"sample_rate": 1.0})
    spawn_s = time.perf_counter() - t0
    procs = {rid: rep.engine.proc for rid, rep in router.replicas.items()}
    res = {"spawn_s": spawn_s}
    child_launches = {}
    try:
        kinds = [rep.engine.chan.endpoint.kind
                 for rep in router.replicas.values()]
        if kinds != ["shm", "tcp"]:
            raise SystemExit(f"proc fleet: transports {kinds}")
        clock = _FleetClock(router)
        clock.drive(warm, PROC_NEW)
        clock.drive(spread, PROC_NEW)
        fb = router.statusz()["fleet"]["fabric"]
        res["migration"] = {k: fb[k] for k in (
            "migrations", "migration_pages", "bytes_moved",
            "migration_fallbacks")}
        if fb["migrations"] < 1:
            raise SystemExit(f"proc fleet: no migration {fb}")
        kill_t = []

        def arm(n):
            # SIGKILL r1 once its last poll reply shows a request past its
            # first token (mid-generation: the children step on their own
            # between the router's polls)
            rep = router.replicas["r1"].engine
            if not kill_t and any(g > 0 for g in rep._active.values()):
                child_launches["r1"] = rep.chan.request(
                    {"op": "launches"}, timeout_s=60)[0]["launches"]
                kill_t.append(router.kill_child("r1", signal.SIGKILL))
        clock.drive(tail, PROC_NEW, arm=arm)
        fo = router.last_failover
        if fo is None or fo["replica"] != "r1":
            raise SystemExit(f"proc fleet: no failover of r1 ({fo})")
        res["failover_s"] = fo["t"] - kill_t[0]
        res["failover"] = {"replaced": sorted(map(str, fo["resubmitted"])),
                           "failed_typed": sorted(map(str,
                                                      fo["failed_typed"]))}
        out = {k: (list(v) if isinstance(v, list) else v)
               for k, v in router.finished.items()}
        ok, failed, shed = _typed_partition(out, prompts)
        for rid, (reason, _) in failed.items():
            if reason != "replica_failed":
                raise SystemExit(f"proc fleet: {rid} failed {reason}")
        survivor = router.replicas["r0"].engine
        child_launches["r0"] = survivor.chan.request(
            {"op": "launches"}, timeout_s=60)[0]["launches"]
        leaks = survivor.check_leaks()
        if leaks or router.orphaned():
            raise SystemExit(f"proc fleet: survivor leaks {leaks} orphans "
                             f"{router.orphaned()}")
        rem = router.remotes["scrape-r0"]
        deadline = time.monotonic() + 30
        while rem.state != FRESH and time.monotonic() < deadline:
            rem.poll()
            time.sleep(0.05)
        health = rem.healthz()
        evs, meta = rem.fetch_trace(since=0)
        off, err = rem.estimate_clock_offset()
        merged = merge_trace_segments([{"events": evs, "offset_ns": off,
                                        "err_ns": err, "replica": "r0"}])
        ts = [e["ts"] for e in merged["traceEvents"] if "ts" in e]
        if rem.state != FRESH or not evs or ts != sorted(ts) or \
                not health.get("ready"):
            raise SystemExit(f"proc fleet: scrape {rem.state} events "
                             f"{len(evs)} health {health}")
        res["scrape"] = {"state": rem.state, "trace_events": len(evs),
                         "clock_offset_ns": off, "offset_err_ns": err,
                         "merged_events": len(merged["traceEvents"])}
        res.update(clock.summary())
        res.update(finished=len(ok), failed=len(failed), shed=len(shed))
        clock.unwrap()
    finally:
        router.shutdown()
    alive = [rid for rid, p in procs.items() if p.poll() is None]
    if alive:
        raise SystemExit(f"proc fleet: children {alive} still running")
    launches = {path: {n: sum(c.get(n, 0) for c in child_launches.values())
                       for n in fns}}
    res["child_launches"] = child_launches
    _check_launches(path, launches[path], SERVING_KERNELS)
    # the oracle: an engine in this process from the same (config, seed)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(
        PROC_SEED), device="cuda", dtype=torch.bfloat16)
    eng_kw = dict(spec["engine"], cache_dtype=torch.bfloat16,
                  device="cuda")
    want = _oracle(lambda: llama_serving_engine(params, cfg, **eng_kw),
                   [warm, spread, tail], PROC_NEW)
    res["flips"] = _held_flips(params, cfg, llama.forward,
                               {k: out[k] for k in ok}, want, prompts)
    log(f"[proc fleet] 2 children (shm, tcp), Llama-3-8B {PROC_LAYERS} "
        f"layers: spawned in {spawn_s:.1f} s; {res} on {card_line}; kernel "
        f"launches {launches[path]}")
    _phase_line(63, card_line, **res)
    return launches, params, cfg


def phase_elastic(fns, card_line, zi_params, zi_cfg):
    """Phase 64: the elastic fleet.  (a) GPT-2 1.3B at all 24 layers, bf16:
    the autoscaler grows a one-replica fleet to three on a burst of 24
    prompts and back to one when idle, then rolls out a second seeded
    weight version through drain -> ``swap_params`` -> rejoin while 12
    more prompts arrive.  Gates: every request ran on one version (each
    router step reads the version of the replica holding it) and its
    tokens equal a fresh engine's on that version's weights (near ties
    held to FLEET_TIE_REL_TOL).  (b) A streamed cold start: a fleet of one
    resident Llama-3-8B replica at 8 layers (phase 63's weights) scales up
    a ZeRO-Inference replica streaming its layers from a host copy; it
    serves, ``promote_resident_layers`` runs to its flip.  Gate: its tokens
    equal the resident engine's.  Cold-start, first-token and flip seconds
    are logged."""
    from deepspeed_tpu_torch.autoscale import FleetAutoscaler
    from deepspeed_tpu_torch.fleet import fleet_router
    from deepspeed_tpu_torch.inference.serving import serving_engine
    from deepspeed_tpu_torch.models import gpt2, llama
    from deepspeed_tpu_torch.telemetry import MetricsRegistry
    from deepspeed_tpu_torch.weights import init_params

    launches, res = {}, {}
    # ---- (a) scale and roll out, GPT-2 1.3B
    cfg = gpt2.GPT2Config.gpt2_1_3b()
    v1, v2 = (init_params(cfg, torch.Generator("cuda").manual_seed(s),
                          device="cuda", dtype=torch.bfloat16)
              for s in ELASTIC_SEEDS)
    opts = dict(max_batch=8, page_size=16, max_seq=512, num_pages=257,
                prefill_bucket=64, cache_dtype=torch.bfloat16,
                prefix_cache={}, device="cuda")
    rng = np.random.default_rng(64)
    burst = {f"b{i}": rng.integers(1, cfg.vocab_size, int(n)).tolist()
             for i, n in enumerate(rng.integers(64, 257, 24))}
    during = {f"v{i}": rng.integers(1, cfg.vocab_size, int(n)).tolist()
              for i, n in enumerate(rng.integers(64, 257, 12))}
    path = "elastic (a) GPT-2 1.3B scale + rollout"
    _zero(fns.values())
    router = fleet_router(v1, cfg, fleet={"replicas": 1},
                          tracing={"ring_capacity": 16384}, **opts)

    def factory(rid, streamed=False):
        return serving_engine(v1, cfg, replica_id=rid, tracing=router.tracer,
                              telemetry=MetricsRegistry(
                                  namespace=f"dstpu_{rid}"), **opts)

    auto = FleetAutoscaler(router, factory, autoscale={
        **ELASTIC_FAST, "rollout_soak_steps": 1})
    versions = {}
    live_max = [1]

    def note():
        """Each running request's replica version (a queued one has run
        on none yet), and the most replicas live at once."""
        live = [rep for rep in router.replicas.values()
                if rep.state != "dead"]
        live_max[0] = max(live_max[0], len(live))
        for rep in live:
            for s in rep.engine.slots:
                if s is not None:
                    versions.setdefault(s.req.req_id, set()).add(
                        str(rep.version))

    def step():
        auto.step()
        note()

    try:
        t0 = time.perf_counter()
        for rid, p in burst.items():            # all at once: a burst
            router.submit(rid, p, max_new_tokens=ELASTIC_NEW)
        for _ in range(200):
            step()
            if auto.status()["live_replicas"] >= 3 or not router.has_work:
                break
        # the burst grew the fleet; the rollout walks it while it serves
        # (draining a lone replica would leave no capacity)
        grown = auto.status()["live_replicas"]
        auto.rollout(v2, version="v2")
        for rid, p in during.items():
            router.submit(rid, p, max_new_tokens=ELASTIC_NEW)
        steps = 0
        while router.has_work or auto.rollout_active:
            step()
            steps += 1
            if steps > 100_000:
                raise SystemExit("elastic: the rollout did not converge")
        served_s = time.perf_counter() - t0
        for _ in range(200):
            step()
            if auto.status()["live_replicas"] == 1 and \
                    not router.has_work:
                break
        down = auto.status()
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        _check_launches(path, launches[path], SERVING_KERNELS)
        _clean(router, path)
        out = {k: (list(v) if isinstance(v, list) else v)
               for k, v in router.finished.items()}
        ok, failed, shed = _typed_partition(out, {**burst, **during})
        st = auto.status()
        last = auto.last_rollout or {}
        res["a"] = {"live_max": live_max[0], "live_at_rollout": grown,
                    "live_after_idle": down["live_replicas"],
                    "scale_ups": st["scale_ups"],
                    "scale_downs": st["scale_downs"],
                    "rollout_completed": last.get("completed"),
                    "rolled_back": last.get("rolled_back"),
                    "burst_and_rollout_s": served_s,
                    "finished": len(ok), "failed": len(failed),
                    "shed": len(shed),
                    "events": [e["kind"] for e in auto.events]}
        mixed = {k: sorted(v) for k, v in versions.items() if len(v) != 1}
        if live_max[0] < 3 or grown < 2 or down["live_replicas"] != 1 or \
                mixed or \
                not last.get("completed") or failed or shed:
            raise SystemExit(f"elastic (a): {res['a']} mixed {mixed}")
    finally:
        router.shutdown()
        del router, auto
        torch.cuda.empty_cache()
    tags = {k: next(iter(v)) for k, v in versions.items()}
    if set(tags) != ok:
        # every finished request was seen in a slot on exactly one
        # version (``mixed`` is empty): none escapes the version gate
        raise SystemExit(f"elastic (a): finished but never seen in a slot "
                         f"{sorted(ok - set(tags))}, seen but not finished "
                         f"{sorted(set(tags) - ok)}")
    want = {}
    for tag, w in (("0", v1), ("v2", v2)):
        mine = {k: p for k, p in {**burst, **during}.items()
                if tags.get(k) == tag}
        if mine:
            got = _oracle(lambda: serving_engine(w, cfg, **opts), [mine],
                          ELASTIC_NEW)
            flips = _held_flips(w, cfg, gpt2.forward,
                                {k: out[k] for k in mine}, got, mine)
            res["a"][f"tagged_{tag}"] = len(mine)
            res["a"][f"flips_{tag}"] = flips
            want.update(got)
    if not res["a"].get("tagged_v2"):
        raise SystemExit("elastic (a): no request ran on v2")
    log(f"[elastic] (a) GPT-2 1.3B 24 layers: {res['a']} on {card_line}; "
        f"kernel launches {launches[path]}")
    del v1, v2
    torch.cuda.empty_cache()

    # ---- (b) a streamed cold start of a ZeRO-Inference replica
    path = "elastic (b) streamed cold start"
    host = {k: (v if k != "blocks" else
                {n: t.to("cpu") for n, t in v.items()})
            for k, v in zi_params.items()}
    zopts = dict(max_batch=8, page_size=16, max_seq=1024, num_pages=513,
                 prefill_bucket=128, cache_dtype=torch.bfloat16,
                 prefix_cache={}, device="cuda")
    queue = {f"z{i}": rng.integers(1, zi_cfg.vocab_size,
                                   int(n)).tolist()
             for i, n in enumerate(rng.integers(64, 513, 16))}
    _zero(fns.values())
    router = fleet_router(zi_params, zi_cfg, fleet={"replicas": 1},
                          tracing={"ring_capacity": 16384}, **zopts)
    spawned = []

    def zi_factory(rid, streamed=False):
        zi = {"enabled": True, "tier": "host"} if streamed else None
        eng = serving_engine(host if streamed else zi_params, zi_cfg,
                             replica_id=rid, zero_inference=zi,
                             tracing=router.tracer,
                             telemetry=MetricsRegistry(
                                 namespace=f"dstpu_{rid}"), **zopts)
        spawned.append(eng)
        return eng

    auto = FleetAutoscaler(router, zi_factory, autoscale={
        **ELASTIC_FAST, "cold_start": "streamed",
        "promote_layers_per_tick": 1, "down_after": 10 ** 6})
    try:
        for rid, p in queue.items():
            router.submit(rid, p, max_new_tokens=ELASTIC_NEW)
            auto.step()
        steps = 0
        while router.has_work or any(
                not getattr(e, "fully_resident", True) for e in spawned):
            auto.step()
            steps += 1
            if steps > 100_000:
                raise SystemExit("elastic (b): the flip did not land")
        launches[path] = {n: f.launches for n, f in fns.items()}
        _check_bodies(path)
        _check_launches(path, launches[path], SERVING_KERNELS)
        _clean(router, path)
        out = {k: (list(v) if isinstance(v, list) else v)
               for k, v in router.finished.items()}
        ok, failed, shed = _typed_partition(out, queue)
        cold = [dict(c) for c in auto.cold_history]
        zi_rows = [e.statusz()["zero_inference"] for e in spawned]
        st = auto.status()
        res["b"] = {"scale_ups": st["scale_ups"],
                    "cold_flips": st["cold_flips"], "cold_history": cold,
                    "zi": [{k: z[k] for k in ("n_streamed_now",
                                              "n_resident_now",
                                              "fully_resident",
                                              "layer_sweeps",
                                              "bytes_uploaded")}
                           for z in zi_rows],
                    "finished": len(ok), "failed": len(failed)}
        if st["cold_flips"] < 1 or not spawned or failed or shed or \
                not all(e.fully_resident for e in spawned):
            raise SystemExit(f"elastic (b): {res['b']}")
    finally:
        router.shutdown()
        del router, auto
        spawned.clear()
        torch.cuda.empty_cache()
    want = _oracle(lambda: serving_engine(zi_params, zi_cfg, **zopts),
                   [queue], ELASTIC_NEW)
    res["b"]["flips"] = _held_flips(zi_params, zi_cfg, llama.forward,
                                    {k: out[k] for k in ok}, want, queue)
    log(f"[elastic] (b) streamed cold start, Llama-3-8B {PROC_LAYERS} "
        f"layers: {res['b']} on {card_line}; kernel launches "
        f"{launches[path]}")
    _phase_line(64, card_line, **res)
    return launches


# ------------------------------------------------------------ phases 65-67
# DeepSpeed's fp16 mode on the card: the float16 bodies of B1-B3 and B5's
# fp16 q over bf16 pages (65), Llama training at phase 8's widths under
# dynamic loss scaling and the fp16 hybrid's rollouts (66), GPT-2 1.3B and
# BERT-large under it (67).  DeepSpeed's documented fp16 defaults:
FP16_DEFAULTS = {"enabled": True, "initial_scale_power": 16,
                 "loss_scale_window": 1000, "hysteresis": 2,
                 "min_loss_scale": 1}
# the kernels a plain-attention twin must not launch
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# phase 65's gates, from the card's readings (an NVIDIA H100 80GB HBM3 at
# 700.00 W): B1's o 4.9e-4 to 9.8e-4 (one or two fp16 ulps of |o| in
# [1, 2)), B2 1.3e-4 to 2.8e-4 of each gradient's largest value, B3 5.3e-4
# to 8.1e-4 (P and dS rounded to fp16 once, as the Pallas kernel does,
# where the plain version multiplies them in f32), B5 decode 1.2e-4; each
# below the ~1e-2 shift that dropping one key of a long row makes, the
# backward under C-f6's rule (an element over the gate must be an fp16
# neighbour of the f64 oracle)
FP16_FLASH_TOL = 4e-3
FP16_FLASH_BWD_REL_TOL = 1e-3
FP16_PAGED_DECODE_TOL = 1e-3
# B5's chunk holds |o| up to ~3, where two fp16 ulps are 3.9e-3; it read
# 9.8e-4 largest and 1.7e-7 mean.  The control, the plain version over q
# rounded to bf16 (the Hopper chunk without its hi + lo split of q), read
# 4.9e-3 largest and 1.1e-4 mean, and must fail the gate
FP16_PAGED_CHUNK_TOL = 4e-3
FP16_PAGED_CHUNK_MEAN_TOL = 2e-5
# phase 66: phase 8's run under FP16_DEFAULTS against phase 8's bf16 losses
# (the same weights and batch; fp16 rounds 3 bits finer), and against its
# twin on attn_impl="reference" (the same fp16 model, plain attention); the
# overflow run starts at 2^FP16_OVERFLOW_POWER and steps until the scaler
# has backed off to a step it takes (at most FP16_OVERFLOW_STEPS; the card
# read 14 overflows, 2^32 down to 2^19, and took the 15th step at 2^18).
# The losses' bounds were set before the first reading; the card read
# 1.4e-3 (bf16) and 1.8e-4 (the twin)
FP16_VS_BF16_RTOL = 1e-2
FP16_TWIN_RTOL = 1e-2
FP16_OVERFLOW_POWER, FP16_OVERFLOW_STEPS = 32, 20
# phase 67: GPT-2 1.3B (micro 8 x 1024) and BERT-large (micro 8 x 512)
# under FP16_DEFAULTS at FP16_MODEL_LAYERS layers, full widths, against their
# plain-attention twins; the hybrid's fp16 rollouts (phase 36's prompts) over
# the paged cache against the dense one's at near-ties of FP16_TIE_REL_TOL
# of a row's max |logit|
FP16_MODEL_LAYERS, FP16_MODEL_STEPS = 4, 4
FP16_TIE_REL_TOL = 1e-2


def _fp16_fwd_case(q, k, v, seg, causal, pairs, tag):
    """B1 in fp16 against its plain version on one shape: the error, the
    device time beside the bound (over ``pairs`` live pairs of one row and
    head) and SDPA's fp16 forward under the same mask."""
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_fwd,
                                                        flash_fwd_body,
                                                        flash_fwd_reference)

    B, T, H, D = q.shape
    KV = k.shape[2]
    if flash_fwd_body(q) != "wgmma":
        raise SystemExit(f"phase 65: {tag} does not take the tensor-core "
                         "body in fp16")
    o, lse = flash_fwd(q, k, v, causal=causal, seg=seg)
    ro, rlse = flash_fwd_reference(q, k, v, causal=causal, seg=seg)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lerr = (lse - rlse).abs().max().item()
    fn = functools.partial(flash_fwd, q, k, v, causal=causal, seg=seg)
    dev = device_ms(fn)
    plain = time_ms(lambda: flash_fwd_reference(q, k, v, causal=causal,
                                                seg=seg), iters=3, warmup=1)
    sdpa = _sdpa(q, k, v, seg, causal=causal)
    lib = sdpa and device_ms(sdpa)
    b_ms, b_by = _flash_bound(B, T, H, KV, D, pairs)
    log(f"[fp16 kernels] flash_fwd {tag} B={B} T={T} H={H} KV={KV} D={D} "
        f"fp16: tensor-core body; max_abs_err {err:.3e} (tol "
        f"{FP16_FLASH_TOL}) lse_err {lerr:.3e} (tol 1e-3); device {dev} ms "
        f"(bound {b_ms:.5f} ms {b_by}, share {_share(b_ms, dev)}); plain "
        f"{plain:.4f} ms; sdpa fp16 device {lib} ms")
    if err > FP16_FLASH_TOL or lerr > 1e-3:
        raise SystemExit(f"phase 65: flash_fwd {tag} disagrees in fp16")
    return {"max_abs_err": err, "lse_err": lerr, "device_ms": dev,
            "plain_ms": plain, "library_device_ms": lib,
            "library": "sdpa fp16 under the same mask", "bound_ms": b_ms,
            "bound_by": b_by, "bound_share": _share(b_ms, dev)}


def _fp16_rounding_check(q, k, v, seg):
    """B3's fp16 arithmetic (P and dS rounded once to fp16, as the Pallas
    kernel does), measured: the kernel's dK and dV against the f64 oracle,
    beside that one rounding with f64 sums (and written to fp16, as the
    kernel stores them) and the outputs' own fp16 rounding (the floor);
    each the largest |error| over the largest |exact value|."""
    from deepspeed_tpu_torch.ops.attention_cuda import (flash_bwd_dkv,
                                                        flash_bwd_dq,
                                                        flash_fwd)

    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(
        65), device="cuda").to(q.dtype)
    o, lse = flash_fwd(q, k, v, seg=seg)
    _, delta = flash_bwd_dq(q, k, v, o, do, lse, seg)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seg)
    _, _, dk64, dv64, dk1, dv1 = flash_bwd_f64_oracle(q, k, v, o, lse, do,
                                                      seg, once=True)
    rel = lambda a, x: ((a.double() - x).abs().max() / x.abs().max()).item()
    out = {g: {"kernel": rel(got, x), "one_rounding": rel(one, x),
               "one_rounding_written": rel(one.to(q.dtype), x),
               "output_rounding": rel(x.to(q.dtype), x)}
           for g, got, one, x in (("dk", dk, dk1, dk64), ("dv", dv, dv1,
                                                          dv64))}
    log(f"[fp16 kernels] B3's one rounding of P and dS at T={q.shape[1]} "
        f"against the f64 oracle (largest |error| over the largest "
        f"|exact|): {out}")
    return out


def phase_fp16_kernels(gen):
    """Phase 65: B1, B2 and B3 in fp16 against their plain versions on the
    tensor-core bodies at Llama's training shape (T = 2047, causal, and with
    3 packed segments), GPT-2 1.3B's (B 8, T 1024, 16 heads of 128, causal)
    and BERT-large's (B 8, T 512, 16 heads of 64, pad ids), and B5 with an
    fp16 q over bf16 pages at phase 3's decode and C = 256 chunk; each timed
    on the device clock beside its bound and SDPA's fp16 call; B3's one
    rounding of P and dS measured against the f64 oracle.  Returns each kernel's fp16 cases."""
    from deepspeed_tpu_torch.inference.paged_attention_cuda import (
        paged_attention_reference, paged_body, paged_chunk_attention,
        paged_chunk_attention_reference, paged_decode_attention)

    dt = torch.float16
    fwd, bwd = {}, {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def backward(label, q, k, v, seg, lens, causal, pairs):
        for name, case in _bert_flash_bwd(
                gen, q, k, v, rand(*q.shape), seg, lens, "fp16 kernels",
                causal=causal, tol=FP16_FLASH_BWD_REL_TOL,
                pairs=pairs).items():
            bwd[name][label] = case
            if not (case["wgmma"] and case.get("delta_rel", 0.0)
                    <= FLASH_DELTA_REL_TOL and (
                        case["rel_err"] <= FP16_FLASH_BWD_REL_TOL
                        or case["over_gate_faithful"])):
                raise SystemExit(f"phase 65: {name} {label} disagrees in "
                                 "fp16")

    # Llama's training shape
    B, T, H, KV, D = 1, 2047, 32, 8, 128
    q, k, v = rand(B, T, H, D), rand(B, T, KV, D), rand(B, T, KV, D)
    for label, nseg in (("llama T2047 causal", 0),
                        ("llama T2047 + 3 segments", 3)):
        seg, lens = _segments(T, nseg) if nseg else (None, [T])
        pairs = sum(n * (n + 1) // 2 for n in lens)
        fwd[label] = _fp16_fwd_case(q, k, v, seg, True, pairs, label)
        backward(label, q, k, v, seg, lens if nseg else None, True,
                 B * pairs)
    rounding = _fp16_rounding_check(q, k, v, None)
    del q, k, v
    torch.cuda.empty_cache()
    # GPT-2 1.3B's (its training micro-batch of phase 19)
    B, T, H, D = 8, 1024, 16, 128
    q, k, v = rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D)
    fwd["gpt2-1.3b B8 T1024"] = _fp16_fwd_case(q, k, v, None, True,
                                               T * (T + 1) // 2, "gpt2-1.3b")
    backward("gpt2-1.3b B8 T1024", q, k, v, None, None, True, None)
    del q, k, v
    # BERT-large's (phase 26's micro-batch), pad ids, one filler row
    B, T, H, D = 8, 512, 16, 64
    rng = np.random.default_rng(65)
    lens = [int(n) for n in rng.integers(128, T + 1, B - 1)] + [0]
    seg = _pad_seg(lens, T)
    q, k, v = rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D)
    fwd["bert-large B8 T512 pad ids"] = _fp16_fwd_case(
        q, k, v, seg, False, _pad_pairs(lens, T) / B, "bert-large")
    backward("bert-large B8 T512 pad ids", q, k, v, seg, lens, False, None)
    del q, k, v
    torch.cuda.empty_cache()

    # B5: an fp16 q over bf16 pages (the fp16 model's paged generator)
    H, KV, D, ps = 32, 8, 128, 16
    lens = [0, 128, 256, 400, 512, 700, 900, 1024]
    kp, vp, table = _paged_inputs(gen, lens, 1)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = rand(8, H, D)
    if paged_body(q) != "sm90":
        raise SystemExit("phase 65: an fp16 q does not take B5's Hopper body")
    out = paged_decode_attention(q, kp, vp, table, seq)
    ref = paged_attention_reference(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    q1, st1 = q[:, None], seq - 1
    dev = device_ms(lambda: paged_chunk_attention(q1, kp, vp, table, st1))
    plain = time_ms(lambda: paged_attention_reference(q, kp, vp, table,
                                                      seq), iters=5)
    live = sum(lens)
    b_ms, b_by = bound(2 * live * KV * D * 2 + 2 * 2 * 8 * H * D,
                       4 * live * H * D, BF16_FLOPS_PER_S)
    paged = {"decode B8 lens 0-1024": {
        "dtype": "fp16 q, bf16 pages", "max_abs_err": err, "device_ms": dev,
        "plain_ms": plain, "library_device_ms": None, "bound_ms": b_ms,
        "bound_by": b_by, "bound_share": _share(b_ms, dev),
        "out_dtype": str(out.dtype)}}
    ok = err <= FP16_PAGED_DECODE_TOL and out.dtype == dt and \
        not out[0].any()
    del kp, vp, table, out, ref
    C = 256
    starts = [0, 128, 256, 300, 512, 600, 700, 768]
    kp, vp, table = _paged_inputs(gen, starts, C)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    qc = rand(8, C, H, D)
    oc = paged_chunk_attention(qc, kp, vp, table, st)
    rc = paged_chunk_attention_reference(qc, kp, vp, table, st)
    # the control: q's split dropped
    ctl = (paged_chunk_attention_reference(qc.to(torch.bfloat16).to(dt), kp,
                                           vp, table, st).float()
           - rc.float()).abs()
    torch.cuda.synchronize()
    err_c = (oc.float() - rc.float()).abs().max().item()
    mean_c = (oc.float() - rc.float()).abs().mean().item()
    ctl_max, ctl_mean = ctl.max().item(), ctl.mean().item()
    del ctl
    caught = ctl_max > FP16_PAGED_CHUNK_TOL or \
        ctl_mean > FP16_PAGED_CHUNK_MEAN_TOL
    dev_c = device_ms(lambda: paged_chunk_attention(qc, kp, vp, table, st))
    plain_c = time_ms(lambda: paged_chunk_attention_reference(
        qc, kp, vp, table, st), iters=3)
    pairs = sum(s * C + C * (C + 1) // 2 for s in starts)
    bc_ms, bc_by = bound(2 * sum(s + C for s in starts) * KV * D * 2
                         + 2 * 2 * 8 * C * H * D, 4 * pairs * H * D,
                         BF16_FLOPS_PER_S)
    paged["chunk B8 C256 starts 0-768"] = {
        "dtype": "fp16 q, bf16 pages", "max_abs_err": err_c,
        "mean_abs_err": mean_c, "control_q_bf16": {
            "max_abs_err": ctl_max, "mean_abs_err": ctl_mean,
            "fails_the_gate": caught},
        "device_ms": dev_c, "plain_ms": plain_c, "library_device_ms": None,
        "bound_ms": bc_ms, "bound_by": bc_by,
        "bound_share": _share(bc_ms, dev_c)}
    ok = ok and err_c <= FP16_PAGED_CHUNK_TOL and \
        mean_c <= FP16_PAGED_CHUNK_MEAN_TOL and caught and oc.dtype == dt
    log(f"[fp16 kernels] paged_attention fp16 q over bf16 pages: decode "
        f"max_abs_err {err:.3e} (tol {FP16_PAGED_DECODE_TOL}) device {dev} "
        f"ms (bound {b_ms:.5f} ms {b_by}, share {_share(b_ms, dev)}) plain "
        f"{plain:.4f} ms; chunk C={C} max_abs_err {err_c:.3e} (tol "
        f"{FP16_PAGED_CHUNK_TOL}) mean {mean_c:.3e} (tol "
        f"{FP16_PAGED_CHUNK_MEAN_TOL}), the control (q rounded to bf16) "
        f"{ctl_max:.3e} / {ctl_mean:.3e} fails the gate: {caught}; "
        f"device {dev_c} ms (bound {bc_ms:.5f} ms "
        f"{bc_by}, share {_share(bc_ms, dev_c)}) plain {plain_c:.4f} ms")
    del kp, vp, table, qc, oc, rc
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("phase 65: B5 with an fp16 q disagrees with its "
                         "plain version")
    return {"flash_fwd": fwd, "flash_bwd_dq": bwd["flash_bwd_dq"],
            "flash_bwd_dkv": dict(bwd["flash_bwd_dkv"], rounding=rounding),
            "paged_attention": paged}


def _fp16_run(fns, path, loss_fn, params, conf, batch, steps, kernels=True,
              until_taken=False):
    """``steps`` train steps of a fresh engine over ``params`` under
    ``conf`` (fused Adam): each step's loss, overflow flag, loss scale and
    host ms, the peak memory, the launches (zeroed just before; a kernel arm
    checks its bodies, a plain-attention twin that B1, B2 and B3 never
    launched).  ``until_taken``: stop after the first step the scaler
    takes.  Returns (rows, launches, engine, peak GB)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops.adam_cuda import fused_adam

    eng = initialize(loss_fn=loss_fn, params=params, config=conf,
                     optimizer=fused_adam(lr=_warmup(), weight_decay=0.1))[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(fns.values())
    rows = []
    for _ in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        loss = float(eng.train_batch(batch))
        ms = (time.perf_counter() - ts) * 1e3
        rows.append({"loss": loss, "overflow": eng.metrics["overflow"],
                     "scale": eng.metrics["loss_scale"], "ms": ms})
        if until_taken and not rows[-1]["overflow"]:
            break
    used = {n: f.launches for n, f in fns.items()}
    if kernels:
        _check_bodies(path)
        _check_fp16(path)
    elif any(used[n] for n in FLASH_NAMES):
        raise SystemExit(f"{path}: the plain-attention twin launched the "
                         f"flash kernels: {used}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[fp16] {path}: losses {[round(r['loss'], 4) for r in rows]} "
        f"overflow {[r['overflow'] for r in rows]} scale "
        f"{[r['scale'] for r in rows]} ms/step "
        f"{[round(r['ms'], 1) for r in rows]} peak {peak:.1f} GB; launches "
        f"{used}")
    return rows, used, eng, peak


def _same_skips(tag, rows, twin, rtol):
    """The kernel arm's overflow flags and scales equal its twin's, step by
    step, and its losses within ``rtol`` of the twin's."""
    flags = [(r["overflow"], r["scale"]) for r in rows]
    want = [(r["overflow"], r["scale"]) for r in twin]
    worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(rows, twin))
    log(f"[fp16] {tag}: overflow / scale {flags} (twin {want}); losses "
        f"within {worst:.3e} of the twin's (tol {rtol})")
    if flags != want or worst > rtol:
        raise SystemExit(f"{tag}: the kernels' fp16 run departs from its "
                         "plain-attention twin")
    return worst


def _check_fp16(path):
    """Every launch of B1, B2, B3 and B5 on ``path`` took an fp16 q."""
    for name, per in DTYPES.items():
        got = per[path]
        if sum(got.values()) != got["float16"]:
            raise SystemExit(f"{path}: {name} launches by dtype {got}, "
                             "expected only float16")


# the kernels line's fp16 rows: each kernel's phase 65 case at Llama's shape
FP16_ROW_CASES = {"flash_fwd": "llama T2047 causal",
                  "flash_bwd_dq": "llama T2047 causal",
                  "flash_bwd_dkv": "llama T2047 causal",
                  "paged_attention": "decode B8 lens 0-1024"}


def _fp16_rows(rows, fp16_cases):
    """The fp16 bodies' rows of the kernels line: each one's launches with
    an fp16 q on the main paths (per path), its error, device time, plain
    time, bound and SDPA's fp16 time at FP16_ROW_CASES' shape, and every
    phase 65 case."""
    out = []
    for name, key in FP16_ROW_CASES.items():
        c = fp16_cases[name][key]
        by_path = {p: n["float16"] for p, n in DTYPES[name].items()
                   if n["float16"]}
        if not by_path:
            raise SystemExit(f"{name} never launched with an fp16 q on a "
                             "main path")
        out.append({
            "name": f"{name}_fp16", "route": "cuda",
            "source": rows[name]["source"],
            "replaces": rows[name]["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": c["max_abs_err"], "ms": c["device_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_device_ms"],
            "dtype": "float16", "shape": key, "cases": fp16_cases[name]})
    return out


def _fp16_rollout_flips(params, cfg, got, want, prompts):
    """Rows of the kernel arm's rollout that differ from the plain arm's:
    each held at its first divergent token to FP16_TIE_REL_TOL in an fp16
    forward of the common prefix.  Returns the flips."""
    from deepspeed_tpu_torch.models import llama

    flips = []
    for b in range(got.shape[0]):
        diff = (got[b] != want[b]).nonzero()
        if not len(diff):
            continue
        j = int(diff[0])
        with torch.inference_mode():
            row = llama.forward(params, want[b:b + 1, :j], cfg)[0, -1].float()
        gap = abs(row[want[b, j]] - row[got[b, j]]).item() / \
            row.abs().max().item()
        flips.append({"row": b, "pos": j - prompts.shape[1], "gap_rel": gap})
        if gap > FP16_TIE_REL_TOL:
            raise SystemExit(f"phase 67: rollout row {b} differs at {j} by "
                             f"{gap:.3e} > {FP16_TIE_REL_TOL}")
    return flips


def phase_fp16_llama(fns, card_line, phase8):
    """Phase 66, and 67 (c): phase 8's run (Llama-3-8B widths, 4 layers,
    micro 1 x accumulation 2 x 2048, fused Adam) under DeepSpeed's fp16
    defaults: its losses beside phase 8's bf16 ones, every step's overflow
    flag and scale equal to its attn_impl="reference" twin's; then starting
    at 2^32, so that the first steps overflow on the kernels and the scaler
    backs off, against its twin.  On the first engine, 67 (c): the hybrid's
    greedy rollouts over the paged cache (B1 prefill, B5 decode with an
    fp16 q over the bf16 cache) against the dense generator's (plain
    attention) over the same fp16 params and a bf16 cache, one train step
    between two rollouts."""
    import dataclasses

    from deepspeed_tpu_torch._tree import tree_leaves
    from deepspeed_tpu_torch.hybrid import init_hybrid_engine
    from deepspeed_tpu_torch.inference.generation import llama_generator
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.weights import init_params

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=4)
    twin_cfg = dataclasses.replace(cfg, attn_impl="reference")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2048)).astype(
        np.int32)}
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda", dtype=torch.float32)
    steps = len(phase8)
    launches, res = {}, {}

    def conf(power):
        c = _train_config(2, 2, {"fp16": dict(FP16_DEFAULTS,
                                             initial_scale_power=power)})
        c["hybrid_engine"] = {"enabled": True, "max_out_tokens": 160}
        return c

    path = "fp16 training"
    rows, launches[path], eng, peak = _fp16_run(
        fns, path, llama.loss_fn(cfg), params, conf(16), batch, steps)
    leaves = len(tree_leaves(eng.state.params))
    taken = sum(1 - r["overflow"] for r in rows)
    want = {"flash_fwd": 8 * steps, "flash_bwd_dq": 8 * steps,
            "flash_bwd_dkv": 8 * steps, "fused_adam": leaves * taken}
    if any(launches[path][n] != c for n, c in want.items()) or any(
            launches[path][n] for n in launches[path] if n not in want):
        raise SystemExit(f"phase 66: launches {launches[path]}, expected "
                         f"{want}")
    # the losses beside phase 8's bf16 run, while both took every step
    upto = next((i + 1 for i, r in enumerate(rows) if r["overflow"]),
                steps)
    vs_bf16 = max(abs(r["loss"] - b["loss"]) / abs(b["loss"])
                  for r, b in zip(rows[:upto], phase8))
    ms = float(np.median([r["ms"] for r in rows[1:]]))
    log(f"[fp16] Llama-3-8B widths, 4 layers, fp16 {FP16_DEFAULTS}: losses "
        f"within {vs_bf16:.3e} of phase 8's bf16 over the first {upto} "
        f"steps (tol {FP16_VS_BF16_RTOL}); {ms:.1f} ms/step against phase "
        f"8's {float(np.median([r['ms'] for r in phase8[1:]])):.1f}; peak "
        f"{peak:.1f} GB on {card_line}")
    if vs_bf16 > FP16_VS_BF16_RTOL or not all(
            np.isfinite(r["loss"]) for r in rows):
        raise SystemExit("phase 66: the fp16 losses depart from bf16's")
    res[path] = {"steps": rows, "peak_gb": peak, "ms_per_step": ms,
                 "vs_bf16_rel": vs_bf16}

    # 67 (c): the hybrid's rollouts on this engine
    prompts = np.random.default_rng(36).integers(
        1, cfg.vocab_size, (HYBRID_PROMPTS, HYBRID_PROMPT_LEN)).astype(
        np.int32)
    paged = init_hybrid_engine(eng, cfg)
    flips, hyb = [], {}
    for tag in ("before step", "after step"):
        p = f"fp16 hybrid rollout {tag}"
        _zero(fns.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = paged.generate(prompts, max_new_tokens=HYBRID_NEW,
                             temperature=0.0)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches[p] = {n: f.launches for n, f in fns.items()}
        _check_bodies(p)
        _check_fp16(p)
        _check_launches(p, launches[p], ("flash_fwd", "paged_attention",
                                         "greedy_argmax"))
        cast = paged.compute_params()
        if any(x.dtype != torch.float16 for x in tree_leaves(cast)
               if x.is_floating_point()):
            raise SystemExit("phase 67: the hybrid's compute params are not "
                             "fp16")
        ref = llama_generator(cast, cfg).generate(
            prompts, HYBRID_NEW, max_seq=paged.max_out_tokens)
        f = _fp16_rollout_flips(cast, cfg, got, ref, prompts)
        del cast
        flips += f
        hyb[p] = {"tokens_per_s": HYBRID_PROMPTS * HYBRID_NEW / s,
                  "rollout_s": s, "rows_identical": HYBRID_PROMPTS - len(f),
                  "flips": f}
        log(f"[fp16] {p}: paged (B1 + B5, fp16 q over the bf16 cache) "
            f"against the dense generator (plain attention): "
            f"{HYBRID_PROMPTS - len(f)} of "
            f"{HYBRID_PROMPTS} rows identical, near-tie flips {f}; "
            f"{hyb[p]['tokens_per_s']:.1f} tokens/s; launches {launches[p]}")
        if tag == "before step":
            p = "fp16 hybrid train step"
            _zero(fns.values())
            loss = float(paged.train_batch(batch))
            launches[p] = {n: f.launches for n, f in fns.items()}
            _check_bodies(p)
            _check_fp16(p)
            _check_launches(p, launches[p], ("flash_fwd", "flash_bwd_dq",
                                             "flash_bwd_dkv", "fused_adam"))
            hyb[p] = {"loss": loss, "overflow": eng.metrics["overflow"]}
    res["hybrid"] = hyb
    del paged, eng
    torch.cuda.empty_cache()

    twin, twin_used, eng, _ = _fp16_run(
        fns, "fp16 training, reference twin", llama.loss_fn(twin_cfg),
        params, conf(16), batch, steps, kernels=False)
    del eng
    res[path]["twin_rel"] = _same_skips("phase 66", rows, twin,
                                        FP16_TWIN_RTOL)
    res[path]["twin_flash_launches"] = {n: twin_used[n] for n in FLASH_NAMES}
    torch.cuda.empty_cache()
    # the overflow run: 2^32 overflows on the kernels, the scaler backs off
    path = "fp16 training from 2^32"
    rows, launches[path], eng, _ = _fp16_run(
        fns, path, llama.loss_fn(cfg), params, conf(FP16_OVERFLOW_POWER),
        batch, FP16_OVERFLOW_STEPS, until_taken=True)
    del eng
    torch.cuda.empty_cache()
    skipped = sum(r["overflow"] for r in rows)
    # each overflow halves the scale (the metrics carry the scale after the
    # step's update), a taken step keeps it
    scale, halves = 2.0 ** FP16_OVERFLOW_POWER, True
    for r in rows:
        scale = scale / 2 if r["overflow"] else scale
        halves = halves and r["scale"] == scale
    if not (rows[0]["overflow"] and halves and not rows[-1]["overflow"]):
        raise SystemExit(f"phase 66: the run from 2^{FP16_OVERFLOW_POWER} "
                         f"did not overflow and back off to a taken step: "
                         f"{rows}")
    twin, twin_used, eng, _ = _fp16_run(
        fns, "fp16 training from 2^32, twin", llama.loss_fn(twin_cfg),
        params, conf(FP16_OVERFLOW_POWER), batch, len(rows), kernels=False)
    del eng, params
    torch.cuda.empty_cache()
    _same_skips("phase 66 from 2^32", rows, twin, FP16_TWIN_RTOL)
    res[path] = {"steps": rows, "skipped": skipped,
                 "final_scale": rows[-1]["scale"],
                 "twin_flash_launches": {n: twin_used[n]
                                         for n in FLASH_NAMES}}
    return launches, res


def phase_fp16_models(fns, card_line):
    """Phase 67 (a), (b): GPT-2 1.3B (micro 8 x 1024, the reference's ZeRO-2
    model) and BERT-large (MLM, micro 8 x 512, pad ids) at full width and
    FP16_MODEL_LAYERS layers under DeepSpeed's fp16 defaults, each against
    its twin with plain attention: overflow flags and scales equal step by
    step, losses within FP16_TWIN_RTOL, the loss falling."""
    import dataclasses
    from unittest import mock

    from deepspeed_tpu_torch.models import bert, gpt2
    from deepspeed_tpu_torch.ops.attention import flash_attention
    from deepspeed_tpu_torch.weights import init_params

    launches, res = {}, {}
    steps = FP16_MODEL_STEPS
    gcfg = dataclasses.replace(gpt2.GPT2Config.gpt2_1_3b(),
                               n_layers=FP16_MODEL_LAYERS)
    bcfg = dataclasses.replace(bert.BertConfig.large(),
                               n_layers=FP16_MODEL_LAYERS)
    rng = np.random.default_rng(67)
    gbatch = {"tokens": rng.integers(0, gcfg.vocab_size, (8, 1025)).astype(
        np.int32)}
    bbatch, _ = _bert_batch(rng, 8, 512, bcfg.vocab_size)
    plain_gpt2 = functools.partial(flash_attention, force_reference=True)
    for name, cfg, batch, loss_fn, twin in (
            ("gpt2-1.3b", gcfg, gbatch, gpt2.loss_fn(gcfg),
             lambda: mock.patch.object(gpt2, "flash_attention", plain_gpt2)),
            ("bert-large", bcfg, bbatch, bert.loss_fn(bcfg),
             None)):
        params = init_params(cfg, torch.Generator("cuda").manual_seed(67),
                             device="cuda", dtype=torch.float32)
        conf = _train_config(8, 1, {"fp16": dict(FP16_DEFAULTS)})
        path = f"{name} fp16 training"
        rows, launches[path], eng, peak = _fp16_run(
            fns, path, loss_fn, params, conf, batch, steps)
        del eng
        torch.cuda.empty_cache()
        L = cfg.n_layers
        for k in FLASH_NAMES:
            if launches[path][k] != L * steps:
                raise SystemExit(f"phase 67: {path} {k} launches "
                                 f"{launches[path][k]}, expected {L * steps}")
        if twin is None:
            tcfg = dataclasses.replace(cfg, attn_impl="reference")
            trows, tused, eng, _ = _fp16_run(fns, f"{path}, twin",
                                             bert.loss_fn(tcfg), params,
                                             conf, batch, steps,
                                             kernels=False)
        else:
            with twin():
                trows, tused, eng, _ = _fp16_run(
                    fns, f"{path}, twin", loss_fn, params, conf, batch,
                    steps, kernels=False)
        del eng, params
        torch.cuda.empty_cache()
        rel = _same_skips(f"phase 67 {name}", rows, trows, FP16_TWIN_RTOL)
        losses = [r["loss"] for r in rows]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise SystemExit(f"phase 67: {path} did not fall: {losses}")
        res[path] = {"steps": rows, "twin_rel": rel, "peak_gb": peak,
                     "layers": L, "twin_flash_launches": {
                         n: tused[n] for n in FLASH_NAMES}}
    log(f"[fp16] phase 67 GPT-2 1.3B / BERT-large at {FP16_MODEL_LAYERS} "
        f"layers on {card_line}: {res}")
    return launches, res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if len(sys.argv) > 1 and sys.argv[1] == ZERO_CHILD_FLAG:
        return zero_child(sys.argv[2], json.loads(sys.argv[3]))
    if len(sys.argv) > 1 and sys.argv[1] == MP_CHILD_FLAG:
        return mp_child(sys.argv[2], json.loads(sys.argv[3]))
    from deepspeed_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke_t0 = time.perf_counter()
    card_line = card()
    log(card_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.lib()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    _LAP[0] = time.perf_counter()

    # each kernel's wrapper, whose `launches` count the main paths read
    fns = _kernel_fns()
    gen = torch.Generator("cuda").manual_seed(0)
    kernels = [phase_flash(gen), phase_paged(gen), phase_greedy(gen)]
    tier_kernels = phase_paged_quant_v1(gen)
    _lap('phases 3, 9 kernels (flash, paged, greedy, quant v1)')
    probe_row, probe_launches = phase_env_probe(fns)
    _lap('phase_env_probe')
    quant_kernels = [phase_quant(gen), probe_row]
    gpt2_cases = phase_gpt2_kernels(gen)
    _lap('phase_gpt2_kernels')
    mixtral_cases = phase_mixtral_kernels(gen)
    _lap('phase_mixtral_kernels')
    bert_cases = phase_bert_kernels(gen)
    _lap('phase_bert_kernels')
    fp16_cases = phase_fp16_kernels(gen)
    _lap('phase_fp16_kernels (phase 65)')
    torch.cuda.empty_cache()
    phase_identity(kernels)
    _lap('phase_identity')
    phase_tier_identity(fns)
    _lap('phase_tier_identity')
    phase_int8_identity(fns)
    _lap('phase_int8_identity')
    phase_gpt2_identity(fns)
    _lap('phase_gpt2_identity')
    phase_mixtral_identity(fns)
    _lap('phase_mixtral_identity')
    phase_bert_identity(fns)
    _lap('phase_bert_identity')
    launches = {"env report": probe_launches}
    launches.update(phase_host_natives(fns, card_line))
    _lap('phase_host_natives')
    launches.update(phase_serving(
        [{"name": n, "fn": f} for n, f in fns.items()], card_line)[0])
    _lap('phase_int8_serving (phase 14)')
    torch.cuda.empty_cache()
    launches.update(phase_gpt2_serving(fns, card_line)[0])
    _lap('phase_gpt2_serving')
    launches.update(phase_gpt2_small(fns, card_line)[0])
    _lap('phase_gpt2_small')
    torch.cuda.empty_cache()
    launches.update(phase_mixtral_serving(fns, card_line)[0])
    _lap('phase_mixtral_serving')
    torch.cuda.empty_cache()
    launches.update(phase_bert_serving(fns, card_line)[0])
    _lap('phase_bert_serving')
    torch.cuda.empty_cache()
    rows = {k["name"]: k for k in kernels + tier_kernels + quant_kernels}
    rows.update(phase_backward(gen))
    _lap('phase_backward')
    rows["fused_adam"] = phase_adam(gen)
    _lap('phase_adam')
    torch.cuda.empty_cache()
    phase_train_identity(fns)
    _lap('phase_train_identity')
    launches["training"], train_run = phase_train(fns, card_line)
    phase8 = train_run["steps"]
    phase8_losses = [r["loss"] for r in phase8]
    del train_run
    _lap('phase_train')
    torch.cuda.empty_cache()
    launches.update(phase_control_plane_train(fns, card_line))
    _lap('phase_control_plane_train (phase 61)')
    torch.cuda.empty_cache()
    launches.update(phase_resume(fns, card_line)[0])
    _lap('phase_resume')
    torch.cuda.empty_cache()
    got, gpt2_runs = phase_gpt2_train(fns, card_line)
    launches.update(got)
    phase19_ms = [round(r["ms"], 1) for r in gpt2_runs["save_attn"]["steps"]]
    del gpt2_runs
    _lap('phase_gpt2_train')
    torch.cuda.empty_cache()
    launches.update(phase_mixtral_train(fns, card_line)[0])
    _lap('phase_mixtral_train')
    torch.cuda.empty_cache()
    got, bert_train = phase_bert_train(fns, card_line)
    launches.update(got)
    phase26_losses = [r["loss"] for r in bert_train["steps"]]
    del bert_train
    _lap('phase_bert_train')
    got, _ = phase_fp16_llama(fns, card_line, phase8)
    launches.update(got)
    _lap('phase_fp16_llama (phases 66, 67 (c))')
    got, _ = phase_fp16_models(fns, card_line)
    launches.update(got)
    _lap('phase_fp16_models (phase 67 (a), (b))')
    torch.cuda.empty_cache()
    launches.update(phase_cnn(fns, card_line)[0])
    _lap('phase_cnn')
    torch.cuda.empty_cache()
    launches.update(phase_rlhf_distill_trainer(fns, card_line))
    _lap('phase_rlhf_distill_trainer')
    torch.cuda.empty_cache()
    got, prefill29 = serve_beyond_the_card(fns, card_line, gen, rows)
    launches.update(got)
    torch.cuda.empty_cache()
    got, refs = train_beyond_the_card(fns, card_line)
    launches.update(got)
    torch.cuda.empty_cache()
    got, refs["phase48_losses"] = phase_zero_launcher(card_line, rows,
                                                      phase19_ms)
    launches.update(got)
    _lap("phases 41, 42, 48 (wire, ZeRO stages, ZeRO-Offload) under the "
         "launcher")
    refs.update(phase8_losses=phase8_losses, phase29_prefill=prefill29,
                phase26_losses=phase26_losses, rates=dict(RATES))
    launches.update(phase_mp_launcher(card_line, refs))
    _lap("phases 43-47, 49-57 (tensor, sequence, pipeline and expert "
         "parallelism; the offload engines over ranks; GPT-2's and BERT's "
         "layouts, int8-resident KV, injection and the hybrid engine) in "
         "two ranks under the launcher")
    launches.update(phase_sparse(fns, card_line, phase8))
    _lap("phase_sparse")
    launches.update(phase_autotune(fns, card_line))
    _lap("phase_autotune")
    phase_rank_shapes(card_line, gen)
    _lap("phase_rank_shapes")
    torch.cuda.empty_cache()
    got, zi_params, zi_cfg = phase_proc_fleet(fns, card_line)
    launches.update(got)
    _lap("phase_proc_fleet (phase 63)")
    launches.update(phase_elastic(fns, card_line, zi_params, zi_cfg))
    del zi_params
    torch.cuda.empty_cache()
    _lap("phase_elastic (phase 64)")
    for name, cases in bert_cases.items():
        rows[name]["bert_shapes"] = cases
    for name, cases in gpt2_cases.items():
        rows[name]["gpt2_shapes"] = cases
    for name, cases in mixtral_cases.items():
        rows[name]["mixtral_shapes"] = cases

    out = []
    for name in fns:
        k = rows[name]
        row = {key: k[key] for key in (
            "name", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
        row["route"] = "cuda"
        # each main path's own count (set to 0 just before it, read just
        # after), and their sum
        row["launches_by_path"] = {p: n[name] for p, n in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if name in BODIES:
            # per body, on the main paths that ran it
            paths = BODIES[name]
            row["launches_by_body"] = {
                b: sum(c[b] for c in paths.values())
                for b in fns[name].body_launches}
            row["launches_by_path_and_body"] = {
                p: c for p, c in paths.items() if any(c.values())}
        for key in ("device_ms", "library_device_ms", "device_median_ms",
                    "library_device_median_ms", "bound_share",
                    "training_shape", "chunk", "f32_split", "kv_rows",
                    "kv_write", "cases", "gpt2_shapes", "mixtral_shapes",
                    "bert_shapes", "verify_shapes", "wire_shape"):
            if key in k:
                row[key] = k[key]
        out.append(row)
    out += _fp16_rows(rows, fp16_cases)
    log(f"[smoke] whole run {time.perf_counter() - smoke_t0:.1f} s on "
        f"{card_line}")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
