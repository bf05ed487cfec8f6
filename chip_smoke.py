#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``.  Phases, each of which fails the run:

1. device and toolchain: versions, the card's name and power limit, SMs;
2. build: the attention, MoE, scan, AES and AdamW kernels (seven sources)
   from ``src/repro_torch/csrc`` into ``build/kernels`` (one ``nvcc`` per
   source, in parallel), with nvcc's ``-Xptxas -v`` report; a kernel that
   spills registers fails the run;
3. each kernel against its plain PyTorch version on the card, over the
   sweep of ``tests/test_kernels.py`` and at the main path's shapes, then
   timed there with CUDA events, L2 flushed before every launch and the card
   held busy while the host enqueues it.  The kernels with more than one
   design (``flash_attention`` and the ``moe_gmm`` prefill: ``wgmma`` for
   bf16; ``decode_attention``: ``split`` for bf16; the ``moe_gmm`` decode
   shapes: ``stream``; ``mamba_scan``: ``lanes``; ``rwkv6_scan``: ``cols``;
   the previous design on its own entry point) are held
   against the plain version in every design, head_dim 120 included, and
   timed in turns, previous, new, new, previous, with the median and mean of
   the launches; the PyTorch call (SDPA with K and V repeated, ``torch.bmm``)
   beside them; ``moe_gmm``'s three designs are also timed from C = 1 to 64.
   Kernels
   and plain versions both compute in fp32 and round once, so fp32 is held
   at atol = rtol = 3e-5 (``moe_gmm`` at the fp32 limit of
   ``tests/test_kernels.py``, atol 2e-3 / rtol 2e-4; the two scans, which
   carry a state through every step, at theirs, 2e-4) and bf16 at atol
   1e-3, rtol 1e-2 (one bf16 ulp is at most 2**-7 of |x|).  ``moe_gmm`` is
   held and timed at mixtral's and Jamba's serving shapes, the scans at
   Jamba's and RWKV6's prefill and decode, and the attention kernels at
   the shapes of phases 5f and 5g: flash without the causal bound at
   seamless-m4t's encoder (S = T = 1500, d 64) and cross prefill (S 512
   against T 1500), causal at seamless's decoder prefill (512, d 64, G 1)
   and pixtral-12b's (1024, d 128, G 4), and decode against seamless's
   1500 encoder frames, all valid and under a ragged prefix, with the
   transposed copy of a layer's cross K/V, and in seamless's 1024-slot and
   pixtral's 2048-slot KV caches; the flash kernel's key-masked designs at
   seamless's cross prefill (ragged valid lengths with one fully masked row,
   whose output must be the mean of v; then dead tiles mid-row and a row
   whose only valid keys sit in its last, partial tile): bf16 on
   ``wgmma_masked`` (the route) and the simt masked design, fp32 on simt,
   the tile walks of each mask printed, ``wgmma_masked`` timed in turns with
   the simt masked design, SDPA given the same boolean mask beside them; the
   flash backward's two kernels in
   both designs (``bwd_route``: bf16 -> the wgmma pair ``bwd_dq_wgmma``,
   ``bwd_dkv_wgmma``; fp32 -> the simt pair ``bwd_dq``, ``bwd_dkv``, which
   also runs bf16 on its own entry point) over the sweep in both dtypes and
   at the training shapes (qwen3-1.7b's and h2o-danube-3-4b's in bf16, S <
   T, S > T and a non-causal case in both dtypes, a 128-key window under
   512 tokens at d 120 and 64 in bf16), at the forward's limits, then timed
   at qwen3's: the wgmma pair in turns with the simt pair, and in turns
   with SDPA's backward (``torch.autograd.grad`` of SDPA through K and V
   repeated to Hq, so that the sum back to Hkv is timed too), all by CUDA
   events with L2 flushed and the card held for ``BWD_HOLD_CYCLES``, long
   enough for the autograd engine to enqueue SDPA's backward before the
   span starts; and the backward kernels of phase 11d's other families:
   ``moe_gmm_bwd`` (``bwd_route``: dx on ``wgmma_nt``, dw on ``wgmma_tn``,
   the backward's own clustered design, neither copying its operands;
   elsewhere the forward designs over copies by the transpose kernel) over
   the MoE sweep in both dtypes and at mixtral's and Jamba's gate/up and
   down at their training capacity (1280, 640), the pair timed in turns
   with the previous pair (the forward's wgmma design: dx reading w
   transposed, dw over a copy of x) and with ``torch.bmm`` for dx and dw,
   then dx and dw apart, each in turns with its previous design and with
   its ``bmm``, and the copy of x alone; ``mamba_scan_bwd`` and ``rwkv6_scan_bwd``
   on their ``ring`` routes (``bwd_route``; Mamba's ragged shapes on
   ``ckpt``), the other spacing of each ring and the previous designs
   (``ckpt``, ``rows``) over the scans' sweeps in both dtypes, with and
   without the state and its cotangent, and at Jamba's B8 S512 di8192 ds16
   and RWKV6's B8 T512 H32 hd64 in fp32 (what the models feed them): each
   step of the ring design timed in turns with the previous design, one
   ablation line a step, beside their forward, then the route in turns with
   the previous design in bf16; a gradient that sums over
   channels, batch rows or time (dB, dC, dA, du, the MoE's dw) held in
   fp32 at ``SUM_REL`` of its largest magnitude, the others at the
   forward's limits, bf16 at the bf16 limit; and the backward of the flash
   kernel's key-masked routes (``bwd_route`` under a mask: bf16 -> the
   ``wgmma_live`` pair, which takes the forward's lse, fp32 -> the simt
   ``masked`` pair; for bf16 the previous ``wgmma_masked`` pair and the
   simt pair on their own entry points too) over ``MASKED_BWD_SWEEP`` (d 32
   to 128, causal, not and windowed, G 1, 2 and 4, T 1500, ragged masks
   with a row that has no valid key, dead tiles, rows whose valid keys lie
   in their causal future) at the unmasked backward's limits, the forward's
   lse against the plain lse (-inf on the same rows), then timed at 11f's
   cross shape under row 1m's ragged mask in turns with the previous
   ``wgmma_masked`` pair, the simt masked pair, SDPA's backward under the
   same boolean mask and the unmasked wgmma pair, each pair's dq and dkv
   entry points apart, (all keys valid) masked against unmasked, and the
   masked forward with and without lse.  The shapes of the three assigned
   architectures of phases 5h-5j and 11g: decode ``split`` at phi4-mini's G
   = 3 (its prefix, ring, empty-row and few-slot masks) and deepseek-67b's
   G = 8 at d 128, each step timed in turns with ``simt`` and reported on
   its own ``kernels decode_attention ...`` line; flash forward and its
   wgmma backward pair at both groupings; ``moe_gmm`` and its backward at
   phi3.5-moe's experts (16, D 4096 and F 6400, C 1 and 640); the AdamW
   kernel (``csrc/adamw.cu``, which replaces no TPU kernel: XLA fuses the
   JAX package's update in its jitted step) at the leaves of full-width
   ``qwen3-1.7b`` against its plain version at a rate of 1e-2 (bf16 p
   within one bf16 ulp plus 3e-7, m and v at fp32's limit on their own scale, the
   norm at rtol 1e-5 and equal bit for bit from a second call; then the
   same leaves in fp32, each element's change at fp32's limit against the
   plain version's, where the decay, the rate and the bias corrections
   show), then there and at ``mixtral-8x7b``'s at 2 layers timed in turns
   with the plain version, beside a copy of the update's bytes;
4. a reduced ``qwen3-1.7b`` at float32 on the CPU (plain versions) and on
   the card (kernels) with the same weights: equal greedy tokens, and
   logits within atol/rtol 1e-4;
4b. the same for a reduced ``mixtral-8x7b`` (4 experts, top 2, window
   128): a 150-token prompt in a 192-slot cache, so the ring wraps, and
   batch 4, so that decode runs at capacity 2 and drops pairs;
4c. the same for a reduced ``jamba-v0.1-52b`` of 8 layers (the whole 1:7
   group: Mamba, Mamba+MoE and one attention block): a 150-token prompt,
   so that the scan's tails run, at batch 4, where decode drops pairs;
4d. the same for a reduced ``rwkv6-1.6b``;
4e. the same for a reduced ``h2o-danube-3-4b`` with its heads 120 wide, as
   in the full model, under a 128-slot window, so the ring wraps;
4f. a reduced ``seamless-m4t-large-v2`` (encoder-decoder): a 40-token
   decoder prompt over 150 encoder frames at batch 4, then 8 greedy decode
   steps through ``T.prefill`` and ``T.decode_step``, card against CPU:
   every step's logits within atol/rtol 1e-4 and equal tokens; then again
   under a ragged ``enc_mask``, the cross prefill on the simt masked route;
4g. the same for a reduced ``pixtral-12b`` (4 query heads a kv head, as
   in the full model) on a prompt of 40 image-patch embeddings;
4h. the same as 4b for reduced ``phi4-mini-3.8b``, ``phi3.5-moe-42b-a6.6b``
   and ``deepseek-67b`` that keep their grouping of query heads (G 3, 4
   and 8; phi3.5's top 2 over 4 experts);
5. full-width ``qwen3-1.7b`` (bf16, random weights from a seed) served by
   ``ServingEngine``: 8 prompts of 512 tokens, 32 new tokens each.  The
   engine captures its prefill (one CUDA graph per prompt shape) and its
   decode step (one per batch shape) in a warm-up request, in one memory
   pool, and replays them; the eager steps (the previous design: op by op,
   the decode step with a Python ``pos``) serve the same prompts in turns
   with them (graph, eager, graph), the counters reset before each run.
   The first run's kernel launch counts are checked against the layers by
   kind, and its launches by route: every bf16 prefill attention on
   ``wgmma``, every bf16 decode attention on ``split``, every expert matmul
   of a prefill on ``wgmma`` and of a decode step on ``stream`` (the routes
   that ``route`` in the wrappers gives their shapes); each other run
   launches the same, and serves the same tokens.  Phase 5 then serves a
   256-token batch between two 512-token batches through the same engine,
   replayed and eager (a second prefill graph in the pool; every run's
   tokens equal the eager run's).  Then the replays
   against an eager loop step by step: equal greedy tokens, every step's
   logits (the prefill's too) at the bf16 limit; then 4 decode steps under
   the profiler (its CUDA activity) as replays and 4 eager, the replay's
   device time within 5 % of the eager step's, and 2 prefills replayed and
   2 eager, the same way: device us, wall us, idle share, the engine's mean
   decode step (``work_us``) of both designs and their prefill ms (host
   clock, 3 prefills a turn in turns: graph, eager, eager, graph), each
   capture's seconds and the peak memory, the graphs' pool included;
5b. the same traffic through full-width ``mixtral-8x7b`` cut from 32 to 24
   layers (bf16, 70.2 GB of weights: all 32 layers do not fit one 80 GB
   card), every expert matmul through the ``moe_gmm`` kernel;
5c. the same traffic through full-width ``jamba-v0.1-52b`` cut from 32 to
   24 layers, 3 of its 4 groups of 8 (bf16, 77.6 GB of weights): every
   selective scan through ``mamba_scan`` on its ``lanes`` design, the
   experts through ``moe_gmm``, the attention through the flash and decode
   kernels;
5d. the same traffic through full-width, full-depth ``rwkv6-1.6b``, every
   wkv recurrence through ``rwkv6_scan`` on its ``cols`` design;
5e. the same traffic through full-width, full-depth ``h2o-danube-3-4b``
   (24 layers, 7.9 GB of bf16 weights, heads 120 wide): the attention of
   head_dim 120 on the flash ``wgmma`` and decode ``split`` designs;
5f. full-width, full-depth ``seamless-m4t-large-v2`` (24 encoder and 24
   decoder layers, 4.07 GB of bf16 weights): 8 requests of 1500 stub
   frames (the engine's ``inputs``), a 512-token decoder prompt and 32 new
   tokens, through the engine as in phase 5; every attention (encoder,
   self, cross) on flash ``wgmma`` and decode ``split``, checked by route;
   then the prefill under a ragged ``enc_mask`` through the engine (its own
   prompt shape, so a third graph), replayed and eager, timed, its logits
   at the bf16 limit of each other, its 24 cross prefills on
   ``wgmma_masked``;
5g. full-width, full-depth ``pixtral-12b`` (24.5 GB of bf16 weights, 5f's
   memory freed first): 8 prompts of 1024 stub image-patch embeddings and
   32 new tokens, the same way; after 5j, the eager and replay figures of
   phases 5-5j in one table;
5h-5j. phase 5's traffic through full-width ``phi4-mini-3.8b`` (all 32
   layers, G 3: its decode on ``split``), ``phi3.5-moe-42b-a6.6b`` cut to 26
   of 32 layers (68.1 GB of weights; experts on ``stream`` and ``wgmma``)
   and ``deepseek-67b`` cut to 48 of 95 (69.8 GB; G 8 at d 128), each
   after the card is freed and checked under 1 GB, its launches by route
   held equal to the expected ones;
6. the AES-128-CTR kernel: the FIPS-197 C.1 known answer, bit-exact
   agreement with its plain version on the card, through the op and through
   each design's own entry point (``ttable``, the design ``route`` gives
   every N, and ``simt``, the previous one), over N (ragged ones too),
   nonces (across the 2**31 sign wrap and past 2**32) and two keys, a round
   trip, its launch counts by route, and both designs timed in turns at 1
   block, the function's 38 blocks (600 B) and 2**20 blocks, beside a
   PyTorch copy of the 2**20 blocks' bytes;
7. the FaaS path through the port's faasd runtime: the AES function's body
   deployed (``AesFunction``: the key expanded and its round keys placed on
   the card once; a call moves 600 B to the card, runs the kernel, brings
   the reply back and synchronises) timed in turns beside the previous
   body, which expands the key and copies the round keys on every call; the
   deployed body's median is AES's ``work_us``, and its 200 counted calls
   must all launch on the route of 38 blocks.  The AES function, the four
   model endpoints of phases 5-5d and the decode steps of 5h-5j are then
   deployed on containerd and on junctiond.  Those latencies are simulated
   on the host from the paper's host costs; only ``work_us`` is measured
   here;
8. the open loop of the paper's Fig 6 on those measured bodies, simulated
   on the host: ``sustainable_throughput`` of AES (phase 7's body) on both
   backends over the default grid of 250 to 24000 rps under a 50 ms p99
   SLO, each curve printed, both knees and their ratio (junctiond's must be
   the higher; its sweep is run twice and must repeat), a ``KneeSearch``
   with a ``drive`` probe on each backend; then the four model endpoints
   of phases 5-5d on a grid of 0.1 to 1.0 of the cores' rate under a p99
   SLO of twice the body, their knees printed.  It launches no kernel;
9. the six backends, the autoscaler and the sanitizer on those bodies,
   simulated on the host (``control_plane``): 9a phase 7's closed loop on
   containerd, junctiond, quark, wasm (whose ``work_mult`` 1.35 scales the
   body), firecracker and gVisor on both platforms, junctiond's median
   the lowest for every function, the warm-path order of the 95 us body
   printed, not asserted; 9b the AES function's cold start on each,
   firecracker's boot, restore and boot after ``remove``, junctiond's
   scale to 4 with shared uProcs and isolated instances; 9c bursts of AES
   through ``drive`` with an ``Autoscaler(LeadTimePolicy)`` on each
   backend: every one scales up, junctiond reacts faster than
   containerd; 9d junctiond's and containerd's drives again under the
   sanitizer, float for float the same.  It launches no kernel;
10. the experiments runner and the fleet on those bodies, simulated on the
   host (``fleet_and_experiments``): 10a the ``smoke`` suite with every AES
   body swapped for phase 7's and ``model-endpoint``'s two for phases 5 and
   5b's; the artifact must validate with no failed cell and
   ``fig6_throughput_ratio >= 5``; the Fig 5 cuts, both Fig 6 knees and
   their ratio, the cold-start ratio, the fleet's tree speedup per backend,
   the autoscaler's reaction ratio and the chain hop tax are printed beside
   the paper's figures, and the artifact is written to
   ``build/phase10_smoke.json``; 10b a ``Cluster`` of 4 workers on
   containerd and on junctiond under AES through ``drive``, run twice and
   once under the sanitizer, float for float the same, with no rejection,
   then a ``scale_out`` storm under ``FaasNetTree`` against
   ``NaiveRegistryPull``.  It launches no kernel;
11. training (``repro_torch.train``): 11a reduced float32 ``qwen3-1.7b``
   and ``h2o-danube-3-4b`` (heads 120 wide, a 128-key window under 160
   tokens) from the same weights and ``SyntheticLM`` batches, 3 steps of
   ``make_train_step(remat=True)`` on the CPU and on the card: losses and
   grad norms within atol/rtol 1e-4, each card step's launches 2 L flash
   forwards (the recompute) and L of each backward kernel of the simt pair,
   the plain attention refused; 11b full-width, full-depth ``qwen3-1.7b`` in
   bf16, its backward on the wgmma pair (the simt pair launched 0 times)
   (fp32 moments, AdamW at 3e-4) on 8 x 512-token batches over its whole
   vocabulary, 4 steps on the step captured as one CUDA graph
   (``TrainGraph``: step 1 runs eagerly as the warm-up, then the capture;
   steps 2-4 are replays), each step's AdamW on the AdamW kernel (3
   launches a step): finite, falling loss and the same launch counts, with
   ``capture_s``, the step time, tokens/s, model FLOPs per second and their
   share of 989 TFLOP/s, peak memory (the graph's pool included), and one
   more replay under the profiler (device time, idle share, the kernels'
   shares); then the same 4 steps from the same weights and batches on the
   eager step (op by op, the previous design) and one more profiled: each
   step's loss and grad norm within rtol 1e-5 of the replay's (printed
   whether exactly equal), every figure printed for both; then the same 4
   steps from the same weights and batches with SDPA's attention and its own backward in
   place of the kernels: each step's loss and grad norm within
   ``TRAIN_SDPA_RTOL`` of the kernels'; 11c reduced float32
   ``mixtral-8x7b``, ``jamba-v0.1-52b`` at 8 layers (attention at layer 4,
   MoE on the odd layers) and ``rwkv6-1.6b``, 3 remat steps card against
   CPU as 11a, each step's launches exact by route (the expert matmuls and
   scans forward twice and backward once), every plain kernel and plain
   backward refused on the card; RWKV6 held step by step (each card step
   from the CPU run's weights and moments: its free-running trajectory
   parts past 1e-4 by rounding alone), mixtral and Jamba free-running over
   the 3 steps; 11d full-width bf16 training, 4 steps of
   8 x 512 tokens each, AdamW as 11b: ``mixtral-8x7b`` and
   ``jamba-v0.1-52b`` at 2 layers, ``rwkv6-1.6b`` at all 24; finite,
   falling loss, exact launches, step time, tokens/s, MFU, peak memory and
   a profiled step (device time, idle share, the backward kernels'
   share), the card freed and checked under 1 GB before each model; after
   RWKV6, in float32, its wkv kernels against the plain scan inside the
   step's gradients: every leaf of a 2-layer model within 1e-4 of its
   largest element, and at all 24 layers each layer's scan forward and
   backward on the inputs and cotangent it met, within the same share; then
   the full-depth grad norm by layer from the weights times 1 and 1 +- 1e-6;
   11e reduced float32 ``seamless-m4t-large-v2`` (4 x 64 decoder tokens over
   150 stub frames under a ragged ``enc_mask`` with a fully masked row) and
   ``pixtral-12b`` (4 x 64 stub patch embeddings, G 4), 3 remat steps card
   against CPU as 11c, free-running, each step's launches exact by route
   (the encoder's flash once forward and once backward a layer, the
   decoder's self- and cross-attention twice and once, the cross-attention
   on the ``masked`` route and pair); 11f full-width, full-depth
   ``seamless-m4t-large-v2`` (24 encoder and 24 decoder layers, bf16) on 8 x
   512 decoder tokens over 8 x 1500 stub frames under 5f's ragged
   ``enc_mask``, then full-width ``pixtral-12b`` cut to
   ``PIXTRAL_TRAIN_LAYERS`` of its 40 layers on 8 x 512 stub patch
   embeddings, each 4 steps as 11d (its cross-attention's forward on
   ``wgmma_masked``, writing each row's lse, and its backward on the
   ``wgmma_live`` pair), with MFU by ``flops.model_flops``, which counts
   an encoder-decoder model's decoder tokens only; 11h reduced float32
   ``phi4-mini-3.8b``, ``phi3.5-moe-42b-a6.6b`` and ``deepseek-67b`` (4h's),
   3 remat steps card against CPU held step by step as 11c holds RWKV6;
   11g full-width bf16 training of the three as 11d: phi4-mini at 16 of 32
   layers, phi3.5-moe at 2 of 32 and deepseek-67b at 2 of 95, the flash
   backward on its wgmma pair at G 3 and G 8 and phi3.5's experts' dx on
   ``wgmma_nt_fwd`` and dw on ``wgmma_tn``.  Every full-width training
   phase (11b, 11d, 11f, 11g) trains on the replayed graph and then on the
   eager step from the same weights and batches, as 11b, the card freed
   and checked under 1 GB before each; 11d's mixtral holds the replay to
   the eager step as 11b does; after 11g a table of both designs' step
   time, device time, idle share, peak and ``capture_s``;
12. the dry run (``repro_torch.launch.dryrun``) and the options only it
   selects: 12a on the host, no kernel launched, ``run_pair`` on the
   256-rank production mesh (data 32 x model 8, a fake process group) for
   qwen3-1.7b x decode_32k with its probes, mixtral-8x7b x train_4k (traced
   twice: every figure equal) and the three prefill_32k pairs whose ops this
   host's torch 2.11 could not place before the port's rules (mixtral's and
   h2o-danube's windowed ``roll``, Jamba's partial-plus-shard ``add``), each
   device's memory, flops, bytes, collective bytes by kind and axis and the
   roofline's three terms, bottleneck and useful ratio (the H100 SXM's
   data-sheet figures at 700 W: predictions), all finite, no op run
   replicated, the peak, flops, bytes accessed and collective bytes each
   within 1 % of torch 2.13's (``PERF.md``); perf's
   expert-parallel variant of mixtral x train_4k at 2 of 32 layers moves
   bytes by all-to-all; 12b the dry run on a 1-rank mesh at phase 11b's
   training step and phase 5's decode step, and at 5h's phi4-mini decode
   step: its parameter, moment and KV cache bytes equal the card's
   tensors', and its roofline step time is not above the device time those
   phases measured; 12c full-width
   qwen3-1.7b on the card: 32 greedy tokens with ``cache_update="select"``
   equal the in-place path's (both step times printed), and a prefill under
   ``attn_impl="chunked"`` and decode steps under ``mixed_precision`` launch
   what the default path launches, by route (flash ``wgmma`` 28 a prefill,
   decode ``split``), every plain attention refused; then
   ``examples/quickstart_torch.py`` on the card's measured AES body, whose
   junctiond median and p99 must be below containerd's (Fig 5), and
   ``examples/serve_e2e_torch.py`` (reduced qwen3 on the card, its decode
   step deployed), junctiond's median below containerd's;
13. the JAX package's assigned input shapes on one card
   (``assigned_shapes``): prefill_32k then decode_32k steps through one
   ``ServingEngine`` a model, long_500k at batch 1 and train_4k through
   ``TrainGraph``, each at the batch and depth ``repro_torch.launch.fit``
   reckons, replayed and eager in turns with tokens and logits exactly
   equal, each kernel then held against its plain version on the inputs
   the model gave it, and the dry run on one rank beside every pair.

    python3 chip_smoke.py --only-assigned-shapes

runs phases 1, 2 and 13 alone, printing a pair that fails and going on.

The line before the last is a JSON object with one entry per kernel (the
flash kernel's masked route and the five backwards with their own); the last is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
START = time.perf_counter()          # phase headers print the seconds since the start
SEED = 0
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12           # dense tensor cores; the timed shapes are bf16
SMEM_LOOKUPS_PER_CLOCK = 32        # one conflict-free 32-lane shared-memory load per SM
FP32_LANES = 128                   # fp32 fused multiply-adds per clock per SM (CUDA cores)
SFU_EXP_PER_CLOCK = 16             # exponentials per clock per SM (special-function units)

FLASH_SWEEP = [  # B, Hq, Hkv, S, T, d, causal, window (tests/test_kernels.py)
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 96, 64, True, 32),
    (2, 2, 2, 64, 192, 32, True, None),
    (1, 4, 4, 128, 128, 128, False, None),
    (1, 2, 1, 257, 257, 64, True, None),
]
DECODE_SWEEP = [(2, 8, 2, 300, 64), (1, 4, 4, 512, 128), (3, 16, 8, 257, 64)]
FLASH_MAIN = (8, 16, 8, 512, 512, 128, True, None)
DECODE_MAIN = (8, 16, 8, 1024, 128)
DECODE_MIXTRAL = (8, 32, 8, 1024, 128)     # G = 4: mixtral-8x7b, jamba, h2o (d 120)
DECODE_ASSIGNED = {   # the decode steps of phases 5h (G = 3) and 5j (G = 8 at d 128)
    "phi4-mini decode": (8, 24, 8, 1024, 128), "deepseek-67b decode": (8, 64, 8, 1024, 128)}
DECODE_STRESS = [   # B, Hq, Hkv, T, d, mask: cases the split design treats apart
    (8, 16, 8, 1024, 128, "wrap"), (8, 16, 8, 1024, 128, "empty_row"),
    (8, 16, 8, 1024, 128, "few"), (3, 16, 8, 257, 128, "prefix"),
    (2, 16, 8, 1500, 128, "wrap"), (8, 32, 8, 1024, 120, "prefix"),
    (2, 32, 8, 300, 120, "empty_row"), (1, 2, 1, 9, 32, "empty_row"),
    (8, 24, 8, 1024, 128, "wrap"), (8, 24, 8, 1024, 128, "empty_row"),   # G = 3
    (8, 24, 8, 1024, 128, "few"), (3, 24, 8, 257, 128, "prefix"),
    (3, 64, 8, 257, 128, "prefix"),                                        # G = 8 at d 128
]
ENCDEC_FLASH = {   # B, Hq, Hkv, S, T, d, causal: the prefill attention of phases 5f and 5g
    "seamless encoder": (8, 16, 16, 1500, 1500, 64, False),
    "seamless cross prefill": (8, 16, 16, 512, 1500, 64, False),
    "seamless self prefill": (8, 16, 16, 512, 512, 64, True),
    "pixtral prefill": (8, 32, 8, 1024, 1024, 128, True),
}
ASSIGNED_FLASH = {   # B, Hq, Hkv, S, T, d, causal: the prefill attention of phases 5h and 5j
    "phi4-mini prefill": (8, 24, 8, 512, 512, 128, True),      # G = 3
    "deepseek-67b prefill": (8, 64, 8, 512, 512, 128, True),   # G = 8 at d 128
}
CROSS_DECODE = (8, 16, 16, 1500, 64)   # B, Hq, Hkv, T, d: seamless's decode against its frames
ENCDEC_DECODE = {   # (B, Hq, Hkv, T, d), valid mask: the decode attention of phases 5f and 5g
    "seamless cross, all valid": (CROSS_DECODE, "all"),
    "seamless cross, ragged prefix": (CROSS_DECODE, "ragged"),
    # self-attention in the KV cache at the middle decode step: prompt + 17 slots valid
    "seamless self": ((8, 16, 16, 1024, 64), 512),
    "pixtral self": ((8, 32, 8, 2048, 128), 1024),
}
FLASH_D120 = [(2, 32, 8, 200, 200, 120, True, None), (1, 4, 2, 70, 40, 120, True, None),
              (1, 8, 2, 300, 300, 120, True, 64),
              (8, 32, 8, 512, 512, 120, True, 4096)]   # phase 5e's prefill: h2o-danube-3-4b
GMM_SWEEP = [(4, 100, 96, 130), (2, 64, 256, 64), (8, 33, 48, 72)]   # E, C, D, F
GMM_THRESHOLD_C = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64)   # C timed in the moe_gmm designs
GMM_STREAM_SWEEP = [   # bf16 shapes of the stream design: ragged C and E, tails of D and F
    (3, 5, 96, 72), (5, 6, 4096, 200), (1, 3, 8, 8), (2, 4, 1000, 1032), (4, 8, 512, 264),
]
GMM_WGMMA_SWEEP = [   # bf16 shapes of the wgmma route: tails of C, D and F, C at the threshold
    (4, 200, 4096, 14336), (3, 200, 96, 72), (2, 640, 96, 14336), (1, 1280, 4096, 72),
    (2, 64, 4096, 4096),
]
GMM_MAIN = {   # E, C, D, F of the expert matmuls of mixtral-8x7b and jamba at the serving traffic
    "decode gate/up": (8, 2, 4096, 14336),
    "decode down": (8, 2, 14336, 4096),
    "prefill gate/up": (8, 1280, 4096, 14336),
    "prefill down": (8, 1280, 14336, 4096),
    "jamba decode gate/up": (16, 1, 4096, 14336),
    "jamba decode down": (16, 1, 14336, 4096),
    "jamba prefill gate/up": (16, 640, 4096, 14336),
    "jamba prefill down": (16, 640, 14336, 4096),
    "phi3.5 decode gate/up": (16, 1, 4096, 6400),        # phi3.5-moe-42b-a6.6b, phase 5i
    "phi3.5 decode down": (16, 1, 6400, 4096),
    "phi3.5 prefill gate/up": (16, 640, 4096, 6400),
    "phi3.5 prefill down": (16, 640, 6400, 4096),
}
MAMBA_SWEEP = [  # B, S, di, ds, with a state: tests/test_kernels.py, then tails and decode
    (2, 128, 64, 16, False), (1, 256, 128, 8, False), (2, 64, 32, 4, False),
    (2, 150, 64, 16, True), (3, 77, 333, 16, True), (4, 1, 256, 16, True),
]
RWKV_SWEEP = [   # B, T, H, hd, with a state
    (2, 128, 2, 64, False), (1, 64, 4, 32, False), (2, 96, 1, 16, False),
    (2, 150, 2, 64, True), (3, 1, 4, 64, True), (1, 70, 3, 32, True),
]
MAMBA_MAIN = {"prefill": (8, 512, 8192, 16), "decode": (8, 1, 8192, 16)}   # jamba, fp32
RWKV_MAIN = {"prefill": (8, 512, 32, 64), "decode": (8, 1, 32, 64)}       # rwkv6-1.6b, fp32
SCAN_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-3, 1e-2)}
MOE_LAYERS = 24              # of mixtral-8x7b's 32: 70.2 GB of bf16 weights
JAMBA_LAYERS = 24            # of jamba-v0.1-52b's 32, 3 groups of 8: 77.6 GB of bf16 weights
# phases 5h-5j: the three assigned architectures no earlier phase served, and
# their depth on one card of 85.0e9 bytes: phi4-mini whole (3.84 B parameters,
# 7.67 GB of bf16 weights); phi3.5-moe at 26 of 32 layers (2.60 GB a layer:
# 34.07 B parameters, 68.1 GB, under 5b's 70.2 GB, whose peak sat 2.4 GB above
# its weights); deepseek-67b at 48 of 95 (1.38 GB a layer and 3.36 GB of
# untied embeddings: 34.90 B, 69.8 GB, and a 1.6 GB KV cache)
ASSIGNED_LAYERS = {"phi4-mini-3.8b": 32, "phi3.5-moe-42b-a6.6b": 26, "deepseek-67b": 48}
MOE_PROMPT, MOE_SEQ, MOE_BATCH = 150, 192, 4     # phases 4b-4d
ENCDEC_PROMPT, ENCDEC_FRAMES = 40, 150           # phases 4f, 4g: S != T, both ragged
ENCDEC_MASK_LENGTHS = (150, 97, 31, 64)          # phase 4f's ragged enc_mask, a row each
PROMPT_LEN, NEW_TOKENS, SLOTS, MAX_SEQ = 512, 32, 8, 1024
PIXTRAL_SEQ = 2048           # phase 5g: 1024 patch embeddings and 32 new tokens
PROFILED_STEPS = 4
PROFILED_PREFILLS = 2
TIMED_PREFILLS = 3           # a turn of prefill_in_turns, phases 5-5j
GRAPH_DEVICE_TOL = 0.05      # a replay's device time against the eager step's, phases 5-5j
HOLD_CYCLES = 400_000        # ~0.2 ms of the card's clock, held before each timed launch
BWD_HOLD_CYCLES = 4_000_000  # ~2 ms: SDPA's backward, enqueued through the autograd engine
AES_SWEEP_N = (1, 38, 40, 4096, 2**20,
               513, 135169)          # ragged: not a multiple of a ttable pass, past the first
AES_NONCES = (0, 7, 2**31 - 20, 2**32 - 20)   # across the int32 sign wrap, and past 2**32
AES_FN_BLOCKS, AES_BATCH_BLOCKS = 38, 2**20   # 600 B; 16 MiB of plaintext
AES_LOOKUPS_PER_BLOCK = 160                   # 16 S-box lookups in each of 10 rounds
FIPS197_C1 = ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
              "69c4e0d86a7b0430d8cdb78070b4c55a")    # key, plaintext, ciphertext
BODY_CALLS = 200
AES_REQUESTS, MODEL_REQUESTS = 100, 50
FIG6_SLO_MS = 50.0           # phase 8: the p99 SLO of sustainable_throughput's AES sweep
# phase 9: every backend, gVisor on both platforms; the warm-path order that
# tests/test_backends.py::test_fig5_style_warm_latency_ordering asserts at 95 us
BACKEND_VARIANTS = ("junctiond", "containerd", "wasm", "firecracker", "gvisor",
                    "gvisor-ptrace", "quark")
WARM_ORDER = ("junctiond", "wasm", "containerd", "firecracker", "gvisor", "quark")
# phase 9c: AES bursts that make every backend scale up while none overloads
BURST = {"base_rps": 100.0, "burst_rps": 1200.0, "mean_quiet_s": 0.25, "mean_burst_s": 0.05}
BURST_DURATION_S, BURST_WARMUP_S, BURST_TARGET_INFLIGHT = 4.0, 0.3, 2.0
# phase 10b: a fleet of 4 workers (10 cores each) under AES at a rate both
# backends sustain with no rejection on the card's 79-120 us bodies; the
# provisioning storm at the scale of tests/test_fleet.py
FLEET_WORKERS, FLEET_RATE_RPS, FLEET_DURATION_S, FLEET_WARMUP_S = 4, 3000.0, 2.0, 0.3
STORM_WORKERS, STORM_REPLICAS = 32, 1000
# the runner's flat metrics that phase 10a prints, in order
PHASE10_METRICS = (
    "fig5_containerd_median", "fig5_junctiond_median", "fig5_median_reduction",
    "fig5_p99_reduction", "fig6_containerd_sustainable_rps", "fig6_junctiond_sustainable_rps",
    "fig6_throughput_ratio", "coldstart_ratio", "coldstart_storm_speedup",
    "fleet_tree_provisioning_speedup", "fleet_containerd_tree_speedup",
    "fleet_junctiond_tree_speedup", "autoscale_containerd_reaction",
    "autoscale_junctiond_reaction", "autoscale_reaction_ratio", "chain_containerd_hop_tax",
    "chain_junctiond_hop_tax", "chain_hop_tax_ratio")
TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-3, 1e-2)}   # (atol, rtol)
#: phase 3's AdamW checks: the rate of the checked calls, large enough that
#: a step moves a weight by ~1e-2 and its decay by ~1e-3 of that on a 0.02
#: weight (a tenth on a 1-D leaf of ones), far above the limit; the limit,
#: fp32's, on each element relative to |expect| + the rms of the tensor (a
#: bf16 weight: one bf16 ulp plus the limit times the rate)
ADAMW_CHECK_LR, ADAMW_RTOL = 1e-2, 3e-5
# phase 3: the flash backward beyond the sweep, (case, dtypes)
FLASH_BWD_MAIN = (8, 16, 8, 512, 512, 128, True, None)   # qwen3-1.7b's training shape, 11b
FLASH_BWD_CASES = [
    (FLASH_BWD_MAIN, ("bfloat16",)),
    ((8, 32, 8, 512, 512, 120, True, 4096), ("bfloat16",)),   # h2o-danube-3-4b's
    ((2, 4, 2, 192, 320, 64, True, None), ("float32", "bfloat16")),   # S < T: the causal offset
    ((1, 4, 2, 70, 40, 32, True, None), ("float32", "bfloat16")),   # S > T: rows that see no key
    ((2, 8, 4, 256, 256, 64, False, None), ("float32", "bfloat16")),   # not causal
    ((2, 8, 4, 512, 512, 120, True, 128), ("bfloat16",)),      # a window that bites, d 120
    ((2, 8, 4, 512, 512, 64, True, 128), ("bfloat16",)),       # and d 64
    ((8, 24, 8, 512, 512, 128, True, None), ("bfloat16",)),    # phi4-mini's G = 3, 11g
    ((8, 64, 8, 512, 512, 128, True, None), ("bfloat16",)),    # deepseek-67b's G = 8, 11g
]
FLASH_BWD_ASSIGNED = {"phi4-mini training": FLASH_BWD_CASES[-2][0],
                      "deepseek-67b training": FLASH_BWD_CASES[-1][0]}
# phase 3: the backward of the key-masked routes, (B, Hq, Hkv, S, T, d, causal,
# window, mask): G 1, 2 and 4, d 32 to 128, causal, not and windowed, most
# masks with a row that has no allowed valid key (masked_bwd_valid)
MASKED_BWD_SWEEP = [
    (2, 4, 2, 128, 128, 64, True, None, "ragged"),      # G 2, causal
    (2, 8, 2, 96, 96, 64, True, 32, "ragged"),          # G 4 under a window
    (2, 2, 2, 64, 192, 32, True, None, "future"),       # G 1, d 32, S < T
    (2, 4, 4, 128, 128, 128, False, None, "ragged"),    # d 128, not causal
    (3, 4, 4, 70, 129, 120, False, None, "ragged"),     # d 120, tile edges
    (2, 8, 2, 96, 200, 128, False, None, "ragged"),     # G 4, d 128
    (2, 4, 2, 160, 300, 120, True, 96, "future"),       # causal window, d 120, S < T
    (4, 4, 2, 300, 1000, 32, False, None, "holes"),     # dead tiles mid-row
    (2, 2, 1, 130, 700, 128, False, 200, "holes"),      # and under a window
    (2, 4, 2, 90, 60, 32, True, None, "ragged"),        # S > T: rows at negative positions
    (2, 8, 2, 512, 1500, 64, False, None, "cross"),     # G 4 at T 1500
    (8, 16, 16, 512, 1500, 64, False, None, "cross"),   # 11f's cross-attention, row 1m's mask
]
# phase 11: training; 11a reduced, card against CPU (h2o's window of 128 under
# a longer sequence), 11b full-width qwen3-1.7b
TRAIN_REDUCED = {"qwen3-1.7b": 64, "h2o-danube-3-4b": 160}   # seq_len by arch, batch 4
TRAIN_REDUCED_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4
# 11b's AdamW: full from the first step, cosine over the 4 steps.  At 1e-3
# the loss fell once (12.35 -> 10.68) and then rose (18.63, 14.31).  At 3e-4
# it also rises at step 3 (18.69) and ends below step 1; SDPA's attention in
# place of the kernels gives the same rise there, so at 3e-4 the rise is the
# optimizer's on a freshly drawn model, not the kernels' (not run at 1e-3).
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
# 11b against SDPA's attention over the same steps: relative limits on the
# loss and the grad norm of each step, from the readings on the H100 (loss
# 1.8e-5, 1.6e-4 to 4e-4, 4.3e-5, 4.0e-4; grad norm 1.2e-4, 3.4e-4, 8.2e-5,
# 2.1e-4), wider at later steps, where SDPA's run-to-run spread (its
# backward sums with atomics) has been carried through more updates
TRAIN_SDPA_RTOL = (1e-3, 2e-3, 5e-3, 1e-2)
GMM_TOL = {"float32": (2e-3, 2e-4), "bfloat16": TOL["bfloat16"]}
# the flash backward's kernels, the pair of each route: none in a serving run
NO_FLASH_BWD_ROUTES = {f"bwd_{kernel}{design}": 0 for kernel in ("dq", "dkv")
                       for design in ("", "_wgmma", "_masked", "_wgmma_masked", "_wgmma_live")}
# the backward kernels of the MoE matmul and the scans, and AdamW's kernels, by
# route: none in a serving run
NO_BWD_ROUTES = {"moe_gmm_bwd": {"dx_wgmma_nt": 0, "dw_wgmma_tn": 0, "dx_wgmma_nt_fwd": 0,
                                 **{f"{p}_{r}": 0 for p in ("dx", "dw")
                                    for r in ("stream", "wgmma", "mma_sync")}},
                 "mamba_scan_bwd": {"ring": 0, "ckpt": 0}, "rwkv6_scan_bwd": {"ring": 0, "rows": 0},
                 "adamw": {"sumsq": 0, "norm": 0, "update": 0}}
# phase 3: the backward kernels at the training shapes of phase 11d (8 x 512
# tokens: capacity 1280 for mixtral's 8 experts, 640 for Jamba's 16)
GMM_BWD_MAIN = {   # E, C, D, F
    "mixtral gate/up": (8, 1280, 4096, 14336), "mixtral down": (8, 1280, 14336, 4096),
    "jamba gate/up": (16, 640, 4096, 14336), "jamba down": (16, 640, 14336, 4096),
    "phi3.5 gate/up": (16, 640, 4096, 6400), "phi3.5 down": (16, 640, 6400, 4096),   # 11g's
}
GMM_BWD_SWEEP = GMM_SWEEP + [(3, 200, 96, 72), (2, 64, 256, 64), (2, 100, 64, 64),
                             (2, 300, 200, 264)]   # the tails of a 256-row box of w
MAMBA_BWD_SWEEP = MAMBA_SWEEP + [(2, 40, 96, 5, True)]
# a gradient that sums over channels, batch rows or time, held at this share
# of its largest magnitude (fp32); the others at the forward's limits
SUM_REL = 1e-4
# phase 11c: reduced mixtral, 8-layer Jamba and RWKV6 trained card against CPU;
# 11d: full-width bf16 training of each (layers, batch) at 512 tokens
TRAIN_FAMILY_REDUCED = {"mixtral-8x7b": 2, "jamba-v0.1-52b": 8, "rwkv6-1.6b": 2}
TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS = 64, 3
#: the families that 11c holds step by step (each card step from the CPU run's
#: weights and moments); the others run free for all 3 steps
TRAIN_FAMILY_RESYNC = ("rwkv6-1.6b",)
TRAIN_FAMILY_FULL = {"mixtral-8x7b": (2, 8), "jamba-v0.1-52b": (2, 8), "rwkv6-1.6b": (24, 8)}
# 11g: full-width bf16 training of the three assigned architectures of 5h-5j,
# (layers, batch) at 512 tokens: phi4-mini at 16 of 32 layers (2.23 B
# parameters), phi3.5-moe at 2 of 32 (2.86 B) and deepseek-67b at 2 of 95
# (3.06 B), near 40, 52 and 55 GB at 11d's ~18 bytes a parameter
TRAIN_ASSIGNED_FULL = {"phi4-mini-3.8b": (16, 8), "phi3.5-moe-42b-a6.6b": (2, 8),
                       "deepseek-67b": (2, 8)}
# 11d's AdamW: a tenth of 11b's lr.  Under 11b's schedule full-width 2-layer
# mixtral's loss rose 10.74 -> 19.42 and ended at 13.84, and warmed up over
# the 4 steps it still ended above step 1 (12.17); the same steps with the
# library's attention and expert matmuls in place of the kernels gave the
# same losses to 1e-3 (H100, PERF.md), so the rise is the optimizer's on a
# freshly drawn model
TRAIN_FAMILY_OPT = dict(lr=3e-5, warmup_steps=1, total_steps=TRAIN_STEPS)
# 11e: reduced seamless-m4t (4 x 64 decoder tokens over 150 stub frames under a
# ragged enc_mask with a fully masked row) and pixtral-12b (4 x 64 stub patch
# embeddings), card against CPU, free-running: on the CPU a 1e-6 nudge of the
# weights moves their step-3 grad norms by 2.2e-6 and 3.4e-6 of themselves
# (tests/test_torch_family_bwd.py::test_trajectory_sensitivity_to_a_weight_nudge)
TRAIN_ENCDEC_FRAMES, TRAIN_ENCDEC_MASK_LENGTHS = 150, (150, 0, 97, 31)
# 11f: full-width seamless-m4t at full depth over 8 x 1500 stub frames under
# 5f's ragged enc_mask, and pixtral-12b cut in depth: 10 of its 40 layers
# (4.09 B parameters, 49 GB at 12 bytes each; all 40 would take 147 GB)
PIXTRAL_TRAIN_LAYERS = 10


def phase(name: str) -> None:
    print(f"\n== {name}  [{time.perf_counter() - START:.1f} s]", flush=True)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def check_close(name: str, out, expect, tol) -> float:
    """Max |out - expect|; raises unless every element is finite and within
    atol + rtol * |expect|, ``tol`` = (atol, rtol)."""
    atol, rtol = tol
    out, expect = out.float(), expect.float()
    err = (out - expect).abs()
    bad = err > atol + rtol * expect.abs()
    if not bool(out.isfinite().all()) or bool(bad.any()):
        raise AssertionError(f"{name}: max |diff| {float(err.max()):.3g} over "
                             f"atol {atol}, rtol {rtol}")
    return float(err.max())


def check_scaled(name: str, out, expect, rtol: float) -> float:
    """Max |out - expect| / (|expect| + rms(expect)); raises unless every
    element is finite and that is within ``rtol``: fp32's limit held on the
    tensor's own scale, where a fixed atol could be larger than the values."""
    out, expect = out.float(), expect.float()
    rel = (out - expect).abs() / (expect.abs() + expect.square().mean().sqrt())
    worst = float(rel.max())
    if not bool(out.isfinite().all()) or not worst <= rtol:
        raise AssertionError(f"{name}: max |diff| / (|expect| + rms) {worst:.3g} over {rtol}")
    return worst


def check_bf16_ulp(name: str, out, expect, atol: float) -> tuple:
    """Raises unless the bf16 tensors are within one bf16 ulp plus ``atol``
    of each other everywhere: each side rounds its fp32 value once, and the
    fp32 values differ by fp32's error on the operands, which is more than
    an ulp only where a result near zero came of cancellation.  Returns the
    counts of elements one ulp apart and of those past one ulp (within
    ``atol``)."""
    a, b = out.float(), expect.float()
    _, e = a.abs().maximum(b.abs()).frexp()
    ulp = (e - 8).float().exp2()          # |x| in [2^(e-1), 2^e): 8 bits of mantissa
    diff = (a - b).abs()
    if not bool(a.isfinite().all()) or bool((diff > ulp + atol).any()):
        raise AssertionError(f"{name}: {int((diff > ulp + atol).sum())} elements more than "
                             f"one bf16 ulp + {atol:.3g} apart, max |diff| "
                             f"{float(diff.max()):.3g}")
    return int(((diff != 0) & (diff <= ulp)).sum()), int((diff > ulp).sum())


def layer_counts(cfg) -> dict:
    """The layers of ``cfg`` by what they run: attention, Mamba, RWKV6, MoE."""
    kinds = [k.value for k in cfg.block_kinds()]
    return {"attn": sum(k.startswith("attn") for k in kinds),
            "mamba": sum(k.startswith("mamba") for k in kinds),
            "rwkv": kinds.count("rwkv"),
            "moe": sum(k.endswith("_moe") for k in kinds)}


def tree_bytes(tree) -> int:
    """Bytes of the tensors in a tree of dicts and tuples."""
    if isinstance(tree, (dict, tuple)):
        return sum(tree_bytes(v) for v in (tree.values() if isinstance(tree, dict) else tree))
    return tree.numel() * tree.element_size()


def free_card(torch, label: str) -> None:
    """Free what the phases before ``label`` left on the card, and fail
    unless less than 1 GB stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"  before the draw: {held} bytes allocated on the card")
    if held > 1e9:
        raise AssertionError(f"{held} bytes still allocated before {label}")


def launch_times_ms(torch, fn, iters: int, flush, hold: int = HOLD_CYCLES) -> list:
    """Device time of each of ``iters`` launches of ``fn``, L2 flushed
    before each (outside the timed span).  After the flush the card spins
    for ``hold`` cycles while the host records the start event and enqueues
    ``fn``, so that the host's time to dispatch ``fn`` stays out of the span."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(hold)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` launches."""
    return statistics.fmean(launch_times_ms(torch, fn, iters, flush))


def in_turns(torch, previous, new, iters: int, flush, hold: int = HOLD_CYCLES):
    """Launch times of two designs timed in turns, previous, new, new,
    previous, ``iters`` launches a turn: (previous's, new's)."""
    old, cur = [], []
    for fn, into in ((previous, old), (new, cur), (new, cur), (previous, old)):
        into += launch_times_ms(torch, fn, iters, flush, hold)
    return old, cur


def spread(ts) -> str:
    return (f"median {statistics.median(ts):.4f} mean {statistics.fmean(ts):.4f} "
            f"over {len(ts)}")


def device_top(torch, prof, per: int):
    """Device time of the kernels a profile saw, divided by ``per``, and the
    six that take most of it; (None, []) when it saw no kernel."""
    device_us, top, _ = device_profile(torch, prof, per)
    return device_us, top


def device_profile(torch, prof, per: int):
    """``device_top``'s pair and the kernels run, each divided by ``per``."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [(e.key, e.self_device_time_total) for e in events]
    total = sum(us for _, us in kernels)
    runs = sum(e.count for e in events) / per
    if not total:
        return None, [], runs
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    return total / per, [(k, us / per) for k, us in top], runs


def prompt_len(batch) -> int:
    """Positions a prefill of ``batch`` fills: its tokens or embeddings."""
    return (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]


def profile_prefill(torch, eng, batch):
    """Device time and host wall time of a prefill of ``batch`` through the
    engine ``eng`` (its graph's replay, or the eager prefill, as
    ``eng.prefill_mode`` says), both over the same ``PROFILED_PREFILLS``
    profiled prefills, the kernels that take most of the device time and
    the kernels a prefill runs.  The profiler traces the card's activity
    only, as ``profile_decode``'s."""
    from torch.profiler import ProfilerActivity, profile

    eng.prefill(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_PREFILLS):
            eng.prefill(batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / PROFILED_PREFILLS
    device_us, top, kernels = device_profile(torch, prof, PROFILED_PREFILLS)
    return device_us, wall_us, top, kernels


def profile_decode(torch, eng, batch):
    """Device time and host wall time of one decode step of the engine
    ``eng`` (its graph's replay, or the eager step, as ``eng.decode_mode``
    says) after a prefill of ``batch``, both over the same
    ``PROFILED_STEPS`` profiled steps, the kernels that take most of the
    device time and the kernels a step runs.  The profiler traces the
    card's activity only: the host's ops of an eager step, traced, would
    take seconds to read back.  Device time is None when the profiler sees
    no kernel."""
    from torch.profiler import ProfilerActivity, profile

    lg = eng.prefill(batch)
    pos = prompt_len(batch)
    tok = lg.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED_STEPS):
            tok = eng.decode_step(tok, pos + i).argmax(-1)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / PROFILED_STEPS
    device_us, top, kernels = device_profile(torch, prof, PROFILED_STEPS)
    return device_us, wall_us, top, kernels


def prefill_in_turns(torch, eng, batch) -> dict:
    """Host-clock ms of ``TIMED_PREFILLS`` prefills of ``batch`` through the
    engine ``eng`` a turn, each up to a synchronize, replayed and eager in
    turns (graph, eager, eager, graph), each turn after one untimed prefill
    of its design (so that the eager prefill finds the allocator's cache
    grown again after a capture emptied it): {"graph": [...], "eager": [...]}."""
    times = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        eng.prefill_mode = mode
        eng.prefill(batch)
        torch.cuda.synchronize()
        for _ in range(TIMED_PREFILLS):
            t0 = time.perf_counter()
            eng.prefill(batch)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0))
    eng.prefill_mode = "graph"
    return times


def set_modes(eng, mode: str) -> None:
    """Both steps of the engine ``eng`` replayed (``"graph"``) or eager."""
    eng.prefill_mode = eng.decode_mode = mode


def print_profiles(torch, eng, batch) -> dict:
    """Profile ``PROFILED_STEPS`` decode steps of ``eng`` on ``batch`` as
    its graph's replay, then as the eager step, and ``PROFILED_PREFILLS``
    prefills the same two ways; print each one's device time, wall time,
    idle share, kernels run and top kernels.  Returns {"graph", "eager",
    "prefill graph", "prefill eager": (device us, wall us, kernels)}, a
    decode step's for the first two and a prefill's for the others; device
    us None where the profiler saw no kernel."""
    out = {}
    for key, what in (("graph", f"decode step (graph replay) over {PROFILED_STEPS} "
                                "profiled steps"),
                      ("eager", f"decode step (eager) over {PROFILED_STEPS} profiled steps"),
                      ("prefill graph", f"prefill (graph) over {PROFILED_PREFILLS} profiled "
                                        "prefills"),
                      ("prefill eager", f"prefill (eager) over {PROFILED_PREFILLS} profiled "
                                        "prefills")):
        mode = key.split()[-1]
        if key.startswith("prefill"):
            eng.prefill_mode = mode
            device_us, wall_us, top, kernels = profile_prefill(torch, eng, batch)
        else:
            eng.decode_mode = mode
            device_us, wall_us, top, kernels = profile_decode(torch, eng, batch)
        out[key] = (device_us, wall_us, kernels)
        if device_us is None:
            print(f"{what}: device time not measured (the profiler saw no kernel); "
                  f"wall_us {wall_us:.1f}")
            continue
        print(f"{what}: device_us {device_us:.1f}  wall_us {wall_us:.1f}  "
              f"device idle share {1 - device_us / wall_us:.3f}  kernels {kernels:.1f}")
        for name, us in top:
            print(f"  {us:10.1f} us  {name[:100]}")
    set_modes(eng, "graph")
    return out


# phase 12a: the prefill_32k pairs whose ops torch 2.11 (the card's host)
# could not place before the port's DTensor rules, and each pair's per-device
# figures on torch 2.13 (python -m repro_torch.launch.dryrun --no-probes on a
# CPU host; PERF.md section 6), which the card's host must give within 1 %
DRYRUN_PREFILLS = (("mixtral-8x7b", "prefill_32k"), ("h2o-danube-3-4b", "prefill_32k"),
                   ("jamba-v0.1-52b", "prefill_32k"))
DRYRUN_213 = {  # peak B, flops, bytes accessed, collective bytes
    ("qwen3-1.7b", "decode_32k"): (2850549796.0, 5478547456.0, 48627237860.0, 13363275324.0),
    # its update traced as the AdamW kernel moves it (trace_ops.adamw_leaf)
    ("mixtral-8x7b", "train_4k"): (189875150924.0, 544215306076160.0, 37263807872312.0,
                                   5949099432699.0),
    ("mixtral-8x7b", "prefill_32k"): (126289788948.0, 3775731552485376.0, 26701793626972.0,
                                      575959739271.0),
    ("h2o-danube-3-4b", "prefill_32k"): (37211225604.0, 79918634680320.0, 3992912573084.0,
                                         45240810055.0),
    ("jamba-v0.1-52b", "prefill_32k"): (127372269592.0, 1907957683978240.0, 11870205611452.0,
                                        368774134151.0)}
DRYRUN_FIGURES = ("peak", "flops", "bytes accessed", "collective bytes")


DRYRUN_12A_PAIRS = ([("qwen3-1.7b", "decode_32k", True), ("mixtral-8x7b", "train_4k", False),
                      ("mixtral-8x7b", "train_4k", False)]
                     + [(a, s, False) for a, s in DRYRUN_PREFILLS])


def assigned_dry_pairs(shape, cfg, run):
    """The dry-run pairs of phase 13d beside a run of ``shape``: (the
    reference's shape name, the InputShape at the run's batch and length,
    the measured figure it is read against)."""
    from repro_torch.config import InputShape, StepKind
    B, S = run.batch, run.seq_len
    if shape == "train_4k":
        return [("train_4k", InputShape("train_4k", S, B, StepKind.TRAIN), "step")]
    if shape == "serve_32k":
        return [("prefill_32k", InputShape("prefill_32k", S, B, StepKind.PREFILL), "prefill"),
                ("decode_32k", InputShape("decode_32k", S + NEW_TOKENS, B, StepKind.DECODE),
                 "decode step")]
    return [("long_500k", InputShape("long_500k", S + NEW_TOKENS, B, StepKind.DECODE),
             "decode step")]


def host_12a() -> dict:
    """Phase 12a's host-only work, run in a worker process while the card
    runs the phases before it: the traces on the production mesh (its two
    traces of mixtral x train_4k in this one process) and perf's variant.
    Meta tensors and a fake process group only: nothing touches the card."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.config import get_arch
    from repro_torch.launch import dryrun, perf

    out = {"torch": torch.__version__, "12a": []}
    for arch, shape, probes in DRYRUN_12A_PAIRS:
        t0 = time.perf_counter()
        rec = dryrun.run_pair(arch, shape, probes=probes, verbose=False)
        out["12a"].append((arch, shape, probes, rec, time.perf_counter() - t0))
    variants = {n: p for n, p, _ in perf.variants_for("train_4k", "mixtral-8x7b")}
    two = dryrun.with_layers(get_arch("mixtral-8x7b"), 2)
    out["12a variant"] = dryrun.run_pair("mixtral-8x7b", "train_4k", probes=False,
                                         verbose=False, policy=variants["chunked_attn+ep"],
                                         cfg=two)
    return out


def host_plan() -> dict:
    """Phase 13's plan (``launch.fit.plans``), reckoned in a worker
    process."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import fit

    t0 = time.perf_counter()
    plan = list(fit.plans())
    return {"plan": plan, "plan seconds": time.perf_counter() - t0}


def host_13d() -> dict:
    """Phase 13d's dry run on a 1-rank mesh at every pair the plan runs,
    the plan reckoned again in this worker process, beside the one that
    hands it to phase 13 at once."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, teardown_mesh

    t_all = time.perf_counter()
    out = {}
    one = make_mesh((1, 1), ("data", "model"))
    for shape, cfg, run, _ in host_plan()["plan"]:
        if run is None:
            continue
        for name, shp, _ in assigned_dry_pairs(shape, cfg, run):
            t0 = time.perf_counter()
            rec = dryrun.run_pair(cfg.name, name, probes=False, verbose=False, mesh=one,
                                  cfg=cfg, shape=shp)
            dryrun.require_placed(rec)
            out[(cfg.name, name)] = dict(
                peak=rec["memory"]["peak_bytes"], step_ms=1e3 * rec["roofline"]["step_time_s"],
                bottleneck=rec["roofline"]["bottleneck"], note=rec["note"],
                seconds=time.perf_counter() - t0)
    teardown_mesh()
    return {"13d": out, "seconds": time.perf_counter() - t_all}


def dry_run_and_options(torch, dev, rng, decode_device_us, train_measured,
                        phi4_decode_us, host: dict) -> None:
    """Phase 12.  12a (host, no kernel): ``dryrun.run_pair`` on the 256-rank
    production mesh (data 32 x model 8) for qwen3-1.7b x decode_32k with its
    probes, mixtral-8x7b x train_4k twice (the two records' figures equal)
    and ``DRYRUN_PREFILLS``, each with no op run replicated
    (``dryrun.require_placed``) and its figures within 1 % of
    ``DRYRUN_213``; and perf's expert-parallel variant of mixtral x
    train_4k at 2 of its 32 layers (its all-to-all must move bytes).  12b: the dry run on a 1-rank mesh at phase 11b's training step
    and phase 5's decode step of full-width qwen3-1.7b, and at phase 5h's
    decode step of phi4-mini-3.8b (``phi4_decode_us``); its parameter,
    moment and KV-cache bytes must equal those of the card's tensors, and its
    roofline step time must not exceed the device time those phases
    measured.  12c: full-width qwen3-1.7b on the card, 32 greedy tokens with
    ``cache_update="select"`` equal to the in-place path's; a prefill under
    ``attn_impl="chunked"`` and decode steps under ``mixed_precision`` with
    every plain attention refused, their launches by route those of the
    default path.  Then ``examples/quickstart_torch.py`` on the card's
    measured AES body: junctiond's median and p99 below containerd's; and
    ``examples/serve_e2e_torch.py``: junctiond's median below containerd's."""
    import os
    from repro_torch.config import InputShape, StepKind, get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, teardown_mesh
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.optimizer import init_state

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def roofline_line(r):
        return (f"compute {1e3 * r['compute_s']:.3f} ms, memory {1e3 * r['memory_s']:.3f} ms, "
                f"collective {1e3 * r['collective_s']:.3f} ms -> {r['bottleneck']}-bound, "
                f"step {1e3 * r['step_time_s']:.3f} ms, useful ratio {r['useful_ratio']:.4f}")

    # -- 12a: the production mesh, on the host ------------------------------------------
    launches_before = dict(ops.LAUNCHES)
    t_phase = time.perf_counter()
    print("12a the dry run on the production mesh (predictions: the H100 SXM's data-sheet "
          "figures at 700 W; per device):")
    print(f"  torch {host['torch']}; the 2.13 figures are a CPU host's sweep "
          f"(PERF.md section 6)")
    figures = {}
    for arch, shape, probes, rec, seconds in host["12a"]:
        cost, r, mem = rec["cost"], rec["roofline"], rec["memory"]
        mine = (mem["peak_bytes"], cost["flops"], cost["bytes accessed"],
                sum(cost["collective bytes by kind"].values()))
        apart = {k: a / b - 1
                 for k, a, b in zip(DRYRUN_FIGURES, mine, DRYRUN_213[(arch, shape)])}
        print(f"  {arch} x {shape} x {rec['mesh']} ({rec['chips']} ranks, "
              f"{'probes ' + str([p['layers'] for p in rec['probes']]) if probes else 'no probes'}"
              f", {seconds:.1f} s of host time): peak {mem['peak_bytes']:.6g} B "
              f"(parameters {mem['params_bytes']:.6g}), flops {cost['flops']:.6g}, bytes "
              f"accessed {cost['bytes accessed']:.6g}; against torch 2.13 "
              f"{ {k: f'{v:+.2e}' for k, v in apart.items()} }")
        print(f"    collective bytes by kind {cost['collective bytes by kind']}, by axis "
              f"{cost['collective bytes by axis']}; ops run replicated (no DTensor rule) "
              f"{cost[dryrun.REPLICATED]}, views placed by the port "
              f"{cost['views placed']}, view gathers {cost['view gathers']}")
        print(f"    roofline: {roofline_line(r)}")
        dryrun.require_placed(rec)
        if any(abs(v) > 0.01 for v in apart.values()):
            raise AssertionError(f"12a {arch} x {shape}: more than 1 % from torch 2.13's "
                                 f"figures: {apart}")
        for k in ("compute_s", "memory_s", "collective_s", "step_time_s", "useful_ratio"):
            if not (math.isfinite(r[k]) and r[k] > 0):
                raise AssertionError(f"12a {arch} x {shape}: {k} {r[k]}")
        again = figures.setdefault((arch, shape), dryrun.record_figures(rec))
        if again != dryrun.record_figures(rec):
            raise AssertionError(f"12a {arch} x {shape}: two traces in one process differ: "
                                 f"{again} against {dryrun.record_figures(rec)}")
    print("  mixtral-8x7b x train_4k traced twice in one process (the host-side worker, "
          "``host_12a``): every figure equal")
    rec = host["12a variant"]
    a2a = rec["cost"]["collective bytes by kind"].get("all-to-all", 0.0)
    print(f"  perf's chunked_attn+ep on mixtral-8x7b x train_4k at 2 of 32 layers: collective "
          f"bytes by kind {rec['cost']['collective bytes by kind']}")
    if not a2a > 0:
        raise AssertionError("12a: the expert-parallel variant moved no byte by all-to-all")
    if dict(ops.LAUNCHES) != launches_before:
        raise AssertionError(f"12a launched kernels: {dict(ops.LAUNCHES)}")
    print(f"  12a took {sum(x[-1] for x in host['12a']):.1f} s of the worker's host time, "
          f"{time.perf_counter() - t_phase:.1f} s here; no kernel launched")

    # -- 12b: the card against the dry run ------------------------------------------------
    one = make_mesh((1, 1), ("data", "model"))

    def card_bytes(cfg, moments=False):
        """Bytes of the parameters and the serving KV cache of ``cfg`` drawn
        on the card (and of AdamW's moments), freed again."""
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
        caches = T.init_caches(params, cfg, SLOTS, MAX_SEQ)
        out = {"params": nbytes(params), "cache": nbytes(caches)}
        if moments:
            st = init_state(params)
            out["opt"] = nbytes(st.mu) + nbytes(st.nu)
            del st
        del params, caches
        gc.collect()
        torch.cuda.empty_cache()
        return out

    qwen3, phi4 = get_arch("qwen3-1.7b"), get_arch("phi4-mini-3.8b")
    cards = {qwen3.name: card_bytes(qwen3, moments=True), phi4.name: card_bytes(phi4)}
    decode = InputShape("decode", MAX_SEQ, SLOTS, StepKind.DECODE)
    for label, cfg, shape, measured_us, state, peak in (
            ("phase 5's decode step", qwen3, decode, decode_device_us, ("params", "cache"), None),
            ("phase 11b's training step", qwen3,
             InputShape("train", TRAIN_SEQ, TRAIN_BATCH, StepKind.TRAIN),
             train_measured["device_us"], ("params", "opt"), train_measured["peak"]),
            ("phase 5h's decode step of phi4-mini-3.8b", phi4, decode, phi4_decode_us,
             ("params", "cache"), None)):
        card = cards[cfg.name]
        rec = dryrun.run_pair(cfg.name, "decode_32k", probes=False, verbose=False, mesh=one,
                              cfg=cfg, shape=shape)
        r, mem = rec["roofline"], rec["memory"]
        print(f"12b {label} ({shape.global_batch} x {shape.seq_len}) on a 1-rank mesh: "
              f"{roofline_line(r)}; measured device time {measured_us:.1f} us")
        for k in state:
            print(f"    {k} bytes: dry run {int(mem[k + '_bytes'])}, the card's tensors {card[k]}")
            if int(mem[k + "_bytes"]) != card[k]:
                raise AssertionError(f"12b {label}: {k} bytes {mem[k + '_bytes']} against "
                                     f"the card's {card[k]}")
        print(f"    predicted peak {mem['peak_bytes']:.6g} B"
              + (f", torch.cuda.max_memory_allocated {peak}" if peak else ""))
        if measured_us is None or not 1e6 * r["step_time_s"] <= measured_us:
            raise AssertionError(f"12b {label}: roofline step {1e6 * r['step_time_s']:.1f} us "
                                 f"above the measured device time {measured_us}")
    teardown_mesh()

    # -- 12c: the options on the card -----------------------------------------------------
    cfg = qwen3
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT_LEN)), device=dev)

    def greedy(n, prefill_opts=None, decode_opts=None):
        with torch.inference_mode():
            lg, caches = T.prefill(params, cfg, {"tokens": toks}, seq_len=MAX_SEQ,
                                   **(prefill_opts or {}))
            tok, out, times = lg.argmax(-1), [], []
            out.append(tok[:, 0].tolist())
            for i in range(n - 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, caches = T.decode_step(params, cfg, tok, PROMPT_LEN + i, caches,
                                           **(decode_opts or {}))
                tok = lg.argmax(-1)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                out.append(tok[:, 0].tolist())
        return out, times

    greedy(2)                                             # warm-up
    dus, dus_t = greedy(NEW_TOKENS)
    sel, sel_t = greedy(NEW_TOKENS, decode_opts={"cache_update": "select"})
    print(f"12c {NEW_TOKENS} greedy tokens of {SLOTS} prompts of {PROMPT_LEN}: in place mean "
          f"step {1e3 * statistics.fmean(dus_t):.3f} ms, select {1e3 * statistics.fmean(sel_t):.3f}"
          f" ms; tokens equal: {sel == dus}")
    if sel != dus:
        raise AssertionError("12c: cache_update='select' served other tokens than the in-place path")

    def routes_of(prefill_opts, decode_opts, steps=4):
        ops.reset_launches()
        greedy(steps + 1, prefill_opts, decode_opts)
        return {op: dict(ops.ROUTE_LAUNCHES[op]) for op in ("flash_attention",
                                                            "decode_attention")}

    default = routes_of(None, None)
    plain = {(ref, "flash_attention_ref"), (ref, "decode_attention_ref"),
             (attention, "chunked_gqa_attend"), (attention, "gqa_attend")}
    kept = {(m, n): getattr(m, n) for m, n in plain}

    def refuse(*args, **kwargs):
        raise AssertionError("12c: an option put a CUDA tensor on a plain path")

    try:
        for m, n in plain:
            setattr(m, n, refuse)
        optioned = routes_of({"attn_impl": "chunked"},
                             {"mixed_precision": True, "cache_update": "select"})
    finally:
        for (m, n), fn in kept.items():
            setattr(m, n, fn)
    print(f"  launches by route, default path {default}; chunked prefill, mixed-precision "
          f"select decode {optioned}")
    L = cfg.n_layers
    if default != optioned or default["flash_attention"]["wgmma"] != L or \
            default["decode_attention"]["split"] != 4 * L:
        raise AssertionError(f"12c: routes {optioned} against the default path's {default}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- the example on the card ---------------------------------------------------------
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    print("examples/quickstart_torch.py on the card:")
    for line in run.stdout.splitlines():
        print(f"  {line}")
    if run.returncode != 0:
        raise AssertionError(f"quickstart_torch.py failed: {run.stderr[-2000:]}")
    stats = {}
    for line in run.stdout.splitlines():
        m = re.match(r"(\w+)\s*: e2e median=([\d.]+) ms p99=([\d.]+) ms", line)
        if m:
            stats[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    j, c = stats["junctiond"], stats["containerd"]
    if not (j[0] < c[0] and j[1] < c[1]):
        raise AssertionError(f"junctiond's median and p99 {j} not below containerd's {c}")
    run = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_e2e_torch.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    print("examples/serve_e2e_torch.py on the card:")
    for line in run.stdout.splitlines():
        print(f"  {line}")
    if run.returncode != 0:
        raise AssertionError(f"serve_e2e_torch.py failed: {run.stderr[-2000:]}")
    medians = {m.group(1): float(m.group(2)) for m in
               re.finditer(r"(\w+)\s*: e2e median=([\d.]+) ms", run.stdout)}
    if not medians["junctiond"] < medians["containerd"]:
        raise AssertionError(f"serve_e2e_torch.py: junctiond's median not below containerd's "
                             f"{medians}")


def control_plane(aes_us: float, endpoints: dict) -> None:
    """Phase 9: the six backends, the autoscaler and the sanitizer on the
    bodies the card measured, simulated on the host.  ``aes_us`` is phase
    7's deployed AES body and ``endpoints`` phases 5-5d's decode steps (us);
    a missing or non-finite body fails the phase.  Launches no kernel."""
    from repro_torch.analysis import sanitizer
    from repro_torch.core import (Autoscaler, BurstyArrivals, FaasdRuntime, FunctionSpec,
                                  GVisor, LeadTimePolicy, LoadSpec, Simulator,
                                  available_backends, drive, run_sequential)

    want = ("rwkv6-1.6b", "qwen3-1.7b", "mixtral-8x7b", "jamba-v0.1-52b")
    bodies = {"aes": aes_us, **{n: endpoints.get(n) for n in want}}
    bad = {n: us for n, us in bodies.items()
           if not (isinstance(us, float) and math.isfinite(us) and us > 0)}
    if bad or set(endpoints) != set(want):
        raise AssertionError(f"phase 9 needs the bodies the card measured: {bad or endpoints}")
    if set(available_backends()) | {"gvisor-ptrace"} != set(BACKEND_VARIANTS):
        raise AssertionError(f"backends {available_backends()} against {BACKEND_VARIANTS}")

    def runtime(variant):
        """A runtime of 10 cores on ``Simulator(seed=1)``, phase 7's."""
        sim = Simulator(seed=1)
        if variant == "gvisor-ptrace":
            return FaasdRuntime(sim, backend=GVisor(sim, platform="ptrace"))
        return FaasdRuntime(sim, backend=variant)

    def spec(name):
        if name == "aes":
            return FunctionSpec(name="aes", work_us=aes_us)
        return FunctionSpec(name=name, work_us=bodies[name], payload_bytes=2048,
                            response_bytes=4096)

    # -- 9a: phase 7's closed loop on every backend -------------------------
    print("9a closed loop, Simulator(seed=1), run_sequential (wasm's work_mult 1.35 scales the "
          "card's body inside its sandbox):")
    for name, us in bodies.items():
        n_req = AES_REQUESTS if name == "aes" else MODEL_REQUESTS
        runs = {}
        for variant in BACKEND_VARIANTS:
            rt = runtime(variant)
            rt.deploy_blocking(spec(name))
            s = run_sequential(rt, name, n=n_req)
            if s.n != n_req:
                raise AssertionError(f"{name} on {variant}: {s.n} latencies for {n_req}")
            runs[variant] = s
        j = runs["junctiond"].median_ms
        print(f"  {name} (work_us {us:.1f} measured):")
        for variant, s in runs.items():
            print(f"    {variant:13s} median_ms {s.median_ms:10.4f}  p99_ms {s.p99_ms:10.4f}  "
                  f"n {s.n}  median x junctiond {s.median_ms / j:.3f}")
        low = min(runs, key=lambda v: runs[v].median_ms)
        if low != "junctiond":
            raise AssertionError(f"{name}: {low}'s median {runs[low].median_ms} is below "
                                 f"junctiond's {j}")
        order = sorted(WARM_ORDER, key=lambda v: runs[v].median_ms)
        print(f"    by median: {' < '.join(order)}; the order of the 95 us body "
              f"({' < '.join(WARM_ORDER)}) {'held' if tuple(order) == WARM_ORDER else 'did not hold'}")

    # -- 9b: cold starts ----------------------------------------------------
    def deploy_ms(rt):
        t0 = rt.sim.now
        rt.deploy_blocking(spec("aes"))
        return 1e3 * (rt.sim.now - t0)

    def drive_ms(rt, gen):
        t0 = rt.sim.now
        p = rt.sim.process(gen)
        p.completion.callbacks.append(lambda _v: rt.sim.stop())
        rt.sim.run()
        if not p.done:
            raise AssertionError("a lifecycle operation did not finish")
        return 1e3 * (rt.sim.now - t0)

    print("9b cold start of the AES function (simulated ms):")
    print("  " + "  ".join(f"{v} {deploy_ms(runtime(v)):.4f}" for v in BACKEND_VARIANTS))
    rt = runtime("firecracker")
    boot = deploy_ms(rt)
    restore = drive_ms(rt, rt.backend.scale("aes", 2))
    rt.backend.remove("aes")
    again = deploy_ms(rt)
    print(f"  firecracker: first deploy (boot + snapshot save) {boot:.4f}, a scale-up replica "
          f"(restore) {restore:.4f}, redeploy after remove (boot again) {again:.4f}; boots "
          f"{rt.backend.boots}, restores {rt.backend.restores}")
    if not (restore < boot and math.isclose(again, boot)):
        raise AssertionError(f"firecracker: restore {restore} ms, boot {boot}, again {again}")
    scale4 = {}
    for isolate in (False, True):
        rt = runtime("junctiond")
        scale4[isolate] = drive_ms(rt, rt.manager.deploy("f4", scale=4, isolate_replicas=isolate))
    print(f"  junctiond scale 4: shared uProcs {scale4[False]:.4f}, isolated instances "
          f"{scale4[True]:.4f}")

    # -- 9c: the autoscaler under a burst -----------------------------------
    def burst(variant):
        rt = runtime(variant)
        rt.deploy_blocking(spec("aes"))
        asc = Autoscaler(rt.sim, rt, LeadTimePolicy(
            target_inflight_per_replica=BURST_TARGET_INFLIGHT))
        asc.run()
        res = drive(rt, LoadSpec(arrivals=BurstyArrivals(**BURST), functions=("aes",),
                                 duration_s=BURST_DURATION_S, warmup_s=BURST_WARMUP_S),
                    observer=asc)
        recs = [(r.fn, r.t_arrival, r.t_start_exec, r.t_end_exec, r.t_done, r.cold)
                for r in rt.records]
        events = json.dumps([dataclasses.asdict(e) for e in asc.scale_events])
        return res, asc, recs, events

    print(f"9c AES bursts {BURST}, {BURST_DURATION_S} s after {BURST_WARMUP_S} s, 10 cores, "
          f"LeadTimePolicy(target_inflight_per_replica={BURST_TARGET_INFLIGHT}) on drive:")
    drives, reaction = {}, {}
    for variant in BACKEND_VARIANTS:
        res, asc, recs, events = burst(variant)
        drives[variant] = (json.dumps(res, sort_keys=True, default=str), recs, events)
        ups = [e for e in asc.scale_events if e.up and e.ready]
        if not ups:
            raise AssertionError(f"{variant} never scaled up under the burst")
        r_ms = [1e3 * e.reaction_s for e in ups]
        reaction[variant] = statistics.median(r_ms)
        print(f"  {variant:13s} scale-ups {len(ups)} (events {len(asc.scale_events)}, "
              f"period {1e3 * asc.policy.control_period(asc.runtime.backend.coldstart):.1f} "
              f"ms)  reaction_ms median {reaction[variant]:.4f} max {max(r_ms):.4f}  "
              f"invocations n {res['n']} median_ms {res['median_ms']:.4f} p99_ms "
              f"{res['p99_ms']:.4f} rejected {res['rejected']}")
    if not reaction["junctiond"] < reaction["containerd"]:
        raise AssertionError(f"junctiond's median reaction {reaction['junctiond']} ms is not "
                             f"below containerd's {reaction['containerd']}")

    # -- 9d: the same drives under the sanitizer ----------------------------
    sanitizer.install()
    try:
        for variant in ("junctiond", "containerd"):
            res, _, recs, events = burst(variant)
            if (json.dumps(res, sort_keys=True, default=str), recs, events) != drives[variant]:
                raise AssertionError(f"{variant}: the checked drive differs from 9c's")
            print(f"9d {variant}: the checked drive gives 9c's row, {len(recs)} records and "
                  f"scale events, float for float")
    finally:
        sanitizer.uninstall()


def fleet_and_experiments(aes_us: float, endpoints: dict) -> None:
    """Phase 10: the experiments runner and the fleet on the bodies the card
    measured, simulated on the host.  ``aes_us`` is phase 7's deployed AES
    body and ``endpoints`` phases 5-5d's decode steps (us).  10a runs the
    ``smoke`` suite with every AES body and ``model-endpoint``'s two bodies
    swapped for the card's; 10b drives a fleet of workers on containerd and
    junctiond, twice and once under the sanitizer, then a provisioning
    storm under each image distribution.  Launches no kernel."""
    from repro_torch.analysis import sanitizer
    from repro_torch.core import FunctionSpec, LoadSpec, Simulator, drive
    from repro_torch.core.latency import AES_600B_WORK_US
    from repro_torch.experiments import (SMOKE_DURATION_SCALE, ExperimentRunner, get_suite,
                                         validate_artifact, write_artifact)
    from repro_torch.fleet import Cluster

    # -- 10a: the smoke suite on the card's bodies ----------------------------
    suite, swapped = [], 0
    for sc in get_suite("smoke"):
        fns = []
        for f in sc.functions:
            if sc.name == "model-endpoint":
                f = dataclasses.replace(f, work_us=endpoints[f.name])
            elif f.work_us == AES_600B_WORK_US:
                f = dataclasses.replace(f, work_us=aes_us)
            else:
                raise AssertionError(f"{sc.name}: {f.name}'s body {f.work_us} us is neither "
                                     f"AES's nor an endpoint's")
            swapped += 1
            fns.append(f)
        suite.append(dataclasses.replace(sc, functions=tuple(fns)))
    print(f"10a smoke suite ({len(suite)} scenarios, duration_scale {SMOKE_DURATION_SCALE}): "
          f"{swapped} function bodies swapped for the card's, AES {aes_us!r} us, "
          + ", ".join(f"{f.name} {f.work_us!r} us" for sc in suite
                      if sc.name == "model-endpoint" for f in sc.functions))
    doc = ExperimentRunner(duration_scale=SMOKE_DURATION_SCALE, smoke=True).run_suite(
        suite, suite="smoke")
    validate_artifact(doc)
    if doc["failures"]:
        raise AssertionError(f"phase 10a: failed cells {doc['failures']}")
    out = ROOT / "build" / "phase10_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    write_artifact(str(out), doc)
    metrics = {m["name"]: m for m in doc["metrics"]}
    for name in PHASE10_METRICS:
        m = metrics[name]
        print(f"  {name:34s} {m['value']}  ({m['derived']})")
    for entry in doc["scenarios"]:
        claims = entry.get("claims", {})
        paper = {k: c for k, c in claims.items() if isinstance(c, dict) and "paper" in c}
        if paper:
            print(f"  {entry['name']} claims against the paper: " + "; ".join(
                f"{k} {c['measured']} (paper {c['paper']})" for k, c in paper.items()))
        if entry["name"] == "model-endpoint":
            for b, res in entry["backends"].items():
                print(f"  model-endpoint on {b}: median_ms {res['median_ms']:.4f} p99_ms "
                      f"{res['p99_ms']:.4f} n {res['n']}")
    ratio = metrics["fig6_throughput_ratio"]["value"]
    if not ratio >= 5.0:
        raise AssertionError(f"fig6_throughput_ratio {ratio} < 5 on the card's bodies")
    print(f"  the artifact validates, no failed cell, fig6_throughput_ratio {ratio} >= 5; "
          f"written to {out.relative_to(ROOT)} (suite wall {doc['meta']['wall_s']} s)")

    # -- 10b: a fleet of workers, twice and under the sanitizer -----------------
    aes = FunctionSpec(name="aes", work_us=aes_us)

    def fleet_drive(backend):
        cl = Cluster(Simulator(seed=1), FLEET_WORKERS, backend=backend)
        cl.deploy_blocking(aes)
        res = drive(cl, LoadSpec.single("aes", FLEET_RATE_RPS, duration_s=FLEET_DURATION_S,
                                        warmup_s=FLEET_WARMUP_S))
        recs = [[(r.fn, r.t_arrival, r.t_start_exec, r.t_end_exec, r.t_done, r.cold)
                 for r in w.runtime.records] for w in cl.workers]
        return res, json.dumps(res, sort_keys=True, default=str), recs

    print(f"10b Cluster of {FLEET_WORKERS} workers of 10 cores, AES at {aes_us!r} us, "
          f"{FLEET_RATE_RPS} rps Poisson for {FLEET_DURATION_S} s after {FLEET_WARMUP_S} s, "
          f"Simulator(seed=1), least-loaded placement:")
    medians = {}
    for backend in ("containerd", "junctiond"):
        res, key, recs = fleet_drive(backend)
        if fleet_drive(backend)[1:] != (key, recs):
            raise AssertionError(f"{backend}: two fleet drives of one seed differ")
        sanitizer.install()
        try:
            checked = fleet_drive(backend)
        finally:
            sanitizer.uninstall()
        if checked[1:] != (key, recs):
            raise AssertionError(f"{backend}: the checked fleet drive differs")
        if res["rejected"] or res["achieved_rps"] < 0.85 * FLEET_RATE_RPS:
            raise AssertionError(f"{backend}: the fleet did not sustain {FLEET_RATE_RPS} rps: "
                                 f"achieved {res['achieved_rps']}, rejected {res['rejected']}")
        medians[backend] = res["median_ms"]
        print(f"  {backend:10s} n {res['n']} achieved_rps {res['achieved_rps']:.1f} median_ms "
              f"{res['median_ms']:.4f} p99_ms {res['p99_ms']:.4f} rejected {res['rejected']}; "
              f"per worker n {[w['n'] for w in res['fleet']['workers']]}; run twice and once "
              f"under the sanitizer: the same row and {sum(map(len, recs))} records")
    if not medians["junctiond"] < medians["containerd"]:
        raise AssertionError(f"fleet: junctiond's median {medians['junctiond']} ms is not below "
                             f"containerd's {medians['containerd']}")

    def storm(backend, distribution):
        sim = Simulator(seed=1)
        cl = Cluster(sim, STORM_WORKERS, backend=backend, distribution=distribution)
        out = {}

        def go():
            out.update((yield from cl.scale_out(aes, STORM_REPLICAS)))
            sim.stop()

        sim.process(go())
        sim.run()
        if not out:
            raise AssertionError(f"{backend}/{distribution}: the storm did not finish")
        return out

    print(f"  scale_out storm of {STORM_REPLICAS} AES replicas over {STORM_WORKERS} workers:")
    for backend in ("containerd", "junctiond"):
        full = {d: storm(backend, d)["time_to_full_s"] for d in ("tree", "naive")}
        if not full["tree"] < full["naive"]:
            raise AssertionError(f"{backend}: FaasNetTree {full['tree']} s is not below "
                                 f"NaiveRegistryPull {full['naive']} s")
        print(f"    {backend:10s} FaasNetTree time_to_full_s {full['tree']:.4f}, "
              f"NaiveRegistryPull {full['naive']:.4f}, speedup "
              f"{full['naive'] / full['tree']:.2f}")


def check_assigned_shapes(get_arch) -> None:
    """Phase 3's shapes for the three architectures of phases 5h-5j and 11g,
    written out above, must be what their configurations give at phase 5's
    traffic (8 slots, 512-token prompts, a 1024-slot cache) and at 11g's
    batches; a configuration that changes fails the run here."""
    cfgs = {arch: get_arch(arch) for arch in ASSIGNED_LAYERS}
    phi4, phi35, deepseek = cfgs.values()

    def prefill(c, batch, seq):
        return (batch, c.n_heads, c.n_kv_heads, seq, seq, c.resolved_head_dim, True)

    def experts(tokens):
        E, k = phi35.moe.num_experts, phi35.moe.top_k
        C = max(1, int(phi35.moe.capacity_factor * k * tokens / E))
        return (E, C, phi35.d_model, phi35.d_ff), (E, C, phi35.d_ff, phi35.d_model)

    train = TRAIN_ASSIGNED_FULL
    checks = [
        (DECODE_ASSIGNED, {label: (SLOTS, c.n_heads, c.n_kv_heads, MAX_SEQ, c.resolved_head_dim)
                           for label, c in (("phi4-mini decode", phi4),
                                            ("deepseek-67b decode", deepseek))}),
        (ASSIGNED_FLASH, {"phi4-mini prefill": prefill(phi4, SLOTS, PROMPT_LEN),
                          "deepseek-67b prefill": prefill(deepseek, SLOTS, PROMPT_LEN)}),
        (FLASH_BWD_ASSIGNED, {
            label: prefill(c, train[c.name][1], TRAIN_SEQ) + (None,)
            for label, c in (("phi4-mini training", phi4), ("deepseek-67b training", deepseek))}),
        ({k: v for k, v in GMM_MAIN.items() if k.startswith("phi3.5")},
         dict(zip(("phi3.5 decode gate/up", "phi3.5 decode down"), experts(SLOTS)))
         | dict(zip(("phi3.5 prefill gate/up", "phi3.5 prefill down"),
                    experts(SLOTS * PROMPT_LEN)))),
        ({k: v for k, v in GMM_BWD_MAIN.items() if k.startswith("phi3.5")},
         dict(zip(("phi3.5 gate/up", "phi3.5 down"),
                  experts(train[phi35.name][1] * TRAIN_SEQ)))),
    ]
    for written, derived in checks:
        if written != derived:
            raise AssertionError(f"phase 3's shapes {written} are not the configurations' "
                                 f"{derived}")


# phase 13: the JAX package's assigned input shapes (src/repro/config/shapes.py:25-28)
# on one card, each pair planned by repro_torch.launch.fit: its batch, its
# depth and the order of its serving runs
LONG_TILE = 128              # query rows of each slice that a flash check takes
LONG_CHUNK = 4096            # steps of a scan's first and last chunk held to the plain loop
LONG_TIMED_STEPS = 27        # decode steps timed on the host clock; the other 4 profiled
LONG_SEED = 40               # prompts and batches: seed 40 + the pair's index
SERVE_TURNS = ("graph", "eager")   # the runs of a serving pair in turns
REF_SCORES_BYTES = 4.3e9     # fp32 scores of the batch rows a plain flash backward takes


def rwkv6_scan_bwd_f64(r, k, v, w, u, S0, do, dS_last):
    """``ref.rwkv6_scan_bwd_ref``'s arithmetic in float64 (phase 13's yardstick
    for the kernel and the plain fp32 version alike): (dr, dk, dv, dw, du,
    dS0), S0 and dS_last zeros where None."""
    import torch
    f64 = torch.float64
    rf, kf, vf, wf, uf, gf = (t.to(f64) for t in (r, k, v, w, u, do))
    B, T, H, hd = r.shape
    S = torch.zeros((B, H, hd, hd), dtype=f64, device=r.device) if S0 is None else S0.to(f64)
    Ss = []
    for t in range(T):
        Ss.append(S)
        S = wf[:, t, :, :, None] * S + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    lam = torch.zeros_like(S) if dS_last is None else dS_last.to(f64)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(T)):
        rt, kt, vt, wt, gt = rf[:, t], kf[:, t], vf[:, t], wf[:, t], gf[:, t]
        vg = (vt * gt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", Ss[t], gt) + uf * kt * vg
        dk[:, t] = torch.einsum("bhij,bhj->bhi", lam, vt) + uf * rt * vg
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", lam, kt)
                    + (rt * uf * kt).sum(-1, keepdim=True) * gt)
        dw[:, t] = (lam * Ss[t]).sum(-1)
        du += (rt * kt * vg).sum(0)
        lam = wt[..., None] * lam + rt[..., None] * gt[..., None, :]
    return dr, dk, dv, dw, du, lam


class Recorder:
    """While on, the first call of each kernel wrapper ``names`` names
    (``"flash.flash_attention"``: a key of ``modules``, a function of that
    module) for each distinct signature (``signature(name, args, kwargs)``:
    the shapes and options the kernel specialises on) keeps its arguments,
    copied to ``keep``: the host, so that they take no room on the card
    while the run goes on, or the card where the run leaves room;
    ``calls(name, dev)`` hands them back on the card, by signature.  The
    wrapper is the one ``kernels.ops`` calls, so the recorded calls are the
    model's own."""

    def __init__(self, modules: dict, names, keep="cpu"):
        self.targets = {n: (modules[n.split(".")[0]], n.split(".")[1]) for n in names}
        self.keep = keep
        self.kept = {}
        self.saved = collections.defaultdict(dict)

    def __enter__(self):
        for key, (mod, name) in self.targets.items():
            fn = getattr(mod, name)
            self.kept[(mod, name)] = fn
            setattr(mod, name, self._wrap(key, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.kept.items():
            setattr(mod, name, fn)

    @staticmethod
    def signature(name, args, kwargs) -> tuple:
        """Attention: (causal, window, S, T, d, G) of q (B, Hq, S, d) and k
        (B, Hkv, T, d), or (T, d, G) of a decode call's q (B, Hq, d) and
        cache (B, T, Hkv, d); any other kernel: its operands' shapes."""
        if name.startswith("flash."):
            q, k = args[0], args[1]
            return (kwargs.get("causal", True), kwargs.get("window"), q.shape[2], k.shape[2],
                    q.shape[3], q.shape[1] // k.shape[1])
        if name.startswith("decode."):
            q, k = args[0], args[1]
            return (k.shape[1], q.shape[2], q.shape[1] // k.shape[2])
        return tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            sig = self.signature(name, args, kwargs)
            if sig not in self.saved[name]:
                def copy(a):
                    return a.detach().to(self.keep, copy=True) if hasattr(a, "detach") else a
                self.saved[name][sig] = ([copy(a) for a in args],
                                         {k: copy(a) for k, a in kwargs.items()})
            return fn(*args, **kwargs)
        return call

    def calls(self, name, dev):
        """(signature, args, kwargs) of each recorded call of ``name``, on
        ``dev``, in the order of their first calls."""
        for sig, (args, kwargs) in self.saved.get(name, {}).items():
            yield (sig, [a.to(dev) if hasattr(a, "to") else a for a in args],
                   {k: a.to(dev) if hasattr(a, "to") else a for k, a in kwargs.items()})


def _ms(x, spec: str = ".1f") -> str:
    """A device figure, or "not measured" where the profiler saw no kernel."""
    return "not measured" if x is None else format(x, spec)


def assigned_shapes(torch, dev, smi, host: dict, keep_going: bool = False) -> None:
    """Phase 13: the assigned input shapes on one card, through the port's
    entry points at full width (bf16, random weights drawn from ``SEED``):

    - the plan (``launch.fit.plans``): for each of the ten architectures
      under each shape of ``fit.PLAN``, its depth (cut where the whole model
      does not fit 80 GB at batch 1: to the most whole periods of layers
      that fit, else to the longest prefix of one period), its batch (the
      largest of 8, 4, 2, 1 that fits at that depth), the order of its
      serving runs (in turns where two copies of a step fit, else once),
      or, for a pair of which not one layer fits at batch 1, its reckoned
      bytes, printed as not run;
    - each pair on the inputs of the JAX package's spec
      (``launch.dryrun.input_specs``): tokens; a VLM's stub ``embeds`` in
      their place; an enc-dec model's stub ``enc_embeds`` beside them,
      every frame valid (no ``enc_mask``); drawn from the pair's seed;
    - 13a prefill_32k and decode_32k: one ``ServingEngine`` a model with a
      32800-slot cache (a windowed model's ring holds 4096), 32768-token
      prompts, then 31 decode steps: both graphs captured
      (``ServingEngine.capture``), then runs replayed and eager in turns
      (``SERVE_TURNS``), each a prefill and 31 steps through ``prefill``
      and ``decode_step``, the prefill profiled, the first
      ``LONG_TIMED_STEPS`` steps timed on the host clock (``work_us``) and
      the rest profiled (device time and idle share); every run's tokens
      equal and its logits exactly equal, its launches by route those of the
      path, the card's reserved peak below the reckoning;
    - 13b long_500k at batch 1: a 524288-token prompt and 31 steps past it,
      natively or under the reference's serving variant (window 4096,
      ``launch.dryrun.serving_variant``; an encoder stays unwindowed); run
      once (the eager design, the allocator's cache emptied, then the
      graphs) where two copies of a prefill do not fit;
    - 13c train_4k: ``TrainGraph`` replays and the eager step from the same
      weights and batches, 4 steps each, then a profiled step: losses and
      grad norms of the replay within rtol 1e-5 of the eager step's, a
      falling loss, the backward kernels' and AdamW's launches by route
      those of the path (AdamW a launch a table of at most 64 leaves);
    - each pair's kernels against their plain versions on the inputs they
      met, layer 0's (``Recorder``: the first call of each distinct
      signature, from an eager prefill and decode step after the runs
      through the first period of layers, whose inputs do not depend on the
      layers after it, or from the eager training steps), at phase 3's
      limits: flash on slices of
      ``LONG_TILE`` query rows (the first, the last and one across the
      window's edge, or the middle one) against ``ref.flash_attention_ref``
      over their keys, each of the decoder's self-attention, an encoder's
      and a cross-attention's; decode ``split`` over the whole cache row and
      over the encoder's frames; ``moe_gmm`` whole; the scans over the first
      ``LONG_CHUNK`` steps and the last (from the kernel's own state before
      them) with the final state; the scans' linear input (dtx, v) and the
      backwards' cotangents scaled to unit rms by a power of two, exactly;
      13c's flash backward pairs (each signature, on the batch rows whose
      scores fit ``REF_SCORES_BYTES``) and the experts' dx at the bf16
      limit, their dw no further from float64 than twice the plain
      version, the scans' backwards whole within ``SUM_REL`` of each
      gradient's largest magnitude, as phase 11d holds them on a model's
      inputs;
    - 13d the dry run on a 1-rank mesh at every pair run (the cut config and
      the run's batch), its predicted peak and step beside the measured
      ones, with their ratio, no bound set.

    The plan and 13d's traces come from ``host``'s futures (``host_plan``
    and ``host_13d``, run in worker processes while the card works).

    With ``keep_going`` a pair that fails is printed and the phase goes on,
    raising at its end."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import InputShape, StepKind
    from repro_torch.kernels import adamw as _adamw
    from repro_torch.kernels import decode_attention as _decode
    from repro_torch.kernels import flash_attention as _flash
    from repro_torch.kernels import mamba_scan as _mamba
    from repro_torch.kernels import moe_gmm as _gmm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as _rwkv
    from repro_torch.launch import fit
    from repro_torch.models import attention, flops
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import stub_frontend_embeddings
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.serving import ServingEngine
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM, make_train_step
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.step_graph import TrainGraph

    bf16, f32 = torch.bfloat16, torch.float32
    modules = {"flash": _flash, "decode": _decode, "gmm": _gmm, "mamba": _mamba,
               "rwkv": _rwkv}
    n_decode = NEW_TOKENS - 1
    rows = []           # the summary: one dict a pair run
    failed = []
    t_phase = time.perf_counter()

    # -- the plan ------------------------------------------------------------------
    planned = host["plan"].result()
    plan = planned["plan"]
    print(f"the plan (launch.fit, {planned['plan seconds']:.1f} s in a host-side worker: a "
          f"step's peak traced on the meta device, x "
          f"{fit.ALLOCATOR_SLACK} for the allocator (in training at least the step plus "
          f"{fit.ALLOCATOR_FLOOR['train'] / 1e9:.1f} GB), x 2 in turns; reserve "
          f"{fit.RESERVE / 1e9:.1f} GB; card {fit.CARD_BYTES / 1e9:.1f} GB; this card's "
          f"total_memory {torch.cuda.get_device_properties(0).total_memory} bytes):")
    for shape, cfg, run, decided in plan:
        print(f"  {shape}: " + (run.line() + (", in turns" if run.pools == 2 else ", once")
                                if run else "NOT RUN: " + decided.line()))

    def attn_layers(cfg):
        """(flash calls of a prefill or a training forward, decode calls of
        a decode step): the decoder's attention layers, and for an enc-dec
        model its encoder's layers and a cross-attention beside each decoder
        attention layer."""
        n = layer_counts(cfg)["attn"]
        if cfg.encdec is None:
            return n, n
        return 2 * n + cfg.encdec.encoder_layers, 2 * n

    def flash_signatures(cfg, S):
        """``Recorder.signature``s of the flash calls of a prefill (or a
        training forward) of S tokens: the decoder's causal self-attention
        under its window, and for an enc-dec model the encoder's
        bidirectional attention and the cross-attention over its frames."""
        d, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
        sigs = {(True, cfg.sliding_window, S, S, d, G)}
        if cfg.encdec is not None:
            F = cfg.encdec.max_source_positions
            sigs |= {(False, None, F, F, d, G), (False, None, S, F, d, G)}
        return sigs

    def expected_routes(cfg, B, S, cap):
        """Launches by route of a prefill of B x S tokens and ``n_decode``
        steps, bf16 attention and experts, fp32 scans."""
        n = layer_counts(cfg)
        want = {}
        if n["attn"]:
            G = cfg.n_heads // cfg.n_kv_heads
            prefills, decodes = attn_layers(cfg)
            want["flash_attention"] = {_flash.route(bf16): prefills}
            c = collections.Counter({_decode.route(bf16, G, cap): n["attn"] * n_decode})
            if cfg.encdec is not None:
                c[_decode.route(bf16, G, cfg.encdec.max_source_positions)] += (
                    (decodes - n["attn"]) * n_decode)
            want["decode_attention"] = dict(c)
        if n["moe"]:
            c = collections.Counter()
            for tokens, steps in ((B * S, 1), (B, n_decode)):
                for C, D, F in expert_products(cfg, tokens):
                    c[_gmm.route(bf16, C, D, F)] += n["moe"] * steps
            want["moe_gmm"] = dict(c)
        if n["mamba"]:
            want["mamba_scan"] = {_mamba.route(f32, cfg.mamba.d_state):
                                  n["mamba"] * (n_decode + 1)}
        if n["rwkv"]:
            want["rwkv6_scan"] = {_rwkv.route(f32, cfg.rwkv.head_size):
                                  n["rwkv"] * (n_decode + 1)}
        return want

    def expert_products(cfg, tokens):
        """(C, D, F) of an MoE layer's three expert products (gate, up,
        down) over ``tokens`` tokens."""
        E, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
        C = max(1, int(cf * k * tokens / E))
        return [(C, cfg.d_model, cfg.d_ff)] * 2 + [(C, cfg.d_ff, cfg.d_model)]

    def train_routes(cfg, B, S, tables):
        """Launches by route of ``TRAIN_STEPS`` training steps' backward
        kernels and AdamW (``tables`` tables of at most 64 leaves)."""
        n = layer_counts(cfg)
        steps, want = TRAIN_STEPS, {}
        if n["attn"]:
            calls = attn_layers(cfg)[0] * steps
            want["flash_attention_bwd"] = {f"bwd_{k}_{_flash.bwd_route(bf16)}": calls
                                           for k in ("dq", "dkv")}
        if n["moe"]:
            c = collections.Counter()
            for C, D, F in expert_products(cfg, B * S):
                r_dx, r_dw = _gmm.bwd_route(bf16, C, D, F)
                c[f"dx_{r_dx}"] += n["moe"] * steps
                c[f"dw_{r_dw}"] += n["moe"] * steps
            want["moe_gmm_bwd"] = dict(c)
        if n["mamba"]:
            di = cfg.mamba.d_inner(cfg.d_model)
            want["mamba_scan_bwd"] = {_mamba.bwd_route(f32, cfg.mamba.d_state, di):
                                      n["mamba"] * steps}
        if n["rwkv"]:
            want["rwkv6_scan_bwd"] = {_rwkv.bwd_route(f32, cfg.rwkv.head_size):
                                      n["rwkv"] * steps}
        want["adamw"] = {"sumsq": tables * steps, "norm": steps, "update": tables * steps}
        return want

    def routes_now():
        return {op: {r: n for r, n in c.items() if n} for op, c in ops.ROUTE_LAUNCHES.items()
                if any(c.values())}

    def pair_inputs(cfg, B, S, seed):
        """The inputs of the JAX package's spec beside the tokens
        (``launch.dryrun.input_specs``), drawn from ``seed``: a VLM's
        ``embeds`` (B, S, width) in their place, an enc-dec model's
        ``enc_embeds`` (B, frames, width), every frame valid."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        if cfg.encdec is not None:
            return {"enc_embeds": stub_frontend_embeddings(cfg, gen, B,
                                                           cfg.encdec.max_source_positions)}
        if cfg.frontend is not None:
            return {"embeds": stub_frontend_embeddings(cfg, gen, B, S)}
        return {}

    def serve_run(eng, batch, S, mode):
        """A prefill of ``batch`` and ``n_decode`` greedy steps through the
        engine in ``mode``, the launch counters reset first; each step's
        logits copied on the card (a replay's are the graph's buffer)."""
        set_modes(eng, mode)
        torch.cuda.synchronize()
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lg = eng.prefill(batch)
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
        p_dev, _, p_kernels = device_profile(torch, prof, 1)
        logits, toks, step_s = [lg.clone()], [lg.argmax(-1)], []
        for i in range(LONG_TIMED_STEPS):
            t0 = time.perf_counter()
            lg = eng.decode_step(toks[-1], S + i)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            logits.append(lg.clone())
            toks.append(lg.argmax(-1))
        rest = n_decode - LONG_TIMED_STEPS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(LONG_TIMED_STEPS, n_decode):
                lg = eng.decode_step(toks[-1], S + i)
                logits.append(lg.clone())
                toks.append(lg.argmax(-1))
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0) / rest
        d_dev, _, d_kernels = device_profile(torch, prof, rest)
        logits = [lg.cpu() for lg in logits]
        set_modes(eng, "graph")
        return dict(mode=mode, prefill_ms=prefill_ms, prefill_dev_ms=p_dev and p_dev / 1e3,
                    prefill_idle=p_dev and 1 - p_dev / (1e3 * prefill_ms),
                    prefill_kernels=p_kernels, work_us=1e6 * statistics.fmean(step_s),
                    decode_dev_us=d_dev, decode_wall_us=wall_us,
                    decode_idle=d_dev and 1 - d_dev / wall_us, decode_kernels=d_kernels,
                    logits=logits, tokens=torch.cat(toks, 1).cpu(), routes=routes_now())

    def recorded(label, rec, name, want):
        """The recorded calls of ``name``, whose signatures must be ``want``."""
        got = set(rec.saved.get(name, {}))
        if got != want:
            raise AssertionError(f"{label}: the model's {name} calls {sorted(got, key=str)}, "
                                 f"expected {sorted(want, key=str)}")
        return rec.calls(name, dev)

    def flash_check(label, rec, want):
        """Each distinct flash call of the prefill against the plain version
        on slices of ``LONG_TILE`` query rows (the first, the last, and one
        across the window's edge or the middle one) over their keys."""
        worst = 0.0
        for (causal, window, S, T, d, G), (q, k, v), kw in recorded(
                label, rec, "flash.flash_attention", want):
            if kw.get("key_valid") is not None:
                raise AssertionError(f"{label}: a key mask on a flash call {kw}")
            B, Hq = q.shape[:2]
            out = _flash.flash_attention(q, k, v, causal=causal, window=window)
            starts = [0, S - LONG_TILE]
            starts.append(window - LONG_TILE // 2 if causal and window and window < S
                          else S // 2)
            errs = []
            for r0 in sorted(set(starts)):
                r1 = r0 + LONG_TILE
                lo, hi = ((max(0, r0 - window + 1) if window else 0), r1) if causal else (0, T)
                expect = ref.flash_attention_ref(q[:, :, r0:r1], k[:, :, lo:hi], v[:, :, lo:hi],
                                                 causal=causal, window=window)
                errs.append((r0, check_close(f"{label} flash {S} x {T} rows {r0}..{r1}",
                                             out[:, :, r0:r1], expect, TOL["bfloat16"])))
                del expect
            ms = time_ms(torch, lambda: _flash.flash_attention(q, k, v, causal=causal,
                                                              window=window), 1, lambda: None)
            pairs = (sum(min(t + 1, window or t + 1) for t in range(S)) if causal else S * T)
            tflops = 4 * d * pairs * B * Hq / (ms * 1e-3) / 1e12
            print(f"  {label} flash ({_flash.route(bf16)}) q {tuple(q.shape)} k {tuple(k.shape)} "
                  f"{'causal' if causal else 'bidirectional'}, window {window}: rows "
                  + ", ".join(f"{r0}..{r0 + LONG_TILE} max |diff| {e:.3g}" for r0, e in errs)
                  + f" (atol, rtol {TOL['bfloat16']}); one launch {ms:.3f} ms, "
                  f"{tflops:.1f} TFLOP/s of the {pairs * B * Hq} allowed pairs")
            worst = max([worst] + [e for _, e in errs])
            del q, k, v, out
        return worst

    def decode_check(label, rec, want):
        """Each distinct decode call (the self-attention over the KV cache,
        an enc-dec model's cross-attention over its frames) against the
        plain version over the whole row."""
        worst = 0.0
        for (T_, d, G), (q, k, v, valid), _ in recorded(label, rec, "decode.decode_attention",
                                                        want):
            B, Hq, _ = q.shape
            Hkv = k.shape[2]
            route = _decode.route(bf16, G, T_)
            got = _decode.decode_attention(q, k, v, valid)
            err = check_close(f"{label} decode over {T_}", got,
                              ref.decode_attention_ref(q, k, v, valid), TOL["bfloat16"])
            ms = time_ms(torch, lambda: _decode.decode_attention(q, k, v, valid), 3,
                         lambda: None)
            nbytes_ = sum(t.numel() * t.element_size() for t in (q, k, v, valid, got))
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            print(f"  {label} decode ({route}, splits {_decode.splits(B, Hkv, T_, sms)}) "
                  f"q {tuple(q.shape)} cache {tuple(k.shape)}, {int(valid[0].sum())} of {T_} "
                  f"slots valid: max |diff| {err:.3g}; {ms:.4f} ms a launch (warm L2), "
                  f"{nbytes_ / (ms * 1e-3) / 1e9:.0f} GB/s of its {nbytes_} bytes")
            worst = max(worst, err)
        return worst

    def gmm_check(label, rec):
        """Each distinct expert product of the prefill and the decode step,
        whole."""
        worst = 0.0
        for _, (x, w), _ in rec.calls("gmm.moe_gmm", dev):
            E, C, D = x.shape
            got = _gmm.moe_gmm(x, w)
            err = check_close(f"{label} moe_gmm", got, ref.moe_gmm_ref(x, w),
                              GMM_TOL["bfloat16"])
            ms = time_ms(torch, lambda: _gmm.moe_gmm(x, w), 3, lambda: None)
            print(f"  {label} moe_gmm ({_gmm.route(bf16, C, D, w.shape[2])}) x {tuple(x.shape)} "
                  f"w {tuple(w.shape)}: max |diff| {err:.3g}; {ms:.3f} ms a launch, "
                  f"{2 * E * C * D * w.shape[2] / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
            worst = max(worst, err)
            del x, w, got
        return worst

    def scan_check(label, rec, which):
        """Each distinct scan of layer 0 (the prefill's, the decode step's)
        against the plain loop, over the first ``LONG_CHUNK`` steps and the
        last (from the kernel's own state after the others) with the final
        state: the plain loop over all of 32768 steps of RWKV6's batch of 8
        took 25 s."""
        name, fn, plain = (("mamba.mamba_scan", _mamba.mamba_scan, ref.mamba_scan_ref)
                           if which == "mamba" else
                           ("rwkv.rwkv6_scan", _rwkv.rwkv6_scan, ref.rwkv6_scan_ref))
        worst = 0.0
        for _, args, _ in rec.calls(name, dev):
            *xs, par, s0 = args
            S = xs[0].shape[1]
            # the output and the state are linear in dtx (Mamba) or v (RWKV6) from a
            # zero state: scaled to unit rms by a power of two, exactly, so that the
            # limits act as on phase 3's inputs
            lin = 1 if which == "mamba" else 2
            scale = unit_scale(xs[lin]) if s0 is None or not bool(s0.any()) else 1.0
            xs[lin] = xs[lin] * scale
            y, s_last = fn(*xs, par, s0)
            tol = SCAN_TOL["float32"]
            if S <= 2 * LONG_CHUNK:
                ey, es = plain(*xs, par, s0)
                err = max(check_close(f"{label} {which} out", y, ey, tol),
                          check_close(f"{label} {which} state", s_last, es, tol))
                how = f"all {S} steps"
            else:
                c = LONG_CHUNK
                ey, _ = plain(*(t[:, :c] for t in xs), par, s0)
                e1 = check_close(f"{label} {which} first {c} steps", y[:, :c], ey, tol)
                _, s_mid = fn(*(t[:, :S - c].contiguous() for t in xs), par, s0)
                ey, es = plain(*(t[:, S - c:] for t in xs), par, s_mid)
                e2 = max(check_close(f"{label} {which} last {c} steps", y[:, S - c:], ey, tol),
                         check_close(f"{label} {which} final state", s_last, es, tol))
                err = max(e1, e2)
                how = f"the first and last {c} of {S} steps and the final state"
            route = (_mamba.route(xs[0].dtype, xs[2].shape[-1]) if which == "mamba"
                     else _rwkv.route(xs[0].dtype, xs[0].shape[-1]))
            print(f"  {label} {which} scan ({route}) {tuple(xs[0].shape)} {xs[0].dtype}, {how}, "
                  f"{'dtx' if lin == 1 else 'v'} times {scale:g}: max |diff| {err:.3g} (atol, "
                  f"rtol {tol})")
            worst = max(worst, err)
        return worst

    def card_peak():
        return torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()

    def unit_scale(t):
        """The power of two that brings ``t``'s rms nearest 1: a product by
        it rounds nothing."""
        rms = float(t.float().square().mean().sqrt())
        return 2.0 ** round(-math.log2(rms)) if rms > 0 else 1.0

    def below_reckoning(label, reserved, rec):
        if not reserved < rec.total:
            raise AssertionError(f"{label}: {reserved} bytes reserved, above the reckoned "
                                 f"{rec.total:.6g}")

    def serve_pair(shape, cfg, rec, seed):
        B, S, turns = rec.batch, rec.seq_len, rec.pools == 2
        label = f"13{'a' if shape == 'serve_32k' else 'b'} {cfg.name} {shape}"
        free_card(torch, label)
        torch.cuda.reset_peak_memory_stats()
        t_pair = time.perf_counter()
        eng = ServingEngine(cfg, batch_slots=B, max_seq_len=S + NEW_TOKENS, seed=SEED,
                            device=dev)
        torch.cuda.synchronize()
        n = layer_counts(cfg)
        cap = attention.kv_cache_capacity(cfg, S + NEW_TOKENS) if n["attn"] else None
        inputs = pair_inputs(cfg, B, S, seed)
        batch = dict(inputs)
        if "embeds" not in batch:
            batch["tokens"] = torch.from_numpy(
                np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))).to(dev)
        print(f"{label}: {rec.depth()} {dict(n)}, window {cfg.sliding_window}, batch "
              f"{B} x {S} {'embeddings' if 'embeds' in batch else 'tokens'} + {NEW_TOKENS}"
              + (f", {inputs['enc_embeds'].shape[1]} encoder frames, all valid"
                 if "enc_embeds" in inputs else "") + "; "
              + (f"KV cache {cap} slots a layer" + (f", a ring that wraps {S // cap} times in "
                                                    f"the prefill" if cap < S else "")
                 if cap else "no KV cache")
              + f"; weights and inputs drawn in {time.perf_counter() - t_pair:.1f} s, "
              f"{torch.cuda.memory_allocated()} bytes on the card; runs "
              + (f"in turns ({', '.join(SERVE_TURNS)})" if turns else
                 "once (eager, the allocator's cache emptied, then graph)"))
        # kept on the card: the recorded steps run once the graphs are dropped,
        # where the engine's weights and caches leave room
        recorder = Recorder(modules, ("flash.flash_attention", "decode.decode_attention",
                                      "gmm.moe_gmm", "mamba.mamba_scan", "rwkv.rwkv6_scan"),
                            keep=dev)
        runs = []
        for mode in (SERVE_TURNS if turns else ("eager", "graph")):
            if mode == "graph" and not eng.prefill_graphs:
                if not turns:
                    gc.collect()
                    torch.cuda.empty_cache()
                set_modes(eng, "graph")
                t0 = time.perf_counter()
                eng.capture(batch, torch.zeros((B, 1), dtype=torch.long, device=dev), S)
                print(f"  both graphs captured (ServingEngine.capture) in "
                      f"{time.perf_counter() - t0:.1f} s: capture_s "
                      + ", ".join(f"{s:.3f}" for s in eng.capture_s))
            runs.append(serve_run(eng, batch, S, mode))
            r = runs[-1]
            print(f"  [{mode}] prefill_ms {r['prefill_ms']:.1f} (device "
                  f"{_ms(r['prefill_dev_ms'])} ms, idle {_ms(r['prefill_idle'], '.3f')}, "
                  f"{r['prefill_kernels']:.0f} kernels); decode work_us {r['work_us']:.1f} (mean "
                  f"of {LONG_TIMED_STEPS}), device_us {_ms(r['decode_dev_us'])} wall_us "
                  f"{r['decode_wall_us']:.1f} idle {_ms(r['decode_idle'], '.3f')} "
                  f"({r['decode_kernels']:.0f} kernels a step); first tokens "
                  f"{r['tokens'][0, :6].tolist()}; so far peak {torch.cuda.max_memory_allocated()}"
                  f" allocated, {torch.cuda.max_memory_reserved()} reserved")
        want = expected_routes(cfg, B, S, cap)
        for r in runs:
            if r["routes"] != want:
                raise AssertionError(f"{label} [{r['mode']}]: launches by route {r['routes']}, "
                                     f"expected {want}")
        first = runs[0]
        for r in runs[1:]:
            if not torch.equal(r["tokens"], first["tokens"]):
                raise AssertionError(f"{label}: the {r['mode']} run's tokens differ")
            for i, (a, b) in enumerate(zip(r["logits"], first["logits"])):
                if not bool(a.float().isfinite().all()) or not torch.equal(a, b):
                    raise AssertionError(f"{label}: step {i}'s logits of the {r['mode']} run "
                                         f"differ from the {first['mode']} run's: max |diff| "
                                         f"{float((a.float() - b.float()).abs().max()):.3g}")
        peak, reserved = card_peak()
        below_reckoning(label, reserved, rec)
        g = [r for r in runs if r["mode"] == "graph"][-1]
        e = [r for r in runs if r["mode"] == "eager"][-1]
        capture = list(eng.capture_s)
        print(f"  {len(runs)} runs: tokens equal, logits exactly equal at every step; launches "
              f"by route {want}; peak {peak} bytes allocated, {reserved} reserved, below the "
              f"reckoned {rec.total:.6g} (step {rec.step} x {rec.pools} x {rec.slack}); "
              f"capture_s {capture}")
        # the kernels' inputs: layer 0's calls in one more eager prefill and decode
        # step, the graphs dropped first, the first call of each kernel's every
        # signature copied on the card.  Layer 0's inputs do not depend on the
        # layers after it, so the step runs through the first period of layers
        # alone (views of the engine's weights; an encoder whole)
        t_runs = time.perf_counter()
        eng.prefill_graphs.clear()
        eng.decode_graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        first = dataclasses.replace(cfg, n_layers=fit.period(cfg))
        params = {k: tree_map(lambda t: t[:1], v) if k == "blocks" else v
                  for k, v in eng.params.items()}
        with recorder, torch.inference_mode():
            lg, state = T.prefill(params, first, batch, seq_len=S + NEW_TOKENS)
            T.decode_step(params, first, lg.argmax(-1), S, state)
        torch.cuda.synchronize()
        del eng, batch, inputs, lg, state, params
        gc.collect()
        torch.cuda.empty_cache()
        t_record = time.perf_counter()
        errs = {}
        if n["attn"]:
            d, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
            errs["flash"] = flash_check(label, recorder, flash_signatures(cfg, S))
            want_dec = {(cap, d, G)}
            if cfg.encdec is not None:
                want_dec.add((cfg.encdec.max_source_positions, d, G))
            errs["decode"] = decode_check(label, recorder, want_dec)
        if n["moe"]:
            errs["moe_gmm"] = gmm_check(label, recorder)
        if n["mamba"]:
            errs["mamba"] = scan_check(label, recorder, "mamba")
        if n["rwkv"]:
            errs["rwkv"] = scan_check(label, recorder, "rwkv")
        del recorder
        gc.collect()
        torch.cuda.empty_cache()
        seconds = time.perf_counter() - t_pair
        print(f"  {label}: {seconds:.1f} s (weights, captures and runs {t_runs - t_pair:.1f}, "
              f"layer 0's recorded steps {t_record - t_runs:.1f}, the kernels' checks "
              f"{time.perf_counter() - t_record:.1f})")
        rows.append(dict(shape=shape, cfg=cfg, B=B, S=S, cap=cap, peak=peak, reserved=reserved,
                         rec=rec, graph=g, eager=e, capture=capture, seconds=seconds,
                         errs=errs, routes=want))

    def ref_rows(B, Hq, S, T):
        """Batch rows of a flash backward whose (Hq, S, T) fp32 scores fit
        ``REF_SCORES_BYTES``, at least one: the plain backward holds a few
        such tensors, and each row's gradients are its own."""
        return max(1, min(B, int(REF_SCORES_BYTES // (4 * Hq * S * T))))

    def train_checks(label, recorder, cfg, S):
        """The backward kernels the training step launched, on the inputs
        and cotangents of the first call of each signature (the last layer
        in the backward's order), the cotangents scaled to unit rms by a
        power of two: the flash pair against ``ref.flash_attention_bwd_ref``
        on the first ``ref_rows`` batch rows, the expert products' dx against
        ``ref.moe_gmm_bwd_ref`` at the bf16 limit and their dw (a sum over the
        batch's tokens) no further from float64 than twice the plain
        version, the scans' backwards whole within ``SUM_REL`` of each
        gradient's largest magnitude, as phase 11d holds them on a model's
        inputs, RWKV6's also no further from float64 than twice the plain
        version."""
        errs = {}
        n = layer_counts(cfg)
        if n["attn"]:
            worst = 0.0
            for (causal, window, S_, T_, d, G), (q, k, v, o, dout), kw in recorded(
                    label, recorder, "flash.flash_attention_bwd", flash_signatures(cfg, S)):
                if kw.get("key_valid") is not None or kw.get("lse") is not None:
                    raise AssertionError(f"{label}: a masked flash backward {kw}")
                kw = dict(causal=causal, window=window)
                # the gradients are linear in the loss's cotangent, of the order of
                # 1 / tokens: scaled to unit rms by a power of two, exactly
                scale = unit_scale(dout)
                dout = dout * scale
                got = _flash.flash_attention_bwd(q, k, v, o, dout, **kw)
                B, Hq = q.shape[:2]
                rows_ = slice(0, ref_rows(B, Hq, S_, T_))
                expect = ref.flash_attention_bwd_ref(q[rows_], k[rows_], v[rows_], o[rows_],
                                                     dout[rows_], **kw)
                err = max(check_close(f"{label} flash backward {S_} x {T_} d{x}", a[rows_], b,
                                      TOL["bfloat16"]) for x, a, b in zip("qkv", got, expect))
                print(f"  {label} flash backward ({_flash.bwd_route(bf16)} pair) q "
                      f"{tuple(q.shape)} k {tuple(k.shape)} {kw}, dout times {scale:g}: max "
                      f"|diff| {err:.3g} on batch rows {rows_.start}..{rows_.stop} (atol, rtol "
                      f"{TOL['bfloat16']})")
                worst = max(worst, err)
                del q, k, v, o, dout, got, expect
            errs["flash_bwd"] = worst
        if n["moe"]:
            worst = 0.0
            for _, (x, w, dy), _ in recorder.calls("gmm.moe_gmm_bwd", dev):
                E, C, D = x.shape
                F = w.shape[2]
                scale = unit_scale(dy)
                dy = dy * scale
                (dx, dw), (ex, ew) = _gmm.moe_gmm_bwd(x, w, dy), ref.moe_gmm_bwd_ref(x, w, dy)
                err = check_close(f"{label} moe_gmm backward dx", dx, ex, TOL["bfloat16"])
                # dw sums over the C rows of every token an expert took: on a model's
                # inputs the sums cancel, and the plain version's fp32 sum, rounded to
                # bf16, lies an ulp or two from the rounded float64 one where a rounding
                # boundary falls between them.  The kernel must lie no further from
                # float64 than twice the plain version
                exact = torch.einsum("ecd,ecf->edf", x.double(), dy.double())
                kd, pd = (float((t.double() - exact).abs().max()) for t in (dw, ew))
                if not (bool(dw.isfinite().all()) and kd <= 2 * pd):
                    raise AssertionError(f"{label} moe_gmm backward dw: the kernel {kd:.4g} from "
                                         f"float64, the plain version {pd:.4g}")
                print(f"  {label} moe_gmm backward {_gmm.bwd_route(bf16, C, D, F)} x "
                      f"{tuple(x.shape)} w {tuple(w.shape)}, dy times {scale:g}: dx max |diff| "
                      f"{err:.3g} (atol, rtol {TOL['bfloat16']}); dw max |diff| from float64, "
                      f"kernel / plain {kd:.4g} / {pd:.4g} (largest |dw| "
                      f"{float(exact.abs().max()):.4g}), kernel against plain "
                      f"{float((dw.float() - ew.float()).abs().max()):.4g}")
                worst = max(worst, err)
                del x, w, dy, dx, dw, ex, ew, exact
            errs["moe_gmm_bwd"] = worst
        for which in ("mamba", "rwkv"):
            if not n[which]:
                continue
            name, fn, plain, names, do = (
                ("mamba.mamba_scan_bwd", _mamba.mamba_scan_bwd, ref.mamba_scan_bwd_ref,
                 ("ddt", "ddtx", "dB", "dC", "dA", "dh0"), 6) if which == "mamba" else
                ("rwkv.rwkv6_scan_bwd", _rwkv.rwkv6_scan_bwd, ref.rwkv6_scan_bwd_ref,
                 ("dr", "dk", "dv", "dw", "du", "dS0"), 6))
            worst = 0.0
            for _, args, _ in recorder.calls(name, dev):
                if args[7] is not None:
                    raise AssertionError(f"{label}: a cotangent of the last state")
                scale = unit_scale(args[do])
                args[do] = args[do] * scale
                got = fn(*args)
                expect = plain(*args)
                # phase 11d's limit for these kernels on a model's inputs: each
                # gradient within SUM_REL of its largest magnitude.  Over 4096 steps
                # the sums cancel, and the plain fp32 version lies past phase 3's
                # elementwise limit from a float64 one
                err = max(
                    check_close(f"{label} {which} backward {x}", a, b, (SUM_REL * big, 0.0)) / big
                    for x, a, b in zip(names, got, expect) if a is not None and b is not None
                    for big in [max(float(b.abs().max()), 1e-30)])
                note = ""
                if which == "rwkv":
                    # the kernel must lie no further from float64 than twice the
                    # plain version
                    two = slice(0, 2)
                    exact = rwkv6_scan_bwd_f64(*(a[two] if a is not None and a.dim() == 4
                                                 else a for a in args))
                    off = []
                    for x, a, b, ex in zip(names, got, expect, exact):
                        if x == "du":                   # a sum over every row of the batch
                            continue
                        kd, pd = (float((t[two].double() - ex).abs().max()) for t in (a, b))
                        off.append(f"{x} {kd:.3g} / {pd:.3g}")
                        if not kd <= 2 * pd + 1e-12 * float(ex.abs().max()):
                            raise AssertionError(f"{label} rwkv6 backward {x}: the kernel "
                                                 f"{kd:.3g} from float64, the plain version "
                                                 f"{pd:.3g}")
                    note = f"; max |diff| from float64 on rows 0-1, kernel / plain: {', '.join(off)}"
                route = (_mamba.bwd_route(args[0].dtype, args[2].shape[-1], args[0].shape[-1])
                         if which == "mamba" else _rwkv.bwd_route(args[0].dtype,
                                                                  args[0].shape[-1]))
                print(f"  {label} {which} backward ({route}) {tuple(args[0].shape)} "
                      f"{args[0].dtype}, {'dy' if which == 'mamba' else 'do'} times {scale:g}: "
                      f"max |diff| over the gradient's largest magnitude {err:.3g} (within "
                      f"{SUM_REL}){note}")
                worst = max(worst, err)
                del args, got, expect
            errs[f"{which}_bwd"] = worst
        return errs

    def train_pair(cfg, rec, seed):
        B, S = rec.batch, rec.seq_len
        label = f"13c {cfg.name} train_4k"
        t_pair = time.perf_counter()
        # 11d's AdamW at qwen3-1.7b's width, the rate scaled by 2048 / d_model: an
        # AdamW step moves each weight by about the rate, and a layer's output
        # by about the rate times its width (3e-4 sent most losses up at 4096
        # tokens, and 3e-5 deepseek-67b's, of width 8192)
        opt = dict(TRAIN_FAMILY_OPT, lr=TRAIN_FAMILY_OPT["lr"] * 2048 / cfg.d_model)
        it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                                    seed=seed)).batches()
        batches = []
        for i in range(TRAIN_STEPS + 1):
            b = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
            extra = pair_inputs(cfg, B, S, seed + 1000 * (i + 1))
            if "embeds" in extra:
                del b["tokens"]
            batches.append({**b, **extra})
        print(f"{label}: {rec.depth()}, batch {B} x {S} "
              + ("embeddings" if "embeds" in batches[0] else "tokens")
              + (f", {batches[0]['enc_embeds'].shape[1]} encoder frames, all valid"
                 if "enc_embeds" in batches[0] else "") + f"; AdamW {opt}")
        recorder = Recorder(modules, ("flash.flash_attention_bwd", "gmm.moe_gmm_bwd",
                                      "mamba.mamba_scan_bwd", "rwkv.rwkv6_scan_bwd"))
        runs = {}
        for mode in ("graph", "eager"):
            free_card(torch, f"{label} ({mode})")
            torch.cuda.reset_peak_memory_stats()
            params = tree_map(lambda p: p.requires_grad_(True),
                              T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED)))
            tables = len(_adamw.split_tables([p.numel() for p in tree_leaves(params)]))
            state = init_state(params)
            step = make_train_step(cfg, AdamWConfig(**opt), remat=True)
            ops.reset_launches()
            times, hist, graph = [], [], None
            with recorder if mode == "eager" else contextlib.nullcontext():
                for b in batches[:TRAIN_STEPS]:
                    t0 = time.perf_counter()
                    if mode == "eager":
                        _, _, m = step(params, state, b)
                    elif graph is None:
                        graph = TrainGraph(step, params, state, b)
                        m = graph.first_metrics
                    else:
                        m = graph.replay(b)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    hist.append({k: float(v) for k, v in m.items()})
            routes = routes_now()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if graph is None:
                    step(params, state, batches[TRAIN_STEPS])
                else:
                    graph.replay(batches[TRAIN_STEPS])
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            device_us, _ = device_top(torch, prof, 1)
            steady = statistics.fmean(times[1:])
            mf = flops.model_flops(cfg, InputShape("train_4k", S, B, StepKind.TRAIN))
            peak, reserved = card_peak()
            runs[mode] = dict(hist=hist, step_ms=1e3 * steady, device_us=device_us,
                              idle=device_us and 1 - device_us / wall_us, peak=peak,
                              reserved=reserved, routes=routes,
                              capture_s=graph.capture_s if graph else None,
                              tokens_s=B * S / steady,
                              mfu=mf["model_flops"] / steady / PEAK_BF16_FLOPS)
            r = runs[mode]
            print(f"{label} [{mode}] B {B} x {S}: losses "
                  f"{[round(h['loss'], 6) for h in hist]}, step_ms {r['step_ms']:.1f} (steps "
                  f"2-{TRAIN_STEPS}; step 1 {1e3 * times[0]:.1f}"
                  + (f", capture_s {r['capture_s']:.3f}" if graph else "")
                  + f"), tokens/s {r['tokens_s']:.1f}, MFU {r['mfu']:.4f}; profiled step device "
                  f"{_ms(device_us and device_us / 1e3)} ms, idle {_ms(r['idle'], '.3f')}; peak "
                  f"{peak} allocated, "
                  f"{reserved} reserved; launches by route {routes}")
            below_reckoning(f"{label} [{mode}]", reserved, rec)
            del params, state, step, graph, prof
            gc.collect()
            torch.cuda.empty_cache()
        g, e = runs["graph"], runs["eager"]
        if g["routes"] != e["routes"]:
            raise AssertionError(f"{label}: launches by route {g['routes']} replayed against "
                                 f"{e['routes']} eager")
        want = train_routes(cfg, B, S, tables)
        got = {op: g["routes"].get(op) for op in want}
        if got != want:
            raise AssertionError(f"{label}: the backward's and AdamW's launches by route {got}, "
                                 f"expected {want}")
        off = []
        for i, (a, b) in enumerate(zip(g["hist"], e["hist"])):
            for k in ("loss", "grad_norm"):
                if not abs(a[k] - b[k]) <= 1e-5 * abs(b[k]):
                    off.append(f"step {i + 1} {k} {a[k]!r} against {b[k]!r}")
        exact = all(a[k] == b[k] for a, b in zip(g["hist"], e["hist"]) for k in ("loss",
                                                                              "grad_norm"))
        losses = [h["loss"] for h in g["hist"]]
        if off or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: {off or losses}")
        print(f"  the replay's losses and grad norms "
              + ("exactly equal" if exact else "within rtol 1e-5 of") + " the eager step's; "
              f"the loss falls {losses[0]:.4f} -> {losses[-1]:.4f}; the backward's and AdamW's "
              f"launches by route {want}")
        del batches
        gc.collect()
        torch.cuda.empty_cache()
        t_checks = time.perf_counter()
        errs = train_checks(label, recorder, cfg, S)
        del recorder
        gc.collect()
        torch.cuda.empty_cache()
        seconds = time.perf_counter() - t_pair
        print(f"  {label}: {seconds:.1f} s (the kernels' checks "
              f"{time.perf_counter() - t_checks:.1f})")
        rows.append(dict(shape="train_4k", cfg=cfg, B=B, S=S, rec=rec, graph=g, eager=e,
                         peak=max(g["peak"], e["peak"]), reserved=max(g["reserved"],
                                                                    e["reserved"]),
                         seconds=seconds, errs=errs))

    for i, (shape, cfg, run, decided) in enumerate(plan):
        if run is None:
            continue
        if shape != plan[i - 1][0] or i == 0:
            phase({"serve_32k": "13a prefill_32k and decode_32k, one engine a model",
                   "long_500k": "13b long_500k at batch 1",
                   "train_4k": "13c train_4k"}[shape])
        try:
            if shape == "train_4k":
                train_pair(cfg, run, LONG_SEED + i)
            else:
                serve_pair(shape, cfg, run, LONG_SEED + i)
        except Exception as err:                       # noqa: BLE001
            if not keep_going:
                raise
            failed.append(f"{cfg.name} {shape}: {type(err).__name__}: {err}")
            print(f"  FAILED {failed[-1]}")
            gc.collect()
            torch.cuda.empty_cache()

    # -- 13d: the dry run beside each measured pair -----------------------------
    phase("13d the dry run on a 1-rank mesh beside each pair run (phase 12b at these lengths)")
    dry = host["13d"].result()
    print(f"  {dry['seconds']:.1f} s of a host-side worker")
    for row in rows:
        cfg, B, S, g = row["cfg"], row["B"], row["S"], row["graph"]
        measured = {"step": g.get("device_us") and g["device_us"] / 1e3,
                    "prefill": g.get("prefill_dev_ms"),
                    "decode step": g.get("decode_dev_us") and g["decode_dev_us"] / 1e3}
        for name, shp, what in assigned_dry_pairs(row["shape"], cfg, row["rec"]):
            d = dry["13d"][(cfg.name, name)]
            measured_ms = measured[what]
            print(f"  {cfg.name} {name} B {B} x {shp.seq_len} ({row['rec'].depth()}"
                  + (f", {d['note']}" if d["note"] else "") + f"): predicted peak "
                  f"{d['peak']:.6g} B against {row['peak']} allocated "
                  f"({d['peak'] / max(row['peak'], 1):.3f} x); predicted {what} "
                  f"{d['step_ms']:.3f} ms ({d['bottleneck']}-bound) against the replay's device "
                  f"{_ms(measured_ms, '.3f')} ms"
                  + (f" ({d['step_ms'] / measured_ms:.3f} x)" if measured_ms else "")
                  + f"; {d['seconds']:.1f} s of the worker's host time")

    # -- the summary ----------------------------------------------------------------
    print(f"\nthe assigned shapes on one card ({smi}; replay / eager; prefill and train "
          f"step device ms from the profile, decode work_us on the host clock):")
    for row in rows:
        cfg, g, e = row["cfg"], row["graph"], row["eager"]
        head = (f"  {row['shape']} {cfg.name} B {row['B']} x {row['S']}, {row['rec'].depth()}"
                + (f", cache {row['cap']} slots" if row.get("cap") else ""))
        if row["shape"] == "train_4k":
            print(f"{head}: step_ms {g['step_ms']:.1f} / {e['step_ms']:.1f}, device_ms "
                  f"{_ms(g['device_us'] and g['device_us'] / 1e3)} / "
                  f"{_ms(e['device_us'] and e['device_us'] / 1e3)}, tokens/s "
                  f"{g['tokens_s']:.1f}, MFU {g['mfu']:.4f}, peak {row['peak'] / 1e9:.2f} GB "
                  f"({row['reserved'] / 1e9:.2f} reserved, reckoned {row['rec'].total / 1e9:.2f}"
                  f"), {row['seconds']:.1f} s")
        else:
            print(f"{head}: prefill_ms {g['prefill_ms']:.1f} / {e['prefill_ms']:.1f} (device "
                  f"{_ms(g['prefill_dev_ms'])} / {_ms(e['prefill_dev_ms'])}), decode work_us "
                  f"{g['work_us']:.1f} / {e['work_us']:.1f} (device {_ms(g['decode_dev_us'])} / "
                  f"{_ms(e['decode_dev_us'])}, idle {_ms(g['decode_idle'], '.3f')} / "
                  f"{_ms(e['decode_idle'], '.3f')}), capture_s "
                  f"{_ms(max(row['capture'], default=None), '.3f')}, peak "
                  f"{row['peak'] / 1e9:.2f} GB ({row['reserved'] / 1e9:.2f} reserved, reckoned "
                  f"{row['rec'].total / 1e9:.2f}), {row['seconds']:.1f} s")
    for shape, cfg, run, decided in plan:
        if run is None:
            print(f"  {shape} {cfg.name}: not run, reckoned {decided.total / 1e9:.2f} GB at "
                  f"batch 1, {decided.depth()} ({decided.line()})")
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("phase 13: " + "; ".join(failed))


def main() -> int:
    import torch

    only_13 = "--only-assigned-shapes" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.config import get_arch, reduced, reduced_grouped
    from repro_torch.core import (FaasdRuntime, FunctionSpec, KneeSearch, LoadSpec, Simulator,
                                  drive, run_sequential, sustainable_throughput)
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels._launch import stream_handle
    from repro_torch.kernels import adamw as _adamw
    from repro_torch.kernels import aes_ctr as _aes
    from repro_torch.kernels import decode_attention as _decode
    from repro_torch.kernels import flash_attention as _flash
    from repro_torch.kernels import mamba_scan as _mamba
    from repro_torch.kernels import moe_gmm as _gmm
    from repro_torch.kernels import rwkv6_scan as _rwkv
    from repro_torch.models import attention
    from repro_torch.train import losses as losses_mod
    from repro_torch.train.checkpoint import _items as tree_items
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import stub_frontend_embeddings
    from repro_torch.models.layers import tree_leaves, tree_map, tree_to
    from repro_torch.serving import AesFunction, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # -- 1 ------------------------------------------------------------------
    phase("1 device and toolchain")
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    smi = smi.splitlines()[0]
    sm_clock_hz = 1e6 * float(sh("nvidia-smi", "--query-gpu=clocks.max.sm",
                                 "--format=csv,noheader,nounits").splitlines()[0])
    props = torch.cuda.get_device_properties(0)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    print(sh(_build.nvcc(), "--version").splitlines()[-1])
    print(smi)
    print(f"{props.name}: {props.multi_processor_count} SMs, "
          f"{props.total_memory / 2**30:.1f} GiB, max SM clock {sm_clock_hz / 1e6:.0f} MHz")

    # -- 2 ------------------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    spills = []
    for name, log in logs.items():
        for line in log.splitlines():
            if "spill" in line or ("ptxas" in line and ("registers" in line
                                                        or "Compiling" in line)):
                print(f"  {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError("kernels spill registers: " + "; ".join(spills))
    # the dry-run traces of phases 12a and 13d and phase 13's plan: host work, in
    # worker processes while the card runs the phases before them
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    worker = ProcessPoolExecutor(max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    host13 = {"plan": worker.submit(host_plan), "13d": worker.submit(host_13d)}
    if only_13:
        phase("13 the assigned input shapes on one card")
        assigned_shapes(torch, dev, smi, host13, keep_going=True)
        worker.shutdown()
        return 0
    host12 = worker.submit(host_12a)

    # -- 3 ------------------------------------------------------------------
    phase("3 kernels against their plain versions")
    check_assigned_shapes(get_arch)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_case(case, dt):
        B, Hq, Hkv, S, Tk, d, causal, win = case
        q, k, v = randn(B, Hq, S, d, dtype=dt), randn(B, Hkv, Tk, d, dtype=dt), \
            randn(B, Hkv, Tk, d, dtype=dt)
        return (q, k, v), dict(causal=causal, window=win)

    def decode_case(case, dt, valid=None):
        B, Hq, Hkv, Tk, d = case
        q, k, v = randn(B, Hq, d, dtype=dt), randn(B, Tk, Hkv, d, dtype=dt), \
            randn(B, Tk, Hkv, d, dtype=dt)
        if valid is None:
            valid = torch.rand((B, Tk), generator=gen, device=dev) < 0.8
            valid[:, 0] = True
        return (q, k, v, valid), {}

    kernels = {
        "flash_attention": dict(op=ops.flash_attention, plain=ref.flash_attention_ref,
                                make=flash_case, sweep=FLASH_SWEEP),
        "decode_attention": dict(op=ops.decode_attention, plain=ref.decode_attention_ref,
                                 make=decode_case, sweep=DECODE_SWEEP),
    }
    for name, kd in kernels.items():
        for case in kd["sweep"]:
            for dname, dt in dtypes.items():
                args, kw = kd["make"](case, dt)
                out = kd["op"](*args, **kw)
                torch.cuda.synchronize()
                err = check_close(f"{name}{case} {dname}", out, kd["plain"](*args, **kw),
                                  TOL[dname])
                print(f"  {name} {case} {dname}: max |diff| {err:.3g} "
                      f"(atol, rtol {TOL[dname]})")

    for case in FLASH_SWEEP:      # the previous design, reachable for bf16 on its own
        args, kw = flash_case(case, torch.bfloat16)
        out = _flash.flash_attention_simt(*args, **kw)
        torch.cuda.synchronize()
        err = check_close(f"flash_attention{case} bfloat16 simt", out,
                          ref.flash_attention_ref(*args, **kw), TOL["bfloat16"])
        print(f"  flash_attention {case} bfloat16, simt design: max |diff| {err:.3g}")
    for case in FLASH_D120:       # head_dim 120, both designs and fp32
        for dname, dt in dtypes.items():
            args, kw = flash_case(case, dt)
            plain = ref.flash_attention_ref(*args, **kw)
            designs = {_flash.route(dt): ops.flash_attention}
            if dt == torch.bfloat16:
                if "wgmma" not in designs:
                    raise AssertionError(f"flash_attention: bf16 routes to {_flash.route(dt)}")
                designs["simt"] = _flash.flash_attention_simt
            for design, fn in designs.items():
                err = check_close(f"flash_attention{case} {dname} {design}", fn(*args, **kw),
                                  plain, TOL[dname])
                print(f"  flash_attention {case} {dname}, {design} design: max |diff| {err:.3g}")

    def decode_mask(B, Tk, mask):
        j = torch.arange(Tk, device=dev)
        if mask == "prefix":      # a 512-token prompt and one new token
            v = j <= min(PROMPT_LEN, Tk - 1)
        elif mask == "wrap":      # a ring that wraps: slots 700 .. T-1 and 0 .. 188
            v = (j >= min(700, Tk - 1)) | (j < 189)
        elif mask == "few":       # 3 valid slots in one tile: the other splits get none
            v = (j == 1) | (j == 5) | (j == 63)
        else:                     # random, the last row with no valid slot
            r = torch.rand((B, Tk), generator=gen, device=dev) < 0.5
            r[-1] = False
            return r
        return v[None].expand(B, Tk).contiguous()

    for case, mask in [(c, "empty_row") for c in DECODE_SWEEP] + [(c[:5], c[5])
                                                                  for c in DECODE_STRESS]:
        for dname, dt in dtypes.items():
            (q, k, v, valid), _ = decode_case(case, dt, decode_mask(case[0], case[3], mask))
            plain = ref.decode_attention_ref(q, k, v, valid)
            designs = {_decode.route(dt, case[1] // case[2], case[3]): ops.decode_attention}
            if dt == torch.bfloat16:
                designs["simt"] = _decode.decode_attention_simt
            for design, fn in designs.items():
                err = check_close(f"decode_attention{case} {mask} {dname} {design}",
                                  fn(q, k, v, valid), plain, TOL[dname])
                print(f"  decode_attention {case} {mask} {dname}, {design} design: "
                      f"max |diff| {err:.3g}")

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    records = {}
    # the kernels at the shapes of phases 5h-5j and 11g, reported once timed
    assigned_kernels = {}
    # flash at the prefill of the main path: both designs, timed in turns
    B, Hq, Hkv, S, Tk, d, causal, win = FLASH_MAIN
    (q, k, v), kw = flash_case(FLASH_MAIN, torch.bfloat16)
    if _flash.route(q.dtype) != "wgmma":
        raise AssertionError(f"flash_attention: bf16 routes to {_flash.route(q.dtype)}")
    out = ops.flash_attention(q, k, v, **kw)
    plain = ref.flash_attention_ref(q, k, v, **kw)
    err = check_close(f"flash_attention{FLASH_MAIN}", out, plain, TOL["bfloat16"])
    err_prev = check_close(f"flash_attention{FLASH_MAIN} simt",
                           _flash.flash_attention_simt(q, k, v, **kw), plain, TOL["bfloat16"])
    pairs = int(torch.tril(torch.ones(S, Tk, dtype=torch.bool), Tk - S).sum())
    kq, vq = k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1)
    old, new = in_turns(torch, lambda: _flash.flash_attention_simt(q, k, v, **kw),
                        lambda: ops.flash_attention(q, k, v, **kw), 20, flush)
    lib = launch_times_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kq, vq, is_causal=True), 40, flush)
    print(f"  flash_attention {FLASH_MAIN} bfloat16: wgmma {spread(new)}, max |diff| "
          f"{err:.3g}; simt (previous) {spread(old)}, max |diff| {err_prev:.3g}; "
          f"SDPA {spread(lib)}")
    records["flash_attention"] = dict(
        err=err,
        ms=statistics.fmean(new), previous_ms=statistics.fmean(old),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 5, flush),
        library_ms=statistics.fmean(lib),
        bytes=sum(t.numel() * t.element_size() for t in (q, k, v, out)),
        ops=f"{4 * d * pairs * B * Hq} FLOP",
        ops_ms=1e3 * 4 * d * pairs * B * Hq / PEAK_BF16_FLOPS,
        replaces="src/repro/kernels/flash_attention.py:98",
        source="src/repro_torch/csrc/flash_attention.cu")

    # the flash backward (phase 11's training): the pair of each design
    # (bwd_route: bf16 -> wgmma, fp32 -> simt; the simt pair for bf16 too)
    # against the plain version over the sweep in both dtypes and at the
    # training shapes, then timed at qwen3-1.7b's: the wgmma pair in turns
    # with the simt pair, and in turns with SDPA's backward (through K and V
    # repeated to Hq, the sum back to Hkv included)
    if _flash.bwd_route(torch.bfloat16) != "wgmma" or _flash.bwd_route(torch.float32) != "simt":
        raise AssertionError("flash_attention_bwd: bf16 must route to wgmma, fp32 to simt")
    for case, dnames in [(c, tuple(dtypes)) for c in FLASH_SWEEP] + FLASH_BWD_CASES:
        for dname in dnames:
            (q, k, v), kw = flash_case(case, dtypes[dname])
            dout = randn(*q.shape, dtype=dtypes[dname])
            o = ref.flash_attention_ref(q, k, v, **kw)
            plain = ref.flash_attention_bwd_ref(q, k, v, o, dout, **kw)
            designs = {_flash.bwd_route(dtypes[dname]): _flash.flash_attention_bwd}
            if dname == "bfloat16":
                designs["simt"] = _flash.flash_attention_bwd_simt
            for design, fn in designs.items():
                got = fn(q, k, v, o, dout, **kw)
                torch.cuda.synchronize()
                errs = [check_close(f"flash_attention_bwd{case} {dname} {design} d{n}", g, e,
                                    TOL[dname]) for n, g, e in zip("qkv", got, plain)]
                print(f"  flash_attention_bwd {case} {dname}, {design} pair: max |diff| dq "
                      f"{errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g} (atol, rtol "
                      f"{TOL[dname]})")

    def flash_bwd_times(case):
        """The wgmma pair at ``case`` (bf16) against the plain version, then
        timed in turns with the simt pair and with SDPA's backward."""
        B, Hq, Hkv, S, Tk, d, causal, win = case
        (q, k, v), kw = flash_case(case, torch.bfloat16)
        dout = randn(*q.shape, dtype=torch.bfloat16)
        o = ops.flash_attention(q, k, v, **kw)
        got = _flash.flash_attention_bwd(q, k, v, o, dout, **kw)
        err = max(check_close(f"flash_attention_bwd{case} d{n}", g, e, TOL["bfloat16"])
                  for n, g, e in zip("qkv", got,
                                     ref.flash_attention_bwd_ref(q, k, v, o, dout, **kw)))
        G = Hq // Hkv
        lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
        lo = torch.nn.functional.scaled_dot_product_attention(
            lq, lk.repeat_interleave(G, 1), lv.repeat_interleave(G, 1), is_causal=True)
        old, new = in_turns(
            torch, lambda: _flash.flash_attention_bwd_simt(q, k, v, o, dout, **kw),
            lambda: _flash.flash_attention_bwd(q, k, v, o, dout, **kw), 10, flush,
            BWD_HOLD_CYCLES)
        lib, new_lib = in_turns(
            torch, lambda: torch.autograd.grad(lo, (lq, lk, lv), dout, retain_graph=True),
            lambda: _flash.flash_attention_bwd(q, k, v, o, dout, **kw), 10, flush,
            BWD_HOLD_CYCLES)
        pairs = int(torch.tril(torch.ones(S, Tk, dtype=torch.bool), Tk - S).sum())
        print(f"  flash_attention_bwd {case} bfloat16, in turns, card held "
              f"{BWD_HOLD_CYCLES} cycles: wgmma pair {spread(new)} beside the simt pair, "
              f"{spread(new_lib)} beside SDPA, max |diff| {err:.3g}; simt pair (previous) "
              f"{spread(old)}; SDPA's backward with the sum over G {spread(lib)}")
        return dict(
            err=err, ms=statistics.fmean(new + new_lib), previous_ms=statistics.fmean(old),
            plain_ms=time_ms(torch, lambda: ref.flash_attention_bwd_ref(q, k, v, o, dout, **kw),
                             3, flush),
            library_ms=statistics.fmean(lib),
            bytes=sum(t.numel() * t.element_size() for t in (q, k, v, o, dout, *got)),
            ops=f"{10 * d * pairs * B * Hq} FLOP (five products)",
            ops_ms=1e3 * 10 * d * pairs * B * Hq / PEAK_BF16_FLOPS,
            replaces="src/repro/kernels/flash_attention.py:98",
            source="src/repro_torch/csrc/flash_attention.cu")

    records["flash_attention_bwd"] = dict(
        flash_bwd_times(FLASH_BWD_MAIN),
        note="the backward of the flash kernel (bwd_dq_wgmma, then bwd_dkv_wgmma; "
             "previous_ms: the simt pair bwd_dq, bwd_dkv); the JAX package has no Pallas "
             "backward and differentiates gqa_attend (src/repro/models/attention.py:51); "
             "launches: phase 11b's training")
    for label, case in FLASH_BWD_ASSIGNED.items():    # 11g's G = 3 and G = 8
        assigned_kernels[f"flash_attention_bwd {label}"] = flash_bwd_times(case)

    # decode at a step of the main path, a 512-token prompt in a 1024-slot
    # cache, at qwen3's G = 2, at G = 4 and at the steps of phases 5h (G = 3)
    # and 5j (G = 8 at d 128): both designs, timed in turns
    decode_labels = {DECODE_MAIN: None, DECODE_MIXTRAL: None,
                     **{shape: label for label, shape in DECODE_ASSIGNED.items()}}
    for shape, label in decode_labels.items():
        B, Hq, Hkv, Tk, d = shape
        (q, k, v, valid), _ = decode_case(shape, torch.bfloat16, decode_mask(B, Tk, "prefix"))
        if _decode.route(q.dtype, Hq // Hkv, Tk) != "split":
            raise AssertionError(f"decode_attention{shape}: bf16 does not route to split")
        plain = ref.decode_attention_ref(q, k, v, valid)
        err = check_close(f"decode_attention{shape}", ops.decode_attention(q, k, v, valid),
                          plain, TOL["bfloat16"])
        err_prev = check_close(f"decode_attention{shape} simt",
                               _decode.decode_attention_simt(q, k, v, valid), plain,
                               TOL["bfloat16"])
        kq = k.transpose(1, 2).repeat_interleave(Hq // Hkv, 1)
        vq = v.transpose(1, 2).repeat_interleave(Hq // Hkv, 1)
        q4, mask4 = q[:, :, None], valid[:, None, None, :]
        old, new = in_turns(torch, lambda: _decode.decode_attention_simt(q, k, v, valid),
                            lambda: ops.decode_attention(q, k, v, valid), 25, flush)
        lib = launch_times_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kq, vq, attn_mask=mask4), 50, flush)
        print(f"  decode_attention {shape} bfloat16, {int(valid[0].sum())} valid slots, "
              f"splits {_decode.splits(B, Hkv, Tk, props.multi_processor_count)}: split "
              f"{spread(new)}, max |diff| {err:.3g}; simt (previous) {spread(old)}, max |diff| "
              f"{err_prev:.3g}; SDPA {spread(lib)}")
        if shape != DECODE_MAIN and label is None:
            continue
        rec = dict(
            err=err,
            ms=statistics.fmean(new), previous_ms=statistics.fmean(old),
            plain_ms=time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, valid), 10, flush),
            library_ms=statistics.fmean(lib),
            # K/V of invalid slots cannot change the output: only valid slots count
            bytes=sum(t.numel() * t.element_size() for t in (q, valid, plain))
            + 2 * int(valid.sum()) * Hkv * d * k.element_size(),
            ops=f"{4 * d * Hq * int(valid.sum())} FLOP",
            ops_ms=1e3 * 4 * d * Hq * int(valid.sum()) / PEAK_BF16_FLOPS,
            replaces="src/repro/kernels/decode_attention.py:77",
            source="src/repro_torch/csrc/decode_attention.cu")
        if label is None:
            records["decode_attention"] = rec
        else:
            assigned_kernels[f"decode_attention {label}"] = rec

    def report(name, r):
        t_bytes = 1e3 * r["bytes"] / PEAK_BYTES_PER_S
        r["bound_ms"], r["bound_by"] = max((t_bytes, "bytes"), (r["ops_ms"], "operations"))
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        prev = f"previous_ms {r['previous_ms']:.4f}  " if "previous_ms" in r else ""
        print(f"kernels {name}: ms {r['ms']:.4f}  {prev}plain_ms {r['plain_ms']:.4f}  "
              f"library_ms {lib}  bound_ms {r['bound_ms']:.6f} ({r['bound_by']}; "
              f"{r['bytes']} B in {t_bytes:.6f} ms, {r['ops']} in {r['ops_ms']:.6f} ms)  "
              f"max |diff| {r['err']:.3g}")

    for name, r in {**records, **assigned_kernels}.items():
        report(name, r)

    # the enc-dec and frontend models' attention (phases 5f and 5g): flash
    # without the causal bound at seamless-m4t's encoder (a ragged T of 1500,
    # d 64, G 1) and cross prefill (S 512 against T 1500), and causal at
    # pixtral-12b's prefill; then the causal prefills of phases 5h (G 3) and
    # 5j (G 8 at d 128); both designs held in bf16 and simt in fp32, then
    # timed in turns, SDPA beside them
    for label, case in {**ENCDEC_FLASH, **ASSIGNED_FLASH}.items():
        B, Hq, Hkv, S, Tk, d, causal = case
        if _flash.route(torch.bfloat16) != "wgmma":
            raise AssertionError(f"flash_attention: bf16 routes to {_flash.route(torch.bfloat16)}")
        (q, k, v), kw = flash_case((*case, None), torch.float32)
        err32 = check_close(f"flash_attention {label} float32 simt", ops.flash_attention(q, k, v, **kw),
                            ref.flash_attention_ref(q, k, v, **kw), TOL["float32"])
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        plain = ref.flash_attention_ref(q, k, v, **kw)
        out = ops.flash_attention(q, k, v, **kw)
        err = check_close(f"flash_attention {label} wgmma", out, plain, TOL["bfloat16"])
        err_prev = check_close(f"flash_attention {label} simt",
                               _flash.flash_attention_simt(q, k, v, **kw), plain, TOL["bfloat16"])
        pairs = int(torch.tril(torch.ones(S, Tk, dtype=torch.bool), Tk - S).sum()) if causal \
            else S * Tk
        kq, vq = k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1)
        old, new = in_turns(torch, lambda: _flash.flash_attention_simt(q, k, v, **kw),
                            lambda: ops.flash_attention(q, k, v, **kw), 10, flush)
        lib = launch_times_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kq, vq, is_causal=causal), 20, flush)
        print(f"  flash_attention {label} {case}: wgmma {spread(new)}, max |diff| {err:.3g}; "
              f"simt {spread(old)}, max |diff| {err_prev:.3g}; SDPA {spread(lib)}; "
              f"fp32 simt max |diff| {err32:.3g}")
        report(f"flash_attention {label}", dict(
            err=err, ms=statistics.fmean(new), previous_ms=statistics.fmean(old),
            plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 3, flush),
            library_ms=statistics.fmean(lib),
            bytes=sum(t.numel() * t.element_size() for t in (q, k, v, out)),
            ops=f"{4 * d * pairs * B * Hq} FLOP",
            ops_ms=1e3 * 4 * d * pairs * B * Hq / PEAK_BF16_FLOPS))
        del q, k, v, kq, vq, out, plain

    # the key-masked designs (phase 5f's cross prefill under an encoder mask
    # in bf16, phase 4f's in fp32) at seamless's cross prefill: the ragged
    # valid lengths with one fully masked row, then a mask with holes; bf16
    # on both designs (wgmma_masked, the route, and the simt masked design on
    # its own entry point), fp32 on simt; then wgmma_masked timed in bf16 in
    # turns with the simt masked design, SDPA given the same boolean mask
    B, Hq, Hkv, S, Tk, d, _ = ENCDEC_FLASH["seamless cross prefill"]
    lengths = [Tk - 97 * b for b in range(B)]
    lengths[1] = 0                # a row with no valid key averages v over T
    tpos = torch.arange(Tk, device=dev)
    masks = {"ragged": tpos[None] < torch.tensor(lengths, device=dev)[:, None]}
    holes = torch.rand((B, Tk), generator=gen, device=dev) < 0.7
    holes[:, 320:832] = False                         # tiles 5..12 dead mid-row
    holes[1] = tpos >= Tk // 64 * 64 + 5              # keys only in the last, partial tile
    holes[3] = (tpos % 256) < 64                      # every fourth tile live
    masks["holes"] = holes
    n_tiles = -(-Tk // 64)

    def tile_walks(key_valid):
        """The key tiles each batch row's blocks walk (not causal, no
        window): the live ones, or all of them for a row with no valid key."""
        live = torch.nn.functional.pad(key_valid, (0, n_tiles * 64 - Tk)).view(
            B, n_tiles, 64).any(-1).sum(-1)
        return torch.where(key_valid.any(-1), live, n_tiles).tolist()

    errs = {}
    for dname, dt in dtypes.items():
        (q, k, v), _ = flash_case((B, Hq, Hkv, S, Tk, d, False, None), dt)
        designs = {_flash.route(dt, True): ops.flash_attention}
        if dt == torch.bfloat16:
            designs["masked"] = _flash.flash_attention_masked_simt
        if set(designs) != ({"wgmma_masked", "masked"} if dname == "bfloat16" else {"masked"}):
            raise AssertionError(f"flash_attention: a key mask in {dname} routes to "
                                 f"{_flash.route(dt, True)}")
        for mname, key_valid in masks.items():
            kw = dict(causal=False, key_valid=key_valid)
            plain = ref.flash_attention_ref(q, k, v, **kw)
            for design, fn in designs.items():
                out = fn(q, k, v, **kw)
                torch.cuda.synchronize()
                errs[dname, mname, design] = check_close(
                    f"flash_attention masked cross prefill {dname} {mname} {design}", out, plain,
                    TOL[dname])
                if mname == "ragged":   # row 1: the mean of v over all of T
                    check_close(f"flash_attention masked {dname} {design}, the fully masked row",
                                out[1], v[1].float().mean(1, keepdim=True).expand(Hkv, S, d),
                                TOL[dname])
        for mname, key_valid in masks.items():
            walks = tile_walks(key_valid)
            print(f"  flash_attention masked cross prefill {dname}, {mname} mask (valid "
                  f"{key_valid.sum(1).tolist()}): max |diff| "
                  + ", ".join(f"{design} {errs[dname, mname, design]:.3g}" for design in designs)
                  + f"; tile walks a query tile {walks}, {sum(walks)} of {B * n_tiles} "
                  f"({sum(walks) * Hq * -(-S // 128)} of {B * n_tiles * Hq * -(-S // 128)} "
                  f"block walks)")
    key_valid = masks["ragged"]
    kw = dict(causal=False, key_valid=key_valid)
    old, new = in_turns(torch, lambda: _flash.flash_attention_masked_simt(q, k, v, **kw),
                        lambda: ops.flash_attention(q, k, v, **kw), 10, flush)
    lib = launch_times_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=key_valid[:, None, None, :]), 20, flush)
    # the products the data needs: each query against its row's valid keys
    # (the fully masked row's output, the mean of v, costs no product).  The
    # bytes it needs: q, out and the mask once, k over the valid keys, v over
    # the valid keys and over all of T for each row with none
    pairs = S * sum(lengths)
    kv_row_bytes = Hkv * d * k.element_size()
    needed_bytes = (sum(t.numel() * t.element_size() for t in (q, key_valid, out))
                    + kv_row_bytes * (2 * sum(lengths) + Tk * lengths.count(0)))
    print(f"  flash_attention masked cross prefill {(B, Hq, Hkv, S, Tk, d)} bfloat16, ragged "
          f"mask, in turns: wgmma_masked {spread(new)}; simt masked (previous) {spread(old)}; "
          f"SDPA with the mask {spread(lib)}")
    # what the live walk saves against the unmasked route, and what a row
    # with no valid key costs (its blocks walk every tile, each masked)
    for mname, mlengths in (("ragged, no empty row", [Tk - 97 * b for b in range(B)]),
                            ("all valid but row 1", [0 if b == 1 else Tk for b in range(B)])):
        mkv = tpos[None] < torch.tensor(mlengths, device=dev)[:, None]
        plain_t, masked_t = in_turns(
            torch, lambda: ops.flash_attention(q, k, v, causal=False),
            lambda: ops.flash_attention(q, k, v, causal=False, key_valid=mkv), 10, flush)
        print(f"  flash_attention masked cross prefill bfloat16, {mname} (tile walks "
              f"{sum(tile_walks(mkv))} of {B * n_tiles}), in turns: wgmma_masked "
              f"{spread(masked_t)}; wgmma unmasked {spread(plain_t)}")
    records["flash_attention_masked"] = dict(
        err=max(errs["bfloat16", m, "wgmma_masked"] for m in masks), ms=statistics.fmean(new),
        previous_ms=statistics.fmean(old),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 3, flush),
        library_ms=statistics.fmean(lib),
        bytes=needed_bytes,
        ops=f"{4 * d * pairs * Hq} FLOP", ops_ms=1e3 * 4 * d * pairs * Hq / PEAK_BF16_FLOPS,
        replaces="src/repro/models/transformer.py:137",
        source="src/repro_torch/csrc/flash_attention.cu",
        note="the wgmma_masked route (previous_ms: the simt masked design, early-stopped); "
             "launches: phase 5f's masked prefill")
    report("flash_attention masked cross prefill", records["flash_attention_masked"])
    del q, k, v, out, plain, key_valid, masks, holes

    # the backward of the key-masked routes (phases 11e and 11f's
    # cross-attention under an encoder mask): each masked pair (bwd_route
    # under a mask: bf16 -> wgmma_live, from the forward's lse, fp32 ->
    # masked; for bf16 also the previous wgmma_masked pair and the simt
    # masked pair) against the plain version over MASKED_BWD_SWEEP at the
    # unmasked backward's limits, most masks with a row that has no allowed
    # valid key, and the forward's lse against the plain lse; then timed at
    # 11f's cross shape under row 1m's ragged mask, in turns: the wgmma_live
    # pair with the previous wgmma_masked pair, with the simt masked pair,
    # with SDPA's backward under the same boolean mask, and with the unmasked
    # wgmma pair on the same inputs (and, all keys valid, masked against
    # unmasked); each pair's dq and dkv entry points timed apart in turns;
    # the masked forward with lse and without, in turns
    if (_flash.bwd_route(torch.bfloat16, True), _flash.bwd_route(torch.float32, True)) != \
            ("wgmma_live", "masked"):
        raise AssertionError("flash_attention_bwd: a key mask must route bf16 to wgmma_live, "
                             "fp32 to masked")

    def masked_bwd_valid(B, Tk, kind):
        """(B, Tk) key masks, a row each: ``cross`` row 1m's ragged lengths
        (row 1 has no valid key); ``ragged`` all, none, tile edges;
        ``holes`` dead tiles mid-row, keys only in the last partial tile,
        none; ``future`` (causal) keys past the early rows, which then see
        no valid key where S >= T, or only early keys."""
        t = torch.arange(Tk, device=dev)
        if kind in ("cross", "ragged"):
            lengths = ([Tk - 97 * b for b in range(B)] if kind == "cross"
                       else [(Tk, 0, 64, 65, Tk - 1)[b % 5] for b in range(B)])
            lengths[1] = 0
            return t[None] < torch.tensor(lengths, device=dev)[:, None]
        rows = []
        for b in range(B):
            if kind == "holes":
                row = (((t < 128) | (t >= 320)) & ~((t >= 640) & (t < 832))
                       & (torch.rand(Tk, generator=gen, device=dev) < 0.7))
                row = (row if b % 3 == 0 else t >= (Tk - 1) // 64 * 64 + 3 if b % 3 == 1
                       else torch.zeros_like(row))
            else:
                row = t >= 40 + 30 * b if b % 2 == 0 else t < 20 + 30 * b
            rows.append(row)
        return torch.stack(rows)

    def check_lse(name, lse, q, k, kw):
        """The forward's lse against the plain lse: -inf on the same rows,
        the others within 1e-3 (log2 units); returns the largest error."""
        expect = ref.flash_attention_lse_ref(q, k, **kw)
        if not torch.equal(torch.isneginf(lse), torch.isneginf(expect)):
            raise AssertionError(f"{name}: lse is -inf on other rows than the plain lse")
        fin = torch.isfinite(expect)
        return check_close(name, lse[fin], expect[fin], (1e-3, 0.0)) if fin.any() else 0.0

    errs = collections.defaultdict(float)
    for case in MASKED_BWD_SWEEP:
        B, Hq, Hkv, S, Tk, d, causal, win, kind = case
        key_valid = masked_bwd_valid(B, Tk, kind)
        kw = dict(causal=causal, window=win, key_valid=key_valid)
        for dname, dt in dtypes.items():
            (q, k, v), _ = flash_case(case[:8], dt)
            dout = randn(*q.shape, dtype=dt)
            o = ref.flash_attention_ref(q, k, v, **kw)
            designs = {_flash.bwd_route(dt, True): _flash.flash_attention_bwd}
            if dname == "bfloat16":
                designs["wgmma_masked"] = _flash.flash_attention_bwd_wgmma_masked
                designs["masked"] = _flash.flash_attention_bwd_masked_simt
            for design, fn in designs.items():
                o_d, extra, lse_note = o, {}, ""
                if design == "wgmma_live":   # the forward's output and lse
                    o_d, lse = _flash.flash_attention(q, k, v, return_lse=True, **kw)
                    lse_err = check_lse(f"flash_attention{case} lse", lse, q, k, kw)
                    errs["lse"] = max(errs["lse"], lse_err)
                    extra, lse_note = dict(lse=lse), f", the forward's lse max |diff| {lse_err:.3g}"
                plain = ref.flash_attention_bwd_ref(q, k, v, o_d, dout, **kw)
                before = dict(_flash.BWD_LAUNCHES)
                got = fn(q, k, v, o_d, dout, **kw, **extra)
                torch.cuda.synchronize()
                if _flash.BWD_LAUNCHES != {r: n + (r in _flash.BWD_PAIRS[design])
                                           for r, n in before.items()}:
                    raise AssertionError(f"flash_attention_bwd {design}: launches "
                                         f"{_flash.BWD_LAUNCHES} after {before}")
                e3 = [check_close(f"flash_attention_bwd{case} {dname} {design} d{n}", g, e,
                                  TOL[dname]) for n, g, e in zip("qkv", got, plain)]
                errs[dname, design] = max(errs[dname, design], *e3)
                print(f"  flash_attention_bwd {case} {dname}, {design} pair: max |diff| dq "
                      f"{e3[0]:.3g}, dk {e3[1]:.3g}, dv {e3[2]:.3g} (atol, rtol {TOL[dname]})"
                      f"{lse_note}; valid {key_valid.sum(1).tolist()}")
            del q, k, v, dout, o, o_d, plain, got
    B, Hq, Hkv, S, Tk, d, _ = ENCDEC_FLASH["seamless cross prefill"]
    (q, k, v), _ = flash_case((B, Hq, Hkv, S, Tk, d, False, None), torch.bfloat16)
    dout = randn(*q.shape, dtype=torch.bfloat16)
    key_valid = masked_bwd_valid(B, Tk, "cross")
    lengths = key_valid.sum(1).tolist()
    kw = dict(causal=False, key_valid=key_valid)
    o, lse = _flash.flash_attention(q, k, v, return_lse=True, **kw)
    if not torch.equal(o, ops.flash_attention(q, k, v, **kw)):
        raise AssertionError("flash_attention wgmma_masked: the output with lse differs")
    plain = ref.flash_attention_bwd_ref(q, k, v, o, dout, **kw)
    err = max(check_close(f"flash_attention_bwd masked cross d{n}", g, e, TOL["bfloat16"])
              for n, g, e in zip("qkv", _flash.flash_attention_bwd(q, k, v, o, dout, lse=lse,
                                                                   **kw), plain))
    err_prev = max(check_close(f"flash_attention_bwd masked cross wgmma_masked d{n}", g, e,
                               TOL["bfloat16"])
                   for n, g, e in zip("qkv", _flash.flash_attention_bwd_wgmma_masked(
                       q, k, v, o, dout, **kw), plain))

    def live_pair():
        return _flash.flash_attention_bwd(q, k, v, o, dout, lse=lse, **kw)

    old, new = in_turns(torch, lambda: _flash.flash_attention_bwd_wgmma_masked(q, k, v, o, dout,
                                                                               **kw),
                        live_pair, 10, flush, BWD_HOLD_CYCLES)
    simt, new_simt = in_turns(
        torch, lambda: _flash.flash_attention_bwd_masked_simt(q, k, v, o, dout, **kw),
        live_pair, 10, flush, BWD_HOLD_CYCLES)
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lo = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv,
                                                          attn_mask=key_valid[:, None, None, :])
    lib, new_lib = in_turns(
        torch, lambda: torch.autograd.grad(lo, (lq, lk, lv), dout, retain_graph=True),
        live_pair, 10, flush, BWD_HOLD_CYCLES)
    o_all = ops.flash_attention(q, k, v, causal=False)
    unmasked, new_unmasked = in_turns(
        torch, lambda: _flash.flash_attention_bwd(q, k, v, o_all, dout, causal=False),
        live_pair, 10, flush, BWD_HOLD_CYCLES)
    all_valid = torch.ones_like(key_valid)
    o_valid, lse_valid = _flash.flash_attention(q, k, v, causal=False, key_valid=all_valid,
                                                return_lse=True)
    unmasked2, all_valid_t = in_turns(
        torch, lambda: _flash.flash_attention_bwd(q, k, v, o_all, dout, causal=False),
        lambda: _flash.flash_attention_bwd(q, k, v, o_valid, dout, causal=False,
                                           key_valid=all_valid, lse=lse_valid),
        10, flush, BWD_HOLD_CYCLES)
    prev_all_valid, _ = in_turns(
        torch, lambda: _flash.flash_attention_bwd_wgmma_masked(q, k, v, o_valid, dout,
                                                               causal=False, key_valid=all_valid),
        lambda: _flash.flash_attention_bwd(q, k, v, o_valid, dout, causal=False,
                                           key_valid=all_valid, lse=lse_valid),
        10, flush, BWD_HOLD_CYCLES)

    # each pair's two entry points apart, on buffers made once: the live
    # pair's dq entry builds the list of live tiles, then runs the dq kernel
    nkt = -(-Tk // _flash.LIVE_TILE)
    bufs = dict(dq=torch.empty_like(q), dk=torch.empty_like(k), dv=torch.empty_like(v),
                lse=torch.empty_like(lse), delta=torch.empty_like(lse),
                words=torch.empty((B, nkt), dtype=torch.int64, device=dev),
                live=torch.empty((B, nkt), dtype=torch.int32, device=dev),
                prefix=torch.empty((B, nkt + 1), dtype=torch.int32, device=dev))
    bp = {n: t.data_ptr() for n, t in bufs.items()}
    shape = [B, Hq, Hkv, S, Tk, d, 0, 0, 0, d ** -0.5, stream_handle(dev)]
    qkv = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    entries = {
        "bwd_dq_wgmma_live": lambda: _flash._entry("bwd_dq_wgmma_live")(
            *qkv, o.data_ptr(), dout.data_ptr(), key_valid.data_ptr(), lse.data_ptr(), bp["dq"],
            bp["delta"], bp["words"], bp["live"], bp["prefix"], *shape),
        "bwd_dkv_wgmma_live": lambda: _flash._entry("bwd_dkv_wgmma_live")(
            *qkv, dout.data_ptr(), lse.data_ptr(), bp["delta"], bp["words"], bp["prefix"],
            bp["dk"], bp["dv"], *shape),
        "bwd_dq_wgmma_masked": lambda: _flash._entry("bwd_dq_wgmma_masked")(
            *qkv, o.data_ptr(), dout.data_ptr(), key_valid.data_ptr(), bp["dq"], bp["lse"],
            bp["delta"], *shape),
        "bwd_dkv_wgmma_masked": lambda: _flash._entry("bwd_dkv_wgmma_masked")(
            *qkv, dout.data_ptr(), key_valid.data_ptr(), bp["lse"], bp["delta"], bp["dk"],
            bp["dv"], *shape)}
    for name, fn in entries.items():   # in the order of the pairs: each reads what the last wrote
        if fn():
            raise AssertionError(f"flash_attention {name}: launch failed")
    torch.cuda.synchronize()
    split = {}
    for kernel in ("dq", "dkv"):
        split[f"{kernel} previous"], split[kernel] = in_turns(
            torch, entries[f"bwd_{kernel}_wgmma_masked"], entries[f"bwd_{kernel}_wgmma_live"],
            10, flush, BWD_HOLD_CYCLES)
    fwd_plain, fwd_lse = in_turns(
        torch, lambda: _flash.flash_attention(q, k, v, **kw),
        lambda: _flash.flash_attention(q, k, v, return_lse=True, **kw), 10, flush)
    print(f"  flash_attention_bwd masked cross {(B, Hq, Hkv, S, Tk, d)} bfloat16, valid {lengths}"
          f", in turns, card held {BWD_HOLD_CYCLES} cycles: wgmma_live pair {spread(new)} "
          f"beside the previous wgmma_masked pair, {spread(new_simt)} beside the simt masked "
          f"pair, {spread(new_lib)} beside SDPA, {spread(new_unmasked)} beside the unmasked "
          f"pair, max |diff| {err:.3g}; previous wgmma_masked pair {spread(old)}, max |diff| "
          f"{err_prev:.3g}; simt masked pair {spread(simt)}; SDPA's backward under the mask "
          f"{spread(lib)}; unmasked wgmma pair {spread(unmasked)}")
    print("  apart, in turns: " + "; ".join(f"{n} {spread(t)}" for n, t in split.items()))
    print(f"  all 1500 keys valid, in turns: wgmma_live pair {spread(all_valid_t)}; unmasked "
          f"wgmma pair {spread(unmasked2)}; previous wgmma_masked pair {spread(prev_all_valid)}")
    print(f"  the masked forward (row 1m), in turns: without lse {spread(fwd_plain)}; writing lse "
          f"{spread(fwd_lse)}")
    # what the data needs: five products over each row's valid keys (a row
    # with none costs no product: its dO / T is a sum); q, o, dO, dq once, k
    # and v over the valid keys, dk and dv over all of T, the mask once
    pairs = S * sum(lengths)
    tb = q.element_size()
    needed_bytes = (4 * B * Hq * S * d * tb + 2 * Hkv * d * tb * sum(lengths)
                    + 2 * B * Hkv * Tk * d * tb + key_valid.numel())
    records["flash_attention_masked_bwd"] = dict(
        err=max(err, errs["bfloat16", "wgmma_live"]), ms=statistics.fmean(new + new_lib),
        previous_ms=statistics.fmean(old), simt_ms=statistics.fmean(simt),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_bwd_ref(q, k, v, o, dout, **kw), 3,
                         flush),
        library_ms=statistics.fmean(lib), unmasked_ms=statistics.fmean(unmasked),
        bytes=needed_bytes, ops=f"{10 * d * pairs * Hq} FLOP (five products)",
        ops_ms=1e3 * 10 * d * pairs * Hq / PEAK_BF16_FLOPS,
        replaces="src/repro/kernels/flash_attention.py:98",
        source="src/repro_torch/csrc/flash_attention.cu",
        note="the backward of the key-masked routes (bwd_dq_wgmma_live: the list of live tiles, "
             "then dq from the forward's lse; then bwd_dkv_wgmma_live; previous_ms: the previous "
             "pair bwd_dq_wgmma_masked, bwd_dkv_wgmma_masked; simt_ms: the simt masked pair; "
             "unmasked_ms: the unmasked wgmma pair on the same inputs); the JAX package "
             "differentiates gqa_attend under the mask (src/repro/models/attention.py:51); "
             "launches: phase 11f's seamless training")
    report("flash_attention masked backward", records["flash_attention_masked_bwd"])
    print("    max |diff| over the sweep: "
          + ", ".join(f"{key} {x:.3g}" for key, x in errs.items()))
    del q, k, v, dout, o, o_all, o_valid, lq, lk, lv, lo, key_valid, all_valid, bufs, plain

    # the decode attention of phases 5f and 5g: against seamless-m4t's 1500
    # encoder frames (G 1, d 64, not a ring; all valid, so every tile is
    # live, then a ragged prefix), and in seamless's 1024-slot and pixtral's
    # 2048-slot KV caches at a step of their decode; both designs, timed in
    # turns, SDPA beside them
    for label, (shape, mask) in ENCDEC_DECODE.items():
        B, Hq, Hkv, Tk, d = shape
        j = torch.arange(Tk, device=dev)
        if mask == "all":
            valid = torch.ones((B, Tk), dtype=torch.bool, device=dev)
        elif mask == "ragged":
            valid = j[None] < torch.tensor([Tk - 97 * b for b in range(B)], device=dev)[:, None]
        else:                     # a prompt of ``mask`` positions, NEW_TOKENS // 2 steps on
            valid = (j <= mask + NEW_TOKENS // 2)[None].expand(B, Tk).contiguous()
        (q, k, v, valid), _ = decode_case(shape, torch.bfloat16, valid)
        if _decode.route(q.dtype, Hq // Hkv, Tk) != "split":
            raise AssertionError(f"decode_attention {label}{shape}: bf16 does not route to split")
        plain = ref.decode_attention_ref(q, k, v, valid)
        err = check_close(f"decode_attention {label}{shape} split",
                          ops.decode_attention(q, k, v, valid), plain, TOL["bfloat16"])
        err_prev = check_close(f"decode_attention {label}{shape} simt",
                               _decode.decode_attention_simt(q, k, v, valid), plain,
                               TOL["bfloat16"])
        q4, mask4 = q[:, :, None], valid[:, None, None, :]
        kq = k.transpose(1, 2).repeat_interleave(Hq // Hkv, 1)
        vq = v.transpose(1, 2).repeat_interleave(Hq // Hkv, 1)
        old, new = in_turns(torch, lambda: _decode.decode_attention_simt(q, k, v, valid),
                            lambda: ops.decode_attention(q, k, v, valid), 25, flush)
        lib = launch_times_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kq, vq, attn_mask=mask4), 50, flush)
        n_valid = int(valid.sum())
        print(f"  decode_attention {label} {shape} bfloat16, {n_valid} valid slots, "
              f"splits {_decode.splits(B, Hkv, Tk, props.multi_processor_count)}: split "
              f"{spread(new)}, max |diff| {err:.3g}; simt {spread(old)}, max |diff| "
              f"{err_prev:.3g}; SDPA {spread(lib)}")
        report(f"decode_attention {label}", dict(
            err=err, ms=statistics.fmean(new), previous_ms=statistics.fmean(old),
            plain_ms=time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, valid), 10, flush),
            library_ms=statistics.fmean(lib),
            bytes=sum(t.numel() * t.element_size() for t in (q, valid, plain))
            + 2 * n_valid * Hkv * d * k.element_size(),
            ops=f"{4 * d * Hq * n_valid} FLOP",
            ops_ms=1e3 * 4 * d * Hq * n_valid / PEAK_BF16_FLOPS))
        if shape == CROSS_DECODE and mask == "all":
            # what the cross prefill's layout costs: K and V of a layer, kept
            # in the decode kernel's (B, T, Hkv, d), copied once to the flash
            # kernel's (B, Hkv, T, d)
            copy = launch_times_ms(torch, lambda: (k.transpose(1, 2).contiguous(),
                                                   v.transpose(1, 2).contiguous()), 50, flush)
            print(f"  cross K/V of one layer to the flash layout "
                  f"({2 * k.numel() * k.element_size()} bytes, two transposed copies): "
                  f"{spread(copy)}")
        del q, k, v, kq, vq, valid, plain

    # the MoE expert matmul: the sweep in fp32 and bf16, then mixtral-8x7b's
    # serving shapes in bf16, with weights at the model's scale N(0, 1/D) as
    # dense_init draws them (so |y| is of the order of the partial sums)
    def gmm_case(E, C, D, F, dt, w_scale=1.0):
        return randn(E, C, D, dtype=dt), (randn(E, D, F, dtype=torch.float32) * w_scale).to(dt)

    for case in GMM_SWEEP:
        for dname, dt in dtypes.items():
            x, w = gmm_case(*case, dt)
            out = ops.moe_gmm(x, w)
            torch.cuda.synchronize()
            err = check_close(f"moe_gmm{case} {dname}", out, ref.moe_gmm_ref(x, w),
                              GMM_TOL[dname])
            print(f"  moe_gmm {case} {dname}: max |diff| {err:.3g} "
                  f"(atol, rtol {GMM_TOL[dname]})")
    for case in GMM_WGMMA_SWEEP:
        E, C, D, F = case
        if _gmm.route(torch.bfloat16, C, D, F) != "wgmma":
            raise AssertionError(f"moe_gmm{case}: bf16 does not route to wgmma")
        x, w = gmm_case(*case, torch.bfloat16, D ** -0.5)
        err = check_close(f"moe_gmm{case} wgmma", ops.moe_gmm(x, w), ref.moe_gmm_ref(x, w),
                          GMM_TOL["bfloat16"])
        print(f"  moe_gmm {case} bfloat16, wgmma design: max |diff| {err:.3g}")
    for case in GMM_STREAM_SWEEP:   # the last past the route's threshold: the kernel's own entry
        E, C, D, F = case
        x, w = gmm_case(*case, torch.bfloat16, D ** -0.5)
        err = check_close(f"moe_gmm{case} stream", _gmm.moe_gmm_stream(x, w),
                          ref.moe_gmm_ref(x, w), GMM_TOL["bfloat16"])
        print(f"  moe_gmm {case} bfloat16, stream design (route {_gmm.route(x.dtype, C, D, F)}): "
              f"max |diff| {err:.3g}")
    # the three designs across the routes' thresholds, at mixtral's gate/up widths
    x_all, w = gmm_case(8, max(GMM_THRESHOLD_C), 4096, 14336, torch.bfloat16, 4096 ** -0.5)
    for C in GMM_THRESHOLD_C:
        x = x_all[:, :C].contiguous()
        old, new = in_turns(torch, lambda: _gmm.moe_gmm_mma_sync(x, w),
                            lambda: _gmm.moe_gmm_wgmma(x, w), 10, flush)
        line = (f"  moe_gmm (8, {C}, 4096, 14336) route {_gmm.route(x.dtype, C, 4096, 14336)}: "
                f"mma_sync {spread(old)}; wgmma {spread(new)}")
        if C <= _gmm.STREAM_KERNEL_MAX_C:
            ts = launch_times_ms(torch, lambda: _gmm.moe_gmm_stream(x, w), 20, flush)
            line += f"; stream {spread(ts)}"
        print(line)
    del x_all, x, w
    gmm_times = {}
    for label, (E, C, D, F) in GMM_MAIN.items():
        x, w = gmm_case(E, C, D, F, torch.bfloat16, D ** -0.5)
        route = _gmm.route(x.dtype, C, D, F)
        out = ops.moe_gmm(x, w)
        plain = ref.moe_gmm_ref(x, w)
        err = check_close(f"moe_gmm {label} {(E, C, D, F)}", out, plain, GMM_TOL["bfloat16"])
        print(f"  moe_gmm {label} {(E, C, D, F)} bfloat16, {route} design: max |diff| {err:.3g}")
        if route == "wgmma":   # both designs, timed in turns
            err_prev = check_close(f"moe_gmm {label} mma_sync", _gmm.moe_gmm_mma_sync(x, w),
                                   plain, GMM_TOL["bfloat16"])
            old, new = in_turns(torch, lambda: _gmm.moe_gmm_mma_sync(x, w),
                                lambda: ops.moe_gmm(x, w), 5, flush)
            lib = launch_times_ms(torch, lambda: torch.bmm(x, w), 10, flush)
            print(f"  moe_gmm {label}: wgmma {spread(new)}; mma_sync (previous) {spread(old)}, "
                  f"max |diff| {err_prev:.3g}; bmm {spread(lib)}")
            times = dict(ms=statistics.fmean(new), previous_ms=statistics.fmean(old),
                         library_ms=statistics.fmean(lib))
        else:                  # stream, against mma_sync in turns; wgmma beside them
            err_prev = check_close(f"moe_gmm {label} mma_sync", _gmm.moe_gmm_mma_sync(x, w),
                                   plain, GMM_TOL["bfloat16"])
            old, new = in_turns(torch, lambda: _gmm.moe_gmm_mma_sync(x, w),
                                lambda: ops.moe_gmm(x, w), 10, flush)
            wg = launch_times_ms(torch, lambda: _gmm.moe_gmm_wgmma(x, w), 20, flush)
            lib = launch_times_ms(torch, lambda: torch.bmm(x, w), 20, flush)
            print(f"  moe_gmm {label}: stream {spread(new)}; mma_sync (previous) {spread(old)}, "
                  f"max |diff| {err_prev:.3g}; wgmma {spread(wg)}; bmm {spread(lib)}")
            times = dict(ms=statistics.fmean(new), previous_ms=statistics.fmean(old),
                         library_ms=statistics.fmean(lib))
        gmm_times[label] = dict(
            err=err, **times,
            plain_ms=time_ms(torch, lambda: ref.moe_gmm_ref(x, w), 3, flush),
            bytes=sum(t.numel() * t.element_size() for t in (x, w, out)),
            ops=f"{2 * E * C * D * F} FLOP",
            ops_ms=1e3 * 2 * E * C * D * F / PEAK_BF16_FLOPS,
            replaces="src/repro/kernels/moe_gmm.py:52",
            source="src/repro_torch/csrc/moe_gmm.cu")
        report(f"moe_gmm {label}", gmm_times[label])
        del x, w, out, plain
    # the line's records: decode gate/up, 1488 of the 2304 launches of 5b
    # (decode down takes 744, the prefill 48 gate/up and 24 down), and the
    # redesigned prefill, gate/up, under its own name
    records["moe_gmm"] = gmm_times["decode gate/up"]
    records["moe_gmm_prefill"] = gmm_times["prefill gate/up"]

    # the two scans: the sweep in fp32 and bf16, then the serving shapes in
    # fp32 (the model feeds them fp32), inputs at the scales of
    # tests/test_kernels.py and an fp32 state
    fp32_flops = FP32_LANES * 2 * props.multi_processor_count * sm_clock_hz
    exp_rate = SFU_EXP_PER_CLOCK * props.multi_processor_count * sm_clock_hz

    def mamba_case(B, S, di, ds, dt_, with_state=True):
        f32 = torch.float32
        dt = (torch.nn.functional.softplus(randn(B, S, di, dtype=f32)) * 0.1).to(dt_)
        dtx = (randn(B, S, di, dtype=f32) * 0.1).to(dt_)
        A = (-torch.exp(randn(di, ds, dtype=f32))).to(dt_)
        h0 = randn(B, di, ds, dtype=f32) if with_state else None
        return dt, dtx, randn(B, S, ds, dtype=dt_), randn(B, S, ds, dtype=dt_), A, h0

    def rwkv_case(B, T, H, hd, dt_, with_state=True):
        f32 = torch.float32
        r = randn(B, T, H, hd, dtype=dt_)
        k, v = ((randn(B, T, H, hd, dtype=f32) * 0.3).to(dt_) for _ in range(2))
        w = torch.sigmoid(randn(B, T, H, hd, dtype=f32) * 0.5 + 2).to(dt_)
        u = (randn(H, hd, dtype=f32) * 0.1).to(dt_)
        S0 = randn(B, H, hd, hd, dtype=f32) * 0.3 if with_state else None
        return r, k, v, w, u, S0

    def check_scan(name, op, plain, args, dname):
        out, state = op(*args)
        torch.cuda.synchronize()
        expect, expect_state = plain(*args)
        return max(check_close(f"{name} out", out, expect, SCAN_TOL[dname]),
                   check_close(f"{name} state", state, expect_state, SCAN_TOL["float32"]))

    # each scan in both designs: the routed one (lanes, cols) and the
    # previous one on its own entry point (simt); every sweep and serving
    # shape routes to the new design (ds a multiple of 4; hd 16, 32, 64)
    scans = {
        "mamba_scan": dict(op=ops.mamba_scan, previous=_mamba.mamba_scan_simt,
                           route=lambda dt_, case: _mamba.route(dt_, case[3]), new="lanes",
                           plain=ref.mamba_scan_ref, make=mamba_case, sweep=MAMBA_SWEEP,
                           main=MAMBA_MAIN),
        "rwkv6_scan": dict(op=ops.rwkv6_scan, previous=_rwkv.rwkv6_scan_simt,
                           route=lambda dt_, case: _rwkv.route(dt_, case[3]), new="cols",
                           plain=ref.rwkv6_scan_ref, make=rwkv_case, sweep=RWKV_SWEEP,
                           main=RWKV_MAIN),
    }
    scan_times = {}
    for name, kd in scans.items():
        for case in kd["sweep"]:
            for dname, dt_ in dtypes.items():
                if kd["route"](dt_, case) != kd["new"]:
                    raise AssertionError(f"{name}{case} {dname} routes to "
                                         f"{kd['route'](dt_, case)}")
                args = kd["make"](*case[:4], dt_, case[4])
                for design, fn in ((kd["new"], kd["op"]), ("simt", kd["previous"])):
                    err = check_scan(f"{name}{case} {dname} {design}", fn, kd["plain"], args,
                                     dname)
                    print(f"  {name} {case} {dname}, {design} design: max |diff| {err:.3g} "
                          f"(atol, rtol {SCAN_TOL[dname]})")
        for label, shape in kd["main"].items():
            args = kd["make"](*shape, torch.float32)
            if kd["route"](torch.float32, shape) != kd["new"]:
                raise AssertionError(f"{name} {label} {shape} does not route to {kd['new']}")
            err = check_scan(f"{name} {label} {shape}", kd["op"], kd["plain"], args, "float32")
            err_prev = check_scan(f"{name} {label} {shape} simt", kd["previous"], kd["plain"],
                                  args, "float32")
            out, state = kd["op"](*args)
            B, S = shape[:2]
            if name == "mamba_scan":
                n_exp = B * S * shape[2] * shape[3]
                ops_desc, ops_ms = f"{n_exp} exponentials", 1e3 * n_exp / exp_rate
            else:
                # the least the function needs: per step and head, an FMA for
                # o and a MUL and an FMA for S at each (i, j), since o_t[j] =
                # sum_i r_i S[i, j] + v_j sum_i r_i u_i k_i; the second sum and
                # its use are 5 FLOP per i
                H, hd = shape[2:]
                flop = 5 * B * S * H * hd * (hd + 1)
                ops_desc, ops_ms = f"{flop} fp32 FLOP", 1e3 * flop / fp32_flops
            # both designs in turns; at the prefill the mean of 20 launches
            # each, at a decode step the median of 200: a few-microsecond
            # kernel, where a host stall between the start event and the
            # launch that outlasts the flush (the host's cores are shared)
            # idles the card inside the timed span and adds its length to
            # one sample
            old, new = in_turns(torch, lambda: kd["previous"](*args), lambda: kd["op"](*args),
                                10 if S > 1 else 100, flush)
            pick = statistics.fmean if S > 1 else statistics.median
            print(f"  {name} {label} {shape} float32: {kd['new']} {spread(new)}, max |diff| "
                  f"{err:.3g}; simt (previous) {spread(old)}, max |diff| {err_prev:.3g}")
            scan_times[(name, label)] = dict(
                err=err,
                ms=pick(new), previous_ms=pick(old),
                plain_ms=time_ms(torch, lambda: kd["plain"](*args), 3, flush),
                library_ms=None,        # no PyTorch call computes either recurrence
                bytes=sum(t.numel() * t.element_size() for t in (*args, out, state)),
                ops=ops_desc, ops_ms=ops_ms,
                replaces={"mamba_scan": "src/repro/kernels/mamba_scan.py:64",
                          "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:58"}[name],
                source=f"src/repro_torch/csrc/{name}.cu")
            report(f"{name} {label} {shape}", scan_times[(name, label)])
            if S == 1:
                # the floor a decode step meets in this timing: one PyTorch
                # copy of the state it reads and writes (no kernel of the port)
                st0 = args[5]
                copy = launch_times_ms(torch, lambda: st0.clone(), 200, flush)
                print(f"  {name} {label}: a copy of the {st0.numel() * 4}-byte state "
                      f"(read and written once) {spread(copy)}")
            del args, out, state
        # the line's record: the decode step, 651 of 672 launches of 5c
        # (31 of 32 for each Mamba layer) and 744 of 768 of 5d
        records[name] = scan_times[(name, "decode")]

    # the backward kernels of the MoE matmul and the scans (phase 11's
    # training): each against its plain version over the sweep in fp32 and
    # bf16 and at phase 11d's shapes, then timed there.  A gradient that sums
    # over channels, batch rows or time (dB, dC, dA, du; dw of the MoE) is
    # held in fp32 at SUM_REL of its largest magnitude, the others at the
    # forward's limits; every bf16 gradient at the bf16 limit (its rounding
    # to bf16 is the larger error)
    def check_grads(name, got, expect, dname, fwd_tol, summed):
        errs = []
        for g_name, g, e in zip(expect, got, expect.values()):
            if g_name in summed and dname == "float32":
                scale = float(e.abs().max())
                errs.append(check_close(f"{name} {g_name}", g, e, (SUM_REL * scale, 0.0)))
            else:
                errs.append(check_close(f"{name} {g_name}", g, e,
                                        fwd_tol if g.dtype == torch.float32 else TOL["bfloat16"]))
        return ", ".join(f"{n} {x:.3g}" for n, x in zip(expect, errs))

    for case in GMM_BWD_SWEEP:
        for dname, dt_ in dtypes.items():
            E, C, D, F = case
            x, w = gmm_case(E, C, D, F, dt_, D ** -0.5)
            dy = randn(E, C, F, dtype=dt_)
            got = _gmm.moe_gmm_bwd(x, w, dy)
            torch.cuda.synchronize()
            exp = dict(zip(("dx", "dw"), ref.moe_gmm_bwd_ref(x, w, dy)))
            errs = check_grads(f"moe_gmm_bwd{case} {dname}", got, exp, dname, GMM_TOL[dname],
                               ("dw",))
            print(f"  moe_gmm_bwd {case} {dname}, routes {_gmm.bwd_route(dt_, C, D, F)}: "
                  f"max |diff| {errs}")
    # phase 11d's shapes: the pair (dx on wgmma_nt, dw on wgmma_tn: the
    # backward's own clustered design) and the previous pair (dx on the
    # forward's wgmma design reading w transposed, dw on it over a copy of x)
    # held to the plain version, then timed in turns with each other and
    # with torch.bmm for dx and dw; then each product apart, in turns with
    # its previous design and with its own bmm, and the copy of x alone
    bwd_times = {}
    print(f"  the backward's design: {_gmm.tn_clusters(True)} two-block clusters fit this card "
          f"for dw, {_gmm.tn_clusters(False)} for dx ({props.multi_processor_count} SMs)")
    for label, (E, C, D, F) in GMM_BWD_MAIN.items():
        x, w = gmm_case(E, C, D, F, torch.bfloat16, D ** -0.5)
        dy = randn(E, C, F, dtype=torch.bfloat16)
        routes = _gmm.bwd_route(torch.bfloat16, C, D, F)
        if routes != ("wgmma_nt" if C // _gmm.DX_ROWS % 2 == 0 else "wgmma_nt_fwd", "wgmma_tn"):
            raise AssertionError(f"moe_gmm_bwd {label}: routes {routes}")
        got = _gmm.moe_gmm_bwd(x, w, dy)
        exp = dict(zip(("dx", "dw"), ref.moe_gmm_bwd_ref(x, w, dy)))
        errs = check_grads(f"moe_gmm_bwd {label}", got, exp, "bfloat16", GMM_TOL["bfloat16"],
                           ("dw",))
        err_prev = max(check_close(f"moe_gmm_bwd {label} previous dx",
                                   _gmm.moe_gmm_dx_previous(w, dy), exp["dx"], TOL["bfloat16"]),
                       check_close(f"moe_gmm_bwd {label} previous dw",
                                   _gmm.moe_gmm_dw_transposed(x, dy), exp["dw"], TOL["bfloat16"]))
        wt = w.transpose(1, 2)
        xt = x.transpose(1, 2)

        def new_pair():
            return _gmm.moe_gmm_bwd(x, w, dy)

        old, new = in_turns(torch, lambda: (_gmm.moe_gmm_dx_previous(w, dy),
                                            _gmm.moe_gmm_dw_transposed(x, dy)), new_pair, 5, flush)
        lib, new_lib = in_turns(torch, lambda: (torch.bmm(dy, wt), torch.bmm(xt, dy)), new_pair,
                                5, flush)
        dw_old, dw_new = in_turns(torch, lambda: _gmm.moe_gmm_dw_transposed(x, dy),
                                  lambda: _gmm.moe_gmm_dw(x, dy), 5, flush)
        dw_lib, dw_new2 = in_turns(torch, lambda: torch.bmm(xt, dy),
                                   lambda: _gmm.moe_gmm_dw(x, dy), 5, flush)
        dx_lib, dx_new = in_turns(torch, lambda: torch.bmm(dy, wt),
                                  lambda: _gmm.moe_gmm_dx(w, dy), 5, flush)
        dx_old, dx_new2 = in_turns(torch, lambda: _gmm.moe_gmm_dx_previous(w, dy),
                                   lambda: _gmm.moe_gmm_dx(w, dy), 5, flush)
        if not torch.equal(_gmm._transpose(w), wt.contiguous()):
            raise AssertionError(f"moe_gmm_bwd {label}: the transpose kernel's copy of w")
        copy_x = launch_times_ms(torch, lambda: _gmm._transpose(x), 5, flush)
        print(f"  moe_gmm_bwd {label} {(E, C, D, F)} bfloat16, routes {routes}: max |diff| "
              f"{errs}, previous dx, dw {err_prev:.3g}; in turns: pair {spread(new)} beside the "
              f"previous pair {spread(old)}; pair {spread(new_lib)} beside bmm for dx and dw "
              f"{spread(lib)}")
        print(f"    apart, in turns: dw {spread(dw_new)} beside the previous dw "
              f"{spread(dw_old)}; dw {spread(dw_new2)} beside bmm {spread(dw_lib)}; dx "
              f"{spread(dx_new2)} beside the previous dx {spread(dx_old)}; dx {spread(dx_new)} "
              f"beside bmm {spread(dx_lib)}; the transpose kernel's copy of x alone "
              f"{spread(copy_x)}")
        bwd_times[("moe_gmm_bwd", label)] = dict(
            err=max(float((g.float() - e.float()).abs().max()) for g, e in zip(got, exp.values())),
            ms=statistics.fmean(new + new_lib), previous_ms=statistics.fmean(old),
            plain_ms=time_ms(torch, lambda: ref.moe_gmm_bwd_ref(x, w, dy), 3, flush),
            library_ms=statistics.fmean(lib),
            bytes=sum(t.numel() * t.element_size() for t in (x, w, dy, *got)),
            ops=f"{4 * E * C * D * F} FLOP (two products)",
            ops_ms=1e3 * 4 * E * C * D * F / PEAK_BF16_FLOPS,
            replaces="src/repro/kernels/moe_gmm.py:52",
            source="src/repro_torch/csrc/moe_gmm.cu",
            note="the backward of moe_gmm on its own design, two-block clusters sharing B by "
                 "TMA multicast, tiles stored by TMA: dx reading w transposed (wgmma_nt), dw "
                 "reading x transposed where it lies (wgmma_tn); previous_ms: dx on the "
                 "forward's wgmma design reading w transposed, dw on it over an (E, D, C) copy "
                 "of x; the JAX package "
                 "differentiates its einsum experts (src/repro/models/moe.py:60-62); "
                 "launches: phase 11d's training")
        report(f"moe_gmm_bwd {label}", bwd_times[("moe_gmm_bwd", label)])
        del x, w, dy, got, exp, wt, xt

    # The scans' backward: the route's design (ring at every shape of the
    # models), its other spacing and the previous design over the sweep in
    # both dtypes; at phase 11d's shapes each step of the new design timed
    # in turns with the previous design (one ablation line a step), beside
    # the forward kernel, in fp32 (what the models feed the scans), then the
    # route against the previous design in bf16.
    scan_bwd = {
        "mamba_scan_bwd": dict(
            fn=_mamba.mamba_scan_bwd, plain=ref.mamba_scan_bwd_ref,
            make=mamba_case, sweep=MAMBA_BWD_SWEEP, main=MAMBA_MAIN["prefill"],
            route=lambda dt_, case: _mamba.bwd_route(dt_, case[3], case[2]),
            previous=("ckpt", _mamba.mamba_scan_bwd_ckpt),
            other=("ring, chunks of 16", lambda *a: _mamba.mamba_scan_bwd_ring(*a, chunk=16)),
            steps=(("ckpt, the previous design", _mamba.mamba_scan_bwd_ckpt),
                   ("ring alone: TMA ring, chunks of 16, one block an SM, a_t taken again",
                    lambda *a: _mamba.mamba_scan_bwd_ring(*a, chunk=16, reuse=False)),
                   ("+ a_t kept from the recompute",
                    lambda *a: _mamba.mamba_scan_bwd_ring(*a, chunk=16)),
                   ("+ chunks of 8, two blocks an SM, without a_t kept",
                    lambda *a: _mamba.mamba_scan_bwd_ring(*a, chunk=8, reuse=False)),
                   ("+ chunks of 8 with a_t kept: the route", _mamba.mamba_scan_bwd)),
            names=("ddt", "ddtx", "dB", "dC", "dA", "dh0"), summed=("dB", "dC", "dA"),
            replaces="src/repro/kernels/mamba_scan.py:64"),
        "rwkv6_scan_bwd": dict(
            fn=_rwkv.rwkv6_scan_bwd, plain=ref.rwkv6_scan_bwd_ref,
            make=rwkv_case, sweep=RWKV_SWEEP, main=RWKV_MAIN["prefill"],
            route=lambda dt_, case: _rwkv.bwd_route(dt_, case[3]),
            previous=("rows", _rwkv.rwkv6_scan_bwd_rows),
            other=("ring, checkpoints every 4", lambda *a: _rwkv.rwkv6_scan_bwd_ring(*a, chunk=4)),
            steps=(("rows, the previous design", _rwkv.rwkv6_scan_bwd_rows),
                   ("ring alone (TMA ring, 8 lanes a row, dr in the walk back), checkpoints "
                    "every 4 steps, one level", lambda *a: _rwkv.rwkv6_scan_bwd_ring(*a, chunk=4)),
                   ("+ checkpoints every 16 steps, two-level recompute: the route",
                    _rwkv.rwkv6_scan_bwd)),
            names=("dr", "dk", "dv", "dw", "du", "dS0"), summed=("du",),
            replaces="src/repro/kernels/rwkv6_scan.py:58"),
    }

    def bwd_args(kd, case, dt_, with_state):
        args = kd["make"](*case[:4], dt_, with_state)
        out_shape = args[0].shape
        last = args[5].shape if with_state else None
        return (*args, randn(*out_shape, dtype=dt_),
                None if last is None else randn(*last, dtype=torch.float32))

    def time_steps(fns, args, iters):
        """Launch times of each design of ``fns`` (label -> fn), in turns:
        in order, then in reverse, ``iters`` launches a turn."""
        ts = {label: [] for label, _ in fns}
        for label, fn in list(fns) + list(reversed(fns)):
            ts[label] += launch_times_ms(torch, lambda: fn(*args), iters, flush)
        return ts

    for name, kd in scan_bwd.items():
        prev_label, prev_fn = kd["previous"]
        other_label, other_fn = kd["other"]
        for case in kd["sweep"]:
            for dname, dt_ in dtypes.items():
                args = bwd_args(kd, case, dt_, case[4])
                exp = dict(zip(kd["names"], kd["plain"](*args)))
                design = kd["route"](dt_, case)
                runs = [(design, kd["fn"]), (prev_label, prev_fn)]
                if design == "ring":
                    runs.append((other_label, other_fn))
                for label, fn in runs:
                    got = fn(*args)
                    torch.cuda.synchronize()
                    errs = check_grads(f"{name}{case} {dname} {label}", got, exp, dname,
                                       SCAN_TOL["float32"], kd["summed"])
                    print(f"  {name} {case} {dname}, {label}{' (the route)' if label == design else ''}: "
                          f"max |diff| {errs}")
        shape = kd["main"]
        if kd["route"](torch.float32, shape) != "ring" or kd["route"](torch.bfloat16, shape) != "ring":
            raise AssertionError(f"{name}: 11d's shape {shape} does not route to ring")
        args = bwd_args(kd, shape, torch.float32, False)
        plain = kd["plain"](*args)
        exp = dict(zip(kd["names"], plain))
        got = kd["fn"](*args)
        errs = check_grads(f"{name} {shape}", got, exp, "float32", SCAN_TOL["float32"],
                           kd["summed"])
        for label, fn in kd["steps"]:
            check_grads(f"{name} {shape} {label}", fn(*args), exp, "float32", SCAN_TOL["float32"],
                        kd["summed"])
        fwd = kd["make"](*shape, torch.float32, False)
        fwd_ts = launch_times_ms(torch, lambda: (ops.mamba_scan if name == "mamba_scan_bwd"
                                                 else ops.rwkv6_scan)(*fwd), 10, flush)
        step_ts = time_steps(kd["steps"], args, 10)
        route_label = next(label for label, fn in kd["steps"] if fn is kd["fn"])
        ts, old = step_ts[route_label], step_ts[kd["steps"][0][0]]
        print(f"  {name} {shape} float32, ring design: {spread(ts)}, max |diff| {errs}; "
              f"{prev_label} in turns {spread(old)}; the forward kernel on the same inputs "
              f"{spread(fwd_ts)}")
        for label, _ in kd["steps"]:
            print(f"  ablation {name} {shape} float32: {label}: {spread(step_ts[label])}")
        B, S = shape[:2]
        if name == "mamba_scan_bwd":
            n_exp = B * S * shape[2] * shape[3]
            ops_desc, ops_ms = f"{n_exp} exponentials", 1e3 * n_exp / exp_rate
        else:
            # per (i, j) and step: the state and its cotangent updated (a MUL
            # and an FMA each) and an FMA each for dr, dk, dv and dw
            H, hd = shape[2:]
            flop = 10 * B * S * H * hd * hd
            ops_desc, ops_ms = f"{flop} fp32 FLOP", 1e3 * flop / fp32_flops
        bwd_times[(name, "train")] = dict(
            err=max(float((g.float() - e.float()).abs().max()) for g, e in zip(got, plain)),
            ms=statistics.fmean(ts), previous_ms=statistics.fmean(old),
            plain_ms=time_ms(torch, lambda: kd["plain"](*args), 2, flush),
            library_ms=None,        # no PyTorch call computes either backward
            bytes=sum(t.numel() * t.element_size() for t in (*args, *got) if t is not None),
            ops=ops_desc, ops_ms=ops_ms, replaces=kd["replaces"],
            source=f"src/repro_torch/csrc/{name[:-4]}.cu",
            note=f"the backward of {name[:-4]} (ring design; previous_ms: the {prev_label} "
                 f"design, in turns); the JAX package differentiates its chunked "
                 f"linear_scan_emit; launches: phase 11d's training")
        report(f"{name} {shape}", bwd_times[(name, "train")])
        del args, got, exp, plain, fwd
        # bf16 at the same shape: the route against the plain version and
        # timed in turns with the previous design
        args = bwd_args(kd, shape, torch.bfloat16, False)
        exp = dict(zip(kd["names"], kd["plain"](*args)))
        errs = check_grads(f"{name} {shape} bfloat16", kd["fn"](*args), exp, "bfloat16",
                           SCAN_TOL["float32"], kd["summed"])
        old, ts = in_turns(torch, lambda: prev_fn(*args), lambda: kd["fn"](*args), 10, flush)
        print(f"  {name} {shape} bfloat16, ring design: {spread(ts)}, max |diff| {errs}; "
              f"{prev_label} in turns {spread(old)}")
        del args, exp
    records["moe_gmm_bwd"] = bwd_times[("moe_gmm_bwd", "mixtral gate/up")]
    records["mamba_scan_bwd"] = bwd_times[("mamba_scan_bwd", "train")]
    records["rwkv6_scan_bwd"] = bwd_times[("rwkv6_scan_bwd", "train")]

    # the AdamW kernel (no TPU kernel: XLA fuses the JAX package's
    # apply_updates in its jitted step) at the leaves of full-width qwen3-1.7b
    # (11b's) and of mixtral-8x7b at 2 layers (11d's), bf16 with fp32
    # moments.  On qwen3's leaves, against its plain version at the rate
    # ADAMW_CHECK_LR: p within one bf16 ulp, m and v at fp32's limit on their
    # own scale, the norm at rtol 1e-5, the norm of a second call equal bit
    # for bit; then the same leaves in fp32, where each element's change is
    # held at fp32's limit against the plain version's change, so that the
    # decay (of the matrices only), the rate and the bias corrections, all
    # under one bf16 ulp of a weight, are seen.  Then timed in turns with the
    # plain version, and a copy of the same 22 bytes a parameter beside it.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  before the AdamW rows: {torch.cuda.memory_allocated()} bytes allocated")
    step_t = torch.tensor(2, dtype=torch.int32, device=dev)
    check_lr = torch.tensor(ADAMW_CHECK_LR, device=dev)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)

    def adamw_operands(cfg, seed, dtype=None):
        """Leaves of ``cfg`` (in ``dtype`` if given), gradients of their
        dtype, fp32 moments: the magnitudes of a step early in training."""
        gen_a = torch.Generator(device=dev).manual_seed(seed)
        leaves = [p if dtype is None else p.to(dtype)
                  for p in tree_leaves(T.init_params(cfg, gen_a))]
        grads = [torch.randn(p.shape, generator=gen_a, device=dev).mul_(1e-2).to(p.dtype)
                 for p in leaves]
        mu = [torch.randn(p.shape, generator=gen_a, device=dev).mul_(1e-3) for p in leaves]
        nu = [torch.rand(p.shape, generator=gen_a, device=dev).mul_(1e-5) for p in leaves]
        return leaves, grads, mu, nu

    def adamw_check(label, leaves, grads, mu, nu):
        """The kernel's call and the plain version's on copies, at the rate
        ADAMW_CHECK_LR.  Returns (kernel's norm, plain norm, the plain
        version's (p, m, v))."""
        expect = [[t.clone() for t in xs] for xs in (leaves, mu, nu)]
        want = ref.adamw_update_ref(expect[0], grads, expect[1], expect[2], step_t, check_lr,
                                    **hyper)
        before = ops.LAUNCHES["adamw"]
        got = ops.adamw_update(leaves, grads, mu, nu, step_t, check_lr, **hyper)
        if ops.LAUNCHES["adamw"] - before != 3:
            raise AssertionError(f"{label}: {ops.LAUNCHES['adamw'] - before} launches")
        if not math.isclose(float(got), float(want), rel_tol=1e-5):
            raise AssertionError(f"{label}: grad norm {float(got)!r}, plain {float(want)!r}")
        for what, xs, ys in (("m", mu, expect[1]), ("v", nu, expect[2])):
            worst = max(check_scaled(f"{label} {what}", a, b, ADAMW_RTOL)
                        for a, b in zip(xs, ys))
            print(f"  {label}: {what} within {worst:.3g} of |plain| + rms (limit {ADAMW_RTOL})")
        return got, want, expect

    for arch, n_layers in (("qwen3-1.7b", None), ("mixtral-8x7b", 2)):
        cfg = get_arch(arch)
        cfg = dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg
        leaves, grads, mu, nu = adamw_operands(cfg, SEED + 20)
        lr_t = torch.tensor(3e-4, device=dev)
        n = sum(p.numel() for p in leaves)
        label = f"adamw {arch} ({len(leaves)} leaves, {n} parameters)"
        err = None
        if n_layers is None:
            got, want, expect = adamw_check(label, leaves, grads, mu, nu)
            counts = [check_bf16_ulp(f"{label} p", a, b, ADAMW_RTOL * ADAMW_CHECK_LR)
                      for a, b in zip(leaves, expect[0])]
            one, past = (sum(c[k] for c in counts) for k in (0, 1))
            err = max(float((a.float() - b.float()).abs().max())
                      for xs, ys in zip((leaves, mu, nu), expect) for a, b in zip(xs, ys))
            again = ops.adamw_update(leaves, grads, mu, nu, step_t, check_lr, **hyper)
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two calls' norms {float(got)!r}, "
                                     f"{float(again)!r}")
            print(f"  {label}: p within one bf16 ulp + {ADAMW_RTOL * ADAMW_CHECK_LR:.3g} of the "
                  f"plain version ({one} of {n} elements one ulp apart, {past} past one ulp "
                  f"near zero, the rest equal); grad norm {float(got)!r}, plain "
                  f"{float(want)!r}; a second call gives {float(again)!r}, bit for bit the "
                  f"same")
            del expect, want, got, again
            torch.cuda.empty_cache()
        old, ts = in_turns(torch, lambda: ref.adamw_update_ref(leaves, grads, mu, nu, step_t,
                                                               lr_t, **hyper),
                           lambda: ops.adamw_update(leaves, grads, mu, nu, step_t, lr_t,
                                                    **hyper), 3, flush)
        print(f"  {label}: kernel {spread(ts)}; plain version in turns {spread(old)}")
        moved = sum(2 * p.numel() * p.element_size() + g.numel() * g.element_size()
                    + 4 * m.numel() * m.element_size() for p, g, m in zip(leaves, grads, mu))
        normed = sum(g.numel() * g.element_size() for g in grads)
        flop = 20 * n          # an element's update and square, in fp32
        rec = dict(err=err if err is not None else float("nan"), ms=statistics.fmean(ts),
                   plain_ms=statistics.fmean(old), library_ms=None,
                   bytes=moved + normed, ops=f"{flop} fp32 FLOP", ops_ms=1e3 * flop / fp32_flops,
                   replaces="none: XLA's fusion of src/repro/train/optimizer.py:52-74 in "
                            "src/repro/train/train_loop.py:42's jax.jit",
                   source="src/repro_torch/csrc/adamw.cu")
        del leaves, grads, mu, nu
        gc.collect()
        torch.cuda.empty_cache()
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy = launch_times_ms(torch, lambda: dst.copy_(src), 5, flush)
        rec["copy_ms"] = statistics.fmean(copy)
        print(f"  {label}: a PyTorch copy of the update's {moved} bytes (read and written once, "
              f"no kernel of the port): {spread(copy)}")
        del src, dst
        torch.cuda.empty_cache()
        rec["note"] = (f"{label}; no PyTorch call computes this update (torch's fused AdamW "
                       f"decays otherwise, keeps bf16 moments and does not clip): copy_ms is a "
                       f"copy of the update's bytes; launches: phase 11b's 4 steps")
        report(label, rec)
        if n_layers is None:
            records["adamw"] = rec
            label32 = f"adamw {arch} in fp32 ({n} parameters)"
            leaves, grads, mu, nu = adamw_operands(cfg, SEED + 21, torch.float32)
            start = [p.clone() for p in leaves]
            _, _, expect = adamw_check(label32, leaves, grads, mu, nu)
            worst = max(check_scaled(f"{label32} change of p", a - o, b - o, ADAMW_RTOL)
                        for a, b, o in zip(leaves, expect[0], start))
            # the check's reach: the decay's share of the change on the
            # largest matrix, in the same measure
            big = max(range(len(start)), key=lambda i: start[i].numel())
            change = expect[0][big] - start[big]
            share = float((ADAMW_CHECK_LR * hyper["weight_decay"] * start[big].abs()).mean()
                          / (change.abs() + change.square().mean().sqrt()).mean())
            if not share > 10 * ADAMW_RTOL:
                raise AssertionError(f"{label32}: the decay's share {share:.3g} of a change is "
                                     f"not above 10 x the limit {ADAMW_RTOL}")
            print(f"  {label32}: each element's change within {worst:.3g} of |plain change| "
                  f"+ rms (limit {ADAMW_RTOL}); the decay is {share:.3g} of a change on "
                  f"the largest matrix {tuple(start[big].shape)}")
            del leaves, grads, mu, nu, start, expect, change
            gc.collect()
            torch.cuda.empty_cache()

    # -- 4 ------------------------------------------------------------------
    phase("4 reduced qwen3-1.7b, card against CPU, float32")
    rng = np.random.default_rng(SEED)
    for kv_heads in (None, 2):
        cfg = reduced(get_arch("qwen3-1.7b"))
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  **({} if kv_heads is None else {"n_kv_heads": kv_heads}))
        p_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED))
        p_gpu = tree_to(p_cpu, dev)
        prompts = rng.integers(0, cfg.vocab_size, (4, 24)).tolist()
        toks = torch.tensor(prompts)
        logits = {}
        for where, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            lg, c = T.prefill(p, cfg, {"tokens": toks.to(where)}, seq_len=40)
            lg2, _ = T.decode_step(p, cfg, lg.argmax(-1), 24, c)
            logits[where] = (lg.cpu(), lg2.cpu())
        for i, step in enumerate(("prefill", "decode")):
            e = check_close(f"{cfg.name} kv={cfg.n_kv_heads} {step} logits",
                            logits["cuda"][i], logits["cpu"][i], (1e-4, 1e-4))
            print(f"  kv_heads {cfg.n_kv_heads}: {step} logits max |diff| {e:.3g}")
        outs = [ServingEngine(cfg, batch_slots=4, max_seq_len=40, device=where,
                              params=p).generate(prompts, max_new_tokens=8)
                for where, p in (("cpu", p_cpu), ("cuda", p_gpu))]
        if outs[0] != outs[1]:
            raise AssertionError(f"greedy tokens differ: cpu {outs[0]} cuda {outs[1]}")
        print(f"  kv_heads {cfg.n_kv_heads}: greedy tokens equal ({outs[1][0]} ...)")

    # -- 4b-4d ---------------------------------------------------------------
    def card_against_cpu(cfg, seed, expect):
        """Prefill a MOE_PROMPT-token prompt at batch MOE_BATCH and take one
        decode step, on the CPU and on the card with the same weights; then
        greedy generation through both engines.  ``expect`` is the card
        run's kernel launches by name."""
        p_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED))
        p_gpu = tree_to(p_cpu, dev)
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)).tolist()
        toks = torch.tensor(prompts)
        logits = {}
        for where, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            ops.reset_launches()
            lg, c = T.prefill(p, cfg, {"tokens": toks.to(where)}, seq_len=MOE_SEQ)
            lg2, _ = T.decode_step(p, cfg, lg.argmax(-1), MOE_PROMPT, c)
            logits[where] = (lg.cpu(), lg2.cpu())
        got = {name: n for name, n in ops.LAUNCHES.items() if n}
        if got != expect:
            raise AssertionError(f"card run: launches {got}, expected {expect}")
        for i, step in enumerate(("prefill", "decode")):
            e = check_close(f"{cfg.name} {step} logits", logits["cuda"][i], logits["cpu"][i],
                            (1e-4, 1e-4))
            print(f"  {step} logits max |diff| {e:.3g}")
        outs = [ServingEngine(cfg, batch_slots=MOE_BATCH, max_seq_len=MOE_SEQ, device=where,
                              params=p).generate(prompts, max_new_tokens=8)
                for where, p in (("cpu", p_cpu), ("cuda", p_gpu))]
        if outs[0] != outs[1]:
            raise AssertionError(f"greedy tokens differ: cpu {outs[0]} cuda {outs[1]}")
        print(f"  launches {got} in the card's prefill and decode step; "
              f"greedy tokens equal ({outs[1][0]} ...)")

    def decode_capacity(cfg):
        E, k = cfg.moe.num_experts, cfg.moe.top_k
        return (f"{E} experts, top {k}: decode capacity "
                f"{max(1, int(cfg.moe.capacity_factor * k * MOE_BATCH / E))} per expert "
                f"for {k * MOE_BATCH} pairs")

    phase("4b reduced mixtral-8x7b, card against CPU, float32")
    cfg = dataclasses.replace(reduced(get_arch("mixtral-8x7b")), dtype="float32")
    cap = attention.kv_cache_capacity(cfg, MOE_SEQ)
    if not cap < MOE_PROMPT:
        raise AssertionError(f"the {cap}-slot cache does not wrap under a {MOE_PROMPT}-token prompt")
    print(f"  {decode_capacity(cfg)}; window {cfg.sliding_window}: a {cap}-slot ring under "
          f"a {MOE_PROMPT}-token prompt")
    L = cfg.n_layers
    card_against_cpu(cfg, SEED + 1, {"flash_attention": L, "decode_attention": L,
                                     "moe_gmm": 2 * 3 * L})

    phase("4c reduced jamba-v0.1-52b (8 layers, one whole group), card against CPU, float32")
    cfg = dataclasses.replace(reduced(get_arch("jamba-v0.1-52b"), n_layers=8), dtype="float32")
    n = layer_counts(cfg)
    print(f"  kinds {[k.value for k in cfg.block_kinds()]}; {decode_capacity(cfg)}")
    card_against_cpu(cfg, SEED + 3, {"flash_attention": n["attn"], "decode_attention": n["attn"],
                                     "mamba_scan": 2 * n["mamba"], "moe_gmm": 2 * 3 * n["moe"]})

    phase("4d reduced rwkv6-1.6b, card against CPU, float32")
    cfg = dataclasses.replace(reduced(get_arch("rwkv6-1.6b")), dtype="float32")
    card_against_cpu(cfg, SEED + 4, {"rwkv6_scan": 2 * layer_counts(cfg)["rwkv"]})

    phase("4e reduced h2o-danube-3-4b with heads 120 wide, card against CPU, float32")
    cfg = dataclasses.replace(reduced(get_arch("h2o-danube-3-4b")), dtype="float32",
                              head_dim=120, n_kv_heads=2)
    cap = attention.kv_cache_capacity(cfg, MOE_SEQ)
    print(f"  head_dim {cfg.resolved_head_dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads; window "
          f"{cfg.sliding_window}: a {cap}-slot ring under a {MOE_PROMPT}-token prompt")
    card_against_cpu(cfg, SEED + 7, {"flash_attention": cfg.n_layers,
                                     "decode_attention": cfg.n_layers})

    # -- 4f, 4g --------------------------------------------------------------
    def generate_direct(params, cfg, batch, seq_len, new_tokens):
        """Greedy generation through ``T.prefill`` and a ``T.decode_step``
        loop: (the logits of every step on the host, the tokens (B, new))."""
        with torch.inference_mode():
            lg, caches = T.prefill(params, cfg, batch, seq_len=seq_len)
            pos = prompt_len(batch)
            steps, toks = [lg.float().cpu()], [lg.argmax(-1)]
            for i in range(new_tokens - 1):
                lg, caches = T.decode_step(params, cfg, toks[-1], pos + i, caches)
                steps.append(lg.float().cpu())
                toks.append(lg.argmax(-1))
        return steps, torch.cat(toks, 1).cpu()

    def generate_against_cpu(cfg, batch, expect, expect_flash=None):
        """Greedy generation of 8 tokens from ``batch`` (numpy arrays) on the
        CPU and on the card with the same weights: every step's logits
        within atol/rtol 1e-4 and the same tokens; ``expect`` is the card
        run's kernel launches by name, ``expect_flash`` (or None) its flash
        launches by route."""
        p_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED))
        runs = {}
        for where, p in (("cpu", p_cpu), ("cuda", tree_to(p_cpu, dev))):
            ops.reset_launches()
            runs[where] = generate_direct(p, cfg, {k: torch.from_numpy(a).to(where)
                                                   for k, a in batch.items()}, 64, 9)
        got = {name: n for name, n in ops.LAUNCHES.items() if n}
        if got != expect:
            raise AssertionError(f"card run: launches {got}, expected {expect}")
        flash_routes = dict(ops.ROUTE_LAUNCHES["flash_attention"])
        if expect_flash is not None and flash_routes != expect_flash:
            raise AssertionError(f"card run: flash launches by route {flash_routes}, expected "
                                 f"{expect_flash}")
        errs = [check_close(f"{cfg.name} step {i} logits", lc, lp, (1e-4, 1e-4))
                for i, (lc, lp) in enumerate(zip(runs["cuda"][0], runs["cpu"][0]))]
        if not torch.equal(runs["cuda"][1], runs["cpu"][1]):
            raise AssertionError(f"greedy tokens differ: cpu {runs['cpu'][1].tolist()} "
                                 f"cuda {runs['cuda'][1].tolist()}")
        print(f"  launches {got} in the card's prefill and 8 decode steps, flash by route "
              f"{flash_routes}; logits max |diff| "
              f"{max(errs):.3g} over the 9 steps; greedy tokens equal "
              f"({runs['cuda'][1][0].tolist()} ...)")

    phase("4f reduced seamless-m4t-large-v2, card against CPU, float32")
    cfg = dataclasses.replace(reduced(get_arch("seamless-m4t-large-v2")), dtype="float32")
    enc_rng = np.random.default_rng(SEED + 9)
    L, E = cfg.n_layers, cfg.encdec.encoder_layers
    print(f"  {E} encoder and {L} decoder layers, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}: a {ENCDEC_PROMPT}-token decoder prompt over "
          f"{ENCDEC_FRAMES} encoder frames, batch {MOE_BATCH}, no mask")
    encdec_batch = {
        "tokens": enc_rng.integers(0, cfg.vocab_size, (MOE_BATCH, ENCDEC_PROMPT)),
        "enc_embeds": enc_rng.standard_normal((MOE_BATCH, ENCDEC_FRAMES, cfg.d_model),
                                              np.float32)}
    generate_against_cpu(cfg, encdec_batch,
                         {"flash_attention": E + 2 * L, "decode_attention": 2 * L * 8},
                         {"wgmma": 0, "simt": E + 2 * L, "masked": 0, "wgmma_masked": 0})
    lengths = ENCDEC_MASK_LENGTHS
    print(f"  again under a ragged enc_mask, valid lengths {lengths}: the cross prefill on the "
          f"simt masked route (fp32), the decode steps' cross-attention under the decode "
          f"kernel's mask")
    encdec_batch["enc_mask"] = np.arange(ENCDEC_FRAMES)[None] < np.array(lengths)[:, None]
    generate_against_cpu(cfg, encdec_batch,
                         {"flash_attention": E + 2 * L, "decode_attention": 2 * L * 8},
                         {"wgmma": 0, "simt": E + L, "masked": L, "wgmma_masked": 0})

    phase("4g reduced pixtral-12b, a prompt of image-patch embeddings, card against CPU, float32")
    cfg = dataclasses.replace(reduced(get_arch("pixtral-12b")), dtype="float32", n_kv_heads=1)
    print(f"  {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim} (pixtral's G = 4): "
          f"{ENCDEC_PROMPT} patch embeddings of width {cfg.frontend.embed_dim}, batch "
          f"{MOE_BATCH}")
    generate_against_cpu(cfg, {"embeds": enc_rng.standard_normal(
        (MOE_BATCH, ENCDEC_PROMPT, cfg.frontend.embed_dim), np.float32)},
        {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers * 8})

    # -- 4h ------------------------------------------------------------------
    def assigned_reduced(arch):
        """The reduced float32 variant of ``arch`` that keeps its grouping."""
        return dataclasses.replace(reduced_grouped(get_arch(arch)), dtype="float32")

    phase("4h reduced phi4-mini-3.8b (G 3), phi3.5-moe-42b-a6.6b (G 4, top 2) and deepseek-67b "
          "(G 8), card against CPU, float32")
    for i, arch in enumerate(ASSIGNED_LAYERS):
        cfg = assigned_reduced(arch)
        n = layer_counts(cfg)
        print(f"{cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.resolved_head_dim}" + (f"; {decode_capacity(cfg)}" if cfg.moe else ""))
        expect = {"flash_attention": n["attn"], "decode_attention": n["attn"]}
        if n["moe"]:
            expect["moe_gmm"] = 2 * 3 * n["moe"]
        card_against_cpu(cfg, SEED + 15 + i, expect)

    # -- 5 ------------------------------------------------------------------
    def check_routes(name, expect_routes):
        """The launches of the run just made, by op and by route; raises
        unless each route in ``expect_routes`` ({op: {route: n}}) holds its
        count and every other route none."""
        launches = dict(ops.LAUNCHES)
        routes = {op: dict(c) for op, c in ops.ROUTE_LAUNCHES.items()}
        want = {op: {r: 0 for r in c} for op, c in ops.ROUTE_LAUNCHES.items()}
        for op, by_route in expect_routes.items():
            for r, n in by_route.items():
                want[op][r] += n
        print(f"launches by route {routes}")
        if routes != want:
            raise AssertionError(f"{name}: launches by route {routes}, expected {want}")
        return launches, routes

    def print_run(label, times_s, first_tokens):
        """A measured run's prefill, mean decode step, rate and peak memory."""
        step_us = 1e6 * statistics.fmean(times_s[1:])
        print(f"serve ({label}) prefill_ms {1e3 * times_s[0]:.3f}  mean_decode_step_us "
              f"{step_us:.1f}  generated_tok_per_s {SLOTS * NEW_TOKENS / sum(times_s):.1f}  "
              f"max_memory_allocated_bytes {torch.cuda.max_memory_allocated()}")
        print(f"  first request's tokens: {first_tokens[:8]} ...")
        return step_us

    def engine_routes(cfg, n_decode, seq_len=MAX_SEQ):
        """The launches by route of one prefill and ``n_decode`` decode
        steps of the engine: the prefill's attention takes the route of the
        model's dtype; each expert matmul that of its capacity, the rows per
        expert of a prefill (all prompts' tokens) or a decode step (one per
        slot); the scans take fp32 from the models, one launch a layer and
        step."""
        n, dtype = layer_counts(cfg), getattr(torch, cfg.dtype)
        want = {"flash_attention": {_flash.route(dtype): n["attn"]}}
        if n["attn"]:
            G, cap = cfg.n_heads // cfg.n_kv_heads, attention.kv_cache_capacity(cfg, seq_len)
            want["decode_attention"] = {_decode.route(dtype, G, cap): n["attn"] * n_decode}
        if n["moe"]:
            E, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
            want["moe_gmm"] = collections.Counter()
            for tokens, steps in ((SLOTS * PROMPT_LEN, 1), (SLOTS, n_decode)):
                C = max(1, int(cf * k * tokens / E))
                for D, F in ((cfg.d_model, cfg.d_ff), (cfg.d_model, cfg.d_ff),
                             (cfg.d_ff, cfg.d_model)):
                    want["moe_gmm"][_gmm.route(dtype, C, D, F)] += n["moe"] * steps
        if n["mamba"]:
            want["mamba_scan"] = {_mamba.route(torch.float32, cfg.mamba.d_state):
                                  n["mamba"] * (n_decode + 1)}
        if n["rwkv"]:
            want["rwkv6_scan"] = {_rwkv.route(torch.float32, cfg.rwkv.head_size):
                                  n["rwkv"] * (n_decode + 1)}
        return want

    def graph_against_eager(eng, batch):
        """Greedy ``NEW_TOKENS`` tokens of ``batch`` through the engine's
        graph replays and through an eager loop (the previous designs: the
        prefill and the step op by op, a Python ``pos``) on the same engine:
        equal tokens, and every step's logits (the prefill's too) finite and
        within the bf16 limit.  Returns the largest |diff|."""
        runs = {}
        for mode in ("graph", "eager"):
            set_modes(eng, mode)
            lg = eng.prefill(batch)
            steps, toks = [lg.clone()], [lg.argmax(-1)]
            for i in range(NEW_TOKENS - 1):
                lg = eng.decode_step(toks[-1], prompt_len(batch) + i)
                steps.append(lg.clone())
                toks.append(lg.argmax(-1))
            runs[mode] = steps, torch.cat(toks, 1)
        set_modes(eng, "graph")
        if not torch.equal(runs["graph"][1], runs["eager"][1]):
            raise AssertionError(f"{eng.cfg.name}: the replays' greedy tokens differ from the "
                                 "eager loop's")
        return max(check_close(f"{eng.cfg.name} step {i} logits, replay against eager", g, e,
                               TOL["bfloat16"])
                   for i, (g, e) in enumerate(zip(runs["graph"][0], runs["eager"][0])))

    def within_tol(name, what, graph_us, eager_us):
        """Raise unless the replay's device time is within
        ``GRAPH_DEVICE_TOL`` of the eager design's."""
        if graph_us is None or eager_us is None or \
                abs(graph_us / eager_us - 1) > GRAPH_DEVICE_TOL:
            raise AssertionError(f"{name}: the {what} replay's device time {graph_us} us is "
                                 f"not within {GRAPH_DEVICE_TOL} of the eager one's "
                                 f"{eager_us} us")

    graph_rows = []              # phases 5-5j, eager against replay: the table after 5j

    def serve(cfg, prompts, inputs=None, seq_len=MAX_SEQ, expect_routes=None, enc_mask=None,
              between=None):
        """Serve ``prompts`` (and ``inputs``, the batch's other entries)
        through a fresh engine of ``cfg`` on the card: a warm-up, which
        captures the prefill and the decode step; then ``NEW_TOKENS``
        tokens three times in turns, replaying the graphs and with the eager
        steps (graph, eager, graph), the launch counters reset before each
        run: the first run's launches held by route to ``expect_routes`` (by
        default ``engine_routes``'), each other run's equal to the first's,
        every run's tokens equal; given ``between`` (prompts of another
        length), the prompts, ``between`` and the prompts again through the
        engine, replayed and eager, every run's tokens equal the eager
        run's; ``graph_against_eager``; the profiled steps and prefills of
        both designs; each replay's device time within ``GRAPH_DEVICE_TOL``
        of the eager design's.  Given ``enc_mask``, then the prefill under it
        through the engine, captured, then replayed and eager in turns,
        timed, its flash launches by route kept.  Returns {"step_us": the
        replays' mean decode step (the endpoint's ``work_us``), "launches",
        "routes", "masked_routes"}."""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServingEngine(cfg, batch_slots=SLOTS, max_seq_len=seq_len, seed=SEED,
                            device="cuda")
        torch.cuda.synchronize()
        groups = eng.params["blocks"]
        print(f"{cfg.name}: {cfg.n_layers} layers"
              + (f", {cfg.encdec.encoder_layers} encoder layers" if cfg.encdec else "")
              + f", d_model {cfg.d_model}, {cfg.dtype}; "
              f"weights drawn in {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated()} bytes on the card; weights {tree_bytes(eng.params)} "
              f"bytes, {tree_bytes(groups) // groups[0]['ln1'].shape[0]} per "
              f"{len(groups)}-layer group")
        eng.generate(prompts, max_new_tokens=2, inputs=inputs)   # warm-up, and the captures
        n_decode = NEW_TOKENS - 1
        if expect_routes is None:
            expect_routes = engine_routes(cfg, n_decode, seq_len)
        expect = {op: sum(expect_routes.get(op, {}).values()) for op in ops.LAUNCHES}
        runs = {"graph": [], "eager": []}
        for turn, mode in enumerate(("graph", "eager", "graph")):
            set_modes(eng, mode)
            eng.step_times_s.clear()
            ops.reset_launches()
            outs = eng.generate(prompts, max_new_tokens=NEW_TOKENS, inputs=inputs)
            if turn == 0:
                launches, routes = check_routes(cfg.name, expect_routes)
                print(f"launches {launches} over 1 prefill and {n_decode} decode steps "
                      f"(graph replays)")
                if launches != expect:
                    raise AssertionError(f"launch counts {launches}, expected {expect}")
                counts = ops.launch_counts()
            elif ops.launch_counts() != counts:
                raise AssertionError(f"{cfg.name}: the {mode} run's launches "
                                     f"{ops.launch_counts()} differ from the first replay run's")
            if len(eng.step_times_s) != NEW_TOKENS:
                raise AssertionError(f"{cfg.name}: {len(eng.step_times_s)} steps timed")
            runs[mode].append((list(eng.step_times_s), outs))
        set_modes(eng, "graph")
        if (len(eng.prefill_graphs), len(eng.decode_graphs), len(eng.capture_s)) != (1, 1, 2):
            raise AssertionError(f"{cfg.name}: {len(eng.prefill_graphs)} prefill and "
                                 f"{len(eng.decode_graphs)} decode graphs, expected one each")
        first = runs["graph"][0][1]
        if any(outs != first for by_mode in runs.values() for _, outs in by_mode):
            raise AssertionError(f"{cfg.name}: the runs served different tokens")
        if [len(o) for o in first] != [NEW_TOKENS] * SLOTS or \
                not all(0 <= t < cfg.vocab_size for o in first for t in o):
            raise AssertionError("generated tokens out of shape or range")
        work = {mode: statistics.fmean(print_run(mode, times, outs[0]) for times, outs in by_mode)
                for mode, by_mode in runs.items()}
        served_ms = {mode: statistics.fmean(1e3 * times[0] for times, _ in by_mode)
                     for mode, by_mode in runs.items()}
        batch = dict(inputs or {})
        if "embeds" not in batch:
            batch["tokens"] = torch.tensor(prompts, device=dev)
        (prefill_graph,), (decode_graph,) = eng.prefill_graphs.values(), eng.decode_graphs.values()
        if between is not None:
            served = {}
            for mode in ("graph", "eager"):
                set_modes(eng, mode)
                served[mode] = [eng.generate(p, max_new_tokens=NEW_TOKENS, inputs=inputs)
                                for p in (prompts, between, prompts)]
            set_modes(eng, "graph")
            if served["graph"] != served["eager"] or served["graph"][0] != first or \
                    served["graph"][2] != first:
                raise AssertionError(f"{cfg.name}: prompts of {len(prompts[0])}, "
                                     f"{len(between[0])} and {len(prompts[0])} tokens in turn "
                                     "served other tokens replayed than eager")
            if (len(eng.prefill_graphs), len(eng.decode_graphs)) != (2, 1):
                raise AssertionError(f"{cfg.name}: {len(eng.prefill_graphs)} prefill and "
                                     f"{len(eng.decode_graphs)} decode graphs, expected 2 and 1")
            print(f"  prompts of {len(prompts[0])}, {len(between[0])} and {len(prompts[0])} "
                  f"tokens in turn through one engine: the replays' tokens equal the eager "
                  f"runs' ({len(between[0])}-token prompts' first tokens "
                  f"{served['graph'][1][0][:8]} ...); prefill graphs "
                  f"{sorted(k[:3] for k in eng.prefill_graphs)}, capture_s of the second "
                  f"{eng.capture_s[-1]:.3f}")
        err = graph_against_eager(eng, batch)
        print(f"  {NEW_TOKENS} greedy tokens of the replays equal an eager loop's; every step's "
              f"logits, the prefill's too, within atol/rtol {TOL['bfloat16']}: max |diff| "
              f"{err:.3g}")
        prefill_times = prefill_in_turns(torch, eng, batch)
        prefill_ms = {mode: statistics.fmean(ts) for mode, ts in prefill_times.items()}
        print(f"  prefill_ms in turns (graph, eager, eager, graph; {TIMED_PREFILLS} a turn): "
              + "; ".join(f"{mode} {spread(ts)}" for mode, ts in prefill_times.items()))
        prof = print_profiles(torch, eng, batch)
        profiles[cfg.name] = {"decode": prof["graph"][0], "prefill": prof["prefill graph"][0]}
        (d_graph, w_graph, k_graph), (d_eager, w_eager, _) = prof["graph"], prof["eager"]
        (pd_graph, pw_graph, pk_graph), (pd_eager, pw_eager, _) = (prof["prefill graph"],
                                                                   prof["prefill eager"])
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        print(f"{cfg.name}: decode step eager / replay: device_us {d_eager} / {d_graph}, wall_us "
              f"{w_eager:.1f} / {w_graph:.1f}, work_us {work['eager']:.1f} / "
              f"{work['graph']:.1f}; capture_s {decode_graph.capture_s:.3f}")
        print(f"{cfg.name}: prefill eager / replay: prefill_ms {prefill_ms['eager']:.3f} / "
              f"{prefill_ms['graph']:.3f} in turns ({served_ms['eager']:.3f} / "
              f"{served_ms['graph']:.3f} in the served runs), device_us {pd_eager} / {pd_graph}, wall_us "
              f"{pw_eager:.1f} / {pw_graph:.1f}; capture_s {prefill_graph.capture_s:.3f}; "
              f"peak {peak} bytes allocated, the graphs' pool included ({reserved} reserved)")
        within_tol(cfg.name, "decode step", d_graph, d_eager)
        within_tol(cfg.name, "prefill", pd_graph, pd_eager)
        graph_rows.append((cfg.name, d_eager, d_graph, w_eager, w_graph, work["eager"],
                           work["graph"], decode_graph.capture_s, peak, k_graph,
                           prefill_ms["eager"], prefill_ms["graph"], pd_eager, pd_graph,
                           pw_eager, pw_graph, prefill_graph.capture_s, pk_graph))
        masked_routes = None
        if enc_mask is not None:
            masked_batch = {**batch, "enc_mask": enc_mask}
            eng.prefill(masked_batch)                                # the capture
            masked_ms, logits = {}, {}
            for mode in ("graph", "eager", "eager", "graph"):
                eng.prefill_mode = mode
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                lg = eng.prefill(masked_batch)
                torch.cuda.synchronize()
                masked_ms.setdefault(mode, []).append(1e3 * (time.perf_counter() - t0))
                logits[mode] = lg.clone()
                routes_now = dict(ops.ROUTE_LAUNCHES["flash_attention"])
                if masked_routes not in (None, routes_now):
                    raise AssertionError(f"{cfg.name}: the masked prefill's flash launches "
                                         f"{routes_now} differ between designs")
                masked_routes = routes_now
            eng.prefill_mode = "graph"
            if not bool(logits["graph"].float().isfinite().all()):
                raise AssertionError(f"{cfg.name}: masked prefill logits are not finite")
            err = check_close(f"{cfg.name} masked prefill logits, replay against eager",
                              logits["graph"], logits["eager"], TOL["bfloat16"])
            print(f"masked prefill (enc_mask valid lengths {enc_mask.sum(1).tolist()}), a "
                  f"third graph: prefill_ms eager / replay "
                  f"{statistics.fmean(masked_ms['eager']):.3f} / "
                  f"{statistics.fmean(masked_ms['graph']):.3f} (two each, in turns); logits "
                  f"max |diff| {err:.3g}; capture_s {eng.capture_s[-1]:.3f}; flash launches "
                  f"by route {masked_routes}")
        return {"step_us": work["graph"], "launches": launches, "routes": routes,
                "masked_routes": masked_routes}

    def serving_routes(flash, split, stream=0, wgmma=0, lanes=0):
        """Every op's launches by route in a bf16 serving run: the prefill
        attention on flash ``wgmma``, the decode on ``split``, the experts
        on ``stream`` (decode) and ``wgmma`` (prefill), Mamba on ``lanes``,
        no other route and no backward."""
        return {"flash_attention": {"wgmma": flash, "simt": 0, "masked": 0, "wgmma_masked": 0},
                "decode_attention": {"split": split, "simt": 0},
                "aes_ctr": {"ttable": 0, "simt": 0},
                "moe_gmm": {"stream": stream, "wgmma": wgmma, "mma_sync": 0},
                "mamba_scan": {"lanes": lanes, "simt": 0}, "rwkv6_scan": {"cols": 0, "simt": 0},
                "flash_attention_bwd": NO_FLASH_BWD_ROUTES, **NO_BWD_ROUTES}

    phase("5 full-width qwen3-1.7b served on the card")
    profiles = {}                # device times of phase 5's profiled steps, for phase 12b
    cfg = get_arch("qwen3-1.7b")
    prompts = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT_LEN)).tolist()
    served = serve(cfg, prompts, between=np.random.default_rng(SEED + 30).integers(
        0, cfg.vocab_size, (SLOTS, PROMPT_LEN // 2)).tolist())
    launches = served["launches"]
    if served["routes"] != serving_routes(28, 868):
        raise AssertionError(f"qwen3's launches by route {served['routes']}")
    endpoints = {cfg.name: served["step_us"]}

    # -- 5b -----------------------------------------------------------------
    phase(f"5b full-width mixtral-8x7b, {MOE_LAYERS} of 32 layers, served on the card")
    gc.collect()
    torch.cuda.empty_cache()         # phase 5's engine is gone: room for 70 GB
    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), n_layers=MOE_LAYERS)
    prompts = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (SLOTS, PROMPT_LEN)).tolist()
    served = serve(cfg, prompts)
    endpoints[cfg.name], routes = served["step_us"], served["routes"]
    launches["moe_gmm"] = served["launches"]["moe_gmm"]
    if routes != serving_routes(24, 744, stream=2232, wgmma=72):
        raise AssertionError(f"mixtral's launches by route {routes}")
    launches["moe_gmm_prefill"] = routes["moe_gmm"]["wgmma"]

    # -- 5c -----------------------------------------------------------------
    phase(f"5c full-width jamba-v0.1-52b, {JAMBA_LAYERS} of 32 layers, served on the card")
    free_card(torch, "phase 5c")     # phase 5b's engine is gone: room for 77.6 GB
    free, total = torch.cuda.mem_get_info()
    print(f"  before the draw: {free} of {total} bytes free on the card")
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS)
    prompts = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (SLOTS, PROMPT_LEN)).tolist()
    served = serve(cfg, prompts)
    endpoints[cfg.name], routes = served["step_us"], served["routes"]
    if routes != serving_routes(3, 93, stream=1116, wgmma=36, lanes=672):
        raise AssertionError(f"Jamba's launches by route {routes}")
    launches["mamba_scan"] = served["launches"]["mamba_scan"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5d -----------------------------------------------------------------
    phase("5d full-width rwkv6-1.6b served on the card")
    cfg = get_arch("rwkv6-1.6b")
    prompts = np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (SLOTS, PROMPT_LEN)).tolist()
    served = serve(cfg, prompts)
    endpoints[cfg.name], routes = served["step_us"], served["routes"]
    if routes["rwkv6_scan"] != {"cols": 768, "simt": 0}:
        raise AssertionError(f"RWKV6's wkv launches by route {routes['rwkv6_scan']}")
    launches["rwkv6_scan"] = served["launches"]["rwkv6_scan"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5e -----------------------------------------------------------------
    phase("5e full-width, full-depth h2o-danube-3-4b (heads 120 wide) served on the card")
    cfg = get_arch("h2o-danube-3-4b")
    print(f"  head_dim {cfg.resolved_head_dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads, window "
          f"{cfg.sliding_window}")
    prompts = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (SLOTS, PROMPT_LEN)).tolist()
    served = serve(cfg, prompts)
    h2o_launches = served["launches"]
    if served["routes"] != serving_routes(24, 744):
        raise AssertionError(f"h2o-danube-3-4b's launches by route {served['routes']}")
    h2o_note = (f"h2o-danube-3-4b (head_dim 120), phase 5e: {h2o_launches['flash_attention']} "
                f"prefill and {h2o_launches['decode_attention']} decode launches")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5f, 5g --------------------------------------------------------------
    phase("5f full-width, full-depth seamless-m4t-large-v2 (encoder-decoder) on the card")
    cfg = get_arch("seamless-m4t-large-v2")
    L, E = cfg.n_layers, cfg.encdec.encoder_layers
    n_decode = NEW_TOKENS - 1
    frames = stub_frontend_embeddings(cfg, torch.Generator(device=dev).manual_seed(SEED + 10),
                                      SLOTS)
    prompts = np.random.default_rng(SEED + 10).integers(
        0, cfg.vocab_size, (SLOTS, PROMPT_LEN)).tolist()
    print(f"  {SLOTS} requests: {frames.shape[1]} stub frames of width {frames.shape[2]} "
          f"({frames.dtype}), a {PROMPT_LEN}-token decoder prompt, {NEW_TOKENS} new tokens, "
          f"a {MAX_SEQ}-slot cache, through the engine; then one prefill under a ragged "
          f"enc_mask")
    n_frames = frames.shape[1]
    enc_mask = torch.arange(n_frames, device=dev)[None] < torch.tensor(
        [n_frames - 97 * b for b in range(SLOTS)], device=dev)[:, None]
    served = serve(cfg, prompts, inputs={"enc_embeds": frames}, expect_routes={   # 72, 1488
        "flash_attention": {"wgmma": E + 2 * L}, "decode_attention": {"split": 2 * L * n_decode}},
        enc_mask=enc_mask)
    seamless_launches, masked_routes = served["launches"], served["masked_routes"]
    if masked_routes != {"wgmma": E + L, "simt": 0, "masked": 0, "wgmma_masked": L}:
        raise AssertionError(f"seamless's masked prefill: flash launches by route "
                             f"{masked_routes}, expected wgmma {E + L} and wgmma_masked {L}")
    launches["flash_attention_masked"] = masked_routes["wgmma_masked"]
    del frames, enc_mask
    gc.collect()
    torch.cuda.empty_cache()

    phase("5g full-width, full-depth pixtral-12b, a prompt of image-patch embeddings, on the card")
    free_card(torch, "phase 5g")
    cfg = get_arch("pixtral-12b")
    patches = stub_frontend_embeddings(cfg, torch.Generator(device=dev).manual_seed(SEED + 11),
                                       SLOTS)
    print(f"  {SLOTS} prompts of {patches.shape[1]} stub patch embeddings of width "
          f"{patches.shape[2]} ({patches.dtype}), {NEW_TOKENS} new tokens, a {PIXTRAL_SEQ}-slot "
          f"cache, through the engine")
    served = serve(cfg, [[0] * patches.shape[1]] * SLOTS, inputs={"embeds": patches},
                   seq_len=PIXTRAL_SEQ, expect_routes={
                       "flash_attention": {"wgmma": cfg.n_layers},
                       "decode_attention": {"split": cfg.n_layers * n_decode}})   # 40 and 1240
    pixtral_launches = served["launches"]
    encdec_note = (f"seamless-m4t-large-v2, phase 5f: {seamless_launches['flash_attention']} "
                   f"prefill and {seamless_launches['decode_attention']} decode launches; "
                   f"pixtral-12b, phase 5g: {pixtral_launches['flash_attention']} prefill and "
                   f"{pixtral_launches['decode_attention']} decode launches")
    del patches
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5h-5j ---------------------------------------------------------------
    assigned = {}      # the decode steps of 5h-5j (us), deployed in phase 7
    for i, (arch, n_layers) in enumerate(ASSIGNED_LAYERS.items()):
        full = get_arch(arch)
        phase(f"5{'hij'[i]} full-width {arch}, {n_layers} of {full.n_layers} layers "
              f"(G {full.n_heads // full.n_kv_heads}), served on the card")
        free_card(torch, f"phase 5{'hij'[i]}")
        cfg = dataclasses.replace(full, n_layers=n_layers)
        prompts = np.random.default_rng(SEED + 20 + i).integers(
            0, cfg.vocab_size, (SLOTS, PROMPT_LEN)).tolist()
        served = serve(cfg, prompts)
        assigned[cfg.name], routes = served["step_us"], served["routes"]
        moe = {}
        if cfg.moe is not None:   # decode: C = 1 on stream; prefill: C = 640 on wgmma
            moe = dict(stream=3 * n_layers * n_decode, wgmma=3 * n_layers)
        want = serving_routes(n_layers, n_layers * n_decode, **moe)
        if routes != want:
            raise AssertionError(f"{arch}'s launches by route {routes}, expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"\ndecode step, eager / graph replay (phases 5-5j; device and wall us a step over "
          f"{PROFILED_STEPS} profiled steps each; work_us the engine's mean decode "
          f"step over {NEW_TOKENS} tokens, two runs of the replay, one eager; capture_s the "
          f"warm-up step and the capture):")
    for name, de, dg, we, wg, ke, kg, cap_s, peak, kernels, *_ in graph_rows:
        print(f"  {name}: device_us {de:.1f} / {dg:.1f} ({dg / de:.4f}); wall_us {we:.1f} / "
              f"{wg:.1f}; idle {1 - de / we:.3f} / {1 - dg / wg:.3f}; work_us {ke:.1f} / "
              f"{kg:.1f} ({ke / kg:.2f} x); capture_s {cap_s:.3f}; peak {peak} bytes; "
              f"{kernels:.1f} kernels a replay, work_us over device_us "
              f"{(kg - dg) / kernels:.3f} us a kernel")
    print(f"\nprefill, eager / graph replay (phases 5-5j; prefill_ms on the host clock, "
          f"{2 * TIMED_PREFILLS} prefills of each design in turns; device and wall us a "
          f"prefill over "
          f"{PROFILED_PREFILLS} profiled prefills each; capture_s the warm-up prefill and the "
          f"capture):")
    for name, *_, pe, pg, de, dg, we, wg, cap_s, kernels in graph_rows:
        print(f"  {name}: prefill_ms {pe:.3f} / {pg:.3f} ({pe / pg:.2f} x); device_us "
              f"{de:.1f} / {dg:.1f} ({dg / de:.4f}); wall_us {we:.1f} / {wg:.1f}; idle "
              f"{1 - de / we:.3f} / {1 - dg / wg:.3f}; capture_s {cap_s:.3f}; {kernels:.1f} "
              f"kernels a replay")

    # -- 6 ------------------------------------------------------------------
    phase("6 AES-128-CTR kernel against its plain version, bit-exact")
    key_hex, pt_hex, ct_hex = FIPS197_C1

    def hex_bytes(h, device):
        return torch.tensor(list(bytes.fromhex(h)), dtype=torch.int32, device=device)

    fips_key, fips_pt = hex_bytes(key_hex, dev), hex_bytes(pt_hex, dev)
    got = bytes(ref.aes_encrypt_block_ref(fips_pt, ref.aes_key_expand(fips_key)).tolist()).hex()
    if got != ct_hex:
        raise AssertionError(f"FIPS-197 C.1: plain AES gives {got}, expected {ct_hex}")
    print(f"  FIPS-197 C.1 through the plain block cipher: {got}")
    keys = {"fips": fips_key,
            "random": torch.tensor(rng.integers(0, 256, 16), dtype=torch.int32, device=dev)}
    # ttable, the design route gives every N, through the routed entry point;
    # simt, the previous one, through its own
    designs = {"ttable": _aes.aes_ctr, "simt": _aes.aes_ctr_simt}
    for n in (1, AES_FN_BLOCKS, AES_BATCH_BLOCKS):
        if _aes.route(n) != "ttable":
            raise AssertionError(f"aes_ctr: {n} blocks route to {_aes.route(n)}")
    print(f"  ttable: {_aes.TTABLE_BLOCKS} blocks a thread, {_aes.TTABLE_THREADS} threads a "
          f"CTA, at most {_aes.TTABLE_CTAS_PER_SM} CTAs an SM")
    calls_before, calls = ops.LAUNCHES["aes_ctr"], 0
    routes_before = dict(_aes.LAUNCHES)

    def rand_int32(n):
        return torch.randint(-2**31, 2**31, (n, 16), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    # the counter-mode output of the op and of each design against the plain
    # keystream of the C.1 key
    pt = fips_pt.repeat(AES_FN_BLOCKS, 1)
    fips_rk = ref.aes_key_expand(fips_key)
    fips_ks = ref.aes_ctr_keystream(AES_FN_BLOCKS, fips_rk)
    ct = ops.aes_ctr(pt, fips_key, nonce=0)
    calls += 1
    if not torch.equal(ct ^ pt, fips_ks):
        raise AssertionError("aes_ctr: ct ^ pt is not the plain keystream under the C.1 key")
    for design, fn in designs.items():
        if not torch.equal(fn(pt, fips_rk) ^ pt, fips_ks):
            raise AssertionError(f"aes_ctr {design}: ct ^ pt is not the plain keystream under "
                                 f"the C.1 key")
    print("  FIPS-197 C.1 key: the op and both designs give the plain keystream")
    aes_err = 0
    for kname, key in keys.items():
        rk = ref.aes_key_expand(key)
        for n in AES_SWEEP_N:
            for nonce in AES_NONCES:
                pt = rand_int32(n)
                plain = ref.aes_ctr_ref(pt, key, nonce)
                outs = {"op": ops.aes_ctr(pt, key, nonce=nonce)}
                calls += 1
                for design, fn in designs.items():
                    outs[design] = fn(pt, rk, nonce=nonce)
                torch.cuda.synchronize()
                for what, out in outs.items():
                    err = int((out.long() - plain.long()).abs().max())
                    if not torch.equal(out, plain):
                        raise AssertionError(f"aes_ctr ({what}) key {kname} N {n} nonce {nonce}: "
                                             f"max |diff| {err}, expected bit-exact")
                    aes_err = max(aes_err, err)
        print(f"  key {kname}: N {AES_SWEEP_N} x nonces {AES_NONCES}, the op and both designs "
              f"bit-exact")
    pt = rand_int32(AES_FN_BLOCKS)
    back = ops.aes_ctr(ops.aes_ctr(pt, keys["random"], nonce=5), keys["random"], nonce=5)
    calls += 2
    if not torch.equal(back, pt):
        raise AssertionError("aes_ctr: the round trip does not decrypt")
    if ops.aes_ctr(rand_int32(0), keys["random"]).shape != (0, 16):
        raise AssertionError("aes_ctr: N = 0 does not give an empty (0, 16) result")
    if ops.LAUNCHES["aes_ctr"] - calls_before != calls:
        raise AssertionError(f"aes_ctr launches {ops.LAUNCHES['aes_ctr'] - calls_before}, "
                             f"expected {calls}")
    by_route = {r: _aes.LAUNCHES[r] - routes_before[r] for r in _aes.LAUNCHES}
    print(f"  round trip decrypts; N = 0 launches nothing; {calls} launches of the op counted; "
          f"launches by route, the op's and each design's own: {by_route}")

    rk = ref.aes_key_expand(keys["random"])
    sms = props.multi_processor_count
    aes_times = {}
    for n in (1, AES_FN_BLOCKS, AES_BATCH_BLOCKS):
        pt = rand_int32(n)
        # both designs in turns, simt (previous), ttable, ttable, simt.  A few
        # blocks make a few-microsecond kernel: as for the scans' decode
        # steps, the record is the median of 200, since a host stall that
        # outlasts the flush and the hold adds its length to one sample
        small = n <= AES_FN_BLOCKS
        old, new = in_turns(torch, lambda: _aes.aes_ctr_simt(pt, rk, nonce=7),
                            lambda: _aes.aes_ctr(pt, rk, nonce=7),
                            100 if small else 25, flush)
        pick = statistics.median if small else statistics.fmean
        verdict = "no slower than" if pick(new) <= pick(old) else "SLOWER than"
        print(f"  aes_ctr N={n}: ttable {spread(new)}; simt (previous) {spread(old)}: ttable "
              f"{verdict} simt; route({n}) = {_aes.route(n)}")
        if n == 1:
            continue
        aes_times[n] = dict(
            err=aes_err,
            ms=pick(new), previous_ms=pick(old),
            plain_ms=time_ms(torch, lambda: pt ^ ref.aes_ctr_keystream(n, rk, 7), 10, flush),
            library_ms=None,            # no PyTorch call computes AES
            bytes=2 * pt.numel() * pt.element_size() + rk.numel() * rk.element_size(),
            ops=f"{AES_LOOKUPS_PER_BLOCK * n} S-box lookups",
            ops_ms=1e3 * AES_LOOKUPS_PER_BLOCK * n / (SMEM_LOOKUPS_PER_CLOCK * sms * sm_clock_hz),
            replaces="src/repro/kernels/aes_ctr.py:76",
            source="src/repro_torch/csrc/aes_ctr.cu")
        report(f"aes_ctr N={n}", aes_times[n])
        r = aes_times[n]
        print(f"  aes_ctr N={n}: ttable at {100 * r['bound_ms'] / r['ms']:.1f} % of its bound, "
              f"simt at {100 * r['bound_ms'] / r['previous_ms']:.1f} %")
    big = rand_int32(AES_BATCH_BLOCKS)
    copy_out = torch.empty_like(big)
    copy = launch_times_ms(torch, lambda: copy_out.copy_(big), 50, flush)
    print(f"  a PyTorch copy of the same {2 * big.numel() * 4} bytes (read and written once, no "
          f"kernel of the port): {spread(copy)}")
    del big, copy_out
    records["aes_ctr"] = aes_times[AES_FN_BLOCKS]

    # -- 7 ------------------------------------------------------------------
    phase("7 FaaS path: the AES function, the four model endpoints and 5h-5j's decode steps "
          "deployed on containerd and junctiond (simulated)")
    payload = torch.tensor(rng.integers(0, 256, (AES_FN_BLOCKS, 16)), dtype=torch.int32)
    fn_key = keys["random"].cpu()
    expect_reply = ref.aes_ctr_ref(payload, fn_key, 0)
    # the deploy: the key expanded once, its round keys placed on the card
    aes_fn = AesFunction(fn_key, device=dev)

    def per_call_body():
        """The previous body: the key expanded and copied to the card on every call."""
        out = ops.aes_ctr(payload.to(dev), fn_key, nonce=0).cpu()
        torch.cuda.synchronize()
        return out

    def host_us(fn, calls=BODY_CALLS):
        """Host times of ``calls`` calls of ``fn`` and a synchronise, in us."""
        ts = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e6 * (time.perf_counter() - t0))
        return ts

    if not (torch.equal(per_call_body(), expect_reply)
            and torch.equal(aes_fn(payload), expect_reply)):
        raise AssertionError("the AES function's reply differs from the plain version on the CPU")
    # both bodies in turns, per-call expansion, deployed, deployed, per-call
    old_body, new_body = [], []
    for fn, into in ((per_call_body, old_body), (lambda: aes_fn(payload), new_body),
                     (lambda: aes_fn(payload), new_body), (per_call_body, old_body)):
        into += host_us(fn, BODY_CALLS // 2)
    aes_us = float(np.median(new_body))
    print(f"AES function body on {props.name}, in turns, {len(new_body)} calls each: deployed "
          f"(round keys on the card since the deploy; 600 B to the card, kernel, back, "
          f"synchronised) median {aes_us:.1f} us, mean {statistics.fmean(new_body):.1f}; "
          f"per-call expansion (previous) median {float(np.median(old_body)):.1f} us, mean "
          f"{statistics.fmean(old_body):.1f}")
    ct_dev = expect_reply.to(dev)
    print(f"  parts of the body, each alone (medians): key schedule to the card "
          f"{float(np.median(host_us(lambda: ref.aes_key_expand(fn_key).to(dev)))):.1f} us "
          f"(previous body only), payload to the card "
          f"{float(np.median(host_us(lambda: payload.to(dev)))):.1f} us, reply to the host "
          f"{float(np.median(host_us(lambda: ct_dev.cpu()))):.1f} us; kernel alone "
          f"(phase 6, CUDA events, {_aes.route(AES_FN_BLOCKS)}) "
          f"{1e3 * records['aes_ctr']['ms']:.1f} us")

    # the main path: the deployed body's calls, then the five functions
    # deployed on both backends, AES with the deployed body's median
    ops.reset_launches()
    replies = [aes_fn(payload) for _ in range(BODY_CALLS)]
    if not all(torch.equal(r, expect_reply) for r in replies):
        raise AssertionError("a reply of the deployed AES body differs from the plain version")
    functions = {"aes": (FunctionSpec(name="aes", work_us=aes_us), AES_REQUESTS)}
    # the four endpoints of benchmarks/model_endpoints.py, then 5h-5j's decode
    # steps, as launch/serve.py --arch deploys any architecture
    for name, us in {**endpoints, **assigned}.items():
        functions[name] = (FunctionSpec(name=name, work_us=us, payload_bytes=2048,
                                        response_bytes=4096), MODEL_REQUESTS)
    for fname, (spec, n_req) in functions.items():
        medians = {}
        for backend in ("containerd", "junctiond"):
            rt = FaasdRuntime(Simulator(seed=1), backend=backend)
            rt.deploy_blocking(spec)
            s = run_sequential(rt, fname, n=n_req)
            if s.n != n_req:
                raise AssertionError(f"{fname} on {backend}: {s.n} latencies for {n_req} requests")
            medians[backend] = s
            print(f"  {fname} (work_us {spec.work_us:.1f} measured) on {backend:10s}: "
                  f"simulated median_ms {s.median_ms:.4f}  p99_ms {s.p99_ms:.4f}  n {s.n}")
        c, j = medians["containerd"], medians["junctiond"]
        if not j.median_ms < c.median_ms:
            raise AssertionError(f"{fname}: junctiond median {j.median_ms} is not below "
                                 f"containerd's {c.median_ms}")
        print(f"  {fname}: junctiond cuts the simulated median by "
              f"{100 * (1 - j.median_ms / c.median_ms):.2f} % and the p99 by "
              f"{100 * (1 - j.p99_ms / c.p99_ms):.2f} %")
    faas_launches = dict(ops.LAUNCHES)
    faas_routes = dict(ops.ROUTE_LAUNCHES["aes_ctr"])
    print(f"launches {faas_launches} on the FaaS path; aes_ctr by route {faas_routes}")
    if faas_launches != {"flash_attention": 0, "decode_attention": 0, "aes_ctr": BODY_CALLS,
                         "moe_gmm": 0, "mamba_scan": 0, "rwkv6_scan": 0,
                         "flash_attention_bwd": 0, **{op: 0 for op in NO_BWD_ROUTES}}:
        raise AssertionError(f"FaaS path launches {faas_launches}, expected "
                             f"{BODY_CALLS} of aes_ctr only")
    expect_routes = {"ttable": 0, "simt": 0}
    expect_routes[_aes.route(AES_FN_BLOCKS)] = BODY_CALLS
    if faas_routes != expect_routes:
        raise AssertionError(f"the AES body's launches by route {faas_routes}, expected "
                             f"{expect_routes}")
    launches["aes_ctr"] = faas_launches["aes_ctr"]

    # -- 8 ------------------------------------------------------------------
    phase("8 open-loop load (Fig 6) on the bodies the card measured (simulated)")

    def print_curve(label, res):
        print(f"  {label}: sustainable_rps {res['sustainable_rps']}")
        for row in res["curve"]:
            print(f"    rate {row['offered_rps']:9.1f}  achieved_rps {row['achieved_rps']:10.2f}  "
                  f"median_ms {row['median_ms']:10.4f}  p99_ms {row['p99_ms']:10.4f}  "
                  f"rejected {row['rejected']}")

    def knee_search(backend, spec, slo_ms, rate0):
        """``KneeSearch`` with a ``drive`` probe: a fresh runtime of 10
        cores per probe, Poisson arrivals, bracketing probes at half the
        duration."""
        def probe(rate, phase_name):
            rt = FaasdRuntime(Simulator(seed=SEED), backend=backend, n_cores=10)
            rt.deploy_blocking(spec)
            return drive(rt, LoadSpec.single(spec.name, rate, warmup_s=0.3,
                                             duration_s=1.0 if phase_name == "bracket" else 2.0))
        return KneeSearch(probe, slo_p99_ms=slo_ms, rate0=rate0).run()

    t0 = time.perf_counter()
    aes_spec = FunctionSpec(name="aes", work_us=aes_us)
    knees = {}
    print(f"AES, work_us {aes_us:.1f} (phase 7's deployed body on {props.name}), 10 cores, the "
          f"default grid of 250 to 24000 rps, p99 SLO {FIG6_SLO_MS} ms:")
    for backend in ("containerd", "junctiond"):
        res = sustainable_throughput(backend, aes_spec, slo_p99_ms=FIG6_SLO_MS)
        print_curve(backend, res)
        knees[backend] = res["sustainable_rps"]
        if backend == "junctiond":
            again = sustainable_throughput(backend, aes_spec, slo_p99_ms=FIG6_SLO_MS)
            if json.dumps(again, default=str) != json.dumps(res, default=str):
                raise AssertionError("junctiond's AES sweep differs between two runs of one seed")
            print("  junctiond's sweep run twice: the same curve, row for row")
        search = knee_search(backend, aes_spec, FIG6_SLO_MS, 2000.0)
        print(f"  {backend}: KneeSearch knee_rps {search.knee_rps:.1f} in {search.n_probes} "
              f"probes (bracket {search.lo_rps:.1f} .. {search.hi_rps:.1f}, converged "
              f"{search.converged})")
    if not knees["junctiond"] > knees["containerd"]:
        raise AssertionError(f"AES: junctiond's knee {knees['junctiond']} rps is not above "
                             f"containerd's {knees['containerd']} rps")
    print(f"AES knees: containerd {knees['containerd']} rps, junctiond {knees['junctiond']} rps, "
          f"ratio {knees['junctiond'] / knees['containerd']:.2f} (the paper: about 10)")
    for name, us in endpoints.items():
        n_cores, work_s = 10, us * 1e-6
        rates = [round(f / 10 * n_cores / work_s, 3) for f in range(1, 11)]
        spec = FunctionSpec(name=name, work_us=us, payload_bytes=2048, response_bytes=4096)
        ep = {b: sustainable_throughput(b, spec, slo_p99_ms=2e-3 * us, rates=rates,
                                        n_cores=n_cores) for b in ("containerd", "junctiond")}
        print(f"{name}, work_us {us:.1f} (phases 5-5d), rates {rates[0]} .. {rates[-1]} rps, "
              f"p99 SLO {2e-3 * us:.3f} ms:")
        for b, res in ep.items():
            print_curve(b, res)
        c, j = ep["containerd"]["sustainable_rps"], ep["junctiond"]["sustainable_rps"]
        print(f"{name} knees: containerd {c} rps, junctiond {j} rps, ratio "
              f"{j / c if c else float('nan'):.3f}")
    if dict(ops.LAUNCHES) != faas_launches or \
            dict(ops.ROUTE_LAUNCHES["aes_ctr"]) != faas_routes:
        raise AssertionError(f"phase 8 launched kernels: {dict(ops.LAUNCHES)} against phase 7's "
                             f"{faas_launches}")
    print(f"launches {dict(ops.LAUNCHES)}: none past phase 7's {BODY_CALLS} AES calls; "
          f"phase 8 took {time.perf_counter() - t0:.1f} s of host time")

    # -- 9 ------------------------------------------------------------------
    phase("9 the six backends, the autoscaler and the sanitizer on the bodies the card "
          "measured (simulated)")
    t0 = time.perf_counter()
    control_plane(aes_us, endpoints)
    if dict(ops.LAUNCHES) != faas_launches or \
            dict(ops.ROUTE_LAUNCHES["aes_ctr"]) != faas_routes:
        raise AssertionError(f"phase 9 launched kernels: {dict(ops.LAUNCHES)} against phase 7's "
                             f"{faas_launches}")
    print(f"launches {dict(ops.LAUNCHES)}: none past phase 7's {BODY_CALLS} AES calls; "
          f"phase 9 took {time.perf_counter() - t0:.1f} s of host time")

    # -- 10 -----------------------------------------------------------------
    phase("10 the experiments runner and the fleet on the bodies the card measured "
          "(simulated)")
    t0 = time.perf_counter()
    fleet_and_experiments(aes_us, endpoints)
    if dict(ops.LAUNCHES) != faas_launches or \
            dict(ops.ROUTE_LAUNCHES["aes_ctr"]) != faas_routes:
        raise AssertionError(f"phase 10 launched kernels: {dict(ops.LAUNCHES)} against "
                             f"phase 7's {faas_launches}")
    print(f"launches {dict(ops.LAUNCHES)}: none past phase 7's {BODY_CALLS} AES calls; "
          f"phase 10 took {time.perf_counter() - t0:.1f} s of host time")

    # -- 11 -----------------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import InputShape, StepKind
    from repro_torch.models import flops
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM, make_train_step
    from repro_torch.train.optimizer import AdamWState, init_state
    from repro_torch.train.step_graph import TrainGraph

    def train_routes(cfg, steps, tokens, masked=False):
        """The launches by route of ``steps`` train steps of ``tokens`` tokens
        under remat: each layer's forward kernels twice (the recompute), its
        backward kernels once; AdamW's kernels a sum of squares and an update
        a table of leaves and one norm, a step.  Attention: the flash forward on the route of
        the dtype, its backward on the pair of ``bwd_route`` (fp32:
        ``bwd_dq``/``bwd_dkv``, bf16: ``bwd_dq_wgmma``/``bwd_dkv_wgmma``); an
        encoder-decoder model's encoder (not recomputed) once forward and once
        backward a layer, its cross-attention as its self-attention, on the
        masked route and pair when ``masked`` (an ``enc_mask`` in the batch);
        MoE: the three expert matmuls at the capacity of ``moe_capacity`` on
        ``route``, their dx and dw on ``bwd_route``; the scans (fp32 in every
        model) on their designs."""
        n = layer_counts(cfg)
        dt = getattr(torch, cfg.dtype)
        expect = {}
        if n["attn"]:
            fwd, bwd = collections.Counter(), collections.Counter()

            def attend(key_mask, forwards, backwards):
                fwd[_flash.route(dt, key_mask)] += forwards * steps
                for kernel in _flash.BWD_PAIRS[_flash.bwd_route(dt, key_mask)]:
                    bwd[kernel] += backwards * steps

            attend(False, 2 * n["attn"], n["attn"])
            if cfg.encdec is not None:
                attend(False, cfg.encdec.encoder_layers, cfg.encdec.encoder_layers)
                attend(masked, 2 * n["attn"], n["attn"])
            expect["flash_attention"], expect["flash_attention_bwd"] = dict(fwd), dict(bwd)
        if n["moe"]:
            E, k = cfg.moe.num_experts, cfg.moe.top_k
            C = max(1, int(cfg.moe.capacity_factor * k * tokens / E))
            fwd, bwd = collections.Counter(), collections.Counter()
            for D, F in ((cfg.d_model, cfg.d_ff),) * 2 + ((cfg.d_ff, cfg.d_model),):
                fwd[_gmm.route(dt, C, D, F)] += 2 * n["moe"] * steps
                r_dx, r_dw = _gmm.bwd_route(dt, C, D, F)
                bwd["dx_" + r_dx] += n["moe"] * steps
                bwd["dw_" + r_dw] += n["moe"] * steps
            expect["moe_gmm"], expect["moe_gmm_bwd"] = dict(fwd), dict(bwd)
        if n["mamba"]:
            ds = cfg.mamba.d_state
            expect["mamba_scan"] = {_mamba.route(torch.float32, ds): 2 * n["mamba"] * steps}
            di = cfg.mamba.d_inner(cfg.d_model)
            expect["mamba_scan_bwd"] = {_mamba.bwd_route(torch.float32, ds, di): n["mamba"] * steps}
        if n["rwkv"]:
            hd = cfg.rwkv.head_size
            expect["rwkv6_scan"] = {_rwkv.route(torch.float32, hd): 2 * n["rwkv"] * steps}
            expect["rwkv6_scan_bwd"] = {_rwkv.bwd_route(torch.float32, hd): n["rwkv"] * steps}
        tables = len(_adamw.split_tables([math.prod(s) for s in flops._param_shapes(cfg)]))
        expect["adamw"] = {"sumsq": tables * steps, "norm": steps, "update": tables * steps}
        return expect

    def check_train_launches(name, cfg, steps, tokens, masked=False):
        """The launches of the run just made, by route and by op, exactly those
        of :func:`train_routes` (a backward of flash or of the MoE matmul is
        two launches by route, one by op)."""
        expect = train_routes(cfg, steps, tokens, masked)
        check_routes(name, expect)
        want = {op: sum(r.values()) // (2 if op in ("flash_attention_bwd", "moe_gmm_bwd") else 1)
                for op, r in expect.items()}
        got = {op: n for op, n in ops.LAUNCHES.items() if n}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")

    plain_names = ("flash_attention_ref", "flash_attention_bwd_ref", "moe_gmm_ref",
                   "moe_gmm_bwd_ref", "mamba_scan_ref", "mamba_scan_bwd_ref", "rwkv6_scan_ref",
                   "rwkv6_scan_bwd_ref")
    plain_kernels = {n: getattr(ref, n) for n in plain_names}

    def refuse_plain(*args, **kwargs):
        raise AssertionError("the card's train step reached a plain kernel")

    def train_card_against_cpu(cfg, seq, steps, resync=False, inputs=None):
        """``steps`` remat train steps of ``cfg`` from the same weights and
        SyntheticLM batches of 4 x ``seq`` tokens on the CPU and on the card
        (``inputs`` maps each numpy batch to the model's: stub frames and an
        ``enc_mask``, or patch embeddings), every plain kernel refused on the
        card: each card step's launches exact, losses and grad norms within
        atol/rtol 1e-4.  With ``resync``
        each card step starts from the CPU run's weights and moments before
        that step, so that the two are held step by step and not along
        trajectories that part by rounding alone: reduced RWKV6's grad norm
        at step 3 moves by 2.2e-3 of itself on the CPU alone when the
        weights move by 1e-6 of themselves, mixtral's and Jamba's by less
        than 1e-4 (tests/test_torch_family_bwd.py::
        test_trajectory_sensitivity_to_a_weight_nudge)."""
        p_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED))
        it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=4,
                                    seed=SEED)).batches()
        batches = [next(it) for _ in range(steps)]
        if inputs is not None:
            batches = [inputs(b) for b in batches]
        masked = "enc_mask" in batches[0]
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps),
                               remat=True)

        def copy_to(tree, where):
            return tree_map(lambda p: p.detach().to(where, copy=True), tree)

        params = {w: tree_map(lambda p: p.requires_grad_(True), copy_to(p_cpu, w))
                  for w in ("cpu", "cuda")}
        state = {w: init_state(params[w]) for w in ("cpu", "cuda")}
        hist = {"cpu": [], "cuda": []}
        for i, b in enumerate(batches):
            if resync and i:
                params["cuda"] = tree_map(lambda p: p.requires_grad_(True),
                                          copy_to(params["cpu"], "cuda"))
                st = state["cpu"]
                state["cuda"] = AdamWState(st.step.to("cuda"), copy_to(st.mu, "cuda"),
                                           copy_to(st.nu, "cuda"))
            for where in ("cpu", "cuda"):
                batch = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
                if where == "cuda":
                    ops.reset_launches()
                    for n in plain_names:
                        setattr(ref, n, refuse_plain)
                try:
                    params[where], state[where], m = step(params[where], state[where], batch)
                finally:
                    for n, fn in plain_kernels.items():
                        setattr(ref, n, fn)
                hist[where].append({k: float(m[k]) for k in ("loss", "grad_norm")})
                if where == "cuda":
                    check_train_launches(f"{cfg.name} step {i + 1}", cfg, 1, 4 * seq, masked)
        for i, (c, g) in enumerate(zip(hist["cpu"], hist["cuda"])):
            for key in ("loss", "grad_norm"):
                if not (math.isfinite(g[key])
                        and math.isclose(g[key], c[key], rel_tol=1e-4, abs_tol=1e-4)):
                    raise AssertionError(f"{cfg.name} step {i + 1} {key}: card {g[key]!r}, "
                                         f"CPU {c[key]!r}")
            print(f"  step {i + 1}: loss card {g['loss']:.6f} CPU {c['loss']:.6f} (|diff| "
                  f"{abs(g['loss'] - c['loss']):.3g}); grad_norm card {g['grad_norm']:.6f} CPU "
                  f"{c['grad_norm']:.6f} (|diff| {abs(g['grad_norm'] - c['grad_norm']):.3g})")
        print(f"  each card step's launches by route: {train_routes(cfg, 1, 4 * seq, masked)}")

    phase("11a reduced qwen3-1.7b and h2o-danube-3-4b (heads 120 wide) trained, card against "
          "CPU, float32")
    for arch, seq in TRAIN_REDUCED.items():
        cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32")
        if arch == "h2o-danube-3-4b":
            cfg = dataclasses.replace(cfg, head_dim=120, n_kv_heads=2)
        print(f"{cfg.name}: head_dim {cfg.resolved_head_dim}, {cfg.n_heads}/{cfg.n_kv_heads} "
              f"heads, window {cfg.sliding_window}; batches of 4 x {seq} tokens")
        train_card_against_cpu(cfg, seq, TRAIN_REDUCED_STEPS)

    # profiler keys by what they run (re.search, the first that matches)
    kernel_tags = (("mamba_scan_bwd_ring_kernel", "mamba_scan_bwd (ring)"),
                   ("mamba_scan_bwd_kernel", "mamba_scan_bwd (ckpt)"),
                   ("mamba_scan_bwd_sum_kernel", "mamba_scan_bwd (sums)"),
                   ("rwkv6_scan_bwd_ring_kernel", "rwkv6_scan_bwd (ring)"),
                   ("rwkv6_scan_bwd_kernel", "rwkv6_scan_bwd (rows)"),
                   ("rwkv6_scan_bwd_sum_kernel", "rwkv6_scan_bwd (sums)"),
                   (r"moe_gmm_tn_kernel<true", "moe_gmm dw (backward, wgmma_tn)"),
                   (r"moe_gmm_tn_kernel<false", "moe_gmm dx (backward, wgmma_nt)"),
                   (r"moe_gmm_wgmma_kernel<true>", "moe_gmm dx (backward, wgmma_nt_fwd)"),
                   ("moe_gmm", "moe_gmm (forward and recompute)"),
                   ("mamba_scan_lanes_kernel", "mamba_scan forward"),
                   ("rwkv6_scan_cols_kernel", "rwkv6_scan forward"),
                   (r"wgb::\w+<\d+, true|dq_live_kernel|live_tiles_kernel",
                    "flash backward, masked"),
                   ("wgb::", "flash backward"),
                   (r"flash_wgmma_kernel<\d+, true>", "flash forward, masked"),
                   ("flash_wgmma_kernel", "flash forward"),
                   (r"\bupdate_kernel", "adamw update"),
                   (r"\bsumsq_kernel|\bnorm_kernel", "adamw norm"))
    #: the full-width training phases' figures, replay and eager, printed after 11g
    train_table = []

    def train_run(cfg, batches, opt, mode, masked=False):
        """``TRAIN_STEPS`` remat steps of ``cfg`` drawn on the card from
        ``SEED``, AdamW ``opt``, on ``batches`` (``TRAIN_STEPS`` + 1 of them,
        on the card), then one more under the profiler.  ``mode`` "graph":
        step 1 builds a ``TrainGraph`` (the step run eagerly as its warm-up,
        then captured), every later step is a replay; "eager": every step op
        by op.  Each step's loss, exact launches over the 4 steps
        (``masked``: the batches carry an ``enc_mask``), step time (mean of
        steps 2-4), tokens/s (the decoder's tokens), MFU by
        ``flops.model_flops``, peak memory (the graph's pool included), the
        profiled step's device time, idle share and kernels.  Frees the
        model; returns the figures."""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tree_map(lambda p: p.requires_grad_(True),
                          T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED)))
        state = init_state(params)
        torch.cuda.synchronize()
        if mode == "graph":
            n_params = sum(p.numel() for p in tree_leaves(params))
            largest = max(p.numel() for p in tree_leaves(params))
            print(f"{cfg.name}: kinds {[k.value for k in cfg.block_kinds()]}, d_model "
                  f"{cfg.d_model}, "
                  + (f"{cfg.encdec.encoder_layers} encoder layers, " if cfg.encdec else "")
                  + f"{n_params} parameters ({cfg.dtype} weights {tree_bytes(params)} bytes, "
                  f"fp32 moments {tree_bytes(state.mu) + tree_bytes(state.nu)} bytes; reckoned "
                  f"at 12 bytes a parameter {12 * n_params} bytes, the largest leaf {largest} "
                  f"values, {4 * largest} bytes in fp32), drawn in "
                  f"{time.perf_counter() - t0:.1f} s")
        batch, seq = batches[0]["labels"].shape
        step = make_train_step(cfg, AdamWConfig(**opt), remat=True)
        print(f"  [{mode}] {TRAIN_STEPS} steps of {batch} x {seq} tokens "
              + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}" for k, v in batches[0].items())
              + f", AdamW {opt}, remat on")
        ops.reset_launches()
        times, hist, graph = [], [], None
        for b in batches[:TRAIN_STEPS]:
            t0 = time.perf_counter()
            if mode == "eager":
                _, _, m = step(params, state, b)
            elif graph is None:
                graph = TrainGraph(step, params, state, b)
                m = graph.first_metrics
            else:
                m = graph.replay(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            hist.append({k: float(v) for k, v in m.items()})
            h = hist[-1]
            print(f"  [{mode}] step {len(hist)}: loss {h['loss']:.6f} nll {h['nll']:.4f} "
                  f"grad_norm {h['grad_norm']:.6f} moe_aux {h['moe_aux']:.4g} lr {h['lr']:.3g} "
                  f"step_ms {1e3 * times[-1]:.1f}"
                  + (" (the eager warm-up and the capture)" if graph is not None
                     and len(hist) == 1 else ""))
        check_train_launches(f"{cfg.name} training ({mode})", cfg, TRAIN_STEPS, batch * seq,
                             masked)
        launched = {op: n for op, n in ops.LAUNCHES.items() if n}
        flash_bwd = {r: n for r, n in ops.ROUTE_LAUNCHES["flash_attention_bwd"].items() if n}
        print(f"  [{mode}] launches by op over the {TRAIN_STEPS} steps: {launched}; the flash "
              f"backward's by kernel {flash_bwd}")
        tokens = batch * seq
        mf = flops.model_flops(cfg, InputShape(f"train_{batch}x{seq}", seq, batch,
                                               StepKind.TRAIN))["model_flops"]
        steady = statistics.fmean(times[1:])
        peak = torch.cuda.max_memory_allocated()
        capture_s = graph.capture_s if graph is not None else None
        print(f"train {cfg.name} [{mode}] step_ms {1e3 * steady:.1f} (mean of steps "
              f"2-{TRAIN_STEPS}; step 1 {1e3 * times[0]:.1f}"
              + (f", capture_s {capture_s:.3f}" if graph is not None else "")
              + f")  tokens_per_s {tokens / steady:.1f}  model_flops_per_step {mf:.6g}  "
              f"model_tflops_per_s {mf / steady / 1e12:.2f}  mfu "
              f"{mf / steady / PEAK_BF16_FLOPS:.4f} (of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s "
              f"bf16"
              + ("; flops.model_flops counts the decoder's tokens only, not the encoder's "
                 "frames, as the reference does" if cfg.encdec else "")
              + f")  max_memory_allocated_bytes {peak}  adamw launches {launched['adamw']}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if graph is None:
                step(params, state, batches[TRAIN_STEPS])
            else:
                graph.replay(batches[TRAIN_STEPS])
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        device_us, top = device_top(torch, prof, 1)
        if device_us is None:
            raise AssertionError(f"the profiler saw no kernel of {cfg.name}'s train step "
                                 f"({mode})")
        by_kernel = collections.Counter()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for part, tag in kernel_tags:
                    if re.search(part, e.key):
                        by_kernel[tag] += e.self_device_time_total
                        break
        idle = 1 - device_us / wall_us
        print(f"  [{mode}] profiled step (one more, its wall including the profiler's cost): "
              f"device_us {device_us:.1f}  wall_us {wall_us:.1f}  idle share {idle:.3f}")
        print("  " + ", ".join(f"{tag} {us:.1f} us ({us / device_us:.3f})"
                               for tag, us in by_kernel.items()))
        for name, us in top:
            print(f"    {us:10.1f} us  {name[:100]}")
        del params, state, prof, step, m, graph
        gc.collect()
        torch.cuda.empty_cache()
        return dict(hist=hist, launched=launched, flash_bwd=flash_bwd, step_ms=1e3 * steady,
                    device_us=device_us, idle=idle, peak=peak, capture_s=capture_s)

    def train_full_width(cfg, batches, opt, label, masked=False, hold=False):
        """``train_run`` of ``cfg`` on the replayed graph, the main path, then
        on the eager step from the same weights and batches, the card freed
        and checked under 1 GB before each: each step's loss and grad norm of
        the two printed side by side (exactly equal or not), and with
        ``hold`` held within rtol 1e-5.  Returns the graph run's figures."""
        runs = {}
        for mode in ("graph", "eager"):
            free_card(torch, f"{label} ({mode})")
            runs[mode] = train_run(cfg, batches, opt, mode, masked)
        off = []
        for i, (g, e) in enumerate(zip(runs["graph"]["hist"], runs["eager"]["hist"])):
            rel = {k: abs(g[k] - e[k]) / abs(e[k]) for k in ("loss", "grad_norm")}
            print(f"  step {i + 1}: loss replay {g['loss']!r} eager {e['loss']!r}, grad_norm "
                  f"replay {g['grad_norm']!r} eager {e['grad_norm']!r}: "
                  + ("exactly equal" if all(g[k] == e[k] for k in rel) else
                     "rel " + ", ".join(f"{k} {x:.3g}" for k, x in rel.items())))
            off += [f"step {i + 1} {k} rel {x:.3g}" for k, x in rel.items() if not x <= 1e-5]
        if hold and off:
            raise AssertionError(f"{cfg.name}: the replay against the eager step: "
                                 f"{', '.join(off)}")
        train_table.append((label, cfg.name, runs))
        return runs["graph"]

    def check_falling(cfg, losses):
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"{cfg.name}: losses {losses} not finite and falling")

    phase("11b full-width, full-depth qwen3-1.7b trained on the card, bf16")
    cfg = get_arch("qwen3-1.7b")
    t0 = time.perf_counter()
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                batch_size=TRAIN_BATCH, seed=SEED)).batches()
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
               for _ in range(TRAIN_STEPS + 1)]
    print(f"  {TRAIN_STEPS + 1} SyntheticLM batches of {TRAIN_BATCH} x {TRAIN_SEQ} tokens over "
          f"the {cfg.vocab_size}-token vocabulary, made in {time.perf_counter() - t0:.1f} s")
    run = train_full_width(cfg, batches, TRAIN_OPT, "phase 11b", hold=True)
    hist = run["hist"]
    launches["flash_attention_bwd"] = run["launched"]["flash_attention_bwd"]
    launches["adamw"] = run["launched"]["adamw"]
    check_falling(cfg, [h["loss"] for h in hist])
    train_measured = {"device_us": run["device_us"], "peak": run["peak"]}
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT), remat=True)

    # the same 4 steps from the same weights and batches with the library's
    # attention (SDPA, K and V repeated to Hq, its own backward) in place of
    # the kernels: a full-width reference for the trajectory
    def sdpa_attention(q, k, v, causal, window, key_valid=None):
        G = q.shape[2] // k.shape[2]
        out = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(G, 1),
            v.transpose(1, 2).repeat_interleave(G, 1), is_causal=causal)
        return out.transpose(1, 2)

    if cfg.sliding_window is not None:
        raise AssertionError("the SDPA reference takes no window")
    params = tree_map(lambda p: p.requires_grad_(True),
                      T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED)))
    state = init_state(params)
    kernel_attention, attention._flash = attention._flash, sdpa_attention
    ref_hist = []
    try:
        for b in batches[:TRAIN_STEPS]:
            params, state, m = step(params, state, b)
            ref_hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    finally:
        attention._flash = kernel_attention
    print(f"  the same {TRAIN_STEPS} steps with SDPA's attention (relative limits by step "
          f"{TRAIN_SDPA_RTOL}):")
    off = []
    for i, (h, r) in enumerate(zip(hist, ref_hist)):
        rel = {k: abs(h[k] - r[k]) / abs(r[k]) for k in ("loss", "grad_norm")}
        print(f"  step {i + 1}: loss kernels {h['loss']:.6f} SDPA {r['loss']:.6f} (rel "
              f"{rel['loss']:.3g}); grad_norm kernels {h['grad_norm']:.6f} SDPA "
              f"{r['grad_norm']:.6f} (rel {rel['grad_norm']:.3g})")
        off += [f"step {i + 1} {k} rel {x:.3g}" for k, x in rel.items()
                if not x <= TRAIN_SDPA_RTOL[i]]
    if off:
        raise AssertionError(f"{cfg.name}: the kernels' trajectory against SDPA's: "
                             f"{', '.join(off)}")
    del params, state, batches, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11c, 11d -------------------------------------------------------------
    phase("11c reduced mixtral-8x7b, jamba-v0.1-52b (8 layers) and rwkv6-1.6b trained, card "
          "against CPU, float32")
    for arch, n_layers in TRAIN_FAMILY_REDUCED.items():
        cfg = dataclasses.replace(reduced(get_arch(arch), n_layers=n_layers), dtype="float32")
        print(f"{cfg.name}: kinds {[k.value for k in cfg.block_kinds()]}; batches of 4 x "
              f"{TRAIN_FAMILY_SEQ} tokens")
        train_card_against_cpu(cfg, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS,
                               resync=arch in TRAIN_FAMILY_RESYNC)

    def step_grads(cfg, params, batch, remat=True):
        """Step 1's loss and its gradients by every leaf (``tree_leaves``
        order), as ``make_train_step`` takes them."""
        logits, aux = T.forward(params, cfg, batch, remat=remat)
        loss = losses_mod.cross_entropy(logits, batch["labels"])["loss"] + aux
        del logits
        return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(params),
                                                         allow_unused=True)

    def rel_diff(got, expect):
        return (float((got.float() - expect.float()).abs().max())
                / max(float(expect.float().abs().max()), 1e-30))

    def rwkv_scan_checks(cfg, batch):
        """The wkv kernels inside full-width RWKV6's gradients, float32.
        (a) At 2 layers and batch 2, step 1's gradients with the kernels
        against those with the plain scan's autograd from the same weights
        and batch (the only difference between the two): each leaf within
        SUM_REL of its largest element.  (b) At all of ``cfg``'s layers and
        batch 1, each layer's scan forward and backward on the inputs and
        the output cotangent that layer met in the step, kernels against
        plain versions: each output and gradient within SUM_REL of its
        largest magnitude.  (c) That step's grad norm, by layer, from the
        weights times 1 and 1 +- 1e-6: how far rounding alone moves it.  At
        full depth the gradient is ill-conditioned, so a whole-model
        comparison of (a)'s kind cannot hold there, and (b) holds the
        kernels layer by layer instead."""
        small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
        b2 = {k: v[:2] for k, v in batch.items()}
        params = tree_map(lambda p: p.requires_grad_(True),
                          T.init_params(small, torch.Generator(device=dev).manual_seed(SEED)))
        _, kernel_grads = step_grads(small, params, b2)
        kernel_scan, ops.rwkv6_scan = ops.rwkv6_scan, ref.rwkv6_scan_ref
        try:
            _, plain_grads = step_grads(small, params, b2)
        finally:
            ops.rwkv6_scan = kernel_scan
        worst = sorted(((rel_diff(g, r), name) for (name, _), g, r
                        in zip(tree_items(params), kernel_grads, plain_grads)
                        if g is not None), reverse=True)
        print(f"  (a) step 1's gradients of 2 float32 layers at batch 2, the wkv kernels against "
              f"the plain scan's autograd, max |diff| over each leaf's largest (limit "
              f"{SUM_REL}): " + ", ".join(f"{n} {x:.3g}" for x, n in worst[:4]))
        if not worst[0][0] <= SUM_REL:
            raise AssertionError(f"{small.name}: kernels against the plain scan, {worst[:4]}")
        del params, kernel_grads, plain_grads

        cfg = dataclasses.replace(cfg, dtype="float32")
        b1 = {k: v[:1] for k, v in batch.items()}
        p0 = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
        met = []

        def recording_scan(r, k, v, w, u, S0=None):
            o, S = kernel_scan(r, k, v, w, u, S0)
            entry = {"inputs": [t.detach().clone() for t in (r, k, v, w, u)]}
            o.register_hook(lambda g: entry.__setitem__("do", g.detach().contiguous()))
            met.append(entry)
            return o, S

        ops.rwkv6_scan = recording_scan
        try:
            step_grads(cfg, tree_map(lambda p: p.detach().requires_grad_(True), p0), b1,
                       remat=False)
        finally:
            ops.rwkv6_scan = kernel_scan
        if len(met) != cfg.n_layers or not all("do" in e for e in met):
            raise AssertionError(f"{cfg.name}: {len(met)} scans recorded")
        worst_layer = (-1.0, -1, "")
        for i, e in enumerate(met):
            r, k, v, w, u = e["inputs"]
            got = (*_rwkv.rwkv6_scan(r, k, v, w, u, None),
                   *_rwkv.rwkv6_scan_bwd(r, k, v, w, u, None, e["do"], None))
            expect = (*ref.rwkv6_scan_ref(r, k, v, w, u, None),
                      *ref.rwkv6_scan_bwd_ref(r, k, v, w, u, None, e["do"], None))
            for name, g, x in zip(("o", "S_last", "dr", "dk", "dv", "dw", "du", "dS0"),
                                  got, expect):
                worst_layer = max(worst_layer, (rel_diff(g, x), i, name))
        print(f"  (b) each of {cfg.n_layers} float32 layers' scan at batch 1 on the inputs and "
              f"output cotangent it met in step 1, kernels against plain versions: max |diff| "
              f"over the largest {worst_layer[0]:.3g} (layer {worst_layer[1]}, "
              f"{worst_layer[2]}; limit {SUM_REL})")
        if not worst_layer[0] <= SUM_REL:
            raise AssertionError(f"{cfg.name}: the kernels on the recorded inputs, "
                                 f"{worst_layer}")
        del met

        for scale in (1.0, 1.0 + 1e-6, 1.0 - 1e-6):
            loss, grads = step_grads(
                cfg, tree_map(lambda p: (p.detach() * scale).requires_grad_(True), p0), b1)
            sq = [g.float().reshape(cfg.n_layers, -1).square().sum(1)
                  for (name, _), g in zip(tree_items(p0), grads)
                  if g is not None and name.startswith("blocks/")]
            per_layer = sum(sq).sqrt()
            norm = math.sqrt(sum(float(g.float().square().sum()) for g in grads
                                 if g is not None))
            if not math.isfinite(norm):
                raise AssertionError(f"{cfg.name}: grad norm {norm} at weights x {scale}")
            print(f"  (c) weights x {scale!r}: loss {loss:.7f}, grad norm {norm:.6g}, by layer "
                  f"(0 first) {[float(f'{x:.4g}') for x in per_layer.tolist()]}")
            del grads, sq
        del p0

    bwd_ops = ("moe_gmm_bwd", "mamba_scan_bwd", "rwkv6_scan_bwd")
    family_launches = collections.Counter()
    for arch, (n_layers, batch) in TRAIN_FAMILY_FULL.items():
        full = get_arch(arch)
        phase(f"11d full-width {arch}, {n_layers} of {full.n_layers} layers, trained on the "
              f"card, bf16")
        cfg = dataclasses.replace(full, n_layers=n_layers)
        it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    batch_size=batch, seed=SEED)).batches()
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
                   for _ in range(TRAIN_STEPS + 1)]
        run = train_full_width(cfg, batches, TRAIN_FAMILY_OPT, f"phase 11d {arch}",
                               hold=arch == "mixtral-8x7b")
        for op in bwd_ops:
            family_launches[op] += run["launched"].get(op, 0)
        if arch == "rwkv6-1.6b":
            rwkv_scan_checks(cfg, batches[0])
        check_falling(cfg, [h["loss"] for h in run["hist"]])
        del batches
        gc.collect()
        torch.cuda.empty_cache()
    for op in bwd_ops:
        launches[op] = family_launches[op]

    # -- 11e, 11f -------------------------------------------------------------
    phase("11e reduced seamless-m4t-large-v2 under a ragged enc_mask and pixtral-12b trained, "
          "card against CPU, float32")
    frames_rng = np.random.default_rng(SEED + 12)
    cfg = dataclasses.replace(reduced(get_arch("seamless-m4t-large-v2")), dtype="float32")
    enc_mask = (np.arange(TRAIN_ENCDEC_FRAMES)[None]
                < np.array(TRAIN_ENCDEC_MASK_LENGTHS)[:, None])
    print(f"{cfg.name}: {cfg.encdec.encoder_layers} encoder and {cfg.n_layers} decoder layers, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}; batches of 4 x "
          f"{TRAIN_FAMILY_SEQ} tokens over {TRAIN_ENCDEC_FRAMES} stub frames, enc_mask valid "
          f"lengths {TRAIN_ENCDEC_MASK_LENGTHS} (row 1 fully masked)")
    train_card_against_cpu(cfg, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS, inputs=lambda b: {
        **b, "enc_mask": enc_mask, "enc_embeds": frames_rng.standard_normal(
            (4, TRAIN_ENCDEC_FRAMES, cfg.frontend.embed_dim), np.float32)})
    cfg = dataclasses.replace(reduced(get_arch("pixtral-12b")), dtype="float32", n_kv_heads=1)
    print(f"{cfg.name}: {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim} "
          f"(pixtral's G = 4); batches of 4 x {TRAIN_FAMILY_SEQ} stub patch embeddings of width "
          f"{cfg.frontend.embed_dim}")
    train_card_against_cpu(cfg, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS, inputs=lambda b: {
        "labels": b["labels"], "embeds": frames_rng.standard_normal(
            (4, TRAIN_FAMILY_SEQ, cfg.frontend.embed_dim), np.float32)})

    phase("11f full-width, full-depth seamless-m4t-large-v2 trained under an enc_mask on the "
          "card, bf16")
    cfg = get_arch("seamless-m4t-large-v2")
    gen_frames = torch.Generator(device=dev).manual_seed(SEED + 13)
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                batch_size=TRAIN_BATCH, seed=SEED)).batches()
    n_frames = cfg.encdec.max_source_positions
    enc_mask = torch.arange(n_frames, device=dev)[None] < torch.tensor(
        [n_frames - 97 * b for b in range(TRAIN_BATCH)], device=dev)[:, None]   # 5f's
    batches = [{**{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()},
                "enc_embeds": stub_frontend_embeddings(cfg, gen_frames, TRAIN_BATCH),
                "enc_mask": enc_mask} for _ in range(TRAIN_STEPS + 1)]
    print(f"  enc_mask valid lengths {enc_mask.sum(1).tolist()} (5f's)")
    run = train_full_width(cfg, batches, TRAIN_FAMILY_OPT, "phase 11f seamless", masked=True)
    launches["flash_attention_masked_bwd"] = run["flash_bwd"]["bwd_dq_wgmma_live"]
    check_falling(cfg, [h["loss"] for h in run["hist"]])
    del batches, enc_mask

    full = get_arch("pixtral-12b")
    phase(f"11f full-width pixtral-12b, {PIXTRAL_TRAIN_LAYERS} of {full.n_layers} layers, "
          f"trained on the card, bf16")
    cfg = dataclasses.replace(full, n_layers=PIXTRAL_TRAIN_LAYERS)
    gen_patches = torch.Generator(device=dev).manual_seed(SEED + 14)
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                batch_size=TRAIN_BATCH, seed=SEED)).batches()
    batches = [{"labels": torch.from_numpy(next(it)["labels"]).to(dev),
                "embeds": stub_frontend_embeddings(cfg, gen_patches, TRAIN_BATCH, TRAIN_SEQ)}
               for _ in range(TRAIN_STEPS + 1)]
    run = train_full_width(cfg, batches, TRAIN_FAMILY_OPT, "phase 11f pixtral")
    check_falling(cfg, [h["loss"] for h in run["hist"]])
    del batches
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11h, 11g -------------------------------------------------------------
    phase("11h reduced phi4-mini-3.8b (G 3), phi3.5-moe-42b-a6.6b (G 4, top 2) and deepseek-67b "
          "(G 8) trained, card against CPU step by step, float32")
    for arch in ASSIGNED_LAYERS:
        cfg = assigned_reduced(arch)
        print(f"{cfg.name}: {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
              f"kinds {[k.value for k in cfg.block_kinds()]}; batches of 4 x {TRAIN_FAMILY_SEQ} "
              f"tokens")
        train_card_against_cpu(cfg, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS, resync=True)

    for arch, (n_layers, batch) in TRAIN_ASSIGNED_FULL.items():
        full = get_arch(arch)
        phase(f"11g full-width {arch}, {n_layers} of {full.n_layers} layers "
              f"(G {full.n_heads // full.n_kv_heads}), trained on the card, bf16")
        cfg = dataclasses.replace(full, n_layers=n_layers)
        it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    batch_size=batch, seed=SEED)).batches()
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
                   for _ in range(TRAIN_STEPS + 1)]
        run = train_full_width(cfg, batches, TRAIN_FAMILY_OPT, f"phase 11g {arch}")
        flash_bwd = run["flash_bwd"]
        # the backward's routes: the flash wgmma pair at G 3, 4 and 8; the
        # experts' dx on wgmma_nt_fwd (C 640: five 128-row tiles that do not
        # pair) and dw on wgmma_tn
        gmm_bwd = {r for r, n in ops.ROUTE_LAUNCHES["moe_gmm_bwd"].items() if n}
        want_gmm = {"dx_wgmma_nt_fwd", "dw_wgmma_tn"} if cfg.moe else set()
        if set(flash_bwd) != {"bwd_dq_wgmma", "bwd_dkv_wgmma"} or gmm_bwd != want_gmm:
            raise AssertionError(f"{arch}: backward routes {flash_bwd}, {gmm_bwd}")
        print(f"  backward routes: flash {sorted(flash_bwd)}"
              + (f", moe_gmm {sorted(gmm_bwd)}" if cfg.moe else ""))
        check_falling(cfg, [h["loss"] for h in run["hist"]])
        del batches
        gc.collect()
        torch.cuda.empty_cache()
    print("the full-width training phases, replay / eager (step ms: mean of steps 2-4; device "
          "ms, idle: the profiled step; peak GB: max_memory_allocated, the graph's pool "
          "included):")
    for label, name, runs in train_table:
        g, e = runs["graph"], runs["eager"]
        print(f"  {label} {name}: step_ms {g['step_ms']:.1f} / {e['step_ms']:.1f}  device_ms "
              f"{g['device_us'] / 1e3:.1f} / {e['device_us'] / 1e3:.1f}  idle {g['idle']:.3f} / "
              f"{e['idle']:.3f}  peak_GB {g['peak'] / 1e9:.2f} / {e['peak'] / 1e9:.2f}  "
              f"capture_s {g['capture_s']:.3f}  adamw launches {g['launched']['adamw']}")

    # -- 12 -----------------------------------------------------------------
    phase("12 the dry run, the roofline and the options on the card")
    gc.collect()
    torch.cuda.empty_cache()
    dry_run_and_options(torch, dev, rng, profiles["qwen3-1.7b"]["decode"], train_measured,
                        profiles["phi4-mini-3.8b"]["decode"], host12.result())

    # -- 13 -----------------------------------------------------------------
    phase("13 the assigned input shapes on one card")
    free_card(torch, "phase 13")
    assigned_shapes(torch, dev, smi, host13)
    worker.shutdown()

    # -- result -------------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **({k: r[k] for k in ("previous_ms", "unmasked_ms", "simt_ms", "copy_ms")
             if k in r}),
         **({"note": f"{h2o_note}; {encdec_note}"}
            if name in ("flash_attention", "decode_attention") else {}),
         **({"note": r["note"]} if "note" in r else {})}
        for name, r in records.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
