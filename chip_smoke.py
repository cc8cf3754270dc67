#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

In order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels (nine, the ssd kernel in three routes)
     from the sources in this checkout, and prints the build's seconds
     (each source's in its log);
  3. holds each kernel of the fp32 and int8 paths against its plain
     PyTorch version on the card, at the shapes of its path (128 UEs x a
     16-period chunk: B = 2048 estimator rows; the int8 path's fc in
     passes of 365 rows);
  4. drives the two paths once each — ``simulate_fleet(..., fused=True)``
     (fp32) and ``simulate_fleet(..., fused=True, quant="int8")`` at the
     paper's estimator width (n_sc 3276, H 124) over a mixed S0-S3 episode
     with seeded random weights and the fig6 PSO table — with every launch
     counter set to 0 just before each and read just after, and checks each
     result against the port run on the CPU for the first UEs;
  5. times each kernel at every shape its path gives it, its plain
     version, a PyTorch yardstick where one call computes the same
     function (cuDNN's LSTM, cuBLAS int8 ``torch._int_mm``), and both
     paths end to end; lstm_scan on its route (``cluster`` at H 124) and
     on the other (``block``) on the same inputs, bit-equal;
  6. the multi-cell path: ``simulate_cells`` of 1024 UEs over 4 cells x 100
     periods with handovers and load-coupled interference, the pf PRB
     scheduler on the segsum kernel and the recurrent SSM estimator on the
     ssd kernel (a short maxsinr run too): both kernels against their plain
     versions, the runs with their launch counts (cold, then three warm),
     the whole fleet against the port on the CPU, the scheduler on the
     CPU's estimates on both devices, kernel timings (``scatter_reduce_``
     as segsum's yardstick; segsum behind one torch op, and at (1, 32) ->
     1, a launch whose work is nothing) and an ``e2e_cells`` line;
  7. the split-computing path at VGG16's full width (224 px, 48 textured
     images): the forward at all 43 split points, dCor(input, activation)
     through the pairwise_dists kernel, the measured profile and PSO table,
     split inference of 8 images at 130/60/30/8 Mbps through the FP16,
     INT8 and INT4 codecs (the quantize kernel at qmax 127 and 7): the
     kernel against its plain version, the runs with their launch counts
     (cold, then three warm), dcor_kernel against the plain profile, the
     card against the port on the CPU for 8 images (every activation, dCor,
     split inference's probabilities and its logits), head/tail against the
     full forward, kernel timings (``torch.cdist`` as the yardstick) and
     an ``e2e_split`` line;
  8. the dense LM's split serving at granite-8b's full width and depth
     (36 layers, d 4096, 32 q heads over 8 kv heads, dh 128; bf16 weights
     seeded on the card): the flash_attention kernel against its plain
     version at the path's shape (128, 4096, 128) bf16 causal and at f32,
     window-1024, dh-80 (non-causal), dh-64, dh-256 and ragged (S 100)
     cases, and at the MoE, hybrid and VLM paths' shapes (steps 10-12);
     ``lm_split_infer`` of 4 x 4096 tokens at split 18 through the FP16,
     INT8 and INT4 codecs (cold, then three warm runs, 36
     flash_attention launches a run and one quantize launch an integer
     codec), the codec's quantize kernel on the bf16 boundary activation
     against its plain version, head plus tail against the forward, the
     kernel on layer 0's own q, k, v against its plain version, and at
     full width cut to 2 layers each sublayer through the kernel, through
     ``use_kernel=False`` and through the port on the CPU on one input
     (f32 and bf16), kernel timings
     (``scaled_dot_product_attention`` as the yardstick; beside the
     bound, the bf16 kernel's design floor of Q.K^T once and P.V three
     times) and an ``e2e_lm`` line;
  9. the SSD LM's split serving at mamba2-370m's full width and depth (48
     layers, d 1024, d_inner 2048, 32 heads x 64, N 128, chunk 256, vocab
     50280; bf16 weights seeded on the card): the ssd kernel's chunked
     routes against the plain version at SSD_CHECKS (bf16 on the tensor
     cores, f32 and a ragged bf16 case on the CUDA cores; chunks of 40 to
     512, two groups) and on layer 0's own inputs at the path's shape (4,
     4096, 32, 64, 1, 128, L 256) bf16, timed there beside the CUDA-core
     kernels on the same inputs (bf16) and at the same shape (f32);
     ``lm_split_infer`` of 4 x 4096 tokens at split 24 through FP16, INT8
     and INT4 (cold, then three warm runs, 48 ssd calls a run, all on the
     tensor-core route, one quantize launch an integer codec), and the same
     checks as the dense LM's (head plus tail, the boundary codec, the
     2-layer cut on the card and the CPU); timings and an ``e2e_ssd_lm``
     line;
 10. the MoE LM's split serving at mixtral-8x22b's full width (d 6144,
     48 q over 8 kv heads, 8 experts top-2, d_ff 16384, window 4096),
     its depth cut to 12 of its 56 layers (bf16 weights seeded on the
     card): ``lm_split_infer`` of 4 x 4096 tokens at split 6 through FP16,
     INT8 and INT4 (cold, then three warm runs, 12 flash_attention
     launches a run at (192, 4096, 128) window 4096, one quantize launch
     an integer codec) with the same checks as the dense LM's, the card
     against the CPU at one layer, each sublayer on one input, the MoE's
     routing decisions (top_i, keep) compared and the share that differ
     printed, its output held on the tokens whose decisions agree; then
     llama4-scout-17b-a16e (16 experts, top-1) at full width cut to 2
     layers, the same checks on the card and the CPU and one timed
     forward; and an ``e2e_moe_lm`` line;
 11. the RG-LRU hybrid's split serving at recurrentgemma-2b's full width
     and depth (26 layers, d 2560, MQA with dh 256, local window 2048):
     split 4 of its 8 megablocks, 8 flash_attention launches a run at
     (40, 4096, 256), the same checks (the card against the CPU at 2
     RG-LRU layers) and an ``e2e_hybrid_lm`` line;
 12. the cross-attention VLM's split serving at llama-3.2-vision-90b's
     full width (d 8192, 64 q over 8 kv heads, d_ff 28672), its depth cut
     to 10 of its 100 layers (two SSSSX megablocks), seeded (4, 1601,
     1280) vision embeddings and cross gates drawn nonzero: split 1, so
     that the tail's cross block reads the vision embeddings, 8
     flash_attention launches a run at (256, 4096, 128), the same checks
     (the card against the CPU at one megablock, its cross block in it)
     and an ``e2e_vlm`` line;
 13. decode, inside steps 8-12 (``serve_lm``): on each LM path, after the
     split serving, ``lm.prefill`` of the same 4 x 4096 tokens with room
     for the decode steps (cold, then two warm runs; the path's kernel once
     a layer it serves, and with the int8 KV cache quantize twice a
     self-attention layer; the last logits bit-equal to the forward's;
     every self-attention ring holding exactly the prompt's last
     positions, recurrentgemma-2b's local rings 2048..4095), then
     teacher-forced ``lm.decode_step`` calls, each timed (no
     flash_attention and no ssd; quantize twice a self-attention layer a
     step with the int8 cache; every ring slid by one a step): granite-8b
     64 steps with the bf16 and with the int8 KV cache (quantize bit-equal
     to plain on layer 0's prefill k and v rows (131072, 128) and on one
     step's (32, 128), timed), the other paths 16 steps with the bf16
     cache; the decode logits against the forward over the prompt and the
     decode tokens reported; and in every cut's card-against-CPU check
     (granite-8b also with the int8 cache) each mixer's prefill cache and
     4 decode steps sublayer by sublayer; then the ``e2e_decode`` line
     (prefill s, the median step, tokens/s, cache and peak GiB, with
     ``--profile`` the device's busy share over four steps);
 14. prints the ``{"kernels": [...]}`` line (ssd's row with its three
     routes, each at its path's shape; quantize's and lstm_scan_q's with
     the int8 path's calls of each route, lstm_scan_q's with its design
     floor; lstm_scan's with the fp32 path's calls of each route, the
     block route's time on the same inputs and its design floor; segsum's
     and featurize's with the path's calls of each route and the card's
     launch floor as design floor (an empty kernel, timed in step 5);
     flash_attention's with its f32 kernel's time, each LM path's
     launches and ``scaled_dot_product_attention`` at each path's shape,
     quantize's with each LM path's boundary and the int8 KV cache's
     shapes; every row with its decode launches) and, last,
     ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero. Without a card, or
outside a checkout of the repository, it exits non-zero and prints no
result.

    python3 chip_smoke.py              # what the card check runs
    python3 chip_smoke.py --profile    # also: a torch.profiler breakdown
    python3 chip_smoke.py --attention  # only flash_attention's checks and
                                       # times (no ok line)
    python3 chip_smoke.py --qmm        # the same for qmm
    python3 chip_smoke.py --dcor       # the same for pairwise_dists
    python3 chip_smoke.py --ssd        # the same for ssd's chunked routes
    python3 chip_smoke.py --int8       # the same for quantize (every
                                       # main-path shape, with its route)
                                       # and lstm_scan_q
    python3 chip_smoke.py --scan       # the same for lstm_scan (each
                                       # route), the fused ssd route (the
                                       # cells call and every fused shape
                                       # checked), the launch floor, and
                                       # segsum's and featurize's wrappers
                                       # and generic routes beside it
    python3 chip_smoke.py --moe        # only the MoE LM path (step 10,
                                       # its decode; no ok line)
    python3 chip_smoke.py --hybrid     # only the hybrid and VLM paths
                                       # (steps 11-12, their decode; no
                                       # ok line)
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_UES, T_PERIODS, CPU_UES, SEED = 128, 16, 4, 0
# the cells path: the reference's cells sweep size (benchmarks/fleet.py,
# run_cells: sizes [64, 1024], T = 100), 4 cells
CELLS_UES, CELLS_T, CELLS_C = 1024, 100, 4
# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 rate, the FP32
# rate outside the tensor cores and the dense int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12  # dense, on the tensor cores
# the clock those rates assume (67 TFLOP/s = 132 SMs x 128 FP32 lanes x 2
# x 1.98 GHz), and an SM's results a clock: FP32 lanes, the MUFU (exp2,
# rcp) and its conversions
N_SMS, SM_CLOCK_HZ = 132, 1.98e9
FP32_PER_CLK, MUFU_PER_CLK = 128, 16
# lstm_scan_q's mma route, one (row, unit, step) of its gate chain as the
# source writes it, estimated from the source (no SASS is read, so the
# floor built on them is an estimate). FP32-pipe instructions: 8 dequantizations of two
# multiplies and the exact widening's subtract, 8 adds into z and the
# forget gate's +1, 3 sigmoids of an add, expf and a reciprocal, 2 tanhf,
# 4 for c and h, h's abs-max, and its code through the row's reciprocal
# scale (a multiply, three adds, a compare), counting expf as 7
# instructions around its MUFU op, __frcp_rn as 4 and tanhf as 8
# (estimates of libdevice's expansions, not read from the SASS). MUFU
# operations: 3 exp2 and 3 reciprocals (the sigmoids), 2 for each tanhf
LSTM_Q_FP32_OPS, LSTM_Q_MUFU_OPS = 95, 10
# the route's two block barriers a step, at an assumed 24 clocks each once
# every warp has arrived
LSTM_Q_BARRIER_CLK = 2 * 24
# lstm_scan's cluster route, one (row, unit, step) of its gate chain as the
# source writes it (``cell``), counted as LSTM_Q_FP32_OPS is: 9 adds into z
# and the forget gate's +1, 3 sigmoids of expf, an add and __frcp_rn, 2
# tanhf, 3 for c and 1 for h, counting expf as 7 instructions, __frcp_rn as
# 4 and tanhf as 8; MUFU operations as there. The x_t and h products are
# counted apart, as FMAs
LSTM_FP32_OPS, LSTM_MUFU_OPS = 65, 10
# the route's one cluster barrier a step (arrival to the end of the wait,
# once every thread of the two blocks has arrived), assumed
LSTM_CLUSTER_BARRIER_CLK = 200
# the fused ssd route's calls checked against ssd_ref, (B, S, L, nh, hd, G,
# N): the cells path's (the recurrent estimator at 1024 UEs: K = 3
# forecasts over 192 padded steps), then smaller shapes of other widths,
# groups and chunks; each within 1e-4 (y) and 1e-3 (state)
SSD_FUSED_SHAPES = [(CELLS_UES, 192, 64, 4, 8, 1, 8), (2, 64, 16, 4, 16, 1, 8),
                    (2, 128, 32, 8, 32, 2, 16), (2, 96, 96, 2, 8, 1, 4)]
# segsum's timed launches beside the launch floor, (T, N, C) sums: the pf
# scheduler's call a period, and one whose work is nothing
SEGSUM_TIMED = [(1, CELLS_UES, CELLS_C), (1, 32, 1)]
# the int8 LSTM on the card against its plain version: sigmoid/tanh ulps
# can flip an int8 code of h (tests/test_torch_lstm.py states the same)
Q_SCAN_ATOL, Q_SCAN_ROWS_OFF = 5e-3, 0.05
# card int8 estimates against the port's int8 on the CPU: an int8 code
# flipped by the other device's sigmoid/tanh moves an estimate on the x40
# head by tenths of a Mbps (0.244 at most on an H100); the bound is half a
# 1-Mbps controller bucket
INT8_EST_ATOL = 0.5
# the split path: VGG16 at the paper's width, fig5's full-run image count,
# split inference on the first images at the quickstart's throughputs
SPLIT_IMAGES, SPLIT_CPU_IMAGES = 48, 8
SPLIT_TPS = (130, 60, 30, 8)
HEAD_TAIL_SPLITS = (1, 5, 17, 31, 34, 40)  # tests/test_split_models.py
# pairwise_dists against its plain version: (n, d) at the profile's widths
# (the input and activations of 48 images), plus tiled and ragged shapes
PAIRWISE_CHECKS = [(48, 150528), (48, 3211264), (48, 802816), (48, 25088),
                   (48, 4096), (48, 1000), (200, 300), (33, 70)]
# squared distances from sums in another order (the kernel's split of d,
# cuBLAS's): within 1e-4 of |x_i|^2 + |x_j|^2, the scale of the cancelling
# terms (under 2e-6 on an H100)
DIST_RTOL = 1e-4
# dCor from those distances, kernel against plain and card against the
# CPU's convolutions (under 3e-7 on an H100)
DCOR_ATOL = 1e-4
# split inference, card against CPU: the softmax of VGG16's growing
# activations saturates, so outputs agree far below this (0 measured)
INFER_ATOL = 1e-5
# the LM path: granite-8b at full width and depth with launch/serve.py's
# defaults (the middle split of its 36 megablocks, the int8 codec among
# the three), batch 4 x 4096 seeded tokens
LM_ARCH, LM_BATCH, LM_SEQ, LM_SPLIT = "granite-8b", 4, 4096, 18
# the card against the port on the CPU: full width, 2 layers, 256 tokens
LM_CPU_LAYERS, LM_CPU_SEQ = 2, 256
# the layers a kernel of an LM path serves: one launch a layer of these
KERNEL_KINDS = {"flash_attention": ("attn", "local"), "ssd": ("ssd",)}
# the MoE LM path: mixtral-8x22b at full width (d 6144, 48 q over 8 kv
# heads, 8 experts top-2, d_ff 16384, window 4096), its depth cut to 12 of
# its 56 layers (5.0 GB of bf16 weights a layer: 12 and the embedding and
# head are 56.7 GiB of the card's 80 GB), split at the middle; the card
# against the CPU at one layer (10 GB in f32)
MOE_ARCH, MOE_LAYERS, MOE_SPLIT, MOE_CPU_LAYERS = "mixtral-8x22b", 12, 6, 1
# llama4-scout-17b-a16e (16 experts, top-1, vocab 202048) at full width,
# cut to 2 layers: the block checks and one timed forward
SCOUT_ARCH, SCOUT_LAYERS = "llama4-scout-17b-a16e", 2
# the card's and the CPU's MoE routing decisions on one input: an f32 near
# tie can flip one, so the output is held on the tokens whose decisions
# agree; more than this share differing is a fault, not a near tie
MOE_DECISIONS_DIFFER = 0.05
# the hybrid LM path: recurrentgemma-2b at full width and depth (26
# layers: 8 megablocks of two RG-LRU and one local-attention block, two
# RG-LRU blocks after them), split at the middle of its 8 megablocks
HYBRID_ARCH, HYBRID_SPLIT = "recurrentgemma-2b", 4
# the VLM path: llama-3.2-vision-90b at full width (d 8192, 64 q over 8 kv
# heads, d_ff 28672), its depth cut to 10 of its 100 layers (two SSSSX
# megablocks of about 1.7 GB a layer), split 1 so that the tail's cross
# block reads batch["vision"]; the card against the CPU at one megablock
# (5 layers), the cross block in it
VLM_ARCH, VLM_LAYERS, VLM_SPLIT, VLM_CPU_LAYERS = (
    "llama-3.2-vision-90b", 10, 1, 5)
# flash_attention's launch on each LM path, (BH, S, dh, dtype, causal,
# window): batch 4 x 32 q heads (granite-8b), 4 x 48 heads at window 4096
# (mixtral-8x22b), 4 x 10 heads of dh 256 at window 2048
# (recurrentgemma-2b), 4 x 64 heads (llama-3.2-vision-90b); each is held
# against the plain version and timed beside its bound
ATTN_PATH_SHAPES = {LM_ARCH: (128, 4096, 128, "bfloat16", True, 0),
                    MOE_ARCH: (192, 4096, 128, "bfloat16", True, 4096),
                    HYBRID_ARCH: (40, 4096, 256, "bfloat16", True, 2048),
                    VLM_ARCH: (256, 4096, 128, "bfloat16", True, 0)}
# flash_attention against its plain version: the paths' launches (the
# first, granite-8b's, is also timed beside plain and SDPA) and cases of
# f32, windows, head dims and a ragged length
ATTN_CHECKS = [ATTN_PATH_SHAPES[LM_ARCH],
               (32, 1024, 128, "float32", True, 0),
               (32, 4096, 128, "bfloat16", True, 1024),
               (32, 1024, 80, "bfloat16", False, 0),
               (32, 1024, 64, "bfloat16", True, 0),
               (8, 1024, 256, "bfloat16", True, 0),
               (4, 100, 128, "bfloat16", True, 0)] + [
    ATTN_PATH_SHAPES[a] for a in (MOE_ARCH, HYBRID_ARCH, VLM_ARCH)]
# the plain version runs on this many heads at a time, so that its f32
# scores at S 4096 stay at 4.3 GB
ATTN_REF_HEADS = 64
# the f32 case timed beside its bound and SDPA: the largest f32 case
ATTN_F32_TIMED = max((c for c in ATTN_CHECKS if c[3] == "float32"),
                     key=lambda c: c[0] * c[1] * c[1] * c[2])
# f32: within 1e-5 of max|o|. bf16: each element within one bf16 ulp of its
# own magnitude (the f32 sums run in another order, so a rounding can
# flip), over a floor of the same 1e-5 of max|o| for elements near 0
ATTN_RTOL = 1e-5
# granite-8b's seeded weights (the reference's init) make the scores reach
# |s| ~ 1.6e3, so a near tie between two keys turns on the last bit of a
# score, and the forward's logits move with any change of rounding: two
# f32 layers whose blocks agree to 4.4e-5 between the card and the CPU
# end 0.155 of the logit scale apart (on an H100). So routes and devices
# are compared block by block on one input, each output relative to its
# largest magnitude, and the end-to-end logits are reported. f32: 1e-4
# (a block moves by 4.4e-5 of its magnitude between the card's and the
# CPU's sums through such near ties, by 1.8e-7 between the card's two
# attention routes); bf16: the tests' bf16 bound (tests/test_torch_lm.py)
LM_BLOCK_RTOL = {"float32": 1e-4, "bfloat16": 0.05}
# llama-3.2-vision-90b's f32 sublayers card against CPU: at d 8192 the
# first layer's scores reach 1.65e3, and the card's f32 sums put its
# attention sublayer 1.07e-4 of its magnitude from a float64 referee on
# the CPU, the CPU's own 3.2e-5 (an H100; cut_check reports both), so the
# two devices differ by 1.04e-4 there; the card's two attention routes
# agree to 1.7e-7. The bound for this path's f32 cut (bf16 as above)
LM_BLOCK_RTOL_F32 = {"llama-3.2-vision-90b": 2e-4}
# a decode step's mixer in f32, card against CPU from the same cache: as
# the reference's, k and v are written to a bf16 cache even in f32, and
# each device rounds its own f32 k and v, which differ in the last bits,
# so an element of the slot the step writes can land one bf16 ulp (2^-8
# of it) away and weigh in with its softmax weight; granite-8b's first
# f32 decode sublayers moved by 1.76e-4 of their magnitude (an H100)
LM_DECODE_RTOL_F32 = 1e-3
# decode after each LM path's LM_BATCH x LM_SEQ prefill: teacher-forced
# seeded tokens, one a sequence a step; granite-8b at full width and depth
# LM_DECODE_STEPS steps with the bf16 and with the int8 KV cache, every
# other path DECODE_STEPS with the bf16 cache. The first DECODE_COLD
# steps are left out of the median step (the allocator and cuBLAS's first
# calls at the new shapes)
LM_DECODE_STEPS, DECODE_STEPS, DECODE_COLD = 64, 16, 2
# the cuts' card-against-CPU decode steps after their LM_CPU_SEQ-token
# prefill
CUT_DECODE_STEPS = 4
# the SSD LM path: mamba2-370m at full width and depth, launch/serve.py's
# middle split of its 48 megablocks, the same batch and codecs
SSD_LM_ARCH, SSD_LM_SPLIT = "mamba2-370m", 24
# the ssd kernel against its plain version, (B, S, L, nh, hd, G, N, dtype):
# mamba2-370m's heads at chunks of 64, 128 and 256 in f32 and bf16, one
# chunk of the whole sequence (the shape the XLA route takes where the
# chunk does not divide S), two groups, and a bf16 shape that does not
# tile into 16s; bf16 takes the tensor-core route where it tiles, f32 and
# the ragged case the CUDA-core one (SSD_ROUTE)
SSD_CHECKS = [(1, 1024, L, 32, 64, 1, 128, dt) for L in (64, 128, 256)
              for dt in ("float32", "bfloat16")] + [
    (1, 512, 512, 32, 64, 1, 128, "bfloat16"),
    (1, 1024, 256, 32, 64, 2, 128, "bfloat16"),
    (2, 160, 40, 6, 24, 3, 20, "bfloat16")]
SSD_ROUTE = {"float32": "chunked", "bfloat16": "chunked_wgmma",
             "ragged": "chunked"}
# y: f32 within 1e-4 of max|y| (sums of up to L * N terms in another order
# cancel near 0: 6.6e-6 at most on an H100); bf16 each element within one
# bf16 ulp of its own magnitude over a floor of 1e-5 of max|y|; the state
# (f32) within 1e-4 of its largest magnitude (1.8e-6 on an H100)
SSD_RTOL = 1e-4
# each activation of the forward, and the logits of split inference,
# card against CPU, relative to the activation's largest magnitude:
# cuDNN and the CPU sum each convolution in other orders (4.0e-6 at most,
# logits 3.4e-6, on an H100); tests/test_torch_vgg.py holds the port to
# the reference at the same bar
ACT_RTOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``, after a warm-up.

    Host ms: the wall time per call of a synchronised loop of ``iters``
    calls, which for a small kernel is the host's launch rate. Device ms:
    CUDA events around ``iters`` calls that the host queued while the card
    was held busy (``torch.cuda._sleep``), so the calls run back to back
    on the card and the events time the card, not the host. ``iters``
    times the launches of one call stays under the driver's queue of about
    a thousand pending launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 10**6)  # cycles, ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


def cold_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` with the 50 MB L2 flushed before each
    call: 64 MB written between calls, CUDA events around each call alone,
    all queued while the card was held busy."""
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(2 * 10**7)  # cycles, ~10 ms at ~2 GHz
    for start, end in evs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters


# cudaGraphNodeType values (CUDA runtime API) and their names
GRAPH_NODE_TYPES = {0: "KERNEL", 1: "MEMCPY", 2: "MEMSET", 3: "HOST",
                    4: "GRAPH", 5: "EMPTY", 6: "WAIT_EVENT",
                    7: "EVENT_RECORD", 10: "MEM_ALLOC", 11: "MEM_FREE"}


def device_ops(fn) -> list:
    """The operations one call of ``fn`` puts on the card (kernels,
    memsets, copies, ...): the node types of a CUDA graph that captures the
    call, on a side stream after a warm-up call there (so that a wrapper's
    per-stream workspaces already exist), read with the CUDA runtime's
    cudaGraphGetNodes and cudaGraphNodeGetType."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        fn()
    torch.cuda.synchronize()
    rt = ctypes.CDLL("libcudart.so.12")  # the runtime torch has loaded
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(rt.cudaGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cudaGraphGetNodes")
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0,
              "cudaGraphNodeGetType")
        types.append(GRAPH_NODE_TYPES.get(kind.value, str(kind.value)))
    del graph
    return types


def bound(nbytes: float, flops: float, int8_ops: float = 0.0,
          bf16_ops: float = 0.0) -> tuple[float, str]:
    """Least time on the card (ms) for the work, and what bounds it: the
    bytes over the memory rate, or the operations of each type over that
    type's peak (FP32, int8 and bf16 on separate units, so the largest)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOPS, int8_ops / INT8_OPS,
                bf16_ops / BF16_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def int8_shapes(e, n_rows: int, pass_rows: int) -> tuple[Counter, Counter]:
    """The quantize (n, d) and qmm (m, n, k) shapes of one run of the int8
    path over one chunk of ``n_rows`` estimator rows, with their counts:
    the six weights once a call (``quantize_estimator``), then each dense
    product's activations (the LSTM projection, the fc in CNN passes of
    ``pass_rows``, the two head layers)."""
    h, hid, flat = e.lstm_hidden, e.hidden, e.cnn_flat
    passes = [min(pass_rows, n_rows - r0)
              for r0 in range(0, n_rows, pass_rows)]
    quant = Counter([(4 * h, e.n_kpms), (4 * h, h), (hid, h), (hid, flat),
                     (hid, hid), (1, hid), (n_rows, h), (n_rows, hid),
                     (n_rows, hid)] + [(p, flat) for p in passes])
    mm = Counter([(n_rows, hid, h), (n_rows, hid, hid), (n_rows, 1, hid)]
                 + [(p, hid, flat) for p in passes])
    return quant, mm


def shape_totals(per_shape: list) -> dict:
    """One run's totals over a kernel's shapes, each timed alone and
    weighted by its count; ``bound_by`` is that of the shape carrying the
    most of the bound."""
    tot = {k: sum(s["count"] * s[k] for s in per_shape)
           for k in ("ms", "plain_ms", "bound_ms", "host_ms",
                     "plain_host_ms")}
    lib = [s["library_ms"] for s in per_shape]
    tot["library_ms"] = (None if None in lib else
                         sum(s["count"] * s["library_ms"]
                             for s in per_shape))
    tot["bound_by"] = max(per_shape, key=lambda s: s["count"]
                          * s["bound_ms"])["bound_by"]
    return tot


def ssd_work(B: int, S: int, nh: int, hd: int, G: int, N: int,
             L: int, el: int = 4) -> tuple[int, int, int]:
    """(bytes, elementwise flops, product flops) of one SSD sequence pass:
    every input read once and both outputs written once (x, B, C and y
    ``el`` bytes an element, dt, A and the state f32). Products, per
    (batch, group) and chunk: the lower triangle of C.B, the masked
    intra-chunk product (hd multiply-adds a (t, s, head)), the state term
    of y (N a (t, head, d)) and the chunk states (L a (head, d, n)).
    Elementwise: a difference, an exp and a multiply a masked (t, s,
    head), dt * x, dt * A and the cumsum, the state term's decay and the
    sum of y's two terms, the decay of dt * x a (t, head, d), and the
    carried decay of the state recurrence a (head, d, n). On bf16 inputs
    the products go to the tensor cores; in f32 all of it is FP32."""
    hpg, nc, tri = nh // G, S // L, L * (L + 1) // 2
    nbytes = (el * (2 * B * S * nh * hd + 2 * B * S * G * N)
              + 4 * (B * S * nh + nh + B * G * hpg * hd * N))
    prod = (2 * N * tri + hpg * tri * 2 * hd + L * hpg * hd * 2 * N
            + hpg * hd * N * 2 * L)
    elem = (hpg * tri * 3 + L * hpg * hd + 2 * L * hpg + L * hpg * hd * 2
            + hpg * L * hd + hpg * hd * N * 2)
    return nbytes, B * G * nc * elem, B * G * nc * prod


def ssd_design_floor(B: int, S: int, nh: int, hd: int, G: int, N: int,
                     L: int) -> dict:
    """The tensor-core route's own floor (ms) at this shape: its products
    as it runs them (C.B on the 64 x 64 tiles at or below the diagonal,
    padded N; three pieces for M' x on those tiles, for the chunk states
    over 32-step slabs, and for the state term of every chunk after the
    first; x padded to 64 columns) at the bf16 rate, and the chunk states'
    round trip through device memory (S_c in f32, the entry states'
    pieces in bf16, each written and read once) at the memory rate."""
    from repro_torch.kernels.ssd import padded_n
    hpg, nc, np_ = nh // G, S // L, padded_n(N)
    n_tt = -(-L // 64)
    tiles = n_tt * (n_tt + 1) // 2
    cb = tiles * 64 * 64 * np_ * 2
    intra = tiles * 3 * 64 * 64 * 64 * 2
    state = 3 * (-(-L // 32) * 32) * np_ * 64 * 2
    inter = 3 * (n_tt * 64) * np_ * 64 * 2
    flops = B * G * (nc * (cb + hpg * (intra + state))
                     + (nc - 1) * hpg * inter)
    nbytes = 2 * B * nc * nh * hd * N * 4 + 2 * B * (nc - 1) * nh * (
        3 * np_ * 64 * 2)
    return {"products": flops / BF16_FLOPS * 1e3,
            "workspace": nbytes / HBM_BYTES_PER_S * 1e3,
            "products_gflop": flops / 1e9, "workspace_mb": nbytes / 1e6}


def lstm_q_design_floor(batch: int, steps: int, k_in: int,
                        hidden: int) -> dict:
    """The mma route's own floor (ms) at this shape, an estimate resting
    on LSTM_Q_FP32_OPS, LSTM_Q_MUFU_OPS (counted from the source, not the
    SASS) and LSTM_Q_BARRIER_CLK (assumed): 16 rows a block (one block an
    SM while blocks <= 132), and each of the ``steps``
    dependent steps no faster than the block's gate chain on its busiest
    unit (LSTM_Q_FP32_OPS over the FP32 lanes, LSTM_Q_MUFU_OPS over the
    MUFU, the step's m16n8k32 and m16n8k16 products at the int8 rate), plus
    its two barriers. Units are computed 8 a warp, so padded units
    count."""
    rows, units = 16, 8 * -(-hidden // 8)
    pairs = rows * units
    waves = -(-(-(-batch // rows)) // N_SMS)
    k32 = 32 * -(-hidden // 32)
    tensor_ops = 2 * rows * 4 * units * (k32 + 16)
    clk = {"fp32": pairs * LSTM_Q_FP32_OPS / FP32_PER_CLK,
           "mufu": pairs * LSTM_Q_MUFU_OPS / MUFU_PER_CLK,
           "tensor": tensor_ops / (INT8_OPS / N_SMS / SM_CLOCK_HZ)}
    step_clk = max(clk.values()) + LSTM_Q_BARRIER_CLK
    ms = waves * steps * step_clk / SM_CLOCK_HZ * 1e3
    return {"ms": ms, "per_step_clk": {**clk, "barriers": LSTM_Q_BARRIER_CLK},
            "bound_by": max(clk, key=clk.get)}


def lstm_design_floor(batch: int, steps: int, k_in: int,
                      hidden: int) -> dict:
    """The cluster route's own floor (ms) at this shape, an estimate resting
    on LSTM_FP32_OPS, LSTM_MUFU_OPS (counted from the source, not the SASS)
    and LSTM_CLUSTER_BARRIER_CLK (assumed): a block a 32-row tile and half
    the units, padded to 64 (one block an SM while blocks <= 132), and each
    of the ``steps`` dependent steps no faster than the busiest block's
    multiply-adds of x_t and h over the SM's 128 FP32 lanes, then its gate
    chain (its FP32 instructions over the lanes or its MUFU operations over
    the MUFU, whichever takes longer), then one cluster barrier."""
    rows, units = 32, 64
    pairs = rows * units
    blocks = 2 * -(-batch // rows)
    waves = -(-blocks // N_SMS)
    clk = {"fma": rows * 4 * units * (hidden + k_in) / FP32_PER_CLK,
           "gates_fp32": pairs * LSTM_FP32_OPS / FP32_PER_CLK,
           "gates_mufu": pairs * LSTM_MUFU_OPS / MUFU_PER_CLK,
           "barrier": LSTM_CLUSTER_BARRIER_CLK}
    step_clk = (clk["fma"] + max(clk["gates_fp32"], clk["gates_mufu"])
                + clk["barrier"])
    return {"ms": waves * steps * step_clk / SM_CLOCK_HZ * 1e3,
            "per_step_clk": clk}


def lstm_row(rows, lp) -> tuple[dict, torch.Tensor]:
    """lstm_scan on the card's windows ``rows`` (B, T, K) with the f32
    weights ``lp``: each route within rtol 1e-4, atol 1e-5 of the plain
    version and the routes bit-equal (checked), the path's route and time
    beside the other route's on the same inputs, the plain version's,
    cuDNN's LSTM (the yardstick), the bound and the design floor. Returns
    the row and the kernel's output."""
    from repro_torch.kernels.lstm import (CLUSTER_MAX_HIDDEN, _launch,
                                          lstm_scan, lstm_scan_ref,
                                          lstm_scan_route)
    wx, wh, b = lp["wx"], lp["wh"], lp["b"]
    batch, steps, k_in = rows.shape
    hid = wh.shape[0]
    h = lstm_scan(rows, wx, wh, b)
    h_ref = lstm_scan_ref(rows, wx, wh, b)
    torch.cuda.synchronize()
    err = (h - h_ref).abs().max().item()
    check(torch.allclose(h, h_ref, rtol=1e-4, atol=1e-5),
          f"lstm_scan within rtol 1e-4, atol 1e-5 of plain ({err:.3g})")
    which = lstm_scan_route(hid, k_in)
    row = {"shape": [batch, steps, k_in, hid], "scan_route": which,
           "max_abs_err": err}
    others = [r for r in ("cluster", "block") if r != which
              and (r == "block" or hid <= CLUSTER_MAX_HIDDEN)]
    for other in others:
        out = torch.empty_like(h)
        _launch(other, rows, wx, wh, b, out)
        torch.cuda.synchronize()
        check(torch.equal(out, h), f"lstm_scan's {other} route bit-equal "
              f"to its {which} route at {tuple(row['shape'])}")
        row[f"{other}_bit_equal"] = True
        row[f"{other}_ms"] = cuda_ms(
            lambda: _launch(other, rows, wx, wh, b, out), 50)[0]
    row["ms"], row["host_ms"] = cuda_ms(
        lambda: lstm_scan(rows, wx, wh, b), 50)
    row["plain_ms"], row["plain_host_ms"] = cuda_ms(  # ~14 launches a step
        lambda: lstm_scan_ref(rows, wx, wh, b), 2)
    # multiply-adds of both products (2 each), the two sums and the bias
    # per gate, and 5 multiply/adds of the state update; exp/tanh uncounted
    flops = batch * steps * (2 * 4 * hid * (k_in + hid) + 2 * 4 * hid
                             + 5 * hid)
    nbytes = 4 * (rows.numel() + wx.numel() + wh.numel() + b.numel()
                  + batch * hid)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    if which == "cluster":
        floor = lstm_design_floor(batch, steps, k_in, hid)
        row["design_floor_ms"], row["design_floor"] = floor["ms"], floor
    # yardstick only (the port never calls it): cuDNN's LSTM computes the
    # same cell with weight_ih = wx.T, weight_hh = wh.T, bias_ih = b and
    # +1 on the forget slice of bias_hh (gate order i, f, g, o in both)
    ref_lstm = torch.nn.LSTM(k_in, hid, batch_first=True).to(rows.device)
    with torch.no_grad():
        ref_lstm.weight_ih_l0.copy_(wx.T)
        ref_lstm.weight_hh_l0.copy_(wh.T)
        ref_lstm.bias_ih_l0.copy_(b)
        ref_lstm.bias_hh_l0.zero_()
        ref_lstm.bias_hh_l0[hid:2 * hid] = 1.0
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        row["library_max_abs_err"] = (ref_lstm(rows)[1][0][0]
                                      - h_ref).abs().max().item()
        row["library_ms"], row["library_host_ms"] = cuda_ms(
            lambda: ref_lstm(rows), 20)
    return row, h


def ssd_inputs(g, dev, B: int, S: int, nh: int, hd: int, G: int, N: int):
    """Seeded ssd inputs on the card as the recurrent estimator draws
    them: x, B, C normal, dt softplus(normal) / 2, A = -exp(normal * 0.3)."""
    x = torch.randn((B, S, nh, hd), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=g, device=dev)) * 0.5
    A = -torch.exp(torch.randn(nh, generator=g, device=dev) * 0.3)
    Bm = torch.randn((B, S, G, N), generator=g, device=dev)
    Cm = torch.randn((B, S, G, N), generator=g, device=dev)
    return x, dt, A, Bm, Cm


def ssd_fused_row(x, dt, A, Bm, Cm, L: int) -> dict:
    """The fused ssd route on these inputs: one launch on the fused route
    within 1e-4 (y) and 1e-3 (state) of ssd_ref (checked), its instance
    (``fused_instance``), time, bound and the plain version's time."""
    from repro_torch.kernels import ROUTES, reset_launches
    from repro_torch.kernels.ssd import fused_instance, route, ssd, ssd_ref
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    shape = (B, S, L, nh, hd, G, N)
    check(route(x.dtype, nh // G, hd, N, L) == "fused",
          f"ssd at {shape} takes the fused route")
    reset_launches()
    y, st = ssd(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    check(ROUTES["ssd"]["fused"] == 1, f"one fused launch at {shape}")
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, L)
    check(torch.allclose(y, yr, rtol=1e-4, atol=1e-4)
          and torch.allclose(st, sr, rtol=1e-3, atol=1e-3),
          f"ssd within 1e-4 (y) and 1e-3 (state) of plain at {shape}")
    nbytes, elem, prod = ssd_work(B, S, nh, hd, G, N, L)
    b_ms, by = bound(nbytes, elem + prod)
    ms, host = cuda_ms(lambda: ssd(x, dt, A, Bm, Cm, chunk=L), 50)
    pms, phost = cuda_ms(lambda: ssd_ref(x, dt, A, Bm, Cm, L), 5)
    return {"shape": list(shape), "dtype": "float32",
            "instance": fused_instance(nh // G, hd, N, L),
            "max_abs_err": (y - yr).abs().max().item(),
            "state_max_abs_err": (st - sr).abs().max().item(), "ms": ms,
            "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
            "host_ms": host, "plain_host_ms": phost}


def torch_op(dev):
    """One torch elementwise op of the kind the scheduler runs before each
    segsum call (sim/sched.py: ``torch.clamp_min`` of the fleet's (1024,)
    f32 PF averages)."""
    x = torch.rand(CELLS_UES, device=dev) + 0.5
    return lambda: torch.clamp_min(x, 1e-6)


def timed_behind(fn, op) -> tuple[float, float, float]:
    """(device ms a call back to back, device ms a call behind one call of
    ``op`` each: the pair's time less ``op``'s alone, host ms a call)."""
    ms, host = cuda_ms(fn, 400)
    op_ms, _ = cuda_ms(op, 400)
    pair_ms, _ = cuda_ms(lambda: (op(), fn()), 400)
    return ms, pair_ms - op_ms, host


def launch_floor(dev) -> dict:
    """The card's launch floors: the kernel with an empty body
    (``kernels/segsum::empty_launch``) launched plainly (``empty``, as
    featurize is) and with programmatic dependent launch (``empty_pdl``, as
    segsum's vec4 route is: its body the wait for the grid ahead), back to
    back and behind one torch elementwise op each (``torch_op``), as
    segsum runs on the cells path. No launch-sized kernel so launched can
    beat its floor: the ``design_floor_ms`` of featurize's row and of
    segsum's."""
    from repro_torch.kernels.segsum import empty_launch
    op, out = torch_op(dev), {}
    for name, pdl in (("empty", False), ("empty_pdl", True)):
        ms, behind, host = timed_behind(lambda: empty_launch(dev, pdl), op)
        out.update({f"{name}_ms": ms, f"{name}_behind_op_ms": behind,
                    f"{name}_host_ms": host})
    return out


def segsum_timed(dev, floor: dict, generic: bool = False) -> list:
    """segsum (sum) at SEGSUM_TIMED through the public wrapper (the route
    ``segsum_route`` picks) and, with ``generic``, on the generic route
    (the first version) on the same inputs, each checked against plain
    first: device ms back to back and behind one torch elementwise op, host
    ms a call, and ms over the launch floor the route is launched with
    (vec4: the empty kernel with programmatic dependent launch)."""
    from repro_torch.kernels import segsum
    g = torch.Generator(device=dev).manual_seed(SEED)
    op, rows = torch_op(dev), []
    for t, n, c in SEGSUM_TIMED:
        v = torch.rand((t, n), generator=g, device=dev)
        ids = torch.randint(0, c, (t, n), generator=g, device=dev,
                            dtype=torch.int32)
        want = segsum.segment_reduce_ref(v, ids, c)
        route = segsum.segsum_route(n, c)
        out = torch.empty((t, c), device=dev)

        def wrapper():
            return segsum.segment_reduce_batched(v, ids, c)

        def first_version():
            segsum._launch(v, ids, out, "sum", "generic")
            return out

        row = {"shape": [t, n, c], "op": "sum", "route": route}
        for name, fn in [("wrapper", wrapper)] + (
                [("generic", first_version)] if generic else []):
            check(torch.allclose(fn(), want, rtol=1e-6, atol=0.0),
                  f"segsum {name} within rtol 1e-6 of plain at {(t, n, c)}")
            ms, behind, host = timed_behind(fn, op)
            which = route if name == "wrapper" else name
            over = ms - floor["empty_pdl_ms" if which == "vec4"
                              else "empty_ms"]
            times = {"ms": ms, "behind_op_ms": behind, "host_ms": host,
                     "over_floor_ms": over}
            if name == "wrapper":
                row.update(times)
            else:
                row[name] = times
        rows.append(row)
    return rows


def path_slab(dev):
    """The fp32 path's featurize input: one chunk's (128, 45, 15) KPM trace
    of the smoke's episode (its IQ, drawn after the KPMs, left out), and
    the normalisation's center and scale."""
    from repro_torch.channel import kpm
    from repro_torch.channel import scenarios as sc
    names = np.asarray(sc.SCENARIOS)[np.arange(N_UES) % len(sc.SCENARIOS)]
    ep = sc.gen_episode_batch(names, T_PERIODS, np.random.default_rng(SEED),
                              include_iq=False)
    slab = np.ascontiguousarray(ep.kpms[:, :T_PERIODS + sc.WINDOW - 1])
    return (torch.from_numpy(slab).to(dev),
            torch.from_numpy(kpm.KPM_CENTER).to(dev),
            torch.from_numpy(kpm.KPM_SCALE).to(dev))


def featurize_timed(dev, floor: dict) -> dict:
    """featurize at the fp32 path's slab (``path_slab``) through the public
    wrapper (the route ``plan`` picks) and on its generic route (the first
    version), each bit-equal to plain first, and a torch fill of its
    output's bytes (the store side alone): device ms, host ms and ms over
    the plain launch floor, beside the byte bound."""
    from repro_torch.channel.scenarios import WINDOW
    from repro_torch.kernels import featurize as feat
    slab, center, scale = path_slab(dev)
    n, length, k = slab.shape
    want = feat.featurize_ref(slab, center, scale, WINDOW)
    out = torch.empty_like(want)
    b_ms, by = bound(4 * (slab.numel() + 2 * k + out.numel()),
                     2 * out.numel())
    fz = {"shape": [n, length, k], "route": feat.plan(length, k),
          "bound_ms": b_ms, "bound_by": by}

    def wrapper():
        return feat.featurize(slab, center, scale, WINDOW)

    def first_version():
        feat._launch(slab, center, scale, WINDOW, out, "generic")
        return out

    for name, fn in (("wrapper", wrapper), ("generic", first_version)):
        out.zero_()
        check(torch.equal(fn(), want),
              f"featurize {name} bit-equal to plain at the path's slab")
        ms, host = cuda_ms(fn, 400)
        fz[name] = {"ms": ms, "host_ms": host,
                    "over_floor_ms": ms - floor["empty_ms"]}
    ms, _ = cuda_ms(lambda: out.fill_(1.0), 400)
    fz["fill"] = {"ms": ms, "over_floor_ms": ms - floor["empty_ms"]}
    return fz


def scan_kernels(dev, smi: str) -> dict:
    """``--scan``: lstm_scan at the fp32 path's (2048, 30, 15), H 124, on
    seeded random windows and the estimator's seeded weights (lstm_row:
    each route, cuDNN's LSTM beside them); the fused ssd route at every
    shape of SSD_FUSED_SHAPES (ssd_fused_row); the card's launch floor
    (``launch_floor``), and segsum's and featurize's wrappers and generic
    routes beside it (``segsum_timed``, ``featurize_timed``)."""
    from repro_torch.channel.scenarios import WINDOW
    from repro_torch.estimator.model import EstimatorConfig, init_estimator
    e = EstimatorConfig()
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = init_estimator(e, torch.Generator().manual_seed(SEED),
                            device="cpu")
    lp = {k: v.to(dev) for k, v in params["lstm"].items()}
    rows = torch.randn((N_UES * T_PERIODS, WINDOW, e.n_kpms), generator=g,
                       device=dev)
    lrow, _ = lstm_row(rows, lp)
    print(json.dumps({"lstm_scan": lrow}))
    srows = []
    for B, S, L, nh, hd, G, N in SSD_FUSED_SHAPES:
        srows.append(ssd_fused_row(*ssd_inputs(g, dev, B, S, nh, hd, G, N),
                                   L))
        print(json.dumps({"ssd_fused": srows[-1]}))
    floor = launch_floor(dev)
    print(json.dumps({"launch_floor": floor}))
    seg = segsum_timed(dev, floor, generic=True)
    print(json.dumps({"segsum": seg}))
    fz = featurize_timed(dev, floor)
    print(json.dumps({"featurize": fz}))
    return {"lstm_scan": lrow, "ssd_fused": srows, "launch_floor": floor,
            "segsum": seg, "featurize": fz, "card": smi}


def vgg_boundary_shapes(m: int) -> list:
    """(n, d) of the VGG16 boundary codec's rows at every split of FULL for
    ``m`` images: each NHWC activation's channel rows (the input's at
    split 0), each flat activation's m rows."""
    from repro_torch.models.vgg import FULL, _shapes
    shapes = [(FULL.image_size, FULL.image_size, FULL.in_channels),
              *_shapes(FULL)]
    return sorted({(m * int(np.prod(sh[:-1])), int(sh[-1]))
                   for sh in shapes})


def quant_shape_row(x, count: int) -> dict:
    """quantize on the card's rows ``x`` (n, d): bit-equal to its plain
    version at qmax 127 and 7 (checked), its route, its time (qmax 127)
    beside its bound and the plain version's."""
    from repro_torch.kernels.quant import quantize, quantize_ref, route
    n, d = x.shape
    for qmax in (127, 7):
        q, s = quantize(x, qmax)
        torch.cuda.synchronize()
        rq, rs = quantize_ref(x, qmax)
        check(torch.equal(q, rq) and torch.equal(s, rs),
              f"quantize bit-equal to plain at {(n, d)} {x.dtype}, qmax "
              f"{qmax}")
    which = route(n, d, x.dtype, x.data_ptr() % 16 == 0)
    ms, host = cuda_ms(lambda: quantize(x), 50)
    pms, phost = cuda_ms(lambda: quantize_ref(x), 10)
    # each value read once and its code written once, one f32 scale a
    # row; abs and max for the amax, divide, round and clip for a code
    b_ms, by = bound(n * d * (x.element_size() + 1) + 4 * n, 5 * n * d)
    row = {"shape": [n, d], "dtype": str(x.dtype).split(".")[-1],
           "count": count, "route": which, "ms": ms, "plain_ms": pms,
           "bound_ms": b_ms, "bound_by": by, "library_ms": None,
           "host_ms": host, "plain_host_ms": phost}
    return row


def lstm_q_row(rows, lq) -> tuple[dict, torch.Tensor]:
    """lstm_scan_q on the card's windows ``rows`` (B, T, K) with the
    quantized weights ``lq``: within Q_SCAN_ATOL of its plain version on
    at most Q_SCAN_ROWS_OFF of the rows beyond 1e-5 (checked), its route
    and time beside its bound, design floor and plain version's, and on
    the tensor-core route the dp4a route's (the first version) time on
    the same inputs and whether the two routes' outputs are bit-equal.
    Returns the row and the kernel's output."""
    from repro_torch.kernels.lstm import (_launch_q, lstm_route,
                                          lstm_scan_q, lstm_scan_q_ref)
    args = (*lq["wx"], *lq["wh"], lq["b"])
    got = lstm_scan_q(rows, *args)
    want = lstm_scan_q_ref(rows, *args)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err, off = err.max().item(), int((err.amax(dim=1) > 1e-5).sum())
    check(max_err <= Q_SCAN_ATOL and off <= Q_SCAN_ROWS_OFF * rows.shape[0],
          f"lstm_scan_q within {Q_SCAN_ATOL} of plain, at most "
          f"{Q_SCAN_ROWS_OFF:.0%} of rows beyond 1e-5 ({max_err:.3g}, "
          f"{off} rows)")
    batch, steps, k_in = rows.shape
    hid = lq["wh"][0].shape[1]
    ms, host = cuda_ms(lambda: lstm_scan_q(rows, *args), 50)
    pms, phost = cuda_ms(  # about 1,350 launches a call
        lambda: lstm_scan_q_ref(rows, *args), 1)
    # int8 multiply-adds of both dots (2 each); per row and step, f32:
    # 5 a value to quantize x_t and h, 6 a gate column to scale and add
    # (24 a unit) and about 16 a unit for the gates; exp/tanh counted once
    b_ms, by = bound(
        4 * rows.numel() + lq["wx"][0].numel() + lq["wh"][0].numel()
        + 4 * (2 * 4 * hid + 4 * hid) + 4 * batch * hid,
        batch * steps * (5 * k_in + 45 * hid),
        batch * steps * 2 * 4 * hid * (k_in + hid))
    floor = lstm_q_design_floor(batch, steps, k_in, hid)
    row = {"shape": [batch, steps, k_in, hid], "scan_route": lstm_route(hid),
           "max_abs_err": max_err, "rows_beyond_1e-5": off, "ms": ms,
           "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
           "design_floor_ms": floor["ms"], "design_floor": floor,
           "host_ms": host, "plain_host_ms": phost}
    if row["scan_route"] != "dp4a":
        out = torch.empty_like(got)
        _launch_q("dp4a", rows, *args, out)
        torch.cuda.synchronize()
        row["dp4a_bit_equal"] = bool(torch.equal(out, got))
        row["dp4a_ms"] = cuda_ms(
            lambda: _launch_q("dp4a", rows, *args, out), 50)[0]
    return row, got


def int8_kernels(dev, smi: str) -> dict:
    """``--int8``: the quantize kernel at every main-path shape (one int8
    run's 15, the VGG boundary's rows at every split for 8 images, both LM
    boundaries in bf16) and lstm_scan_q at the int8 path's (2048, 30, 15),
    H 124, on seeded random inputs and the estimator's seeded weights:
    checks, routes and times (quant_shape_row, lstm_q_row)."""
    from repro_torch.channel.scenarios import WINDOW
    from repro_torch.configs import get_config
    from repro_torch.estimator.model import EstimatorConfig, init_estimator
    from repro_torch.estimator.serve import quantize_estimator
    e = EstimatorConfig()
    g = torch.Generator(device=dev).manual_seed(SEED)
    qshapes, _ = int8_shapes(e, N_UES * T_PERIODS, fc_pass_rows(e))
    cases = [((n, d), torch.float32, count, "int8 run")
             for (n, d), count in sorted(qshapes.items())]
    cases += [(nd, torch.float32, 1, "vgg boundary")
              for nd in vgg_boundary_shapes(SPLIT_CPU_IMAGES)]
    cases += [((LM_BATCH * LM_SEQ, get_config(a).d_model), torch.bfloat16,
               1, a) for a in (LM_ARCH, SSD_LM_ARCH)]
    qrows = []
    for (n, d), dtype, count, path in cases:
        x = (torch.randn((n, d), generator=g, device=dev)
             * torch.rand((n, 1), generator=g, device=dev) * 10).to(dtype)
        x[0] = 0.0  # an all-zero row: the 1e-8 scale floor
        qrows.append(dict(quant_shape_row(x, count), path=path))
        del x
        print(json.dumps(qrows[-1]))
    run = [r for r in qrows if r["path"] == "int8 run"]
    per_run = {k: sum(r["count"] * r[k] for r in run)
               for k in ("ms", "bound_ms", "plain_ms")}
    params = init_estimator(e, torch.Generator().manual_seed(SEED),
                            device="cpu")
    lq = quantize_estimator({k: {n: v.to(dev) for n, v in d.items()}
                             for k, d in params.items()})["lstm"]
    rows = torch.randn((N_UES * T_PERIODS, WINDOW, e.n_kpms),
                       generator=g, device=dev)
    lrow, _ = lstm_q_row(rows, lq)
    print(json.dumps({"lstm_scan_q": lrow}))
    return {"quantize": {"per_int8_run": per_run, "shapes": qrows},
            "lstm_scan_q": lrow, "card": smi}


def cells_path(dev, prof, table, cfg, fixed, argv, floor: dict) -> list:
    """The multi-cell, PRB-scheduled fleet driven by the recurrent SSM
    estimator at the repo's cells sweep size (benchmarks/fleet.py
    run_cells: 1024 UEs over 4 cells, T = 100): the segsum and ssd kernels
    against their plain versions, the path's runs with their launch
    counts, the whole fleet against the port on the CPU, timings and the
    ``e2e_cells`` line. Returns segsum's row of the kernels line (beside
    the launch floor ``floor``) and the numbers of ssd's fused route
    there."""
    from repro_torch.channel import scenarios as sc
    from repro_torch.estimator.ssm import (SSMConfig, episode_features,
                                           init_ssm, reduce_forecasts,
                                           ssm_forward_seq)
    from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
    from repro_torch.kernels.segsum import (segment_reduce_batched,
                                            segment_reduce_ref)
    from repro_torch.sim import (SchedulerConfig, attach_ring,
                                 build_cells_episode, cell_load,
                                 estimate_fleet, handover_grid,
                                 ring_coupling, run_scheduled,
                                 simulate_cells, split_metrics)
    from repro_torch.channel.throughput import prb_scaled_mbps
    from repro_torch.core.pso import TP_CLIP_MBPS

    W = sc.WINDOW
    n, T, C = CELLS_UES, CELLS_T, CELLS_C
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    grid = handover_grid(attach_ring(n, C), T + W, 0.25, rng, n_cells=C)
    names = np.asarray(sc.SCENARIOS)[np.arange(n) % len(sc.SCENARIOS)]
    ep = build_cells_episode(names, T, rng, grid, coupling=ring_coupling(C),
                             include_iq=False)
    c = SSMConfig(use_kernel=True, forecast_horizon=3,
                  forecast_policy="discount")
    params = init_ssm(c, torch.Generator().manual_seed(SEED), device="cpu")
    # spread the untrained readout over the table's 1-Mbps buckets, as the
    # fp32 path's head
    params["head"]["w2"] *= 40.0
    params["head"]["b2"] += 60.0
    gparams = {g: {k: v.to(dev) for k, v in d.items()}
               for g, d in params.items()}
    tables = np.broadcast_to(table.table, (n, len(table.table)))
    sched = SchedulerConfig("pf", fused=True)
    print(f"cells setup: {n} UEs over {C} cells x {T} periods (handover "
          f"25%, ring coupling), SSMConfig(use_kernel=True, K=3, "
          f"discount): {time.perf_counter() - t0:.2f} s")

    # the kernels against their plain versions at the path's shapes
    ids_row = torch.from_numpy(grid[:, W].astype(np.int32))[None].to(dev)
    rate_row = torch.from_numpy(ep.tp_mbps[:, 0].astype(np.float32))[None] \
        .to(dev)  # (1, 1024): one period's scheduler reduction
    ids_load = torch.from_numpy(np.ascontiguousarray(grid.T, np.int32)
                                ).to(dev)  # (130, 1024): cell_load
    dem = torch.from_numpy(ep.alloc_ratio.astype(np.float32)).to(dev) \
        .broadcast_to(ids_load.shape).contiguous()
    g = torch.Generator(device=dev).manual_seed(SEED)
    ids_mask = torch.randint(-3, C + 3, (7, 1024), generator=g, device=dev,
                             dtype=torch.int32)  # ids outside [0, C + 1)
    v_mask = torch.randn((7, 1024), generator=g, device=dev)
    # (name, values, ids, segments, atol of a sum): the path's sums are of
    # positive values; the masked case's random signs cancel, so its
    # near-zero sums get the reference's atol
    seg_cases = [("period", rate_row, ids_row, C, 0.0),
                 ("cell_load", dem, ids_load, C, 0.0),
                 ("masked", v_mask, ids_mask, C + 1, 1e-5)]
    seg_err = 0.0
    for name, v, ids, nseg, atol in seg_cases:
        for op in ("sum", "max"):
            got = segment_reduce_batched(v, ids, nseg, op=op)
            torch.cuda.synchronize()
            want = segment_reduce_ref(v, ids, nseg, op=op)
            if op == "max":
                check(torch.equal(got, want),
                      f"segsum max bit-equal to plain on {name}")
            else:
                check(torch.allclose(got, want, rtol=1e-6, atol=atol),
                      f"segsum sum within rtol 1e-6 of plain on {name}")
                seg_err = max(seg_err, (got - want).abs().max().item())
    load = cell_load(grid, ep.alloc_ratio, C, use_kernel=True, device=dev)
    check(np.allclose(load, cell_load(grid, ep.alloc_ratio, C), rtol=1e-5,
                      atol=1e-6), "cell_load on the kernel vs the host")
    # the fused ssd route at each shape, checked and timed (the first is
    # the path's call)
    ssd_rows = [ssd_fused_row(*ssd_inputs(g, dev, B, S, nh, hd, G, N), L)
                for B, S, L, nh, hd, G, N in SSD_FUSED_SHAPES]
    ssd_err = [max(r[k] for r in ssd_rows)
               for k in ("max_abs_err", "state_max_abs_err")]
    print(f"cells kernels vs plain: segsum max bit-equal, sum max |err| "
          f"{seg_err:.3g} (rtol 1e-6) at (1, {n}), ({T + W}, {n}) and a "
          f"masked (7, 1024) with ids in [-3, {C + 3}); ssd max |err| "
          f"y {ssd_err[0]:.3g}, state {ssd_err[1]:.3g} at "
          f"{[s[:5] for s in SSD_FUSED_SHAPES]}")

    # the path: cold once, then warm three times, counters around each run
    def run(policy="pf"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate_cells(ep, grid, table, prof, cfg, n_cells=C,
                             warm_split=fixed, estimator=(c, gparams),
                             sched=SchedulerConfig(policy, fused=True),
                             device=dev)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    res, first_s, launches = run()
    check(ROUTES["ssd"] == {"fused": 1, "chunked": 0, "chunked_wgmma": 0},
          f"the cells run's ssd call takes the fused route ({ROUTES})")
    seg_routes = dict(ROUTES["segsum"])
    check(seg_routes == {"vec4": T, "generic": 0},
          f"the cells run's segsum calls take the vec4 route ({seg_routes})")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    warm_s = []
    for _ in range(3):
        _, s_, l_ = run()
        warm_s.append(s_)
        check(l_["segsum"] == T and l_["ssd"] == 1,
              f"warm cells run launches {l_}")
    check(launches["segsum"] == T and launches["ssd"] == 1,
          f"a pf run launches segsum {T} times and ssd once ({launches})")
    check(all(launches[k] == 0 for k in launches
              if k not in ("segsum", "ssd")), "the cells path runs no other "
          f"kernel ({launches})")
    f = res.fleet
    check(f.splits.shape == (n, T) and f.prb_share.shape == (n, T),
          "cells result shapes")
    for name in ("est_tp", "prb_share", "delay_s"):
        check(bool(np.isfinite(getattr(f, name)).all()), f"{name} finite")
    check(np.allclose(res.share_sums(), 1.0, rtol=1e-5),
          "every cell's PRB shares sum to 1")
    res_mx, _, launches_mx = run("maxsinr")
    check(launches_mx["segsum"] == 2 * T and launches_mx["ssd"] == 1,
          f"a maxsinr run launches segsum {2 * T} times ({launches_mx})")
    seg_routes_mx = dict(ROUTES["segsum"])
    check(seg_routes_mx == {"vec4": 2 * T, "generic": 0}, "the maxsinr run's "
          f"segsum calls take the vec4 route ({seg_routes_mx})")

    # the whole fleet through the port on the CPU: shares couple every UE
    # of a cell, so no subset is the same computation
    t0 = time.perf_counter()
    cpu = simulate_cells(ep, grid, table, prof, cfg, n_cells=C,
                         warm_split=fixed, estimator=(c, params),
                         sched=sched, device="cpu")
    cpu_s = time.perf_counter() - t0
    cpu_est = estimate_fleet(ep, (c, params), device="cpu")
    card_est = estimate_fleet(ep, (c, gparams), device=dev)
    est_rel = float(np.max(np.abs(card_est - cpu_est) / np.abs(cpu_est)))
    check(np.allclose(card_est, cpu_est, rtol=1e-4, atol=0.0),
          f"card SSM estimates within 1e-4 relative of CPU ({est_rel:.3g})")
    share_err = float(np.abs(f.prb_share - cpu.fleet.prb_share).max())
    check(np.allclose(f.prb_share, cpu.fleet.prb_share, rtol=1e-5,
                      atol=1e-6), f"card pf shares vs CPU ({share_err:.3g})")
    agree = int((f.splits == cpu.fleet.splits).sum())
    check(agree >= 0.999 * f.splits.size,
          f"card splits equal CPU splits on >= 99.9% ({agree} of "
          f"{f.splits.size})")
    buckets = len(np.unique(np.round(card_est)))
    # the CPU's estimates through the scheduler and controllers on both
    # devices: rr and maxsinr sum small integers, so bit-equal
    cells_t = grid[:, W:]
    exact = {}
    for policy in ("rr", "maxsinr", "pf"):
        sc_ = SchedulerConfig(policy, fused=True)
        sp_d, sh_d = run_scheduled(tables, cpu_est, cfg, fixed, sc_, C,
                                   cells_t, ep.tp_mbps, device=dev)
        sp_c, sh_c = run_scheduled(tables, cpu_est, cfg, fixed, sc_, C,
                                   cells_t, ep.tp_mbps, device="cpu")
        if policy != "pf":
            check(np.array_equal(sp_d, sp_c) and np.array_equal(sh_d, sh_c),
                  f"{policy}: card scheduler + controllers bit-equal to CPU")
        exact[policy] = int((sp_d == sp_c).sum())
    print(f"cells path: simulate_cells(sched=pf fused, SSM) {n} UEs x {T} "
          f"periods, launches {launches} (maxsinr {launches_mx}); "
          f"{buckets} distinct 1-Mbps buckets; card vs CPU (whole fleet, CPU "
          f"run {cpu_s:.2f} s): estimates max rel {est_rel:.3g}, shares max "
          f"|err| {share_err:.3g}, splits equal {agree} of {f.splits.size}; "
          f"CPU estimates through run_scheduled on both: rr and maxsinr "
          f"bit-equal, pf splits equal {exact['pf']}; jain pf "
          f"{res.jain():.4f}, maxsinr {res_mx.jain():.4f}; peak device "
          f"memory {peak_gib:.2f} GiB; first run {first_s:.3f} s")

    # stages of a warm run
    stages = {}
    t0 = time.perf_counter()
    feats = episode_features(ep.kpms, ep.alloc_ratio)
    stages["episode_features_host"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fc, _ = ssm_forward_seq(c, gparams, feats, device=dev)
    torch.cuda.synchronize()
    stages["ssm_forward_seq"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = np.clip(reduce_forecasts(c, fc[:, W - 1:W - 1 + T].cpu().numpy()),
                  *TP_CLIP_MBPS)
    stages["reduce_forecasts"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    splits, shares = run_scheduled(tables, est, cfg, fixed, sched, C,
                                   cells_t, ep.tp_mbps, device=dev)
    stages["run_scheduled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    split_metrics(prof, splits, prb_scaled_mbps(ep.tp_mbps, shares),
                  device=dev)
    stages["split_metrics"] = time.perf_counter() - t0
    print(json.dumps({"e2e_cells": {
        "ue_periods": n * T, "first_s": first_s, "warm_s": warm_s,
        "ue_periods_per_s": n * T / float(np.median(warm_s)),
        "stages_s": stages,
        "launches": {"segsum": launches["segsum"], "ssd": launches["ssd"],
                     "segsum_maxsinr": launches_mx["segsum"]},
        "peak_device_gib": peak_gib,
        "splits_equal_cpu": agree, "splits_total": int(f.splits.size)}}))

    # kernel timings at the path's shapes
    seg_rows = []
    for name, v, ids, nseg, _ in seg_cases[:2]:
        t_, n_ = v.shape
        red = torch.where((ids >= 0) & (ids < nseg), ids, nseg).long()
        for op in ("sum", "max"):
            ms, host = cuda_ms(
                lambda: segment_reduce_batched(v, ids, nseg, op=op), 200)
            pms, phost = cuda_ms(
                lambda: segment_reduce_ref(v, ids, nseg, op=op), 100)
            # yardstick only (the port never calls it): one scatter into
            # C + 1 buckets, the last taking the out-of-range ids
            fill, how = (0.0, "sum") if op == "sum" else (float("-inf"),
                                                          "amax")

            def lib():
                return torch.full((t_, nseg + 1), fill, device=dev) \
                    .scatter_reduce_(1, red, v, how,
                                     include_self=False)[:, :nseg]

            lib_err = (lib() - segment_reduce_ref(v, ids, nseg, op=op)
                       ).abs().max().item()
            lms, lhost = cuda_ms(lib, 200)
            b_ms, by = bound(4 * (2 * v.numel() + t_ * nseg),
                             v.numel() * nseg)
            seg_rows.append({
                "shape": [t_, n_, nseg], "op": op, "use": name,
                "count": T if (name, op) == ("period", "sum") else 0,
                "count_maxsinr": T if name == "period" else 0, "ms": ms,
                "plain_ms": pms, "bound_ms": b_ms,
                "bound_by": by, "library_ms": lms, "host_ms": host,
                "plain_host_ms": phost, "library_host_ms": lhost,
                "library_max_abs_err": lib_err})
    main_row = seg_rows[0]  # sum at (1, 1024): the pf path's launch
    path_t, fixed_t = segsum_timed(dev, floor)  # SEGSUM_TIMED's two

    if "--profile" in argv:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_run:
            run()
        wall = time.perf_counter() - t0
        avg = prof_run.key_averages()
        device_s = sum(e.self_device_time_total for e in avg
                       if e.device_type == DeviceType.CUDA) / 1e6
        busy = device_s / float(np.median(warm_s))
        print(f"profiled cells run: {wall:.3f} s wall, device time "
              f"{device_s * 1e3:.2f} ms ({busy:.1%} of the warm run's "
              "median)")
        print(avg.table(sort_by="self_cuda_time_total", row_limit=20))
    return [
        {"name": "segsum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segsum.cu",
         "replaces": "src/repro/kernels/segsum/kernel.py:57",
         "launches": launches["segsum"], "max_abs_err": seg_err,
         "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
         "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
         "library_ms": main_row["library_ms"], "host_ms": main_row["host_ms"],
         "plain_host_ms": main_row["plain_host_ms"],
         "design_floor_ms": floor["empty_pdl_ms"], "floor": floor,
         "behind_op_ms": path_t["behind_op_ms"],
         "fixed_ms": fixed_t["ms"], "fixed": fixed_t,
         "routes": {"pf": seg_routes, "maxsinr": seg_routes_mx},
         "per": f"one launch at the pf scheduler's shape (1, {n}) -> {C}, "
               f"{T} a run; shapes: each op at both path shapes; design "
               "floor: an empty kernel launched as the vec4 route is (with "
               "programmatic dependent launch), back to back (floor: also "
               "plainly, and behind one torch op); fixed: a launch at (1, "
               "32) -> 1",
         "shapes": seg_rows},
        {**ssd_rows[0], "route": "fused",
         "source": "src/repro_torch/kernels/csrc/ssd.cu",
         "device_launches_per_call": 1, "path": "cells",
         "launches": launches["ssd"], "max_abs_err": ssd_err[0],
         "state_max_abs_err": ssd_err[1], "library_ms": None,
         "library": "none (no one call)", "shapes": ssd_rows[1:]},
    ]


def qmm_rows(dev, mm_shapes: Counter, g) -> list:
    """qmm at every (m, n, k) of one int8 run, on seeded random codes: bit-
    equal to its plain version (checked), the route its wrapper picks, its
    time (and, at the fc's K, its time with the L2 flushed before each
    call) beside its bound, the plain version's and cuBLAS int8's."""
    from repro_torch.kernels.qmm import card_fit, plan, qmm, qmm_ref

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    fit = card_fit(dev.index or 0)
    rows = []
    for (m, n, k), count in sorted(mm_shapes.items()):
        xq, wq = codes(m, k), codes(n, k)
        sx = torch.rand((m, 1), generator=g, device=dev) + 0.01
        sw = torch.rand((n, 1), generator=g, device=dev) + 0.01
        got = qmm(xq, sx, wq, sw)
        torch.cuda.synchronize()
        check(torch.equal(got, qmm_ref(xq, sx, wq, sw)),
              f"qmm bit-equal to plain at {(m, n, k)} on random codes")
        route, per, splits, cluster = plan(m, n, k, fit)
        ops = device_ops(lambda: qmm(xq, sx, wq, sw))
        check(ops == ["KERNEL"], f"qmm one kernel and no other device op a "
              f"call at {(m, n, k)} ({ops})")
        ms, host = cuda_ms(lambda: qmm(xq, sx, wq, sw), 50)
        pms, phost = cuda_ms(lambda: qmm_ref(xq, sx, wq, sw), 20)
        # yardstick only (the port never calls it): cuBLAS int8 -> int32
        # through torch._int_mm, K and N zero-padded to multiples of 8
        # beforehand, then the two scale multiplies
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        xp = torch.zeros((m, kp), dtype=torch.int8, device=dev)
        xp[:, :k] = xq
        wp = torch.zeros((np_, kp), dtype=torch.int8, device=dev)
        wp[:n, :k] = wq

        def lib_mm():
            return (torch._int_mm(xp, wp.t())[:, :n].to(torch.float32)
                    * sx * sw.T)

        lib_eq = torch.equal(lib_mm(), qmm_ref(xq, sx, wq, sw))
        lms, lhost = cuda_ms(lib_mm, 50)
        b_ms, by = bound(m * k + n * k + 4 * (m + n) + 4 * m * n,
                         2 * m * n, 2 * m * n * k)
        # clusters of this size the card runs at once (cudaOccupancy-
        # MaxActiveClusters), which bounds the plan's wave
        row = {"shape": [m, n, k], "count": count, "route": route,
               "k_tiles_a_split": per, "splits": splits, "cluster": cluster,
               "clusters_at_once": fit(cluster) if route == "wgmma" else None,
               "ms": ms,
               "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
               "library_ms": lms, "host_ms": host, "plain_host_ms": phost,
               "library_host_ms": lhost, "library_bit_equal": lib_eq}
        if k > 4096:  # the fc: its 38 MB of operands fit in the L2
            row["cold_l2_ms"] = cold_ms(lambda: qmm(xq, sx, wq, sw), 20)
            row["library_cold_l2_ms"] = cold_ms(lib_mm, 20)
        rows.append(row)
        print(f"qmm {(m, n, k)} x{count} route {route} ({splits} splits): "
              f"{ms:.5f} ms, cold L2 {row.get('cold_l2_ms', 'n/a')}; bound "
              f"{b_ms:.5f} ({by}); torch._int_mm {lms:.5f}")
        del xq, wq, xp, wp
    return rows


def fc_pass_rows(e) -> int:
    """Rows a pass of the estimator's CNN trunk (its CNN_CHUNK_BYTES cap)."""
    from repro_torch.estimator.model import CNN_CHUNK_BYTES
    return max(1, CNN_CHUNK_BYTES // (4 * e.cnn_ch[0] * e.n_sc * e.n_sym))


def pairwise_work(n: int, d: int) -> tuple[int, int]:
    """(bytes, flops) of one pairwise-distance call: x read once and the
    (n, n) distances written once (f32); the Gram x x^T, which is
    symmetric, so one multiply-add for each of its n (n + 1) / 2 distinct
    pairs and d columns."""
    return 4 * (n * d + n * n), n * (n + 1) * d


def pairwise_checks(dev, g) -> tuple[float, float]:
    """pairwise_dists against its plain version at PAIRWISE_CHECKS, on
    non-negative rows as after a ReLU: diagonal exactly 0, symmetric and
    repeatable bit for bit, squared distances within DIST_RTOL; one device
    op a call. Returns (max |err|, max relative squared-distance error)."""
    from repro_torch.kernels.dcor import pairwise_dists, pairwise_dists_ref
    dist_err, dist_rel = 0.0, 0.0
    for rows, d in PAIRWISE_CHECKS:
        x = torch.rand((rows, d), generator=g, device=dev)
        got = pairwise_dists(x)
        again = pairwise_dists(x)
        torch.cuda.synchronize()
        want = pairwise_dists_ref(x)
        check(torch.equal(torch.diagonal(got), torch.zeros(rows, device=dev)),
              f"pairwise_dists diagonal exactly 0 at {(rows, d)}")
        check(torch.equal(got, got.T) and torch.equal(got, again),
              f"pairwise_dists symmetric and repeatable at {(rows, d)}")
        sq = (x.double() ** 2).sum(1)
        rel = float(((got.double() ** 2 - want.double() ** 2).abs()
                     / (sq[:, None] + sq[None, :])).max())
        check(rel <= DIST_RTOL, f"pairwise_dists squared distances within "
              f"{DIST_RTOL} of the rows' squared norms at {(rows, d)} "
              f"({rel:.3g})")
        ops = device_ops(lambda: pairwise_dists(x))
        check(ops == ["KERNEL"], f"pairwise_dists one kernel and no other "
              f"device op a call at {(rows, d)} ({ops})")
        dist_rel = max(dist_rel, rel)
        dist_err = max(dist_err, float((got - want).abs().max()))
        del x, got, again, want
    print(f"pairwise_dists vs plain at {PAIRWISE_CHECKS}: diagonal 0, "
          f"symmetric and repeatable bit for bit, one launch a call; max "
          f"|d2 err| / (|x_i|^2 + |x_j|^2) {dist_rel:.3g} (bound "
          f"{DIST_RTOL}), max |err| {dist_err:.3g}")
    return dist_err, dist_rel


def pairwise_rows(dev, g) -> list:
    """pairwise_dists at every (n, d) of one profile run (48 images: the
    input, 43 times, and the 43 activations), each timed alone beside its
    bound, the plain version's and ``torch.cdist``'s time."""
    from repro_torch.kernels.dcor import (card_fit, pairwise_dists,
                                          pairwise_dists_ref, plan)
    from repro_torch.models.vgg import FULL, _shapes
    n = SPLIT_IMAGES
    fit = card_fit(dev.index or 0)
    widths = Counter([int(np.prod(s)) for s in _shapes(FULL)])
    widths[FULL.image_size ** 2 * 3] += len(_shapes(FULL))  # the input
    rows = []
    for d, count in sorted(widths.items()):
        x = torch.rand((n, d), generator=g, device=dev)
        ms, host = cuda_ms(lambda: pairwise_dists(x), 20)
        pms, phost = cuda_ms(lambda: pairwise_dists_ref(x), 10)
        # yardstick only (the port never calls it): one cdist call, whose
        # diagonal is not pinned to 0
        lms, lhost = cuda_ms(lambda: torch.cdist(
            x, x, compute_mode="use_mm_for_euclid_dist"), 10)
        b_ms, by = bound(*pairwise_work(n, d))
        route, tiles, chunk, splits, cluster = plan(n, d, fit)
        rows.append({"shape": [n, d], "count": count, "route": route,
                     "chunk": chunk, "splits": splits, "cluster": cluster,
                     "clusters_at_once": (fit(cluster, tiles > 1)
                                          if route == "splits" else None),
                     "ms": ms,
                     "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": lms, "host_ms": host,
                     "plain_host_ms": phost, "library_host_ms": lhost})
        print(f"pairwise_dists {(n, d)} x{count} route {route} ({splits} "
              f"splits, clusters of {cluster}): {ms:.5f} ms, bound "
              f"{b_ms:.5f} ({by}), {b_ms / ms:.0%} of it; host {host:.4f}")
        del x
    return rows


def split_path(dev, argv) -> tuple[dict, dict]:
    """The paper's split-computing loop with a measured privacy profile, at
    VGG16's full width (224 px, 48 images): the forward at all 43 split
    points, dCor(input, activation) through the pairwise-distance kernel,
    the profile and PSO table, then split inference at four throughputs
    through each boundary codec (the quantize kernel at qmax 127 and 7).
    The kernel against its plain version, the path's runs with their
    launch counts (cold, then three warm), the card against the port on
    the CPU, head/tail against the full forward, timings and the
    ``e2e_split`` line. Returns the pairwise_dists row of the kernels line
    and the quantize kernel's boundary timings."""
    from repro_torch.core import boundary
    from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE
    from repro_torch.core.objective import Constraints, Weights
    from repro_torch.core.privacy import layer_privacy_profile
    from repro_torch.core.pso import NO_SPLIT, pso_vectorized
    from repro_torch.core.splitting import (vgg_head, vgg_split_infer,
                                            vgg_tail)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.dcor import dcor_kernel
    from repro_torch.kernels.quant import quantize, quantize_ref
    from repro_torch.kernels.quant import route as quant_route
    from repro_torch.models.vgg import FULL, _shapes, forward, init_vgg, \
        layout, vgg_split_profile

    n, m = SPLIT_IMAGES, SPLIT_CPU_IMAGES
    codecs = (boundary.FP16, boundary.INT8, boundary.INT4)
    t0 = time.perf_counter()
    params = init_vgg(FULL, torch.Generator().manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED)  # fig5's textured inputs
    xs = np.cumsum(np.cumsum(rng.normal(size=(
        n, FULL.image_size, FULL.image_size, 3)), 1), 2)
    xs = (xs * 0.05).astype(np.float32)
    print(f"split setup: VGG16 FULL (224 px, 138 M parameters) seeded, {n} "
          f"textured images: {time.perf_counter() - t0:.2f} s")

    g = torch.Generator(device=dev).manual_seed(SEED)
    dist_err, dist_rel = pairwise_checks(dev, g)

    # the path
    def run():
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acts = forward(FULL, params, xs, collect=True, device=dev)
        torch.cuda.synchronize()
        stages["forward"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        x_in = acts[0].reshape(n, -1)  # op 'input': the images on the card
        priv = torch.stack([dcor_kernel(x_in, a.reshape(n, -1))
                            for a in acts]).cpu().numpy().astype(np.float64)
        stages["dcor_43"] = time.perf_counter() - t0
        del acts, x_in
        t0 = time.perf_counter()
        prof = vgg_split_profile(FULL, privacy=priv)
        table = pso_vectorized(prof, UE_VM_2CORE, EDGE_A40X2,
                               Weights(1.0, 0.15, 0.1),
                               Constraints(rho_max=0.92, tau_max_s=6.0,
                                           e_max_j=40.0), 130)
        splits = {tp: table.query(tp) for tp in SPLIT_TPS}
        stages["profile_pso"] = time.perf_counter() - t0
        outs = {}
        for codec in codecs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for tp in SPLIT_TPS:
                outs[tp, codec.name] = vgg_split_infer(
                    FULL, params, xs[:m], splits[tp], codec, device=dev)
            torch.cuda.synchronize()
            stages[f"split_infer_{codec.name}"] = time.perf_counter() - t0
        return priv, table, splits, outs, stages

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    priv, table, splits, outs, _ = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_quant = 2 * len(SPLIT_TPS)  # INT8 and INT4 at each throughput
    check(launches["pairwise_dists"] == 2 * 43,
          f"86 pairwise_dists launches, two a dCor ({launches})")
    check(launches["quantize"] == n_quant,
          f"{n_quant} quantize launches ({launches})")
    check(all(v == 0 for k, v in launches.items()
              if k not in ("pairwise_dists", "quantize")),
          f"the split path runs no other kernel ({launches})")
    check(bool(np.isfinite(priv).all()) and priv.shape == (43,)
          and bool(((priv >= 0) & (priv <= 1 + 1e-6)).all()),
          "43 finite dCor values in [0, 1]")
    check(abs(priv[0] - 1.0) < 1e-5, f"split 1 (the input) has dCor 1 "
          f"({priv[0]!r})")
    check(any(l != NO_SPLIT for l in splits.values()),
          f"the measured table picks a split ({splits})")
    for key, out in outs.items():
        check(out.shape == (m, FULL.num_classes)
              and bool(torch.isfinite(out).all())
              and bool(torch.allclose(out.sum(-1), torch.ones(m, device=dev),
                                      atol=1e-5)),
              f"split inference {key}: finite probabilities of shape "
              f"{(m, FULL.num_classes)}")
    warm, warm_stages = [], []
    for _ in range(3):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_, _, s_, _, st = run()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        warm_stages.append(st)
        check(dict(LAUNCHES) == launches and s_ == splits
              and np.allclose(p_, priv, rtol=0.0, atol=1e-6),
              "a warm run repeats the first")

    # dcor_kernel against the plain profile, on the card
    acts = forward(FULL, params, xs, collect=True, device=dev)
    plain = layer_privacy_profile(acts[0], acts).cpu().numpy()
    del acts
    kern_vs_plain = float(np.abs(priv - plain).max())
    check(kern_vs_plain <= DCOR_ATOL, f"dcor_kernel within {DCOR_ATOL} of "
          f"layer_privacy_profile on the card ({kern_vs_plain:.3g})")

    # the card against the port on the CPU, first m images: every
    # activation, relative to its largest magnitude, then dCor
    cpu_params = {k: v.cpu() for k, v in params.items()}
    t0 = time.perf_counter()
    cacts = forward(FULL, cpu_params, xs[:m], collect=True, device="cpu")
    gacts = forward(FULL, params, xs[:m], collect=True, device=dev)
    act_rel = [float((a.cpu() - c).abs().max() / c.abs().max())
               for a, c in zip(gacts, cacts)]
    worst = int(np.argmax(act_rel))
    check(act_rel[worst] <= ACT_RTOL, f"card activations within {ACT_RTOL} "
          f"of the CPU's, relative to each one's largest magnitude (split "
          f"{worst + 1}: {act_rel[worst]:.3g})")
    cpu_priv = layer_privacy_profile(cacts[0], cacts).numpy()
    del cacts
    card_priv = torch.stack([dcor_kernel(gacts[0].reshape(m, -1),
                                         a.reshape(m, -1)) for a in gacts]
                            ).cpu().numpy()
    del gacts
    card_vs_cpu = float(np.abs(card_priv - cpu_priv).max())
    check(card_vs_cpu <= DCOR_ATOL, f"card dCor ({m} images, kernel) within "
          f"{DCOR_ATOL} of the CPU port's ({card_vs_cpu:.3g})")
    # split inference: the probabilities of the whole path, then the codec
    # and the tail up to the logits (ops [l, softmax)) on the card's head
    # activation, so that both devices code the same values
    logits_op = [kind for kind, _ in layout(FULL.num_classes)].index(
        "softmax")
    infer_err, logit_rel = 0.0, 0.0
    for (tp, name), out in outs.items():
        codec, l = getattr(boundary, name.upper()), splits[tp]
        cpu_out = vgg_split_infer(FULL, cpu_params, xs[:m], l, codec,
                                  device="cpu")
        err = float((out.cpu() - cpu_out).abs().max())
        check(err <= INFER_ATOL and torch.equal(out.cpu().argmax(1),
                                                cpu_out.argmax(1)),
              f"split inference at {tp} Mbps (split {l + 1}, {name}) card "
              f"vs CPU within {INFER_ATOL}, same classes ({err:.3g})")
        infer_err = max(infer_err, err)
        head = vgg_head(FULL, params, xs[:m], l, device=dev)
        sent = boundary.roundtrip(head, codec)
        cpu_sent = boundary.roundtrip(head.cpu(), codec)
        check(torch.equal(sent.cpu(), cpu_sent), f"{name} round trip at "
              f"split {l + 1} on the card bit-equal to the CPU's")
        if l < logits_op:  # else the codec comes after the logits
            logits = forward(FULL, params, sent, start=l, stop=logits_op,
                             device=dev).cpu()
            cpu_logits = forward(FULL, cpu_params, cpu_sent, start=l,
                                 stop=logits_op, device="cpu")
            rel = float((logits - cpu_logits).abs().max()
                        / cpu_logits.abs().max())
            check(rel <= ACT_RTOL, f"split inference logits at {tp} Mbps "
                  f"(split {l + 1}, {name}) card vs CPU within {ACT_RTOL} "
                  f"of their largest magnitude ({rel:.3g})")
            logit_rel = max(logit_rel, rel)
    cpu_s = time.perf_counter() - t0
    del cpu_params

    # head/tail with no codec against the full forward, on the card
    full = forward(FULL, params, xs[:m], device=dev)
    head_err = 0.0
    for l in HEAD_TAIL_SPLITS:
        out = vgg_tail(FULL, params, vgg_head(FULL, params, xs[:m], l,
                                              device=dev), l, device=dev)
        check(torch.allclose(out, full, rtol=1e-4, atol=1e-5),
              f"head/tail at split {l} equals the full forward")
        head_err = max(head_err, float((out - full).abs().max()))
    print(f"split path: forward of {n} images at {FULL.image_size} px, 43 "
          f"dCor through the kernel, PSO, split inference of {m} images at "
          f"{dict(splits)} (TP -> split, 0-based) x {[c.name for c in codecs]}"
          f"; launches {launches}; dcor_kernel vs plain on the card max "
          f"{kern_vs_plain:.3g}; card vs CPU ({m} images, {cpu_s:.1f} s on "
          f"the CPU): activations max {act_rel[worst]:.3g} relative, dCor "
          f"max {card_vs_cpu:.3g}, split inference max {infer_err:.3g}, its "
          f"logits max {logit_rel:.3g} relative; head/tail at {HEAD_TAIL_SPLITS} vs full max "
          f"{head_err:.3g}; peak device memory {peak_gib:.2f} GiB; first run "
          f"{first_s:.3f} s")

    stages = {k: float(np.median([st[k] for st in warm_stages]))
              for k in warm_stages[0]}
    profile_s = [st["forward"] + st["dcor_43"] + st["profile_pso"]
                 for st in warm_stages]
    print(json.dumps({"e2e_split": {
        "images": n, "first_s": first_s, "warm_s": warm,
        "images_per_s": n / float(np.median(profile_s)),
        "profile_warm_s": profile_s, "stages_s": stages,
        "launches": {"pairwise_dists": launches["pairwise_dists"],
                     "quantize": launches["quantize"]},
        "peak_device_gib": peak_gib, "privacy": priv.tolist(),
        "split_by_tp": {str(tp): l for tp, l in splits.items()},
        "dcor_kernel_vs_plain": kern_vs_plain,
        "activations_card_vs_cpu_rel": act_rel[worst],
        "dcor_card_vs_cpu": card_vs_cpu,
        "split_infer_card_vs_cpu": infer_err,
        "split_logits_card_vs_cpu_rel": logit_rel,
        "head_tail_vs_full": head_err,
        "pairwise_dists_rel_d2": dist_rel}}))

    rows = pairwise_rows(dev, g)
    tot = shape_totals(rows)
    largest = max(rows, key=lambda r: r["shape"][1])

    # the quantize kernel at the boundary's shapes: the head's activation
    # of the first m images at each split the table picked, as (rows, C)
    shapes = _shapes(FULL)
    qrows = []
    for l in sorted(set(splits.values())):
        sh = shapes[l - 1] if l > 0 else xs.shape[1:]
        nd = (m * int(np.prod(sh[:-1])), int(sh[-1]))
        x = torch.rand(nd, generator=g, device=dev) * 2.0 - 1.0
        for qmax in (127, 7):
            q, s = quantize(x, qmax)
            torch.cuda.synchronize()
            rq, rs = quantize_ref(x, qmax)
            check(torch.equal(q, rq) and torch.equal(s, rs),
                  f"quantize bit-equal to plain at {nd}, qmax {qmax}")
            ms, host = cuda_ms(lambda: quantize(x, qmax), 50)
            pms, phost = cuda_ms(lambda: quantize_ref(x, qmax), 20)
            b_ms, by = bound(5 * nd[0] * nd[1] + 4 * nd[0],
                             5 * nd[0] * nd[1])
            qrows.append({"shape": list(nd), "qmax": qmax, "split": l,
                          "route": quant_route(*nd, x.dtype,
                                               x.data_ptr() % 16 == 0),
                          "count": sum(1 for v in splits.values() if v == l),
                          "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                          "bound_by": by, "host_ms": host,
                          "plain_host_ms": phost})
    print(f"quantize vs plain at the boundary's shapes "
          f"{sorted({tuple(r['shape']) for r in qrows})}: bit-equal at qmax "
          f"127 and 7")

    if "--profile" in argv:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_run:
            run()
        wall = time.perf_counter() - t0
        avg = prof_run.key_averages()
        device_s = sum(e.self_device_time_total for e in avg
                       if e.device_type == DeviceType.CUDA) / 1e6
        print(f"profiled split run: {wall:.3f} s wall, device time "
              f"{device_s * 1e3:.2f} ms ({device_s / float(np.median(warm)):.1%}"
              " of the warm run's median)")
        print(avg.table(sort_by="self_cuda_time_total", row_limit=25))

    row = {"name": "pairwise_dists", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dcor.cu",
           "replaces": "src/repro/kernels/dcor/kernel.py:49",
           "launches": launches["pairwise_dists"], "max_abs_err": dist_err,
           "max_rel_d2_err": dist_rel, "ms": tot["ms"],
           "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
           "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
           "host_ms": tot["host_ms"], "plain_host_ms": tot["plain_host_ms"],
           "per": f"one profile run ({2 * 43} launches at n = {n}): the sum "
                  "over its launches, each shape timed alone",
           "largest": largest, "shapes": rows}
    return row, {"launches_split": launches["quantize"],
                 "boundary_shapes": qrows}

def ulp_close(got, want, f32_rtol: float) -> tuple[bool, float, float]:
    """(within the bound, max |err|, the largest error over its bound):
    f32 within ``f32_rtol`` of max|want|; bf16 each element within one
    bf16 ulp of its own magnitude over a floor of 1e-5 of max|want| (see
    ATTN_RTOL, SSD_RTOL)."""
    err = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    if want.dtype == torch.float32:
        worst = float(err.max()) / (f32_rtol * top)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(1e-30))) - 7)
        worst = float((err / (ulp + 1e-5 * top)).max())
    return worst <= 1.0, float(err.max()), worst


def attention_work(bh: int, s: int, dh: int, nbytes_el: int,
                   causal: bool, window: int = 0) -> tuple[int, int]:
    """(bytes, flops) of one attention call: q, k, v read once and o
    written once; Q.K^T and P.V, 2 dh multiply-adds a (query, key) pair
    the masks keep (causal: the s (s + 1) / 2 pairs i >= j; a window w:
    i - j < w of them)."""
    if not causal:
        pairs = s * s
    else:
        w = min(window or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    return 4 * bh * s * dh * nbytes_el, bh * pairs * dh * 2 * 2


def sdpa_row(q, k, v, want, causal: bool, window: int) -> dict:
    """A yardstick only (the port never calls it): PyTorch's
    ``scaled_dot_product_attention`` on the same (BH, S, dh) tensors as
    (LM_BATCH, heads, S, dh), ``is_causal`` without a window and a boolean
    mask of the window's pairs with one, timed, and its largest
    difference from the plain version."""
    bh, s, dh = q.shape
    q4, k4, v4 = (t.view(LM_BATCH, bh // LM_BATCH, s, dh) for t in (q, k, v))
    kw = {"is_causal": causal}
    if window:
        i = torch.arange(s, device=q.device)
        kw = {"attn_mask": (i[:, None] >= i[None, :])
              & (i[:, None] - i[None, :] < window)}

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, **kw)

    err = float((sdpa().reshape(bh, s, dh).float() - want.float()).abs()
                .max())
    ms, host = cuda_ms(sdpa, 10)
    return {"library_ms": ms, "library_host_ms": host,
            "library_max_abs_err": err,
            "library": "scaled_dot_product_attention, "
                       + ("boolean window mask" if window else
                          "is_causal" if causal else "no mask")}


def attention_kernel(dev) -> tuple[list, dict]:
    """flash_attention against its plain version at every ATTN_CHECKS case,
    then timed at the LM path's shape (the first case) beside its plain
    version and PyTorch's fused attention. Returns the checks' rows and the
    timings."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    g = torch.Generator(device=dev).manual_seed(SEED)
    attn_rows = []
    for bh, s, dh, dt, causal, window in ATTN_CHECKS:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((bh, s, dh), generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()

        def plain():
            return torch.cat([attention_ref(
                q[i:i + ATTN_REF_HEADS], k[i:i + ATTN_REF_HEADS],
                v[i:i + ATTN_REF_HEADS], causal=causal, window=window)
                for i in range(0, bh, ATTN_REF_HEADS)])

        want = plain()
        ok, err, worst = ulp_close(got, want, ATTN_RTOL)
        case = (bh, s, dh, dt, causal, window)
        check(ok and bool(torch.isfinite(got).all()),
              f"flash_attention within its bound of plain at {case} "
              f"(max |err| {err:.3g}, {worst:.3g} of the bound)")
        row = {"case": list(case), "max_abs_err": err, "of_bound": worst}
        if case in ATTN_PATH_SHAPES.values():  # timed beside its bound
            row["path"] = next(a for a, c in ATTN_PATH_SHAPES.items()
                               if c == case)
            row["ms"], row["host_ms"] = cuda_ms(lambda: flash_attention(
                q, k, v, causal=causal, window=window), 10)
            nb, fl = attention_work(bh, s, dh, 2, causal, window)
            row["bound_ms"], row["bound_by"] = bound(nb, 0.0, bf16_ops=fl)
            row["plain_ms"], _ = cuda_ms(plain, 2)  # ATTN_REF_HEADS a call
            row.update(sdpa_row(q, k, v, want, causal, window))
        attn_rows.append(row)
        if len(attn_rows) == 1:
            path_in = (q, k, v)
        if case == ATTN_F32_TIMED:
            f32_in = (q, k, v)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    print(f"flash_attention vs plain: {attn_rows}")

    # timings at the path's shape: one launch of the 36 of a forward
    q, k, v = path_in
    bh, s, dh = q.shape
    ms, host = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    pms, phost = cuda_ms(lambda: attention_ref(q, k, v, causal=True), 2)
    # yardstick only (the port never calls it): PyTorch's fused attention
    # on the same tensors as (batch, heads, S, dh)
    q4, k4, v4 = (t.view(LM_BATCH, bh // LM_BATCH, s, dh) for t in path_in)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)

    lib_err = float((sdpa().reshape(bh, s, dh).float() - attention_ref(
        q, k, v, causal=True).float()).abs().max())
    lms, lhost = cuda_ms(sdpa, 20)
    nbytes, flops = attention_work(bh, s, dh, 2, True)
    b_ms, by = bound(nbytes, 0.0, bf16_ops=flops)
    # the bf16 kernel's own floor: Q.K^T once and P.V three times (P as
    # three bf16 pieces) on the tensor cores, twice the function's work
    floor_ms, _ = bound(0.0, 0.0, bf16_ops=2 * flops)
    del q, k, v, q4, k4, v4, path_in
    # the f32 kernel (FMAs on the CUDA cores), which no timed path runs, at
    # the largest f32 case beside its FP32 bound and SDPA in f32
    q, k, v = f32_in
    fbh, fs, fdh, _, fcausal, fwin = ATTN_F32_TIMED
    fms, fhost = cuda_ms(lambda: flash_attention(
        q, k, v, causal=fcausal, window=fwin), 20)
    fpms, _ = cuda_ms(lambda: attention_ref(
        q, k, v, causal=fcausal, window=fwin), 5)

    def sdpa32():
        return torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=fcausal)[0]

    flib_err = float((sdpa32() - attention_ref(
        q, k, v, causal=fcausal)).abs().max())
    flms, _ = cuda_ms(sdpa32, 20)
    fbytes, fflops = attention_work(fbh, fs, fdh, 4, fcausal)
    fb_ms, fby = bound(fbytes, fflops)
    f32 = {"shape": [fbh, fs, fdh], "causal": fcausal, "ms": fms,
           "plain_ms": fpms, "bound_ms": fb_ms, "bound_by": fby,
           "library_ms": flms, "library_max_abs_err": flib_err,
           "host_ms": fhost}
    del q, k, v, f32_in
    torch.cuda.empty_cache()
    timing = {"ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
              "design_floor_ms": floor_ms, "library_ms": lms,
              "host_ms": host, "plain_host_ms": phost,
              "library_host_ms": lhost, "library_max_abs_err": lib_err,
              "shape": [bh, s, dh], "f32": f32}
    print(f"flash_attention at {(bh, s, dh)} bf16 causal: {ms:.4f} ms "
          f"(bound {b_ms:.4f} ms, {by}; design floor {floor_ms:.4f} ms), "
          f"plain {pms:.3f} ms, SDPA {lms:.4f} ms; f32 at {(fbh, fs, fdh)}: "
          f"{fms:.4f} ms (bound {fb_ms:.4f} ms, {fby}), SDPA {flms:.4f} ms")
    return attn_rows, timing


def layer_specs(cfg) -> list:
    """The spec of every layer in order: the megablocks, then the
    remainder."""
    return [s for _ in range(cfg.n_full_patterns) for s in cfg.pattern] + \
        list(cfg.remainder)


def model_layers(cfg, *trees):
    """(spec, each tree's parameters of that layer) for every layer in
    order: the megablocks, then the remainder."""
    from repro_torch.models.template import tree_map
    for i in range(cfg.n_full_patterns):
        for j, spec in enumerate(cfg.pattern):
            yield (spec, *(tree_map(lambda t: t[i], tr["groups"][j])
                           for tr in trees))
    for j, spec in enumerate(cfg.remainder):
        yield (spec, *(tr["rem"][j] for tr in trees))


def draw_gates(cfg, params, g) -> None:
    """Every cross-attention gate of ``params`` drawn in [0.5, 1.5] from
    ``g``: the init is zeros, and tanh(0) = 0 would make each cross block
    output nothing."""
    blocks_ = [grp for s, grp in zip(cfg.pattern, params["groups"])
               if s.kind == "cross"]
    blocks_ += [p for s, p in zip(cfg.remainder, params["rem"])
                if s.kind == "cross"]
    for b in blocks_:
        gate = b["attn"]["gate"]
        gate.copy_(torch.rand(gate.shape, generator=g, device=gate.device)
                   + 0.5)


def attention_layer0(cfg, params, tokens, dev) -> dict:
    """flash_attention on the first self-attention layer's own q, k, v
    (batch 1; the blocks before it in megablock 0 run first) against its
    plain version, with the layer's window, in f32 (held; the bf16 inputs
    upcast exactly) and in bf16 (reported: the scores reach |s| ~ 1.5e3,
    so f32 rounding of a near tie moves a weight more than on random
    data)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     flatten_gqa)
    from repro_torch.models import blocks, lm
    from repro_torch.models.template import tree_map

    bf16 = torch.bfloat16
    j = next(i for i, s in enumerate(cfg.pattern)
             if s.kind in ("attn", "local"))
    window = cfg.pattern[j].window
    with torch.inference_mode():
        x = lm.embed_in(cfg, params, {"tokens": tokens[:1]}, bf16, dev)
        pos = torch.arange(LM_SEQ, device=dev)[None]
        for i in range(j):
            x = lm.apply_block(cfg, cfg.pattern[i], tree_map(
                lambda t: t[0], params["groups"][i]), x, positions=pos,
                dtype=bf16)
        p0 = tree_map(lambda t: t[0], params["groups"][j])["attn"]
        q, k, v = blocks.qkv_proj(cfg, p0, blocks.rms_norm(
            x, p0["ln"], cfg.norm_eps), dtype=bf16)
        qkv = flatten_gqa(blocks.rope(q, pos, cfg.rope_theta),
                          blocks.rope(k, pos, cfg.rope_theta), v)
        real = {"layer": j, "window": window}
        for dtype in (torch.float32, bf16):
            t3 = [t.to(dtype) for t in qkv]
            got = flash_attention(*t3, causal=True, window=window)
            want = attention_ref(*t3, causal=True, window=window)
            err = (got.float() - want.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(1e-30))) - 7)
            real[str(dtype).split(".")[-1]] = {
                "max_abs_err": float(err.max()),
                "rel_to_max": float(err.max() / want.float().abs().max()),
                "beyond_one_ulp": int((err > ulp).sum()),
                "max_score": float(torch.matmul(
                    t3[0][:8].float(), t3[1][:8].float().transpose(1, 2)
                ).abs().max()) * cfg.head_dim ** -0.5}
            del t3, got, want, err, ulp
    check(real["float32"]["rel_to_max"] <= ATTN_RTOL,
          f"flash_attention within {ATTN_RTOL} of max|o| of plain on layer "
          f"{j}'s q, k, v {tuple(qkv[0].shape)} in f32 ({real})")
    return real


def cache_diff(card: dict, cpu: dict, rtol: float) -> dict:
    """A block's decode cache on the card against the CPU's: f32 leaves'
    largest difference relative to the card leaf's largest magnitude; bf16
    leaves' largest difference over one bf16 ulp of each element plus
    ``rtol`` of that magnitude (a value rounded to bf16 from f32 sums in
    another order can land one ulp away); positions must be equal; int8
    codes are compared by their largest difference and the share that
    differ. Returns {"f32": rel, "bf16": of the bound, "pos_equal": bool,
    "codes_max": int, "codes_differ": share, "codes_n": count}."""
    from repro_torch.models.template import tree_map
    out = {"f32": 0.0, "bf16": 0.0, "pos_equal": True, "codes_max": 0,
           "codes_differ": 0, "codes_n": 0}
    leaves_g, leaves_c = [], []
    tree_map(leaves_g.append, card)
    tree_map(leaves_c.append, cpu)
    for g, c in zip(leaves_g, leaves_c):
        g = g.cpu()
        if g.dtype == torch.int32:
            out["pos_equal"] &= torch.equal(g, c)
        elif g.dtype == torch.int8:
            d = (g.int() - c.int()).abs()
            out["codes_max"] = max(out["codes_max"], int(d.max()))
            out["codes_differ"] += int((d > 0).sum())
            out["codes_n"] += d.numel()
        elif g.dtype == torch.float32:
            top = float(g.abs().max())
            out["f32"] = max(out["f32"], float((g - c).abs().max())
                             / max(top, 1e-30))
        else:
            err = (g.float() - c.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                g.float().abs().clamp_min(1e-30))) - 7)
            bound_ = ulp + rtol * float(g.float().abs().max())
            out["bf16"] = max(out["bf16"], float((err / bound_).max()))
    return out


def cut_check(cfg, dev, n_layers: int, tokens, vision,
              decode_steps: int = CUT_DECODE_STEPS,
              kv_dtypes=("bf16",)) -> tuple[dict, float]:
    """``cfg`` at full width cut to ``n_layers`` layers, batch 1, LM_CPU_SEQ
    tokens (and the first row of ``vision``), weights drawn on the card
    (cross gates nonzero) and copied bit for bit to the CPU, in f32 and in
    bf16. Each sublayer on one input: the mixer (attention, the RG-LRU or
    the SSD mixer) through the kernel on the card, through
    ``use_kernel=False`` on the card and through the port on the CPU (in
    f32 an attention sublayer also through the port on the CPU in
    float64, a referee both are reported against); the feed-forward on
    the card and on the CPU, both on the card's mixer output. A MoE's
    routing decisions (top_i and keep of every (token, k)) are compared
    between the card and the CPU, and its output held on the tokens whose
    decisions agree (an f32 near tie can flip one). Each mixer's prefill
    cache (room for ``decode_steps`` more tokens) is held against the
    CPU's (``cache_diff``). Then ``decode_steps`` teacher-forced decode
    steps, sublayer by sublayer: each mixer on the card's input and the
    card's cache, on the card and on the CPU (a copy of the card's cache),
    its output and updated cache held, then the feed-forward as above.
    Then the logits on one input; the end-to-end logits are reported.
    Each cache dtype of ``kv_dtypes`` is a pass of its own (the int8 KV
    cache's codes: within one code, the share that differ reported).
    Returns ({dtype: each comparison's largest difference relative to the
    card's output's largest magnitude, ...}, seconds on the CPU)."""
    import dataclasses

    from repro_torch.models import blocks, init_params, lm
    from repro_torch.models.template import tree_map

    tk = {"tokens": tokens[:1, :LM_CPU_SEQ]}
    if vision is not None:
        tk["vision"] = vision[:1]
    pos = torch.arange(LM_CPU_SEQ, dtype=torch.int32)[None]
    max_seq = LM_CPU_SEQ + decode_steps

    def rel(a, b, rows=None):
        a = a.double().cpu().reshape(-1, a.shape[-1])
        d = (b.double().cpu().reshape(a.shape) - a).abs()
        d = d if rows is None else d[rows]
        return float(d.max()) / float(a.abs().max()) if d.numel() else 0.0

    def ffn_pair(c2, pg, pcg, a, worst, moe, what):
        """The feed-forward on the card and on the CPU, both on the card's
        mixer output ``a``; a MoE's decisions compared and its output held
        on the tokens whose decisions agree."""
        nonlocal cpu_s
        y = lm.apply_ffn(c2, pg, a, dtype)
        t0 = time.perf_counter()
        y_cpu = lm.apply_ffn(c2, pcg, a.cpu(), dtype)
        cpu_s += time.perf_counter() - t0
        rows = None
        if c2.is_moe:
            r_g, r_c = (blocks.moe_route(c2, q["ffn"], blocks.rms_norm(
                t, q["ffn"]["ln"], c2.norm_eps))
                for q, t in ((pg, a), (pcg, a.cpu())))
            same = ((r_g["top_i"].cpu() == r_c["top_i"])
                    & (r_g["keep"].cpu() == r_c["keep"]))
            moe["decisions"] += same.numel()
            moe["differ"] += int((~same).sum())
            rows = same.all(-1).reshape(-1)
        worst[what] = max(worst[what], rel(y, y_cpu, rows))
        return y

    def held_cache(worst, diff, what):
        worst[what] = max(worst[what], diff["f32"])
        worst[what + "_bf16_of_bound"] = max(
            worst[what + "_bf16_of_bound"], diff["bf16"])
        worst["pos_equal"] &= diff["pos_equal"]
        for k_ in ("codes_max", "codes_differ", "codes_n"):
            worst[k_] = (max if k_ == "codes_max" else sum)(
                (worst[k_], diff[k_]))

    cut, cpu_s = {}, 0.0
    for kv in kv_dtypes:
        c2 = dataclasses.replace(cfg, n_layers=n_layers, kv_dtype=kv)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            rtol = LM_BLOCK_RTOL[name]
            if dtype == torch.float32:
                rtol = LM_BLOCK_RTOL_F32.get(cfg.name, rtol)
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            p2 = init_params(c2, g, device=dev, dtype=dtype)
            draw_gates(c2, p2, g)
            pc = tree_map(lambda t: t.cpu(), p2)  # the same bits
            vis, vis_c = lm.vision_in(tk, dev), lm.vision_in(tk, "cpu")
            worst = {"use_kernel_false": 0.0, "cpu": 0.0, "ffn_cpu": 0.0}
            if decode_steps:
                worst.update(
                    prefill_cache_cpu=0.0, prefill_cache_cpu_bf16_of_bound=0.0,
                    decode_cpu=0.0, decode_ffn_cpu=0.0, decode_cache_cpu=0.0,
                    decode_cache_cpu_bf16_of_bound=0.0, pos_equal=True,
                    codes_max=0, codes_differ=0, codes_n=0)
            attn = any(s_.kind in ("attn", "local", "cross")
                       for s_ in layer_specs(c2))
            if dtype == torch.float32 and attn:
                # each attention sublayer against a float64 referee
                worst.update(card_vs_f64=0.0, cpu_vs_f64=0.0)
            moe = {"decisions": 0, "differ": 0}
            caches, dec_logits = [], []
            with torch.inference_mode():
                x = lm.embed_in(c2, p2, tk, dtype, dev)
                for spec, pg, pcg in model_layers(c2, p2, pc):
                    kw = dict(positions=pos.to(dev), vision=vis, dtype=dtype)
                    a, cache_g = lm.apply_mixer(c2, spec, pg, x,
                                                max_seq=max_seq, **kw)
                    a_off = lm.apply_mixer(c2, spec, pg, x, use_kernel=False,
                                           **kw)
                    t0 = time.perf_counter()
                    a_cpu, cache_c = lm.apply_mixer(
                        c2, spec, pcg, x.cpu(), positions=pos, vision=vis_c,
                        dtype=dtype, max_seq=max_seq)
                    cpu_s += time.perf_counter() - t0
                    worst["use_kernel_false"] = max(
                        worst["use_kernel_false"], rel(a, a_off))
                    worst["cpu"] = max(worst["cpu"], rel(a, a_cpu))
                    if decode_steps:
                        held_cache(worst, cache_diff(cache_g, cache_c, rtol),
                                   "prefill_cache_cpu")
                        caches.append(cache_g)
                    if "card_vs_f64" in worst and spec.kind in (
                            "attn", "local", "cross"):
                        f64 = torch.float64
                        pd = tree_map(lambda t: t.to(f64), {
                            k_: v_ for k_, v_ in pcg.items() if k_ != "ffn"})
                        t0 = time.perf_counter()
                        a64 = lm.apply_mixer(
                            c2, spec, pd, x.cpu().to(f64), positions=pos,
                            vision=None if vis_c is None else vis_c.to(f64),
                            dtype=f64, use_kernel=False)
                        cpu_s += time.perf_counter() - t0
                        worst["card_vs_f64"] = max(worst["card_vs_f64"],
                                                   rel(a64, a))
                        worst["cpu_vs_f64"] = max(worst["cpu_vs_f64"],
                                                  rel(a64, a_cpu))
                        del pd, a64
                    if spec.kind == "ssd":  # the mixer is the block
                        x = a
                        continue
                    x = ffn_pair(c2, pg, pcg, a, worst, moe, "ffn_cpu")
                lg = lm.logits_out(c2, p2, x, dtype).float().cpu()
                lc = lm.logits_out(c2, pc, x.cpu(), dtype).float()
                worst["logits_cpu"] = float((lg - lc).abs().max()
                                            / lc.abs().max())
                ga = lm.forward(c2, p2, tk, device=dev).float().cpu()
                t0 = time.perf_counter()
                ca = lm.forward(c2, pc, tk, device="cpu").float()
                cpu_s += time.perf_counter() - t0
                for t in range(decode_steps):
                    at = LM_CPU_SEQ + t
                    x = lm.embed_in(c2, p2, {"tokens": tokens[:1, at:at + 1]},
                                    dtype, dev)
                    layers = model_layers(c2, p2, pc)
                    for (spec, pg, pcg), cache_g in zip(layers, caches):
                        cache_c = tree_map(lambda t_: t_.cpu().clone(),
                                           cache_g)
                        a = lm.decode_mixer(c2, spec, pg, x, cache_g, at,
                                            dtype=dtype)
                        t0 = time.perf_counter()
                        a_cpu = lm.decode_mixer(c2, spec, pcg, x.cpu(),
                                                cache_c, at, dtype=dtype)
                        cpu_s += time.perf_counter() - t0
                        worst["decode_cpu"] = max(worst["decode_cpu"],
                                                  rel(a, a_cpu))
                        held_cache(worst, cache_diff(cache_g, cache_c, rtol),
                                   "decode_cache_cpu")
                        if spec.kind == "ssd":
                            x = a
                            continue
                        x = ffn_pair(c2, pg, pcg, a, worst, moe,
                                     "decode_ffn_cpu")
                    dec_logits.append(lm.logits_out(c2, p2, x, dtype))
                if decode_steps:  # reported: against the forward over
                    # the prompt and the decode tokens (plain attention:
                    # any length)
                    n = LM_CPU_SEQ + decode_steps
                    fw = lm.forward(c2, p2, dict(tk, tokens=tokens[:1, :n]),
                                    dtype=dtype, use_kernel=False,
                                    device=dev)[:, LM_CPU_SEQ:].float()
                    dl = torch.cat(dec_logits, 1).float()
                    worst["decode_vs_forward_rel"] = float(
                        (dl - fw).abs().max() / fw.abs().max())
                    worst["decode_argmax_equal_forward"] = float(
                        (dl.argmax(-1) == fw.argmax(-1)).float().mean())
            key = name if kv == "bf16" else f"{name}_kv_{kv}"
            cut[key] = dict(worst, end_to_end_cpu_rel=float(
                (ga - ca).abs().max() / ca.abs().max()),
                argmax_equal=float((ga.argmax(-1) == ca.argmax(-1)).float()
                                   .mean()),
                last_token_equal=int(ga[0, -1].argmax()) == int(
                    ca[0, -1].argmax()))
            if c2.is_moe:
                cut[key]["moe_decisions"] = dict(
                    moe, share_differ=moe["differ"] / moe["decisions"])
            del p2, pc, x, caches
            torch.cuda.empty_cache()
            print(f"{cfg.name} at full width, {n_layers} layers, {key}, card "
                  f"vs CPU: {cut[key]} ({cpu_s:.1f} s on the CPU so far)")
            check_cut(cfg.name, n_layers, key, cut[key], rtol, c2.is_moe)
    return cut, cpu_s


def check_cut(arch: str, n_layers: int, key: str, res: dict, rtol: float,
              is_moe: bool) -> None:
    """cut_check's bounds on one (dtype, cache dtype) pass: every
    sublayer, the logits and the float cache leaves within ``rtol`` of
    their largest magnitude (bf16 leaves within one bf16 ulp of each
    element over it), positions equal, int8 codes within one, and a MoE's
    card and CPU decisions differing on at most MOE_DECISIONS_DIFFER."""
    for what in ("use_kernel_false", "cpu", "ffn_cpu", "logits_cpu",
                 "prefill_cache_cpu", "decode_cpu", "decode_ffn_cpu",
                 "decode_cache_cpu"):
        bound_ = rtol
        if what == "decode_cpu" and key.startswith("float32"):
            bound_ = max(rtol, LM_DECODE_RTOL_F32)
        if what in res:
            check(res[what] <= bound_, f"{arch}, {key}, {n_layers} layers "
                  f"at full width: each sublayer's (or the logits' or the "
                  f"cache's) {what.replace('_', ' ')} within {bound_} of "
                  f"its largest magnitude ({res[what]:.3g})")
    for what in ("prefill_cache_cpu_bf16_of_bound",
                 "decode_cache_cpu_bf16_of_bound"):
        if what in res:
            check(res[what] <= 1.0, f"{arch}, {key}: the bf16 cache leaves "
                  f"card vs CPU within one bf16 ulp of each element over "
                  f"{rtol} of the largest magnitude ({res[what]:.3g} of it)")
    if "pos_equal" in res:
        check(res["pos_equal"] and res["codes_max"] <= 1, f"{arch}, {key}: "
              f"the cache positions equal on the card and the CPU, int8 "
              f"codes within one ({res['codes_max']})")
    if is_moe:
        share = res["moe_decisions"]["share_differ"]
        check(share <= MOE_DECISIONS_DIFFER, f"{arch}, {key}: the card's "
              f"and the CPU's routing decisions differ on {share:.3%} of "
              f"(token, k), at most {MOE_DECISIONS_DIFFER:.0%}")


# every decode run's rows of the e2e_decode line, and every decode run's
# kernel launches (prefills excluded), added up for the kernels line
E2E_DECODE: list = []
DECODE_LAUNCHES: Counter = Counter()


def ring_positions(W: int, last: int, dev) -> torch.Tensor:
    """The positions a ring of W slots holds once positions 0..last are
    written, position p in slot p % W (-1 where none was)."""
    p = torch.arange(max(0, last - W + 1), last + 1, device=dev)
    want = torch.full((W,), -1, dtype=torch.int32, device=dev)
    want[p % W] = p.to(torch.int32)
    return want


def rings_hold(cfg, cache, last: int, dev) -> bool:
    """Every self-attention ring of ``cache`` holds exactly the positions
    it must once positions 0..last are written."""
    rings = [grp["attn"]["pos"] for spec, grp in zip(cfg.pattern,
                                                      cache["groups"])
             if spec.kind in ("attn", "local")]
    rings += [c["attn"]["pos"][None] for spec, c in zip(cfg.remainder,
                                                        cache["rem"])
              if spec.kind in ("attn", "local")]
    return all(bool((r == ring_positions(r.shape[-1], last, dev)).all())
               for r in rings)


def kv_quant_rows(cfg, params, batch, dec, dev) -> list:
    """The quantize kernel at the int8 KV cache's shapes, on layer 0's
    own rope'd k and its v (a self-attention layer): the prefill's rows
    (LM_BATCH x LM_SEQ x kv heads, head_dim) and one decode step's
    (LM_BATCH x kv heads, head_dim), bit-equal to its plain version, and
    timed beside it and its bound."""
    from repro_torch.kernels.quant import quantize, quantize_ref
    from repro_torch.kernels.quant import route as quant_route
    from repro_torch.models import blocks, lm
    from repro_torch.models.template import tree_map

    bf16 = torch.bfloat16
    check(cfg.pattern[0].kind == "attn", "layer 0 is self-attention")
    p0 = tree_map(lambda t: t[0], params["groups"][0])["attn"]
    n_self = sum(s.kind in ("attn", "local") for s in layer_specs(cfg))
    rows = []
    with torch.inference_mode():
        for per, toks, start in (("prefill", batch["tokens"], 0),
                                 ("decode step", dec[:, :1], LM_SEQ)):
            x = lm.embed_in(cfg, params, {"tokens": toks}, bf16, dev)
            _, k, v = blocks.qkv_proj(cfg, p0, blocks.rms_norm(
                x, p0["ln"], cfg.norm_eps), dtype=bf16)
            at = torch.arange(start, start + x.shape[1], device=dev)[None]
            k = blocks.rope(k, at, cfg.rope_theta)
            for name, t in (("k", k), ("v", v)):
                r2 = t.reshape(-1, cfg.head_dim).contiguous()
                qq, qs = quantize(r2, 127)
                torch.cuda.synchronize()
                rq, rs = quantize_ref(r2, 127)
                check(torch.equal(qq, rq) and torch.equal(qs, rs),
                      f"quantize bit-equal to plain on {cfg.name}'s layer 0 "
                      f"{per} {name} rows {tuple(r2.shape)} (the int8 KV "
                      "cache)")
            n_, d_ = r2.shape
            qms, qhost = cuda_ms(lambda: quantize(r2, 127), 50)
            qpms, qphost = cuda_ms(lambda: quantize_ref(r2, 127), 10)
            qb_ms, qby = bound(3 * n_ * d_ + 4 * n_, 5 * n_ * d_)
            rows.append({"shape": [n_, d_], "dtype": "bfloat16", "qmax": 127,
                         "route": quant_route(n_, d_, r2.dtype,
                                              r2.data_ptr() % 16 == 0),
                         "count": 2 * n_self, "per": per, "ms": qms,
                         "plain_ms": qpms, "bound_ms": qb_ms,
                         "bound_by": qby, "host_ms": qhost,
                         "plain_host_ms": qphost, "path": cfg.name})
    return rows


def decode_lm(cfg, params, batch, whole, dev, smi: str, argv, kernel: str,
              n_kernel: int, *, steps: int, kv_dtypes) -> dict:
    """Prefill and decode of ``cfg`` on the card with each KV cache dtype
    of ``kv_dtypes``: ``lm.prefill`` of ``batch`` with room for ``steps``
    more tokens (cold, then two warm runs: ``kernel`` ``n_kernel`` times,
    quantize twice a self-attention layer with the int8 cache, no other
    kernel; the last logits bit-equal to ``whole``, the forward's; every
    self-attention ring holding exactly the prompt's last positions), then
    ``steps`` teacher-forced ``lm.decode_step`` calls (no flash_attention
    and no ssd, quantize twice a self-attention layer a step with the int8
    cache; finite logits; every ring slid by one a step), timed step by
    step; with ``--profile`` the device's busy share of four more steps.
    The decode logits against the forward over the prompt and the decode
    tokens are reported, not held (random weights amplify rounding). With
    the int8 cache, ``kv_quant_rows``. Returns {"rows": the e2e_decode
    rows, "kv_quant": quantize's KV-cache rows or []}."""
    import dataclasses

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.models.template import tree_map

    n_self = sum(s.kind in ("attn", "local") for s in layer_specs(cfg))
    max_seq = LM_SEQ + steps
    # the decode tokens; the forward runs over the prompt and them, padded
    # with more to a length the kernels take (flash_attention multiples of
    # 128, ssd of the full configs' 256-token chunk)
    ext = -(-(LM_SEQ + steps) // 256) * 256 - LM_SEQ
    dec = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (LM_BATCH, ext)).astype(np.int32)
    with torch.inference_mode():
        full = lm.forward(cfg, params, dict(batch, tokens=np.concatenate(
            [batch["tokens"], dec], 1)), device=dev)
        # a copy: .float() of f32 (softcap) logits would be a view that
        # keeps all of them
        want = full[:, LM_SEQ:LM_SEQ + steps].clone().float()
        del full
    torch.cuda.empty_cache()
    rows, kv_rows = [], []
    for kv in kv_dtypes:
        c = dataclasses.replace(cfg, kv_dtype=kv)
        what = f"{cfg.name}, {kv} KV cache"
        torch.cuda.reset_peak_memory_stats()
        pre_s, cache = [], None
        want_pre = {kernel: n_kernel, "quantize": 2 * n_self * (kv == "int8")}
        for _ in range(3):
            cache = None  # the last run's
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = lm.prefill(c, params, batch, max_seq=max_seq,
                                     device=dev)
            torch.cuda.synchronize()
            pre_s.append(time.perf_counter() - t0)
            pre_l = dict(LAUNCHES)
            check(all(pre_l[k_] == want_pre.get(k_, 0) for k_ in pre_l),
                  f"{what}: a prefill launches {kernel} {n_kernel} times and "
                  f"quantize {want_pre['quantize']}, no other kernel "
                  f"({pre_l})")
            check(torch.equal(last, whole), f"{what}: prefill's last logits "
                  "bit-equal to forward(logits_mode='last')")
        # recurrentgemma-2b's local rings: positions 2048..4095 in order
        check(rings_hold(c, cache, LM_SEQ - 1, dev), f"{what}: every "
              "self-attention ring holds the prompt's last positions")
        leaves = []
        tree_map(leaves.append, cache)
        cache_gib = sum(t.numel() * t.element_size() for t in leaves) / 2**30
        reset_launches()
        step_s, outs = [], []
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, cache = lm.decode_step(c, params, cache, dec[:, t:t + 1],
                                        LM_SEQ + t, device=dev)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            outs.append(out)
            check(rings_hold(c, cache, LM_SEQ + t, dev), f"{what}: after "
                  f"decode step {t} every ring holds the positions it must "
                  "(slid by one)")
        dec_l = dict(LAUNCHES)
        DECODE_LAUNCHES.update(dec_l)
        want_dec = {"quantize": 2 * n_self * steps * (kv == "int8")}
        check(all(dec_l[k_] == want_dec.get(k_, 0) for k_ in dec_l),
              f"{what}: {steps} decode steps launch no flash_attention and "
              f"no ssd, quantize {want_dec['quantize']} times ({dec_l})")
        got = torch.cat(outs, 1).float()
        check(got.shape == (LM_BATCH, steps, cfg.vocab)
              and bool(torch.isfinite(got).all()),
              f"{what}: finite decode logits {(LM_BATCH, steps, cfg.vocab)}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        med = float(np.median(step_s[DECODE_COLD:]))
        busy = None
        if "--profile" in argv:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof_run:
                for t in range(4):  # past max_seq: the rings wrap
                    lm.decode_step(c, params, cache, dec[:, t:t + 1],
                                   max_seq + t, device=dev)
                torch.cuda.synchronize()
            avg = prof_run.key_averages()
            device_s = sum(e.self_device_time_total for e in avg
                           if e.device_type == DeviceType.CUDA) / 1e6
            busy = device_s / (4 * med)
            print(f"profiled 4 decode steps of {what}: device time "
                  f"{device_s * 1e3:.3f} ms, {busy:.1%} of four median steps")
            print(avg.table(sort_by="self_cuda_time_total", row_limit=15))
        rows.append({
            "arch": cfg.name, "kv_dtype": kv, "layers": cfg.n_layers,
            "batch": LM_BATCH, "prompt": LM_SEQ, "steps": steps,
            "max_seq": max_seq, "card": smi,
            "prefill_s": {"cold": pre_s[0],
                          "warm_median": float(np.median(pre_s[1:])),
                          "warm": pre_s[1:]},
            "step_ms_median": med * 1e3,
            "step_ms": [x * 1e3 for x in step_s],
            "tokens_per_s": LM_BATCH / med, "cache_gib": cache_gib,
            "peak_device_gib": peak, "device_busy": busy,
            "launches": {"prefill": {k_: v_ for k_, v_ in pre_l.items()
                                     if v_},
                         "decode": {k_: v_ for k_, v_ in dec_l.items()
                                    if v_}},
            "logits_vs_forward_rel": float((got - want).abs().max()
                                           / want.abs().max()),
            "argmax_equal_forward": float((got.argmax(-1) == want.argmax(-1))
                                          .float().mean())})
        print(f"decode: {json.dumps(rows[-1])}")
        del cache, outs, got, last
        torch.cuda.empty_cache()
        if kv == "int8":
            kv_rows += kv_quant_rows(cfg, params, batch, dec, dev)
    E2E_DECODE.extend(rows)
    return {"rows": rows, "kv_quant": kv_rows}


def serve_lm(dev, smi: str, argv, arch: str, split: int, kernel: str,
             layer0, route: str | None = None, *, layers: int | None = None,
             cpu_layers: int = LM_CPU_LAYERS, decode_steps: int = DECODE_STEPS,
             kv_dtypes=("bf16",)) -> dict:
    """Split serving of ``arch`` at full width, at full depth or cut to
    ``layers`` layers, bf16 weights drawn on the card (cross-attention
    gates nonzero), LM_BATCH x LM_SEQ seeded tokens (and seeded vision
    embeddings for a cross-attention config) split at megablock
    ``split``: ``lm_split_infer`` through the FP16, INT8 and INT4 codecs
    (cold, then three warm runs; ``kernel`` launched once a layer it
    serves (flash_attention: a self-attention layer; ssd: an SSD layer),
    through its ``route`` where it has routes, and quantize once an
    integer codec, no other kernel), head plus tail through FP16 against
    the forward, the stages of a warm run, the quantize kernel on the bf16
    boundary activation against its plain version, the kernel path
    against ``use_kernel=False`` at batch 1 (reported: see LM_BLOCK_RTOL),
    ``layer0(cfg, params, tokens, dev)`` (the kernel on its first layer's
    own inputs), ``decode_lm`` (``decode_steps`` steps after a prefill of
    the same batch, with each KV cache dtype of ``kv_dtypes``), and
    ``cut_check`` at ``cpu_layers`` layers (with each of ``kv_dtypes``).
    Returns the numbers of the path's e2e line, the launches of its runs,
    the boundary's quantize rows and decode_lm's result."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import boundary
    from repro_torch.core.splitting import lm_head, lm_split_infer, lm_tail
    from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
    from repro_torch.kernels.quant import quantize, quantize_ref
    from repro_torch.kernels.quant import route as quant_route
    from repro_torch.models import init_params, lm

    bf16 = torch.bfloat16
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    n_kernel = sum(s.kind in KERNEL_KINDS[kernel] for s in layer_specs(cfg))

    def make_params():
        g = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, g, device=dev, dtype=bf16)
        draw_gates(cfg, params, g)
        return params

    t0 = time.perf_counter()
    params = make_params()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_SEQ)).astype(np.int32)
    batch = {"tokens": tokens}
    vision = None
    if cfg.vision_dim:
        vision = torch.randn(
            (LM_BATCH, cfg.vision_tokens, cfg.vision_dim),
            generator=torch.Generator(device=dev).manual_seed(SEED + 2),
            device=dev)
        batch["vision"] = vision
    n_tok = LM_BATCH * LM_SEQ
    depth = (f"{cfg.n_layers} of its {full.n_layers} layers"
             if layers is not None else f"{cfg.n_layers} layers")
    print(f"{arch} setup: {depth}, {cfg.param_count() / 1e9:.3f} B "
          f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"bf16, drawn on the card in {init_s:.2f} s; {LM_BATCH} x "
          f"{LM_SEQ} tokens"
          + (f" and vision {tuple(vision.shape)}" if vision is not None
             else "") + f", split {split} of {cfg.n_full_patterns}")

    def run(codec):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm_split_infer(cfg, params, batch, split, codec, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(LAUNCHES)

    codecs = (boundary.FP16, boundary.INT8, boundary.INT4)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for codec in codecs:
        out, first_s, launches = run(codec)
        if route is not None:
            check(ROUTES[kernel][route] == n_kernel,
                  f"{arch} {codec.name}: every {kernel} call took the "
                  f"{route} route ({ROUTES[kernel]})")
        want = {kernel: n_kernel, "quantize": int(codec.bits < 16)}
        check(all(launches[k_] == want.get(k_, 0) for k_ in launches),
              f"{arch} {codec.name}: {n_kernel} {kernel} launches and "
              f"{want['quantize']} quantize a run, no other kernel "
              f"({launches})")
        check(out.shape == (LM_BATCH, 1, cfg.vocab)
              and bool(torch.isfinite(out).all()),
              f"{arch} {codec.name}: finite last-token logits "
              f"{(LM_BATCH, 1, cfg.vocab)}")
        warm = []
        for _ in range(3):
            again, s_, l_ = run(codec)
            warm.append(s_)
            check(l_ == launches and torch.equal(again, out),
                  f"{arch} {codec.name}: a warm run repeats the first")
        runs[codec.name] = {"out": out, "first_s": first_s, "warm_s": warm,
                            "launches": launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with torch.inference_mode():
        whole = lm.forward(cfg, params, batch, logits_mode="last",
                           device=dev)
    check(torch.equal(whole, runs["fp16"]["out"]), f"{arch}: head plus tail "
          "through the FP16 codec equals forward(logits_mode='last') bit "
          "for bit")
    codec_rel = {c: float((runs[c]["out"].float() - whole.float()).abs()
                          .max() / whole.float().abs().max()) for c in runs}
    dec = decode_lm(cfg, params, batch, whole, dev, smi, argv, kernel,
                    n_kernel, steps=decode_steps, kv_dtypes=kv_dtypes)

    # stages of a warm run, and the codec's kernel on the boundary
    # activation against its plain version
    stages = {}
    with torch.inference_mode():
        for codec in codecs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            act = lm_head(cfg, params, batch, split, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sent = boundary.roundtrip(act, codec)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            lm_tail(cfg, params, sent, batch, split, device=dev)
            torch.cuda.synchronize()
            stages[codec.name] = {"head": t1 - t0, "codec": t2 - t1,
                                  "tail": time.perf_counter() - t2}
    rows2d = act.reshape(-1, cfg.d_model)  # (16384, d_model) bf16
    qrows = []
    for qmax in (127, 7):
        qq, qs = quantize(rows2d, qmax)
        torch.cuda.synchronize()
        rq, rs = quantize_ref(rows2d, qmax)
        check(torch.equal(qq, rq) and torch.equal(qs, rs), f"quantize "
              f"bit-equal to plain on {arch}'s bf16 boundary activation "
              f"{tuple(rows2d.shape)}, qmax {qmax}")
        qms, qhost = cuda_ms(lambda: quantize(rows2d, qmax), 50)
        qpms, qphost = cuda_ms(lambda: quantize_ref(rows2d, qmax), 10)
        n_, d_ = rows2d.shape
        qb_ms, qby = bound(3 * n_ * d_ + 4 * n_, 5 * n_ * d_)
        qrows.append({"shape": [n_, d_], "dtype": "bfloat16", "qmax": qmax,
                      "route": quant_route(n_, d_, rows2d.dtype,
                                           rows2d.data_ptr() % 16 == 0),
                      "count": 1, "ms": qms, "plain_ms": qpms,
                      "bound_ms": qb_ms, "bound_by": qby, "host_ms": qhost,
                      "plain_host_ms": qphost, "path": arch})
    del act, sent, rows2d

    # batch 1: the kernel path against use_kernel=False (reported: see
    # LM_BLOCK_RTOL); the kernel on its first layer's own inputs
    with torch.inference_mode():
        b1 = {k_: v_[:1] for k_, v_ in batch.items()}
        a = lm.forward(cfg, params, b1, logits_mode="last", device=dev)
        b = lm.forward(cfg, params, b1, logits_mode="last", use_kernel=False,
                       device=dev)
        deep_off_rel = float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())
    real = layer0(cfg, params, tokens, dev)
    del params, a, b, whole
    for r in runs.values():
        del r["out"]
    torch.cuda.empty_cache()

    cut, cpu_s = cut_check(cfg, dev, cpu_layers, tokens, vision,
                           kv_dtypes=kv_dtypes)
    print(f"{arch} path: lm_split_infer({LM_BATCH} x {LM_SEQ}, {depth}, "
          f"split {split}) launches "
          f"{ {c: r['launches'] for c, r in runs.items()} }; codecs vs the "
          f"forward (max |diff| / max |logit|) {codec_rel}; batch 1, "
          f"use_kernel=False vs the kernel path {deep_off_rel:.3g} "
          f"(reported); the first layer's {kernel} on its own inputs "
          f"{real}; {cpu_layers} layers at full width (card vs CPU "
          f"{cpu_s:.1f} s on the CPU) {cut}; peak device memory "
          f"{peak_gib:.2f} GiB")

    busy = None
    if "--profile" in argv:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        params = make_params()
        run(boundary.INT8)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_run:
            _, wall, _ = run(boundary.INT8)
        avg = prof_run.key_averages()
        device_s = sum(e.self_device_time_total for e in avg
                       if e.device_type == DeviceType.CUDA) / 1e6
        busy = device_s / float(np.median(runs["int8"]["warm_s"]))
        print(f"profiled {arch} INT8 split inference: {wall:.3f} s wall, "
              f"device time {device_s:.3f} s ({busy:.1%} of the warm run's "
              "median)")
        print(avg.table(sort_by="self_cuda_time_total", row_limit=20))
        del params
        torch.cuda.empty_cache()

    e2e = {
        "arch": arch, "layers": cfg.n_layers, "layers_of": full.n_layers,
        "batch": LM_BATCH, "seq": LM_SEQ, "split": split, "tokens": n_tok,
        "vision": None if vision is None else list(vision.shape),
        "card": smi, "init_s": init_s,
        "codecs": {c: {"first_s": r["first_s"], "warm_s": r["warm_s"],
                       "tokens_per_s": n_tok / float(np.median(r["warm_s"])),
                       "launches": {k_: v_ for k_, v_ in
                                    r["launches"].items() if v_}}
                   for c, r in runs.items()},
        "stages_s": stages, "peak_device_gib": peak_gib,
        "device_busy": busy, "codec_vs_forward_rel": codec_rel,
        "batch1_use_kernel_false_rel": deep_off_rel,
        f"first_layer_{kernel}": real,
        f"cut_to_{cpu_layers}_layers": cut, "decode": dec["rows"]}
    return {"e2e": e2e, "launches": runs["fp16"]["launches"][kernel],
            "quantize_launches": runs["int8"]["launches"]["quantize"],
            "boundary": qrows, "decode": dec}


def lm_path(dev, smi: str, argv) -> tuple[dict, dict]:
    """The dense LM's split serving at granite-8b's full width and depth:
    the flash_attention kernel against its plain version, then
    ``serve_lm`` with the kernel on layer 0's own q, k, v, and the
    ``e2e_lm`` line (decode: 64 steps with the bf16 and the int8 KV
    cache). Returns the flash_attention row of the kernels line and the
    quantize kernel's LM boundary and KV-cache timings."""
    attn_rows, timing = attention_kernel(dev)
    res = serve_lm(dev, smi, argv, LM_ARCH, LM_SPLIT, "flash_attention",
                   attention_layer0, decode_steps=LM_DECODE_STEPS,
                   kv_dtypes=("bf16", "int8"))
    print(f"SDPA vs plain max |err| {timing['library_max_abs_err']:.3g}")
    print(json.dumps({"e2e_lm": dict(res["e2e"],
                                     attention_checks=attn_rows)}))
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
           "launches": res["launches"],
           "max_abs_err": attn_rows[0]["max_abs_err"], **timing,
           "dtype": "bfloat16", "causal": True,
           "per": f"one launch at the path's shape, {res['launches']} a "
                  "split inference",
           "path_shapes": [r for r in attn_rows if "path" in r]}
    return row, {"launches_lm": res["quantize_launches"],
                 "lm_boundary": res["boundary"],
                 "kv_cache_shapes": res["decode"]["kv_quant"]}


def ssd_held(x, dt, A, Bm, Cm, L, what: str) -> dict:
    """ssd (whichever route its wrapper takes) against ssd_ref on the same
    tensors, held to SSD_RTOL for y and the state; returns the errors."""
    from repro_torch.kernels.ssd import ssd, ssd_ref
    y, st = ssd(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, L)
    ok, err, worst = ulp_close(y, yr, SSD_RTOL)
    s_rel = float((st - sr).abs().max() / sr.abs().max())
    check(ok and s_rel <= SSD_RTOL and bool(torch.isfinite(y).all()),
          f"ssd within its bound of plain at {what} (y max |err| {err:.3g}, "
          f"{worst:.3g} of the bound; state {s_rel:.3g} of its max)")
    return {"max_abs_err": err, "of_bound": worst, "state_rel": s_rel}


def ssd_checks(dev) -> list:
    """The ssd kernel against its plain version at every SSD_CHECKS case,
    on seeded random inputs, each through the route SSD_ROUTE names."""
    from repro_torch.kernels import ROUTES, reset_launches
    g = torch.Generator(device=dev).manual_seed(SEED)
    checks = []
    for B, S, L, nh, hd, G, N, dt_name in SSD_CHECKS:
        dtype = getattr(torch, dt_name)

        def t(*shape):
            return torch.randn(shape, generator=g, device=dev)

        x, Bm, Cm = (t(B, S, nh, hd).to(dtype), t(B, S, G, N).to(dtype),
                     t(B, S, G, N).to(dtype))
        dt = torch.nn.functional.softplus(t(B, S, nh)) * 0.5
        A = -torch.exp(t(nh) * 0.3)
        case = (B, S, L, nh, hd, G, N, dt_name)
        ragged = dtype == torch.bfloat16 and (hd % 16 or N % 16 or L % 16)
        want = SSD_ROUTE["ragged" if ragged else dt_name]
        reset_launches()
        row = ssd_held(x, dt, A, Bm, Cm, L, str(case))
        check(ROUTES["ssd"][want] == 1, f"ssd at {case} took the {want} "
              f"route ({ROUTES['ssd']})")
        checks.append(dict(row, case=list(case), route=want))
        del x, Bm, Cm, dt
    print(f"ssd (chunked routes) vs plain: {checks}")
    return checks


def ssd_cuda_core(x, dt, A, Bm, Cm, L):
    """The CUDA-core chunked kernels in bf16 (``repro_ssd_chunked``'s kind
    1, which the wrapper now runs only for bf16 shapes that do not tile)
    on inputs that the wrapper sends to the tensor cores: the design the
    tensor-core route replaced, launched for comparison and counted
    nowhere. Returns (y, state)."""
    from repro_torch.kernels import _build
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    state = torch.empty((B, G, nh // G, hd, N), **f32)
    lcum = torch.empty((B, nh, S), **f32)
    states = torch.empty((B, S // L, nh, hd, N), **f32)
    cbT = torch.empty((B, S // L, G, L, L), **f32)
    rc = _build.library().repro_ssd_chunked(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), lcum.data_ptr(),
        states.data_ptr(), cbT.data_ptr(), B, S, nh, hd, G, N, L, 1,
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "ssd (CUDA cores, bf16)")
    return y, state


def ssd_layer0(cfg, params, tokens, dev, by_launch: bool = False) -> dict:
    """The ssd kernel on layer 0's own inputs (all LM_BATCH x LM_SEQ
    tokens, bf16) against its plain version, held to SSD_RTOL, and timed
    there beside its plain version, its bound and its design floor; the
    CUDA-core kernels held and timed on the same inputs (bf16) and on
    their f32 copy (the route the wrapper takes in f32), beside the plain
    version and the bound there. With ``by_launch`` the tensor-core
    route's device time is also split by device launch with
    torch.profiler."""
    from repro_torch.kernels.ssd import (DEVICE_LAUNCHES, route, ssd,
                                         ssd_ref)
    from repro_torch.models import blocks, lm
    from repro_torch.models.template import tree_map

    with torch.inference_mode():
        x = lm.embed_in(cfg, params, {"tokens": tokens}, torch.bfloat16, dev)
        p0 = tree_map(lambda t: t[0], params["groups"][0])["ssd"]
        _, xh, Bg, Cg, dt, A, _ = blocks._ssd_inputs(cfg, p0, x,
                                                     torch.bfloat16)
        L = min(cfg.ssm_chunk, LM_SEQ)
        B, S, nh, hd = xh.shape
        G, N = Bg.shape[2], Bg.shape[3]
        shape = (B, S, nh, hd, G, N, L)
        real = ssd_held(xh, dt, A, Bg, Cg, L, f"layer 0's inputs {shape} "
                        "bf16")
        ms, host = cuda_ms(lambda: ssd(xh, dt, A, Bg, Cg, chunk=L), 20)
        pms, phost = cuda_ms(lambda: ssd_ref(xh, dt, A, Bg, Cg, L), 2)
        # the CUDA-core kernels: bf16 on the same inputs, then f32
        y_c, s_c = ssd_cuda_core(xh, dt, A, Bg, Cg, L)
        torch.cuda.synchronize()
        yr, sr = ssd_ref(xh, dt, A, Bg, Cg, L)
        ok, core_err, _ = ulp_close(y_c, yr, SSD_RTOL)
        check(ok and float((s_c - sr).abs().max() / sr.abs().max())
              <= SSD_RTOL, "the CUDA-core kernels within their bound of "
              f"plain on layer 0's inputs (y max |err| {core_err:.3g})")
        del y_c, s_c, yr, sr
        core_ms, _ = cuda_ms(lambda: ssd_cuda_core(xh, dt, A, Bg, Cg, L), 20)
        x32, B32, C32 = xh.float(), Bg.float(), Cg.float()
        f32 = ssd_held(x32, dt, A, B32, C32, L, f"layer 0's inputs {shape} "
                       "in f32")
        f32_ms, f32_host = cuda_ms(lambda: ssd(x32, dt, A, B32, C32,
                                               chunk=L), 10)
        f32_pms, f32_phost = cuda_ms(lambda: ssd_ref(x32, dt, A, B32, C32,
                                                     L), 2)
        if by_launch:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof_run:
                for _ in range(5):
                    ssd(xh, dt, A, Bg, Cg, chunk=L)
                torch.cuda.synchronize()
            split = {}
            for e in prof_run.key_averages():
                name = re.search(r"chunk_\w+|state_passing\w*", e.key)
                if e.device_type == DeviceType.CUDA and name:
                    split[name.group(0)] = e.self_device_time_total / 5e3
        del x32, B32, C32
    which = route(xh.dtype, nh // G, hd, N, L)
    nbytes, elem, prod = ssd_work(B, S, nh, hd, G, N, L, el=2)
    b_ms, by = bound(nbytes, elem, bf16_ops=prod)
    nbytes4, elem4, prod4 = ssd_work(B, S, nh, hd, G, N, L, el=4)
    b4_ms, by4 = bound(nbytes4, elem4 + prod4)
    floor = ssd_design_floor(B, S, nh, hd, G, N, L)
    real.update({"route": which,
                 "device_launches_per_call": DEVICE_LAUNCHES[which],
                 "shape": list(shape), "dtype": "bfloat16",
                 "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                 "bound_by": by, "design_floor_ms": floor,
                 "library_ms": None,
                 "library": "none (no one call)", "host_ms": host,
                 "plain_host_ms": phost,
                 "cuda_core_bf16_ms": core_ms,
                 "cuda_core_bf16_max_abs_err": core_err})
    f32.update({"route": route(torch.float32, nh // G, hd, N, L),
                "device_launches_per_call": DEVICE_LAUNCHES["chunked"],
                "shape": list(shape), "dtype": "float32", "ms": f32_ms,
                "plain_ms": f32_pms, "bound_ms": b4_ms, "bound_by": by4,
                "library_ms": None, "library": "none (no one call)",
                "host_ms": f32_host, "plain_host_ms": f32_phost})
    real["f32"] = f32
    if by_launch:
        real["device_ms_by_kernel"] = split
    print(f"ssd ({which}) at the path's shape {shape} bf16: {ms:.4f} ms "
          f"(bound {b_ms:.4f} ms, {by}; design floor: products "
          f"{floor['products']:.4f} ms, workspace {floor['workspace']:.4f}"
          f" ms), plain {pms:.3f} ms; CUDA-core kernels {core_ms:.4f} ms "
          f"in bf16, {f32_ms:.4f} ms in f32 (bound {b4_ms:.4f} ms, {by4})")
    return real


def ssd_lm_path(dev, smi: str, argv) -> tuple[dict, dict]:
    """Split serving of the SSD LM at mamba2-370m's full width and depth:
    the ssd kernel against its plain version at SSD_CHECKS, then
    ``serve_lm`` with the kernel on layer 0's own inputs (held and
    timed), and the ``e2e_ssd_lm`` line. Returns the chunked route's
    numbers for the ssd row and the quantize kernel's boundary timing."""
    checks = ssd_checks(dev)
    res = serve_lm(dev, smi, argv, SSD_LM_ARCH, SSD_LM_SPLIT, "ssd",
                   ssd_layer0, route=SSD_ROUTE["bfloat16"])
    print(json.dumps({"e2e_ssd_lm": dict(res["e2e"], ssd_checks=checks)}))
    real = res["e2e"]["first_layer_ssd"]
    src = "src/repro_torch/kernels/csrc/ssd_chunked.cu"
    wgmma = {k: real[k] for k in (
        "route", "device_launches_per_call", "shape", "dtype", "ms",
        "plain_ms", "bound_ms", "bound_by", "design_floor_ms",
        "library_ms", "library", "host_ms", "plain_host_ms", "max_abs_err",
        "state_rel", "cuda_core_bf16_ms")}
    wgmma.update({"source": src, "launches": res["launches"],
                  "path": SSD_LM_ARCH, "max_abs_err_checks": max(
                      c["max_abs_err"] for c in checks
                      if c["route"] == "chunked_wgmma")})
    core = dict(real["f32"], source=src, launches=0,
                path="none timed (the 2-layer f32 cut of the SSD LM path)",
                max_abs_err_checks=max(c["max_abs_err"] for c in checks
                                       if c["route"] == "chunked"))
    return {"chunked_wgmma": wgmma, "chunked": core}, {
        "launches_ssd_lm": res["quantize_launches"],
        "ssd_lm_boundary": res["boundary"]}


def scout_check(dev) -> dict:
    """llama4-scout-17b-a16e (16 experts, top-1, vocab 202048) at full
    width cut to SCOUT_LAYERS layers: ``cut_check`` at those layers, then
    one forward of LM_BATCH x LM_SEQ seeded tokens with bf16 weights drawn
    on the card (cold, then three warm runs; flash_attention once a
    layer, no other kernel). Returns the numbers of the e2e_moe_lm line's
    ``scout`` entry."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params, lm

    full = get_config(SCOUT_ARCH)
    cfg = dataclasses.replace(full, n_layers=SCOUT_LAYERS)
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_SEQ)).astype(np.int32)
    cut, cpu_s = cut_check(cfg, dev, SCOUT_LAYERS, tokens, None,
                           decode_steps=0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev, dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()

    def run():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = lm.forward(cfg, params, {"tokens": tokens},
                             logits_mode="last", device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(LAUNCHES)

    out, first_s, launches = run()
    check(all(launches[k_] == (SCOUT_LAYERS if k_ == "flash_attention"
                               else 0) for k_ in launches),
          f"{SCOUT_ARCH}: {SCOUT_LAYERS} flash_attention launches a forward, "
          f"no other kernel ({launches})")
    check(out.shape == (LM_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(out).all()),
          f"{SCOUT_ARCH}: finite last-token logits")
    warm = []
    for _ in range(3):
        again, s_, l_ = run()
        warm.append(s_)
        check(l_ == launches and torch.equal(again, out),
              f"{SCOUT_ARCH}: a warm forward repeats the first")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del params, out, again
    torch.cuda.empty_cache()
    res = {"arch": SCOUT_ARCH, "layers": SCOUT_LAYERS,
           "layers_of": full.n_layers, "batch": LM_BATCH, "seq": LM_SEQ,
           "first_s": first_s, "warm_s": warm,
           "tokens_per_s": LM_BATCH * LM_SEQ / float(np.median(warm)),
           "launches": {k_: v_ for k_, v_ in launches.items() if v_},
           "peak_device_gib": peak_gib,
           f"cut_to_{SCOUT_LAYERS}_layers": cut, "cpu_s": cpu_s}
    print(f"{SCOUT_ARCH} at full width, {SCOUT_LAYERS} layers: {res}")
    return res


def moe_path(dev, smi: str, argv) -> dict:
    """Split serving of the MoE LM: ``serve_lm`` of mixtral-8x22b at full
    width cut to MOE_LAYERS layers, split MOE_SPLIT, the card against the
    CPU at MOE_CPU_LAYERS layers; then ``scout_check``; and the
    ``e2e_moe_lm`` line. Returns serve_lm's result, with scout's
    flash_attention launches."""
    res = serve_lm(dev, smi, argv, MOE_ARCH, MOE_SPLIT, "flash_attention",
                   attention_layer0, layers=MOE_LAYERS,
                   cpu_layers=MOE_CPU_LAYERS)
    torch.cuda.empty_cache()
    scout = scout_check(dev)
    print(json.dumps({"e2e_moe_lm": dict(res["e2e"], scout=scout)}))
    return dict(res, scout_launches=scout["launches"].get("flash_attention", 0))


def hybrid_path(dev, smi: str, argv) -> tuple[dict, dict]:
    """Split serving of the RG-LRU hybrid (``serve_lm`` of
    recurrentgemma-2b at full width and depth, split HYBRID_SPLIT) and of
    the cross-attention VLM (llama-3.2-vision-90b at full width cut to
    VLM_LAYERS layers, split VLM_SPLIT, seeded vision embeddings, the card
    against the CPU at VLM_CPU_LAYERS layers), with the ``e2e_hybrid_lm``
    and ``e2e_vlm`` lines. Returns serve_lm's two results."""
    hyb = serve_lm(dev, smi, argv, HYBRID_ARCH, HYBRID_SPLIT,
                   "flash_attention", attention_layer0)
    print(json.dumps({"e2e_hybrid_lm": hyb["e2e"]}))
    torch.cuda.empty_cache()
    vlm = serve_lm(dev, smi, argv, VLM_ARCH, VLM_SPLIT, "flash_attention",
                   attention_layer0, layers=VLM_LAYERS,
                   cpu_layers=VLM_CPU_LAYERS)
    print(json.dumps({"e2e_vlm": vlm["e2e"]}))
    return hyb, vlm


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run this from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch._device import resolve_device
    from repro_torch.channel import kpm
    from repro_torch.channel import scenarios as sc
    from repro_torch.channel.throughput import max_throughput_mbps
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE
    from repro_torch.core.objective import Constraints, Weights
    from repro_torch.core.pso import TP_CLIP_MBPS, pso_vectorized
    from repro_torch.estimator.model import (EstimatorConfig, conv_trunk,
                                             full_f32, init_estimator)
    from repro_torch.estimator.serve import quantize_estimator
    from repro_torch.kernels import LAUNCHES, ROUTES, _build, reset_launches
    from repro_torch.kernels.featurize import featurize, featurize_ref
    from repro_torch.kernels.lstm import lstm_scan, lstm_scan_ref
    from repro_torch.kernels.qmm import qmm, qmm_ref
    from repro_torch.kernels.quant import quantize, quantize_ref
    from repro_torch.models.vgg import FULL, vgg_split_profile
    from repro_torch.sim import (estimate_fleet, run_controllers,
                                 simulate_fleet, split_metrics)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions too
    # bf16 products accumulate in f32 throughout, as the reference's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}, "
          f"capability {torch.cuda.get_device_capability(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    n_src = len(list(_build.CSRC.glob("*.cu")))
    print(f"build: {build_s:.2f} s (nvcc, {n_src} sources in parallel)")
    print(_build.build_log.strip())
    if "--attention" in argv:  # the attention kernel's checks and times
        rows, timing = attention_kernel(dev)
        print(json.dumps({"flash_attention": dict(timing, card=smi,
                                                  checks=rows)}))
        return 0
    if "--qmm" in argv:  # qmm's checks and times at the int8 path's shapes
        e = EstimatorConfig()
        _, mm_shapes = int8_shapes(e, N_UES * T_PERIODS, fc_pass_rows(e))
        rows = qmm_rows(dev, mm_shapes,
                        torch.Generator(device=dev).manual_seed(SEED))
        print(json.dumps({"qmm": dict(shape_totals(rows), card=smi,
                                      shapes=rows)}))
        return 0
    if "--ssd" in argv:  # the ssd kernel's checks and time at the LM's call
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        cfg = get_config(SSD_LM_ARCH)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), device=dev, dtype=torch.bfloat16)
        tokens = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_BATCH, LM_SEQ)).astype(np.int32)
        print(json.dumps({"ssd": dict(
            ssd_layer0(cfg, params, tokens, dev, by_launch=True), card=smi,
            checks=ssd_checks(dev))}))
        return 0
    if "--int8" in argv:  # quantize's and lstm_scan_q's checks and times
        print(json.dumps({"int8": int8_kernels(dev, smi)}))
        return 0
    if "--scan" in argv:  # lstm_scan's, the fused ssd's, the launch
        # floor and the launch-sized kernels'
        print(json.dumps({"scan": scan_kernels(dev, smi)}))
        return 0
    if "--dcor" in argv:  # pairwise_dists' checks and profile-run times
        g = torch.Generator(device=dev).manual_seed(SEED)
        err, rel = pairwise_checks(dev, g)
        rows = pairwise_rows(dev, g)
        print(json.dumps({"pairwise_dists": dict(
            shape_totals(rows), card=smi, max_abs_err=err,
            max_rel_d2_err=rel, shapes=rows)}))
        return 0
    if "--moe" in argv:  # the MoE LM path alone
        moe_path(dev, smi, argv)
        print(json.dumps({"e2e_decode": E2E_DECODE}))
        return 0
    if "--hybrid" in argv:  # the RG-LRU hybrid and the VLM paths alone
        hybrid_path(dev, smi, argv)
        print(json.dumps({"e2e_decode": E2E_DECODE}))
        return 0

    # the main path's inputs: a mixed S0-S3 episode at the paper's width,
    # the fig6 table (benchmarks/fig6_adaptive.py::fig6_table) and seeded
    # random weights whose untrained head is rescaled so the estimates
    # spread over the table's 1-130 Mbps range
    e = EstimatorConfig()
    t0 = time.perf_counter()
    names = np.asarray(sc.SCENARIOS)[np.arange(N_UES) % len(sc.SCENARIOS)]
    ep = sc.gen_episode_batch(names, T_PERIODS, np.random.default_rng(SEED),
                              n_sc=e.n_sc)
    prof = vgg_split_profile(FULL)
    table = pso_vectorized(prof, UE_VM_2CORE, EDGE_A40X2,
                           Weights(1.0, 0.15, 0.1),
                           Constraints(rho_max=0.92, tau_max_s=6.0,
                                       e_max_j=40.0), 130)
    fixed = table.query(float(max_throughput_mbps(np.array(-60.0))))
    cfg = ControllerConfig(ewma_alpha=0.6, hysteresis_steps=2,
                           fallback_split=fixed)
    params = init_estimator(e, torch.Generator().manual_seed(SEED),
                            device="cpu")
    params["head"]["w2"] *= 40.0
    params["head"]["b2"] += 60.0
    gparams = {g: {k: v.to(dev) for k, v in d.items()}
               for g, d in params.items()}
    print(f"setup: episode {N_UES} UEs x {T_PERIODS} periods at n_sc "
          f"{e.n_sc} ({ep.iq.nbytes / 2**30:.2f} GiB of IQ), fig6 table, "
          f"fixed split {fixed}: {time.perf_counter() - t0:.2f} s")

    # 3. each kernel against its plain version, at the main path's shapes
    W = sc.WINDOW
    slab = torch.from_numpy(ep.kpms[:, :T_PERIODS + W - 1]).to(dev)
    slab = slab.contiguous()  # (128, 45, 15): one chunk's trace
    center = torch.from_numpy(kpm.KPM_CENTER).to(dev)
    scale = torch.from_numpy(kpm.KPM_SCALE).to(dev)
    win = featurize(slab, center, scale, W)
    win_ref = featurize_ref(slab, center, scale, W)
    torch.cuda.synchronize()
    check(torch.equal(win, win_ref), "featurize kernel bit-equal to plain")
    rows = win.reshape(-1, W, e.n_kpms)  # (2048, 30, 15)
    lp = gparams["lstm"]
    h = lstm_scan(rows, lp["wx"], lp["wh"], lp["b"])
    h_ref = lstm_scan_ref(rows, lp["wx"], lp["wh"], lp["b"])
    torch.cuda.synchronize()
    lstm_err = (h - h_ref).abs().max().item()
    check(torch.allclose(h, h_ref, rtol=1e-4, atol=1e-5),
          f"lstm_scan within rtol 1e-4, atol 1e-5 of plain ({lstm_err:.3g})")
    print(f"kernels vs plain: featurize {tuple(slab.shape)} -> "
          f"{tuple(win.shape)} bit-equal; lstm_scan {tuple(rows.shape)} -> "
          f"{tuple(h.shape)} max |err| {lstm_err:.3g} (rtol 1e-4, atol 1e-5)")

    # 3b. the int8 kernels against their plain versions, at the int8
    # path's shapes: the weights quantized by the quantize kernel, the
    # int8 scan over the same 2048 windows, one fc pass's trunk output (the
    # first 365 rows of the chunk through the f32 conv trunk)
    qp = quantize_estimator(gparams)
    for gname, group in qp.items():
        for name, leaf in group.items():
            if isinstance(leaf, tuple):
                ref_q, ref_s = quantize_ref(
                    gparams[gname][name].T.contiguous())
                check(torch.equal(leaf[0], ref_q)
                      and torch.equal(leaf[1], ref_s),
                      f"quantize kernel bit-equal on weight {name}")
    lq, cq, hqp = qp["lstm"], qp["cnn"], qp["head"]
    lq_row, hq8 = lstm_q_row(rows, lq)  # checked against plain, timed
    lstm_q_err, lstm_q_rows = lq_row["max_abs_err"], lq_row[
        "rows_beyond_1e-5"]
    pass_rows = fc_pass_rows(e)
    iq_pass = torch.from_numpy(np.asarray(
        ep.iq[:, :T_PERIODS].reshape(-1, *ep.iq.shape[2:])[:pass_rows],
        np.float32)).to(dev)
    with torch.inference_mode(), full_f32(dev):
        trunk = next(conv_trunk(cq, iq_pass))  # (365, 78624)
    del iq_pass
    acts = {"fc": trunk, "proj": hq8, "w1": hq8, "w2": hq8}
    for name, x in (("trunk", trunk), ("h", hq8)):
        xq, sx = quantize(x)
        torch.cuda.synchronize()
        rq, rs = quantize_ref(x)
        check(torch.equal(xq, rq) and torch.equal(sx, rs),
              f"quantize kernel bit-equal on {name} {tuple(x.shape)}")
    for name, wpair in (("fc", cq["fc"]), ("proj", lq["proj"]),
                        ("w1", hqp["w1"]), ("w2", hqp["w2"])):
        xq, sx = quantize(acts[name])
        out = qmm(xq, sx, *wpair)
        torch.cuda.synchronize()
        check(torch.equal(out, qmm_ref(xq, sx, *wpair)),
              f"qmm kernel bit-equal on {name} {tuple(xq.shape)} x "
              f"{tuple(wpair[0].shape)}")
    print(f"int8 kernels vs plain: quantize bit-equal on the six weights, "
          f"the fc trunk pass {tuple(trunk.shape)} and h {tuple(hq8.shape)};"
          f" qmm bit-equal on fc, proj, w1, w2; lstm_scan_q "
          f"{tuple(rows.shape)} -> {tuple(hq8.shape)} max |err| "
          f"{lstm_q_err:.3g}, {lstm_q_rows} of {rows.shape[0]} rows beyond "
          f"1e-5 (bounds {Q_SCAN_ATOL}, {Q_SCAN_ROWS_OFF:.0%})")

    # 4. the main path, once, with the launch counters read around it
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate_fleet(ep, table, prof, cfg, warm_split=fixed,
                         estimator=(e, gparams), fused=True)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    lstm_routes = dict(ROUTES["lstm_scan"])
    feat_routes = dict(ROUTES["featurize"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name in ("featurize", "lstm_scan"):
        check(launches[name] > 0,
              f"{name} launched on the main path ({launches[name]})")
    check(lstm_routes["cluster"] == launches["lstm_scan"],
          f"the fp32 path's scans take the cluster route ({lstm_routes})")
    check(feat_routes["staged"] == launches["featurize"],
          f"the fp32 path's featurize takes the staged route ({feat_routes})")
    check(launches["quantize"] == launches["qmm"]
          == launches["lstm_scan_q"] == 0, "the fp32 path runs no int8")
    check(res.est_tp.shape == (N_UES, T_PERIODS), "estimate shape")
    check(bool(np.isfinite(res.est_tp).all()), "estimates finite")
    check(bool(((res.est_tp >= TP_CLIP_MBPS[0])
                & (res.est_tp <= TP_CLIP_MBPS[1])).all()),
          "estimates inside TP_CLIP_MBPS")
    buckets = len(np.unique(np.round(res.est_tp)))
    # the same first UEs through the port on the CPU: controllers are per
    # UE and the forward is row-wise, so the subset is the same computation
    sub = sc.EpisodeBatch(
        scenario_idx=ep.scenario_idx[:CPU_UES],
        alloc_ratio=ep.alloc_ratio[:CPU_UES], int_dbm=ep.int_dbm[:CPU_UES],
        kpms=ep.kpms[:CPU_UES], tp_mbps=ep.tp_mbps[:CPU_UES],
        iq=ep.iq[:CPU_UES])
    cpu = simulate_fleet(sub, table, prof, cfg, warm_split=fixed,
                         estimator=(e, params), fused=True, device="cpu")
    est_diff = float(np.abs(cpu.est_tp - res.est_tp[:CPU_UES]).max())
    # f32 sums in other orders on the two devices (cuDNN/cuBLAS vs the CPU
    # library), scaled x40 by the rescaled head
    check(np.allclose(res.est_tp[:CPU_UES], cpu.est_tp, rtol=1e-4,
                      atol=1e-3), f"card estimates vs CPU ({est_diff:.3g})")
    check(np.array_equal(res.splits[:CPU_UES], cpu.splits),
          "card splits equal CPU splits on the UE subset")
    tables = np.broadcast_to(table.table, (CPU_UES, len(table.table)))
    check(np.array_equal(run_controllers(tables, cpu.est_tp, cfg, fixed),
                         cpu.splits), "card controllers on CPU estimates")
    for a, b in zip(split_metrics(prof, res.splits, res.true_tp),
                    split_metrics(prof, res.splits, res.true_tp,
                                  device="cpu")):
        check(np.array_equal(a, b), "float64 split metrics bit-equal")
    check(np.array_equal(res.delay_s[:CPU_UES], cpu.delay_s),
          "delay on the UE subset")
    print(f"main path: simulate_fleet(fused=True) {N_UES} UEs x {T_PERIODS} "
          f"periods, launches {launches}, {buckets} distinct 1-Mbps "
          f"buckets, max |card - cpu| estimate {est_diff:.3g} Mbps, splits "
          f"of UEs 0-{CPU_UES - 1} equal; peak device memory "
          f"{peak_gib:.2f} GiB; first run {cold_s:.3f} s")

    # 4b. the int8 path, once, with the launch counters read around it
    quant_shapes, mm_shapes = int8_shapes(e, N_UES * T_PERIODS, pass_rows)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res8 = simulate_fleet(ep, table, prof, cfg, warm_split=fixed,
                          estimator=(e, gparams), fused=True, quant="int8")
    torch.cuda.synchronize()
    cold8_s = time.perf_counter() - t0
    launches8 = dict(LAUNCHES)
    routes8 = {k: dict(v) for k, v in ROUTES.items()}
    peak8_gib = torch.cuda.max_memory_allocated() / 2**30
    for name in ("featurize", "quantize", "qmm", "lstm_scan_q"):
        check(launches8[name] > 0,
              f"{name} launched on the int8 path ({launches8[name]})")
    check(launches8["lstm_scan"] == 0, "the int8 path runs no fp32 scan")
    check(routes8["featurize"]["staged"] == launches8["featurize"],
          f"the int8 path's featurize takes the staged route ({routes8})")
    check(routes8["quantize"]["two_pass"] == 0
          and routes8["lstm_scan_q"]["mma"] == launches8["lstm_scan_q"],
          f"the int8 path's quantize reads each value once and its scan "
          f"runs on the tensor cores ({routes8})")
    check(launches8["quantize"] == sum(quant_shapes.values())
          and launches8["qmm"] == sum(mm_shapes.values()),
          f"int8 launches {launches8} match the path's shapes")
    check(res8.est_tp.shape == (N_UES, T_PERIODS), "int8 estimate shape")
    check(bool(np.isfinite(res8.est_tp).all()), "int8 estimates finite")
    check(bool(((res8.est_tp >= TP_CLIP_MBPS[0])
                & (res8.est_tp <= TP_CLIP_MBPS[1])).all()),
          "int8 estimates inside TP_CLIP_MBPS")
    buckets8 = len(np.unique(np.round(res8.est_tp)))
    cpu8 = simulate_fleet(sub, table, prof, cfg, warm_split=fixed,
                          estimator=(e, params), fused=True, quant="int8",
                          device="cpu")
    est8_diff = float(np.abs(cpu8.est_tp - res8.est_tp[:CPU_UES]).max())
    check(est8_diff <= INT8_EST_ATOL,
          f"int8 card estimates vs CPU within {INT8_EST_ATOL} Mbps "
          f"({est8_diff:.3g})")
    check(np.array_equal(res8.splits[:CPU_UES], cpu8.splits),
          "int8 card splits equal CPU splits on the UE subset")
    check(np.array_equal(run_controllers(tables, cpu8.est_tp, cfg, fixed),
                         cpu8.splits),
          "card controllers on CPU int8 estimates")
    check(np.array_equal(res8.delay_s[:CPU_UES], cpu8.delay_s),
          "int8 delay on the UE subset")
    rmse8 = float(np.sqrt(np.mean((res8.est_tp - res.est_tp) ** 2)))
    print(f"int8 path: simulate_fleet(fused=True, quant=\"int8\") {N_UES} "
          f"UEs x {T_PERIODS} periods, launches {launches8}, {buckets8} "
          f"distinct 1-Mbps buckets, max |card - cpu| estimate "
          f"{est8_diff:.3g} Mbps, splits of UEs 0-{CPU_UES - 1} equal; "
          f"RMSE against the fp32 run {rmse8:.4g} Mbps, splits differing "
          f"from fp32 in {int((res8.splits != res.splits).sum())} of "
          f"{res.splits.size}; peak device memory {peak8_gib:.2f} GiB; "
          f"first run {cold8_s:.3f} s")

    # 5. timings, beside the card's launch floor
    floor = launch_floor(dev)
    print(json.dumps({"launch_floor": floor}))
    feat_ms, feat_host = cuda_ms(
        lambda: featurize(slab, center, scale, W), 100)
    feat_plain, feat_plain_host = cuda_ms(
        lambda: featurize_ref(slab, center, scale, W), 100)
    n_out = win.numel()
    feat_bound, feat_by = bound(4 * (slab.numel() + 2 * e.n_kpms + n_out),
                                2 * n_out)
    lrow, _ = lstm_row(rows, lp)  # checked against plain, timed
    print(f"cuDNN LSTM yardstick max |err| vs plain "
          f"{lrow['library_max_abs_err']:.3g}")
    kernels = [
        {"name": "featurize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/featurize.cu",
         "replaces": "src/repro/kernels/featurize/kernel.py:40",
         "launches": launches["featurize"], "max_abs_err": 0.0,
         "ms": feat_ms, "plain_ms": feat_plain, "bound_ms": feat_bound,
         "bound_by": feat_by, "design_floor_ms": floor["empty_ms"],
         "library_ms": None, "host_ms": feat_host,
         "plain_host_ms": feat_plain_host,
         "routes": {"fp32": feat_routes, "int8": routes8["featurize"]}},
        {"name": "lstm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lstm_scan.cu",
         "replaces": "src/repro/kernels/lstm/kernel.py:92",
         "launches": launches["lstm_scan"], "routes": lstm_routes,
         **lrow, "max_abs_err": lstm_err},
    ]

    # the int8 kernels at every shape of one int8 run, each timed alone
    g = torch.Generator(device=dev).manual_seed(SEED)
    quant_rows = []
    for (n, d), count in sorted(quant_shapes.items()):
        x = torch.randn((n, d), generator=g, device=dev)
        quant_rows.append(quant_shape_row(x, count))
    mm_rows = qmm_rows(dev, mm_shapes, g)
    qt, mt = shape_totals(quant_rows), shape_totals(mm_rows)
    per_run = (f"one int8 path run ({N_UES * T_PERIODS} rows, one chunk): "
               "the sum over its launches, each shape timed alone")
    kernels += [
        {"name": "quantize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quant.cu",
         "replaces": "src/repro/kernels/quant/kernel.py:30",
         "launches": launches8["quantize"], "max_abs_err": 0.0,
         "ms": qt["ms"], "plain_ms": qt["plain_ms"],
         "bound_ms": qt["bound_ms"], "bound_by": qt["bound_by"],
         "library_ms": None, "host_ms": qt["host_ms"], "per": per_run,
         "routes": routes8["quantize"], "shapes": quant_rows},
        {"name": "qmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qmm.cu",
         "replaces": "src/repro/kernels/qmm/kernel.py:45",
         "launches": launches8["qmm"], "max_abs_err": 0.0,
         "ms": mt["ms"], "plain_ms": mt["plain_ms"],
         "bound_ms": mt["bound_ms"], "bound_by": mt["bound_by"],
         "library_ms": mt["library_ms"], "host_ms": mt["host_ms"],
         "plain_host_ms": mt["plain_host_ms"], "per": per_run,
         "shapes": mm_rows},
        {"name": "lstm_scan_q", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lstm_scan_q.cu",
         "replaces": "src/repro/kernels/lstm/kernel.py:120",
         "launches": launches8["lstm_scan_q"], "library_ms": None,
         "routes": routes8["lstm_scan_q"], **lq_row},
    ]
    for k in kernels:
        print(json.dumps(k))

    # end to end, warm (three runs), and by stage
    warm_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate_fleet(ep, table, prof, cfg, warm_split=fixed,
                       estimator=(e, gparams), fused=True)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    stages = {}
    # inside estimate_fleet: the episode's float64 IQ cast to float32 on
    # the host, then the copy to the card
    t0 = time.perf_counter()
    iq32 = np.asarray(ep.iq, np.float32)
    stages["iq_to_f32_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.from_numpy(iq32).to(dev)
    torch.cuda.synchronize()
    stages["iq_to_card"] = time.perf_counter() - t0
    del iq32
    t0 = time.perf_counter()
    est = estimate_fleet(ep, (e, gparams), fused=True)
    torch.cuda.synchronize()
    stages["estimate_fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    splits = run_controllers(
        np.broadcast_to(table.table, (N_UES, len(table.table))), est, cfg,
        fixed)
    stages["run_controllers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    split_metrics(prof, splits, ep.tp_mbps)
    stages["split_metrics"] = time.perf_counter() - t0
    print(json.dumps({"e2e": {
        "ue_periods": N_UES * T_PERIODS, "first_s": cold_s, "warm_s": warm_s,
        "ue_periods_per_s": N_UES * T_PERIODS / float(np.median(warm_s)),
        "stages_s": stages, "build_s": build_s,
        "peak_device_gib": peak_gib}}))
    warm8_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate_fleet(ep, table, prof, cfg, warm_split=fixed,
                       estimator=(e, gparams), fused=True, quant="int8")
        torch.cuda.synchronize()
        warm8_s.append(time.perf_counter() - t0)
    print(json.dumps({"e2e_int8": {
        "ue_periods": N_UES * T_PERIODS, "first_s": cold8_s,
        "warm_s": warm8_s,
        "ue_periods_per_s": N_UES * T_PERIODS / float(np.median(warm8_s)),
        "peak_device_gib": peak8_gib, "rmse_vs_fp32_mbps": rmse8}}))

    # 6. the multi-cell scheduled fleet on the recurrent SSM estimator
    seg_row, ssd_fused = cells_path(dev, prof, table, cfg, fixed, argv,
                                    floor)
    check(ssd_fused["route"] == "fused", "the cells path's ssd call takes "
          f"the fused route ({ssd_fused['route']})")
    kernels.append(seg_row)
    print(json.dumps(seg_row))
    print(json.dumps({"ssd_fused_route": ssd_fused}))

    # 7. split computing: VGG16 at full width with a measured privacy
    # profile
    split_row, quant_split = split_path(dev, argv)
    next(k for k in kernels if k["name"] == "quantize").update(quant_split)
    kernels.append(split_row)
    print(json.dumps(split_row))

    # 8. the dense LM's split serving at granite-8b's full width and depth
    torch.cuda.empty_cache()
    attn_row, quant_lm = lm_path(dev, smi, argv)
    next(k for k in kernels if k["name"] == "quantize").update(quant_lm)
    kernels.append(attn_row)
    print(json.dumps(attn_row))

    # 9. split serving of the SSD LM at mamba2-370m's full width and depth
    torch.cuda.empty_cache()
    ssd_routes, quant_ssd = ssd_lm_path(dev, smi, argv)
    next(k for k in kernels if k["name"] == "quantize").update(quant_ssd)
    main = ssd_routes["chunked_wgmma"]
    ssd_row = {
        "name": "ssd", "route": "cuda", "source": main["source"],
        "replaces": "src/repro/kernels/ssd/kernel.py:65",
        "launches": main["launches"], "max_abs_err": main["max_abs_err"],
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "design_floor_ms")},
        "per": f"one call ({main['device_launches_per_call']} device "
               f"launches) at the SSD LM's shape {main['shape']} bf16, "
               f"{main['launches']} a split inference; routes: each route "
               "at its own path's shape (the CUDA-core chunked route at "
               "the SSD LM's shape in f32), with that path's calls a run",
        "routes": {**ssd_routes, "fused": ssd_fused}}
    kernels.append(ssd_row)
    print(json.dumps(ssd_row))

    # 10. split serving of the MoE LMs: mixtral-8x22b at full width cut to
    # 12 layers, llama4-scout-17b-a16e cut to 2
    torch.cuda.empty_cache()
    moe = moe_path(dev, smi, argv)
    # 11-12. split serving of the RG-LRU hybrid (recurrentgemma-2b) at full
    # width and depth, and of the VLM (llama-3.2-vision-90b) cut to 10
    # layers
    torch.cuda.empty_cache()
    hyb, vlm = hybrid_path(dev, smi, argv)
    attn_row["launches_by_path"] = {
        LM_ARCH: attn_row["launches"], f"{MOE_ARCH} ({MOE_LAYERS} layers)":
        moe["launches"], f"{SCOUT_ARCH} ({SCOUT_LAYERS} layers, forward)":
        moe["scout_launches"], HYBRID_ARCH: hyb["launches"],
        f"{VLM_ARCH} ({VLM_LAYERS} layers)": vlm["launches"]}
    next(k for k in kernels if k["name"] == "quantize").update({
        "launches_moe_lm": moe["quantize_launches"],
        "moe_lm_boundary": moe["boundary"],
        "launches_hybrid_lm": hyb["quantize_launches"],
        "hybrid_lm_boundary": hyb["boundary"],
        "launches_vlm": vlm["quantize_launches"],
        "vlm_boundary": vlm["boundary"]})

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_run:
            simulate_fleet(ep, table, prof, cfg, warm_split=fixed,
                           estimator=(e, gparams), fused=True)
            torch.cuda.synchronize()
        print(f"profiled run: {time.perf_counter() - t0:.3f} s wall")
        print(prof_run.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=20))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_run:
            simulate_fleet(ep, table, prof, cfg, warm_split=fixed,
                           estimator=(e, gparams), fused=True, quant="int8")
            torch.cuda.synchronize()
        print("profiled int8 run")
        print(prof_run.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=20))

    # 13. decode on every LM path, and each kernel's decode launches
    print(json.dumps({"e2e_decode": E2E_DECODE}))
    for k in kernels:
        k["launches_decode"] = DECODE_LAUNCHES[k["name"]]
    check(DECODE_LAUNCHES["quantize"] > 0 and not any(
        DECODE_LAUNCHES[k] for k in ("flash_attention", "ssd")),
        f"decode launched quantize (the int8 KV cache) and no attention or "
        f"ssd kernel ({dict(DECODE_LAUNCHES)})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
