#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

In order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels (eight) from the sources in this
     checkout;
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
     paths end to end;
  6. the multi-cell path: ``simulate_cells`` of 1024 UEs over 4 cells x 100
     periods with handovers and load-coupled interference, the pf PRB
     scheduler on the segsum kernel and the recurrent SSM estimator on the
     ssd kernel (a short maxsinr run too): both kernels against their plain
     versions, the runs with their launch counts (cold, then three warm),
     the whole fleet against the port on the CPU, the scheduler on the
     CPU's estimates on both devices, kernel timings (``scatter_reduce_``
     as segsum's yardstick) and an ``e2e_cells`` line;
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
  8. prints the ``{"kernels": [...]}`` line and, last,
     ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero. Without a card, or
outside a checkout of the repository, it exits non-zero and prints no
result.

    python3 chip_smoke.py            # what the card check runs
    python3 chip_smoke.py --profile  # also: a torch.profiler breakdown
"""
from __future__ import annotations

import json
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


def bound(nbytes: float, flops: float,
          int8_ops: float = 0.0) -> tuple[float, str]:
    """Least time on the card (ms) for the work, and what bounds it: the
    bytes over the memory rate, or the operations of each type over that
    type's peak (FP32 and int8 run on separate units, so the larger)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOPS, int8_ops / INT8_OPS)
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
             L: int) -> tuple[int, int]:
    """(bytes, flops) of one SSD sequence pass: every input read once and
    both outputs written once (f32); per (batch, group) and chunk the
    lower triangle of C.B, the masked intra-chunk product (a difference,
    an exp and a multiply a (t, s, head), then hd multiply-adds), dt * x,
    the cumsum, the state term of y and the state update."""
    hpg, nc, tri = nh // G, S // L, L * (L + 1) // 2
    nbytes = 4 * (2 * B * S * nh * hd + B * S * nh + nh + 2 * B * S * G * N
                  + B * G * hpg * hd * N)
    per_chunk = (2 * N * tri + hpg * tri * (3 + 2 * hd) + L * hpg * hd
                 + 2 * L * hpg + L * hpg * hd * (2 * N + 2)
                 + hpg * hd * N * (3 * L + 2))
    return nbytes, B * G * nc * per_chunk


def cells_path(dev, prof, table, cfg, fixed, argv) -> list:
    """The multi-cell, PRB-scheduled fleet driven by the recurrent SSM
    estimator at the repo's cells sweep size (benchmarks/fleet.py
    run_cells: 1024 UEs over 4 cells, T = 100): the segsum and ssd kernels
    against their plain versions, the path's runs with their launch
    counts, the whole fleet against the port on the CPU, timings and the
    ``e2e_cells`` line. Returns the two kernels' rows of the kernels
    line."""
    from repro_torch.channel import scenarios as sc
    from repro_torch.estimator.ssm import (SSMConfig, episode_features,
                                           init_ssm, reduce_forecasts,
                                           ssm_forward_seq)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.segsum import (segment_reduce_batched,
                                            segment_reduce_ref)
    from repro_torch.kernels.ssd import ssd, ssd_ref
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
    ssd_shapes = [(n, 192, 64, 4, 8, 1, 8), (2, 64, 16, 4, 16, 1, 8),
                  (2, 128, 32, 8, 32, 2, 16), (2, 96, 96, 2, 8, 1, 4)]
    ssd_err = [0.0, 0.0]
    for B, S, L, nh, hd, G, N in ssd_shapes:
        x = torch.randn((B, S, nh, hd), generator=g, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, nh), generator=g, device=dev)) * 0.5
        A = -torch.exp(torch.randn(nh, generator=g, device=dev) * 0.3)
        Bm = torch.randn((B, S, G, N), generator=g, device=dev)
        Cm = torch.randn((B, S, G, N), generator=g, device=dev)
        y, st = ssd(x, dt, A, Bm, Cm, chunk=L)
        torch.cuda.synchronize()
        yr, sr = ssd_ref(x, dt, A, Bm, Cm, L)
        check(torch.allclose(y, yr, rtol=1e-4, atol=1e-4)
              and torch.allclose(st, sr, rtol=1e-3, atol=1e-3),
              f"ssd within 1e-4 (y) and 1e-3 (state) of plain at "
              f"{(B, S, L, nh, hd, G, N)}")
        ssd_err = [max(ssd_err[0], (y - yr).abs().max().item()),
                   max(ssd_err[1], (st - sr).abs().max().item())]
        if B == n:
            ssd_in = (x, dt, A, Bm, Cm, L)
    print(f"cells kernels vs plain: segsum max bit-equal, sum max |err| "
          f"{seg_err:.3g} (rtol 1e-6) at (1, {n}), ({T + W}, {n}) and a "
          f"masked (7, 1024) with ids in [-3, {C + 3}); ssd max |err| "
          f"y {ssd_err[0]:.3g}, state {ssd_err[1]:.3g} at "
          f"{[s[:5] for s in ssd_shapes]}")

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
    x, dt, A, Bm, Cm, L = ssd_in
    ssd_ms, ssd_host = cuda_ms(lambda: ssd(x, dt, A, Bm, Cm, chunk=L), 50)
    ssd_plain, ssd_plain_host = cuda_ms(lambda: ssd_ref(x, dt, A, Bm, Cm, L),
                                        5)
    B, S, nh, hd = x.shape
    nbytes, flops = ssd_work(B, S, nh, hd, Bm.shape[2], Bm.shape[3], L)
    ssd_bound, ssd_by = bound(nbytes, flops)

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
         "per": f"one launch at the pf scheduler's shape (1, {n}) -> {C}, "
               f"{T} a run; shapes: each op at both path shapes",
         "shapes": seg_rows},
        {"name": "ssd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd/kernel.py:65",
         "launches": launches["ssd"], "max_abs_err": ssd_err[0],
         "state_max_abs_err": ssd_err[1], "ms": ssd_ms,
         "plain_ms": ssd_plain, "bound_ms": ssd_bound, "bound_by": ssd_by,
         "library_ms": None, "host_ms": ssd_host,
         "plain_host_ms": ssd_plain_host,
         "shape": [B, S, nh, hd, Bm.shape[2], Bm.shape[3], L]},
    ]


def pairwise_work(n: int, d: int) -> tuple[int, int]:
    """(bytes, flops) of one pairwise-distance call: x read once and the
    (n, n) distances written once (f32); the Gram x x^T, which is
    symmetric, so one multiply-add for each of its n (n + 1) / 2 distinct
    pairs and d columns."""
    return 4 * (n * d + n * n), n * (n + 1) * d


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
    from repro_torch.kernels.dcor import (dcor_kernel, pairwise_dists,
                                          pairwise_dists_ref)
    from repro_torch.kernels.quant import quantize, quantize_ref
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

    # the kernel against its plain version at the path's shapes, on
    # non-negative rows as after a ReLU
    g = torch.Generator(device=dev).manual_seed(SEED)
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
        dist_rel = max(dist_rel, rel)
        dist_err = max(dist_err, float((got - want).abs().max()))
        del x, got, again, want
    print(f"pairwise_dists vs plain at {PAIRWISE_CHECKS}: diagonal 0, "
          f"symmetric and repeatable bit for bit; max |d2 err| / (|x_i|^2 + "
          f"|x_j|^2) {dist_rel:.3g} (bound {DIST_RTOL}), max |err| "
          f"{dist_err:.3g}")

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

    # the kernel at every shape of one profile run, each timed alone
    widths = Counter([int(np.prod(s)) for s in _shapes(FULL)])
    widths[int(np.prod(xs.shape[1:]))] += len(_shapes(FULL))  # the input
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
        rows.append({"shape": [n, d], "count": count, "ms": ms,
                     "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": lms, "host_ms": host,
                     "plain_host_ms": phost, "library_host_ms": lhost})
        del x
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
    from repro_torch.estimator.model import (CNN_CHUNK_BYTES,
                                             EstimatorConfig, conv_trunk,
                                             full_f32, init_estimator)
    from repro_torch.estimator.serve import quantize_estimator
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.featurize import featurize, featurize_ref
    from repro_torch.kernels.lstm import (lstm_scan, lstm_scan_q,
                                          lstm_scan_q_ref, lstm_scan_ref)
    from repro_torch.kernels.qmm import qmm, qmm_ref
    from repro_torch.kernels.quant import quantize, quantize_ref
    from repro_torch.models.vgg import FULL, vgg_split_profile
    from repro_torch.sim import (estimate_fleet, run_controllers,
                                 simulate_fleet, split_metrics)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions too

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
    hq8 = lstm_scan_q(rows, *lq["wx"], *lq["wh"], lq["b"])
    hq8_ref = lstm_scan_q_ref(rows, *lq["wx"], *lq["wh"], lq["b"])
    torch.cuda.synchronize()
    qerr = (hq8 - hq8_ref).abs()
    lstm_q_err = qerr.max().item()
    lstm_q_rows = int((qerr.amax(dim=1) > 1e-5).sum())
    check(lstm_q_err <= Q_SCAN_ATOL
          and lstm_q_rows <= Q_SCAN_ROWS_OFF * rows.shape[0],
          f"lstm_scan_q within {Q_SCAN_ATOL} of plain, at most "
          f"{Q_SCAN_ROWS_OFF:.0%} of rows beyond 1e-5 ({lstm_q_err:.3g}, "
          f"{lstm_q_rows} rows)")
    pass_rows = max(1, CNN_CHUNK_BYTES // (4 * e.cnn_ch[0] * e.n_sc
                                           * e.n_sym))
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
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name in ("featurize", "lstm_scan"):
        check(launches[name] > 0,
              f"{name} launched on the main path ({launches[name]})")
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
    peak8_gib = torch.cuda.max_memory_allocated() / 2**30
    for name in ("featurize", "quantize", "qmm", "lstm_scan_q"):
        check(launches8[name] > 0,
              f"{name} launched on the int8 path ({launches8[name]})")
    check(launches8["lstm_scan"] == 0, "the int8 path runs no fp32 scan")
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

    # 5. timings
    n_rows, hid = rows.shape[0], e.lstm_hidden
    feat_ms, feat_host = cuda_ms(
        lambda: featurize(slab, center, scale, W), 100)
    feat_plain, feat_plain_host = cuda_ms(
        lambda: featurize_ref(slab, center, scale, W), 100)
    n_out = win.numel()
    feat_bound, feat_by = bound(4 * (slab.numel() + 2 * e.n_kpms + n_out),
                                2 * n_out)
    lstm_ms, lstm_host = cuda_ms(
        lambda: lstm_scan(rows, lp["wx"], lp["wh"], lp["b"]), 50)
    lstm_plain, lstm_plain_host = cuda_ms(  # about 420 launches a call
        lambda: lstm_scan_ref(rows, lp["wx"], lp["wh"], lp["b"]), 2)
    # multiply-adds of both products (2 each), the two sums and the bias
    # per gate, and 5 multiply/adds of the state update; exp/tanh uncounted
    steps = n_rows * W
    lstm_flops = steps * (2 * 4 * hid * (e.n_kpms + hid) + 2 * 4 * hid
                          + 5 * hid)
    lstm_bytes = 4 * (rows.numel() + lp["wx"].numel() + lp["wh"].numel()
                      + lp["b"].numel() + n_rows * hid)
    lstm_bound, lstm_by = bound(lstm_bytes, lstm_flops)
    # yardstick only (the port never calls it): cuDNN's LSTM computes the
    # same cell with weight_ih = wx.T, weight_hh = wh.T, bias_ih = b and
    # +1 on the forget slice of bias_hh (gate order i, f, g, o in both)
    ref_lstm = torch.nn.LSTM(e.n_kpms, hid, batch_first=True).to(dev)
    with torch.no_grad():
        ref_lstm.weight_ih_l0.copy_(lp["wx"].T)
        ref_lstm.weight_hh_l0.copy_(lp["wh"].T)
        ref_lstm.bias_ih_l0.copy_(lp["b"])
        ref_lstm.bias_hh_l0.zero_()
        ref_lstm.bias_hh_l0[hid:2 * hid] = 1.0
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        lib_err = (ref_lstm(rows)[1][0][0] - h_ref).abs().max().item()
        lib_ms, lib_host = cuda_ms(lambda: ref_lstm(rows), 20)
    print(f"cuDNN LSTM yardstick max |err| vs plain {lib_err:.3g}")
    kernels = [
        {"name": "featurize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/featurize.cu",
         "replaces": "src/repro/kernels/featurize/kernel.py:40",
         "launches": launches["featurize"], "max_abs_err": 0.0,
         "ms": feat_ms, "plain_ms": feat_plain, "bound_ms": feat_bound,
         "bound_by": feat_by, "library_ms": None, "host_ms": feat_host,
         "plain_host_ms": feat_plain_host},
        {"name": "lstm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lstm_scan.cu",
         "replaces": "src/repro/kernels/lstm/kernel.py:92",
         "launches": launches["lstm_scan"], "max_abs_err": lstm_err,
         "ms": lstm_ms, "plain_ms": lstm_plain, "bound_ms": lstm_bound,
         "bound_by": lstm_by, "library_ms": lib_ms, "host_ms": lstm_host,
         "plain_host_ms": lstm_plain_host, "library_host_ms": lib_host},
    ]

    # the int8 kernels at every shape of one int8 run, each timed alone
    g = torch.Generator(device=dev).manual_seed(SEED)

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    quant_rows = []
    for (n, d), count in sorted(quant_shapes.items()):
        x = torch.randn((n, d), generator=g, device=dev)
        ms, host = cuda_ms(lambda: quantize(x), 50)
        pms, phost = cuda_ms(lambda: quantize_ref(x), 20)
        # abs and max for the amax; divide, round and clip for a code
        b_ms, by = bound(4 * n * d + n * d + 4 * n, 5 * n * d)
        quant_rows.append({"shape": [n, d], "count": count, "ms": ms,
                           "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
                           "library_ms": None, "host_ms": host,
                           "plain_host_ms": phost})
    mm_rows = []
    for (m, n, k), count in sorted(mm_shapes.items()):
        xq, wq = codes(m, k), codes(n, k)
        sx = torch.rand((m, 1), generator=g, device=dev) + 0.01
        sw = torch.rand((n, 1), generator=g, device=dev) + 0.01
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
        mm_rows.append({"shape": [m, n, k], "count": count, "ms": ms,
                        "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
                        "library_ms": lms, "host_ms": host,
                        "plain_host_ms": phost, "library_host_ms": lhost,
                        "library_bit_equal": lib_eq})
    lq_ms, lq_host = cuda_ms(
        lambda: lstm_scan_q(rows, *lq["wx"], *lq["wh"], lq["b"]), 50)
    lq_plain, lq_plain_host = cuda_ms(  # about 1,350 launches a call
        lambda: lstm_scan_q_ref(rows, *lq["wx"], *lq["wh"], lq["b"]), 1)
    # int8 multiply-adds of both dots (2 each); per row and step, f32:
    # 5 a value to quantize x_t and h, 6 a gate column to scale and add
    # (24 a unit) and about 16 a unit for the gates; exp/tanh counted once
    k_in = e.n_kpms
    lq_bound, lq_by = bound(
        4 * rows.numel() + lq["wx"][0].numel() + lq["wh"][0].numel()
        + 4 * (2 * 4 * hid + 4 * hid) + 4 * n_rows * hid,
        steps * (5 * k_in + 45 * hid), steps * 2 * 4 * hid * (k_in + hid))
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
         "library_ms": None, "host_ms": qt["host_ms"],
         "plain_host_ms": qt["plain_host_ms"], "per": per_run,
         "shapes": quant_rows},
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
         "launches": launches8["lstm_scan_q"], "max_abs_err": lstm_q_err,
         "rows_beyond_1e-5": lstm_q_rows, "ms": lq_ms,
         "plain_ms": lq_plain, "bound_ms": lq_bound, "bound_by": lq_by,
         "library_ms": None, "host_ms": lq_host,
         "plain_host_ms": lq_plain_host},
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
    kernels += cells_path(dev, prof, table, cfg, fixed, argv)
    for k in kernels[-2:]:
        print(json.dumps(k))

    # 7. split computing: VGG16 at full width with a measured privacy
    # profile
    split_row, quant_split = split_path(dev, argv)
    next(k for k in kernels if k["name"] == "quantize").update(quant_split)
    kernels.append(split_row)
    print(json.dumps(split_row))

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

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
