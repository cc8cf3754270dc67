#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

In order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels from the sources in this checkout;
  3. holds each kernel against its plain PyTorch version on the card, at
     the shapes of its path (128 UEs x a 16-period chunk: B = 2048
     estimator rows; the int8 path's fc in passes of 365 rows);
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
  6. prints ``{"ok": true, "device": {...}}`` as the last line.

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
