"""Rowwise symmetric integer quantization (int8 codes, ``qmax`` 127 or 7)
of f32 or bf16 rows (a bf16 value upcasts to f32 exactly, so both give the
codes of the f32 values).

``quantize`` is the wrapper of the CUDA kernel ``csrc/quant.cu``;
``quantize_ref`` is its plain PyTorch version, which the wrapper runs for
tensors on the CPU and the tests hold the kernel to. ``quantize_rows`` is
the dispatch for any leading shape.

The formula is the reference's, kept here in its own copy:
``scale = max(amax, 1e-8) * f32(1 / qmax)`` with an explicit reciprocal
multiply, then ``q = clip(round_half_even(x / scale), -qmax - 1, qmax)``
with a true division. Both are load-bearing: a 1-ulp skew in the scale
flips a rounding, and so does a reciprocal in place of the division. The
reciprocal is the double ``1 / qmax`` rounded once to f32, on the host for
the kernel too (``jnp.float32(1.0 / qmax)`` in the reference).

On a card ``route`` picks the kernel from the rows' shape, dtype and
alignment (see ``csrc/quant.cu``); every route but ``two_pass`` reads each
value from device memory once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

F32 = torch.float32
BF16 = torch.bfloat16
I8 = torch.int8
SCALE_FLOOR = 1e-8

# the routes of csrc/quant.cu and their codes in its C entry points
ROUTE_IDS = {"warp": 0, "warp_scalar": 1, "block": 2, "cluster": 3,
             "two_pass": 4}
# bytes of a row each route holds on chip: a warp's 32 lanes x 4 vectors
# of 16 bytes, a 512-thread block's 16 vectors a thread, a cluster's
# CLUSTER_MAX blocks (always all 8) of a slice of up to 208 KB each; values
# of a row off the 16-byte grid that a warp's 32 lanes hold, 32 each
WARP_MAX_BYTES = 32 * 4 * 16
BLOCK_MAX_BYTES = 512 * 16 * 16
CLUSTER_SLICE_MAX = 208 * 1024
CLUSTER_MAX = 8
SCALAR_MAX = 32 * 32


def route(n: int, d: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The kernel a card runs for (n, d) rows of ``dtype`` (f32 or bf16):

    - "warp": rows on the 16-byte grid (``aligned``: the base on 16 bytes;
      and d times the value's bytes a multiple of 16) of up to
      ``WARP_MAX_BYTES``, a group of 1-32 lanes a row held in registers;
    - "warp_scalar": rows off the grid of up to ``SCALAR_MAX`` values, the
      same with a value a load;
    - "block": rows on the grid of up to ``BLOCK_MAX_BYTES``, a 512-thread
      block a row held in registers;
    - "cluster": rows on the grid of up to ``CLUSTER_MAX`` slices of
      ``CLUSTER_SLICE_MAX``, a cluster of ``CLUSTER_MAX`` blocks a row
      held in shared memory;
    - "two_pass": the rest, a block a row read twice (no path of the
      repository has such rows)."""
    del n  # every route takes any number of rows
    row = d * (4 if dtype == F32 else 2)
    if not aligned or row % 16:
        return "warp_scalar" if d <= SCALAR_MAX else "two_pass"
    if row <= WARP_MAX_BYTES:
        return "warp"
    if row <= BLOCK_MAX_BYTES:
        return "block"
    if row <= CLUSTER_MAX * CLUSTER_SLICE_MAX:
        return "cluster"
    return "two_pass"


def quantize_ref(x: torch.Tensor, qmax: int = 127):
    """x (..., d) -> (q int8 (..., d), scale f32 (..., 1))."""
    x = x.to(F32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    recip = torch.tensor(1.0 / qmax, dtype=F32, device=x.device)
    scale = torch.clamp_min(amax, SCALE_FLOOR) * recip
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(I8), scale


def _check(x, qmax):
    if not 1 <= qmax <= 127:
        raise ValueError(f"qmax must lie in [1, 127] for int8 codes, got "
                         f"{qmax}")
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    if x.dtype not in (F32, BF16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[1] < 1:
        raise ValueError("rows must hold at least one value")


def quantize(x: torch.Tensor, qmax: int = 127):
    """The quantize kernel: contiguous f32 or bf16 (n, d) -> (q int8 (n, d),
    scale f32 (n, 1)), codes in [-qmax - 1, qmax].

    Tensors on the CPU run ``quantize_ref``; on a card the CUDA kernel
    runs, or this raises."""
    qmax = int(qmax)
    _check(x, qmax)
    if x.device.type == "cpu":
        return quantize_ref(x, qmax)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    n, d = x.shape
    q = torch.empty((n, d), dtype=I8, device=x.device)
    scale = torch.empty((n, 1), dtype=F32, device=x.device)
    if n == 0:
        return q, scale
    which = route(n, d, x.dtype, x.data_ptr() % 16 == 0)
    lib = _build.library()
    entry = (lib.repro_quantize_rows_bf16_s8 if x.dtype == BF16
             else lib.repro_quantize_rows_s8)
    with torch.cuda.device(x.device):
        rc = entry(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), n, d, qmax,
            float(np.float32(1.0 / qmax)), ROUTE_IDS[which],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "quantize")
    _build.LAUNCHES["quantize"] += 1
    _build.ROUTES["quantize"][which] += 1
    return q, scale


def quantize_rows(x: torch.Tensor, qmax: int = 127):
    """x (..., d) -> (q int8 (..., d), scale f32 (..., 1)), one scale per
    row of the last axis, on the input's device. bf16 goes to the kernel as
    it is; any other type is cast to f32 first."""
    shape = x.shape
    if x.dtype != BF16:
        x = x.to(F32)
    q, s = quantize(x.reshape(-1, shape[-1]).contiguous(), qmax)
    return q.reshape(shape), s.reshape(*shape[:-1], 1)
