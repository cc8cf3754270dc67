"""Rowwise symmetric int8 quantization.

``quantize`` is the wrapper of the CUDA kernel ``csrc/quant.cu``;
``quantize_ref`` is its plain PyTorch version, which the wrapper runs for
tensors on the CPU and the tests hold the kernel to. ``quantize_rows`` is
the dispatch for any leading shape.

The formula is the reference's, kept here in its own copy:
``scale = max(amax, 1e-8) * f32(1 / 127)`` with an explicit reciprocal
multiply, then ``q = clip(round_half_even(x / scale), -128, 127)`` with a
true division. Both are load-bearing: a 1-ulp skew in the scale
flips a rounding, and so does a reciprocal in place of the division.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

F32 = torch.float32
I8 = torch.int8
QMAX = 127
SCALE_FLOOR = 1e-8


def quantize_ref(x: torch.Tensor):
    """x (..., d) -> (q int8 (..., d), scale f32 (..., 1))."""
    x = x.to(F32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    recip = torch.tensor(1.0 / QMAX, dtype=F32, device=x.device)
    scale = torch.clamp_min(amax, SCALE_FLOOR) * recip
    q = torch.clamp(torch.round(x / scale), -QMAX - 1, QMAX)
    return q.to(I8), scale


def _check(x):
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    if x.dtype != F32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[1] < 1:
        raise ValueError("rows must hold at least one value")


def quantize(x: torch.Tensor):
    """The quantize kernel: contiguous f32 (n, d) -> (q int8 (n, d),
    scale f32 (n, 1)).

    Tensors on the CPU run ``quantize_ref``; on a card the CUDA kernel
    runs, or this raises."""
    _check(x)
    if x.device.type == "cpu":
        return quantize_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    n, d = x.shape
    q = torch.empty((n, d), dtype=I8, device=x.device)
    scale = torch.empty((n, 1), dtype=F32, device=x.device)
    if n == 0:
        return q, scale
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_quantize_rows_s8(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "quantize")
    _build.LAUNCHES["quantize"] += 1
    return q, scale


def quantize_rows(x: torch.Tensor):
    """x (..., d) f32 -> (q int8 (..., d), scale f32 (..., 1)), one scale
    per row of the last axis, on the input's device."""
    shape = x.shape
    q, s = quantize(x.to(F32).reshape(-1, shape[-1]).contiguous())
    return q.reshape(shape), s.reshape(*shape[:-1], 1)
