"""int8 x int8 -> int32 rowwise-scaled matrix product.

``qmm`` is the wrapper of the CUDA kernel ``csrc/qmm.cu``; ``qmm_ref`` is
its plain PyTorch version, which the wrapper runs for tensors on the CPU
and the tests hold the kernel to. Integer sums are exact, so the kernel
and the plain version agree bit for bit.

``quantize_weight`` is the offline half of int8 serving (once per
deployment), ``int8_matmul`` the serving half: it quantizes the
activation rows with the ``quantize`` kernel, then runs ``qmm``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import quantize, quantize_rows

F32 = torch.float32
I8 = torch.int8
I32 = torch.int32

# Split-K for the kernel: aim at this many blocks in flight (two an SM),
# and give every split at least KSPLIT_MIN_BYTES of the contraction. Its
# TILE x TILE output tiles (kTile in qmm.cu; a mismatch costs speed, not
# correctness) alone fill the card only when M and N are large.
TARGET_BLOCKS = 264
KSPLIT_MIN_BYTES = 512
TILE = 64


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact.

    The products run in float64: an int8 x int8 product is below 2^14 and
    a sum of K of them below 2^53 for any K under 2^39, so every partial
    sum is an exact integer (``torch.matmul`` has no int32 on a card)."""
    return (a.to(torch.float64) @ b.to(torch.float64).T).to(I32)


def qmm_ref(xq, sx, wq, sw) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) f32, rowwise scales applied as
    ``acc * sx * sw.T`` in that order."""
    return int_dot(xq, wq).to(F32) * sx.to(F32) * sw.to(F32).T


def _check(xq, sx, wq, sw):
    if xq.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"xq and wq must be 2-D, got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    (m, k), n = xq.shape, wq.shape[0]
    want = {"xq": (I8, (m, k)), "sx": (F32, (m, 1)), "wq": (I8, (n, k)),
            "sw": (F32, (n, 1))}
    for name, t in (("xq", xq), ("sx", sx), ("wq", wq), ("sw", sw)):
        dtype, shape = want[name]
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k < 1:
        raise ValueError("the contraction must hold at least one value")


def k_splits(m: int, n: int, k: int) -> int:
    """How many slices of K the kernel sums apart (int32, exact)."""
    tiles = -(-m // TILE) * -(-n // TILE)
    most = max(1, -(-k // KSPLIT_MIN_BYTES))
    return max(1, min(most, -(-TARGET_BLOCKS // tiles)))


def qmm(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
        sw: torch.Tensor) -> torch.Tensor:
    """The qmm kernel: contiguous int8 xq (M, K), f32 sx (M, 1), int8 wq
    (N, K), f32 sw (N, 1) -> (M, N) f32.

    Tensors on the CPU run ``qmm_ref``; on a card the CUDA kernel runs,
    or this raises."""
    _check(xq, sx, wq, sw)
    if xq.device.type == "cpu":
        return qmm_ref(xq, sx, wq, sw)
    if xq.device.type != "cuda":
        raise ValueError(f"no qmm kernel for device {xq.device}")
    (m, k), n = xq.shape, wq.shape[0]
    out = torch.empty((m, n), dtype=F32, device=xq.device)
    if m == 0 or n == 0:
        return out
    splits = k_splits(m, n, k)
    # int32 partial sums of each K slice, summed by the kernel's epilogue
    part = torch.empty((splits, m, n) if splits > 1 else (0,), dtype=I32,
                       device=xq.device)
    lib = _build.library()
    with torch.cuda.device(xq.device):
        rc = lib.repro_qmm_s8(
            xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            out.data_ptr(), part.data_ptr(), m, n, k, splits,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "qmm")
    _build.LAUNCHES["qmm"] += 1
    return out


def quantize_weight(w: torch.Tensor):
    """(K, N) f32 weight -> ((N, K) int8, (N, 1) f32 scales): rowwise
    quantization of ``w.T``, one int8 row and one scale per output
    channel, on the weight's device."""
    return quantize_rows(w.T)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 @ a ``quantize_weight`` pair -> (M, N) f32.

    The activation rows are quantized with the ``quantize`` kernel, then
    multiplied in int8 x int8 -> int32 and scaled back to f32."""
    xq, sx = quantize(x.to(F32).contiguous())
    return qmm(xq, sx, wq.contiguous(), sw.to(F32).contiguous())
