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

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import quantize, quantize_rows

F32 = torch.float32
I8 = torch.int8
I32 = torch.int32

# the wgmma route (csrc/qmm.cu): TILE x TILE output tiles, K in whole
# K_TILE-byte tiles (BM, BN, BK there), up to CLUSTER splits of a tile in
# a cluster (the portable most)
TILE = 128
K_TILE = 128
CLUSTER = 8


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


def plan(m: int, n: int, k: int, fit,
         aligned: bool = True) -> tuple[str, int, int, int]:
    """(route, k tiles a split, splits, cluster) of a launch, from the
    shape, the operands' alignment and ``fit(c)``, how many clusters of c
    blocks of the wgmma route the card runs at once.

    ``"wgmma"``, the int8 tensor cores fed by TMA, where K is a multiple of
    16 and both bases are 16-byte aligned, as TMA requires: the CNN fc.
    Its TILE x TILE output tiles times ranges of whole K_TILE-byte k tiles
    run in one wave, the splits of a tile in clusters of ``cluster`` (the
    largest of CLUSTER, 4, 2 that gives every cluster's split a k tile)
    that add their int32 sums in shared memory; several clusters add
    theirs exactly with integer atomics. Only the last cluster's trailing
    splits may hold no k tile. ``"dp4a"``, on the CUDA cores, takes every
    other shape (the 124-deep products of the LSTM projection and the
    head): one block a 64 x 64 tile over all of K, so (0, 1, 1)."""
    if k % 16 or not aligned:
        return "dp4a", 0, 1, 1
    tiles = -(-m // TILE) * -(-n // TILE)
    k_tiles = -(-k // K_TILE)
    splits = cluster = 1
    for c in (CLUSTER, 4, 2):
        s = min(fit(c) // tiles, k_tiles // c) * c
        if s >= c:
            splits, cluster = s, c
            break
    per = -(-k_tiles // splits)
    return "wgmma", per, -(-k_tiles // (per * cluster)) * cluster, cluster


def card_fit(index: int):
    """``plan``'s fit for card ``index``: the clusters of the wgmma route it
    runs at once, asked of the card once."""
    return functools.partial(_build.max_clusters, "repro_qmm_max_clusters",
                             index)


@functools.lru_cache(maxsize=None)
def _card_plan(m: int, n: int, k: int, index: int, aligned: bool):
    return plan(m, n, k, card_fit(index), aligned)


def qmm(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
        sw: torch.Tensor) -> torch.Tensor:
    """The qmm kernel: contiguous int8 xq (M, K), f32 sx (M, 1), int8 wq
    (N, K), f32 sw (N, 1) -> (M, N) f32.

    Tensors on the CPU run ``qmm_ref``; on a card the CUDA kernel runs on
    the route ``plan`` picks, or this raises."""
    _check(xq, sx, wq, sw)
    if xq.device.type == "cpu":
        return qmm_ref(xq, sx, wq, sw)
    if xq.device.type != "cuda":
        raise ValueError(f"no qmm kernel for device {xq.device}")
    (m, k), n = xq.shape, wq.shape[0]
    out = torch.empty((m, n), dtype=F32, device=xq.device)
    if m == 0 or n == 0:
        return out
    index = xq.device.index
    aligned = xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    route, per, splits, cluster = _card_plan(m, n, k, index, aligned)
    lib = _build.library()
    ptrs = (xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            out.data_ptr())
    ctx, stream = _build.device_stream(index)
    with ctx:
        if route == "wgmma":
            # the tickets (cluster a tile), then the (m, n) int32 sums of
            # the clusters
            tiles = -(-m // TILE) * -(-n // TILE)
            scratch = (_build.scratch(index, stream, tiles * cluster + m * n)
                       .data_ptr() if splits > cluster else None)
            rc = lib.repro_qmm_s8_wgmma(*ptrs, scratch, m, n, k, per, splits,
                                        cluster, stream)
        else:
            rc = lib.repro_qmm_s8_dp4a(*ptrs, m, n, k, stream)
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
