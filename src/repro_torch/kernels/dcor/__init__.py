"""Pairwise Euclidean distances, the O(n^2 d) inner loop of distance
correlation (the privacy metric).

``pairwise_dists`` is the wrapper of the CUDA kernel ``csrc/dcor.cu``;
``pairwise_dists_ref`` is its plain PyTorch version, the oracle of
``repro_torch.core.privacy`` (with its exact-0 diagonal), which the
wrapper runs for tensors on the CPU and the tests hold the kernel to.
``dcor_kernel`` is distance correlation with the kernel's distances (the
reference's ``kernels/dcor/ops.py::dcor_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch.core.privacy import dcor
from repro_torch.core.privacy import pairwise_dists as pairwise_dists_ref
from repro_torch.kernels import _build

F32 = torch.float32
SLAB = 32  # columns a block stages at a time (kSlab of csrc/dcor.cu)
# blocks an SM a launch aims at: at the profile's n = 48 a block holds
# about 60 registers a thread and 14 KB of shared memory, so four fit, and
# more blocks hide more of each slab's load latency
BLOCKS_PER_SM = 4


def plan(n: int, d: int, sms: int) -> tuple[int, int, int]:
    """(tile, chunk, splits) of a launch: rows a tile (the fewest multiple
    of 16 that holds n, at most 128), and d cut into ``splits`` ranges of
    ``chunk`` columns (a multiple of ``SLAB``) so that tiles x splits is
    about ``BLOCKS_PER_SM`` blocks an SM."""
    tile = 16 * -(-min(n, 128) // 16)
    tiles = -(-n // tile)
    slabs = -(-d // SLAB)
    splits = min(slabs, max(1, -(-BLOCKS_PER_SM * sms // tiles ** 2)))
    chunk = -(-slabs // splits) * SLAB
    return tile, chunk, -(-d // chunk)


def _check(x):
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    if x.dtype != F32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must hold at least one row and one column, got "
                         f"{tuple(x.shape)}")


def pairwise_dists(x: torch.Tensor) -> torch.Tensor:
    """The pairwise-distance kernel: contiguous f32 (n, d) -> (n, n) f32,
    diagonal exactly 0.

    Tensors on the CPU run ``pairwise_dists_ref``; on a card the CUDA
    kernel runs, or this raises."""
    _check(x)
    if x.device.type == "cpu":
        return pairwise_dists_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no pairwise_dists kernel for device {x.device}")
    n, d = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, chunk, splits = plan(n, d, sms)
    # the partial Grams (splits, n, n)
    work = torch.empty(splits * n * n, dtype=F32, device=x.device)
    out = torch.empty((n, n), dtype=F32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_pairwise_dists_f32(
            x.data_ptr(), work.data_ptr(), out.data_ptr(), n, d, tile, chunk,
            splits, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "pairwise_dists")
    _build.LAUNCHES["pairwise_dists"] += 1
    return out


def _kernel_dists(x: torch.Tensor) -> torch.Tensor:
    return pairwise_dists(x.to(F32).contiguous())


def dcor_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """dCor(x, y) with both distance matrices from ``pairwise_dists``: two
    launches a call on a card."""
    with torch.inference_mode():
        return dcor(x, y, dist_fn=_kernel_dists)
