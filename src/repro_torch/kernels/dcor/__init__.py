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

import functools

import torch

from repro_torch.core.privacy import dcor
from repro_torch.core.privacy import pairwise_dists as pairwise_dists_ref
from repro_torch.kernels import _build

F32 = torch.float32
# the kernel's geometry (csrc/dcor.cu): ROWS-row tiles, SLAB columns a
# stage of the split route; a register tile's rows a group: 8 on the split
# route, TILE_GROUP on the tile route
ROWS, SLAB, TILE_GROUP = 48, 96, 4
# rows of at most SHORT_D values take the tile route; longer ones the
# split route, whose blocks need the fewest MIN_SLABS slabs each so that
# the ring of four stages has work to overlap, in clusters of up to
# CLUSTER splits that add their partials in shared memory (the portable
# most)
SHORT_D, MIN_SLABS, CLUSTER = 8192, 2, 8


def plan(n: int, d: int, fit) -> tuple[str, int, int, int, int]:
    """(route, tiles, chunk, splits, cluster) of a launch, from the shape
    and ``fit(c, two_tiles)``, how many clusters of c blocks the split
    route's kernel runs at once (blocks of one tile pair, or of more).

    n is cut into ``tiles`` tiles of ROWS rows, whose pairs I <= J
    (``tile_pairs``) are the blocks' rows of the grid. ``"tiles"`` (d up to
    SHORT_D): one block a register tile over all of d (chunk d, one split,
    no cluster). ``"splits"``: d cut into ranges of ``chunk`` columns (at
    least MIN_SLABS whole slabs), one a split, run in one wave in clusters
    of 8, 4 or 2: the largest whose wave holds 90% of the blocks the best
    one does, or all the work but one cluster's worth (a smaller cluster
    leaves more clusters' sums for the last ones to add). Only the last
    cluster's trailing splits may hold no column."""
    tiles = -(-n // ROWS)
    if d <= SHORT_D:
        return "tiles", tiles, d, 1, 1
    pairs = tiles * (tiles + 1) // 2
    slabs = -(-d // SLAB)
    want = slabs // MIN_SLABS
    waves = {c: min(want, fit(c, tiles > 1) // pairs * c) // c * c
             for c in (CLUSTER, 4, 2)}
    most = max(waves.values())
    cluster = next((c for c in (CLUSTER, 4, 2)
                    if waves[c] and waves[c] >= min(0.9 * most, want - c)), 1)
    splits = max(1, waves.get(cluster, 1))
    per = -(-slabs // splits)
    return ("splits", tiles, per * SLAB,
            -(-slabs // (per * cluster)) * cluster, cluster)


def tile_pairs(tiles: int) -> list[tuple[int, int]]:
    """The tile pairs (I, J), I <= J, in the order of the grid's rows."""
    return [(i, j) for i in range(tiles) for j in range(i, tiles)]


def register_tiles(diagonal: bool, group: int = 8) -> list[tuple[int, int]]:
    """The row groups (a, b) of the register tiles of a tile pair, in
    order: the split route's threads (group 8), the tile route's blocks
    (group TILE_GROUP). A tile's rows fall into ROWS / group groups of
    ``group`` rows, group a holding rows a, a + ROWS / group, ...; the
    register tile (a, b) owns rows (a + ROWS / group ii, b + ROWS / group
    jj) of tiles (I, J) for ii, jj < group. On a diagonal tile pair a <= b
    (the pairs i <= j), and where a == b only ii <= jj."""
    k = ROWS // group
    return [(a, b) for a in range(k) for b in range(k)
            if not diagonal or a <= b]


def card_fit(index: int):
    """``plan``'s fit for card ``index``: the clusters it runs at once,
    asked of the card once."""
    return lambda c, two_tiles: _build.max_clusters(
        "repro_pairwise_dists_max_clusters", index, c, int(two_tiles))


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


@functools.lru_cache(maxsize=None)
def _card_plan(n: int, d: int, index: int):
    return plan(n, d, card_fit(index))


def pairwise_dists(x: torch.Tensor) -> torch.Tensor:
    """The pairwise-distance kernel: contiguous f32 (n, d) -> (n, n) f32,
    diagonal exactly 0.

    Tensors on the CPU run ``pairwise_dists_ref``; on a card the CUDA
    kernel runs on the route ``plan`` picks, or this raises."""
    _check(x)
    if x.device.type == "cpu":
        return pairwise_dists_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no pairwise_dists kernel for device {x.device}")
    (n, d), index = x.shape, x.device.index
    route, tiles, chunk, splits, cluster = _card_plan(n, d, index)
    out = torch.empty((n, n), dtype=F32, device=x.device)
    lib = _build.library()
    ctx, stream = _build.device_stream(index)
    with ctx:
        if route == "tiles":
            rc = lib.repro_pairwise_dists_tiles_f32(
                x.data_ptr(), out.data_ptr(), n, d, stream)
        else:
            # the clusters' sums and squared norms, then (more than one
            # tile pair) the final Gram; and the tickets
            pairs = tiles * (tiles + 1) // 2
            work = _build.scratch(
                index, stream, pairs * (splits // cluster * (ROWS + 1) * ROWS
                                        + (ROWS * ROWS if pairs > 1 else 0)),
                F32, zeroed=False)
            tickets = _build.scratch(index, stream, pairs * cluster + 1)
            rc = lib.repro_pairwise_dists_f32(
                x.data_ptr(), work.data_ptr(), out.data_ptr(),
                tickets.data_ptr(), n, d, chunk, splits, cluster, stream)
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
