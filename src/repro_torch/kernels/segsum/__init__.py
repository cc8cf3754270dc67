"""Batched segment reduction (sum / max) over small segment counts.

The multi-cell fleet reduces into a handful of cells in two places: the
PRB scheduler's per-cell normalizers and max-C/I winner (``sim.sched``,
every report period) and the per-cell offered load behind the
interference coupling (``sim.cells.cell_load``).

``segment_reduce_batched`` is the wrapper of the CUDA kernel
``csrc/segsum.cu`` (route ``vec4`` or ``generic``, picked by
``segsum_route``); ``segment_reduce_ref`` is its plain PyTorch version:
the TPU kernel's one-hot compare-and-reduce, which the wrapper runs for
tensors on the CPU and the tests hold the kernel to. ``segment_reduce`` is
the dispatch the scheduler and the cells layer call (the reference's
``ops.segment_reduce``).

Semantics, as the reference has them: values are f32, ids int32; an id
outside ``[0, n_segments)``, negative ids included, contributes nothing;
an empty segment reduces to 0 for a sum and -inf for a max.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

F32 = torch.float32
I32 = torch.int32
OPS = ("sum", "max")
# the routes of csrc/segsum.cu and their codes in its C entry point; rows
# the vec4 route takes: up to VEC4_MAX_N values in 16-byte vectors (a warp
# holds 256, a row has at most 16 warps), up to VEC4_MAX_SEGMENTS segments
ROUTE_IDS = {"generic": 0, "vec4": 1}
VEC4_MAX_N = 4096
VEC4_MAX_SEGMENTS = 8


def segsum_route(n: int, c: int, aligned: bool = True) -> str:
    """The kernel a card runs for rows of ``n`` values into ``c`` segments:

    - "vec4": 1 <= c <= VEC4_MAX_SEGMENTS, 1 <= n <= VEC4_MAX_N with n a
      multiple of 4, and (``aligned``) values and ids on the 16-byte grid:
      a compile-time instance for c, each lane's 16-byte loads all issued
      before their use;
    - "generic": the rest, the first version (a block a row)."""
    if (aligned and 1 <= c <= VEC4_MAX_SEGMENTS and 1 <= n <= VEC4_MAX_N
            and n % 4 == 0):
        return "vec4"
    return "generic"


def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op must be 'sum' or 'max': {op!r}")


def segment_reduce_ref(values, seg_ids, n_segments: int, *,
                       op: str = "sum") -> torch.Tensor:
    """values (T, N) + seg_ids (T, N) -> (T, C) f32 per-row reductions,
    as a one-hot compare against ``arange(C)`` reduced over N."""
    _check_op(op)
    v = values.to(F32)
    seg = torch.arange(n_segments, dtype=seg_ids.dtype, device=v.device)
    hit = seg_ids[..., None] == seg  # (T, N, C)
    if op == "sum":
        return torch.where(hit, v[..., None], 0.0).sum(dim=1)
    return torch.where(hit, v[..., None], float("-inf")).amax(dim=1)


def _check(values, seg_ids, n_segments):
    if values.dim() != 2:
        raise ValueError(f"values must be (T, N), got {tuple(values.shape)}")
    if seg_ids.shape != values.shape:
        raise ValueError(f"seg_ids {tuple(seg_ids.shape)} must match values "
                         f"{tuple(values.shape)}")
    if values.dtype != F32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    if seg_ids.dtype != I32:
        raise TypeError(f"seg_ids must be int32, got {seg_ids.dtype}")
    if seg_ids.device != values.device:
        raise ValueError(f"seg_ids are on {seg_ids.device}, values on "
                         f"{values.device}")
    for name, t in (("values", values), ("seg_ids", seg_ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= n_segments <= 1 << 20:
        raise ValueError(f"n_segments must be in [1, 2^20]: {n_segments}")


def segment_reduce_batched(values: torch.Tensor, seg_ids: torch.Tensor,
                           n_segments: int, *,
                           op: str = "sum") -> torch.Tensor:
    """The segsum kernel: contiguous f32 values and int32 ids, both (T, N)
    -> (T, n_segments) f32.

    Tensors on the CPU run ``segment_reduce_ref``; on a card the CUDA
    kernel runs, or this raises."""
    _check_op(op)
    _check(values, seg_ids, n_segments)
    if values.device.type == "cpu":
        return segment_reduce_ref(values, seg_ids, n_segments, op=op)
    if values.device.type != "cuda":
        raise ValueError(f"no segsum kernel for device {values.device}")
    t, n = values.shape
    out = torch.empty((t, n_segments), dtype=F32, device=values.device)
    if t == 0:
        return out
    which = segsum_route(n, n_segments, values.data_ptr() % 16 == 0
                         and seg_ids.data_ptr() % 16 == 0)
    _launch(values, seg_ids, out, op, which)
    return out


def _launch(values, seg_ids, out, op: str, which: str) -> None:
    """One launch of segsum's route ``which`` on checked inputs, counted
    (the vec4 route with programmatic dependent launch)."""
    (t, n), c = values.shape, out.shape[1]
    lib = _build.library()
    ctx, stream = _build.device_stream(values.device.index)
    with ctx:
        rc = lib.repro_segsum_f32(
            values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), t, n, c,
            OPS.index(op), ROUTE_IDS[which], stream)
    _build.check_launch(rc, "segsum")
    _build.LAUNCHES["segsum"] += 1
    _build.ROUTES["segsum"][which] += 1


def empty_launch(device, pdl: bool = False) -> None:
    """Launch the kernel with an empty body on ``device``'s current
    stream: the card's launch floor, against which segsum's and
    featurize's times are read; ``pdl`` as the vec4 route is launched, its
    body the wait for the previous grid. Not counted: no path runs it."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    lib = _build.library()
    entry = lib.repro_empty_launch_pdl if pdl else lib.repro_empty_launch
    ctx, stream = _build.device_stream(index)
    with ctx:
        rc = entry(stream)
    _build.check_launch(rc, "empty")


def segment_reduce(values, seg_ids, n_segments: int, *, op: str = "sum",
                   mask=None, use_kernel: bool = True) -> torch.Tensor:
    """Reduce ``values`` into ``n_segments`` buckets keyed by ``seg_ids``.

    Accepts (N,) or (T, N) values; ``seg_ids`` broadcasts against them.
    ``mask=False`` slots are redirected to id ``n_segments`` and so
    contribute nothing. ``use_kernel`` runs ``segment_reduce_batched``
    (the kernel on a card); otherwise the plain version runs."""
    _check_op(op)
    squeeze = values.dim() == 1
    v = (values[None] if squeeze else values).to(F32).contiguous()
    g = torch.as_tensor(seg_ids, device=v.device).to(I32)
    g = g.broadcast_to(v.shape)
    if mask is not None:
        m = torch.as_tensor(mask, device=v.device).to(torch.bool)
        g = torch.where(m.broadcast_to(v.shape), g, n_segments)
    g = g.contiguous()
    if use_kernel:
        out = segment_reduce_batched(v, g, n_segments, op=op)
    else:
        out = segment_reduce_ref(v, g, n_segments, op=op)
    return out[0] if squeeze else out
