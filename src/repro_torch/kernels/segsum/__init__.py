"""Batched segment reduction (sum / max) over small segment counts.

The multi-cell fleet reduces into a handful of cells in two places: the
PRB scheduler's per-cell normalizers and max-C/I winner (``sim.sched``,
every report period) and the per-cell offered load behind the
interference coupling (``sim.cells.cell_load``).

``segment_reduce_batched`` is the wrapper of the CUDA kernel
``csrc/segsum.cu``; ``segment_reduce_ref`` is its plain PyTorch version:
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
    lib = _build.library()
    with torch.cuda.device(values.device):
        rc = lib.repro_segsum_f32(
            values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), t, n,
            n_segments, OPS.index(op),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "segsum")
    _build.LAUNCHES["segsum"] += 1
    return out


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
