"""The split of an f32 factor into three exact bf16 pieces.

The bf16 tensor-core kernels (``csrc/flash_attention.cu``'s P.V,
``csrc/ssd_chunked.cu``'s chunk state and chunk scan) multiply an f32
factor with an exact bf16 operand on ``wgmma``: the factor enters as three
bf16 pieces whose sum is the factor bit for bit, each piece times a bf16
value is exact in the f32 accumulator, so the product is the reference's
f32 product up to the order of its sums. ``csrc/sm90.cuh::split3`` is the
kernels' split; ``split_bf16x3`` is its plain version, for the tests.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def split_bf16x3(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """An f32 ``p`` as three bf16 pieces, hi = bf16(p), mid = bf16(p - hi),
    lo = bf16(p - hi - mid), each rounded to nearest even, the differences
    exact in f32: hi + mid + lo == p for every |p| >= 2^-100."""
    p = p.to(F32)
    hi = p.to(torch.bfloat16)
    r = p - hi.to(F32)
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.to(F32)).to(torch.bfloat16)
