"""Split-boundary activation codec (beyond-paper, JALAD-inspired).

The head quantises the intermediate activation before transmission; the
tail dequantises. data_size(l) scales with the codec ratio, which changes
the PSO tables: deeper splits tolerate lower bitwidths (features are more
abstract). The integer codecs go through the ``quantize`` kernel
(``repro_torch.kernels.quant``), so on a card they launch it; the "fp16"
codec is a bf16 round trip, as the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.quant import quantize_rows

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    bits: int

    @property
    def ratio(self) -> float:
        """bytes(coded)/bytes(bf16 reference)."""
        return self.bits / 16.0


FP16 = Codec("fp16", 16)
INT8 = Codec("int8", 8)
INT4 = Codec("int4", 4)


def rowwise_quant(x: torch.Tensor, qmax: int):
    """Symmetric per-row (last dim) integer quantisation. Returns (q int8,
    scale f32 (..., 1)): ``scale = max(amax, 1e-8) * f32(1 / qmax)``,
    ``q = clip(round(x / scale), -qmax - 1, qmax)``, the reference's
    formula, computed by the ``quantize`` kernel (its plain version on the
    CPU)."""
    return quantize_rows(x, qmax)


def quantize(x: torch.Tensor, bits: int):
    """Split-boundary codec entry point. Returns (q, scale)."""
    if bits not in (4, 8):
        raise ValueError(f"the integer codecs have 4 or 8 bits, got {bits}")
    return rowwise_quant(x, 2 ** (bits - 1) - 1)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(F32) * scale).to(dtype)


def roundtrip(x: torch.Tensor, codec: Codec) -> torch.Tensor:
    if codec.bits >= 16:  # round to nearest even, as JAX's astype
        return x.to(torch.bfloat16).to(x.dtype)
    q, s = quantize(x, codec.bits)
    return dequantize(q, s, x.dtype)


def transmit_bytes(shape, codec: Codec) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    payload = n * codec.bits // 8
    if codec.bits < 16:  # per-channel fp32 scales
        payload += 4 * n // int(shape[-1])
    return payload
