"""Per-split-point profiles: the inputs Algorithm 1 consumes.

A SplitProfile holds, for each candidate split l in {1..L}:
  flops_head[l]   cumulative FLOPs executed on the UE (layers 1..l)
  flops_tail[l]   remaining FLOPs on the edge
  data_bytes[l]   size of the transmitted intermediate activation
  privacy[l]      dCor(input, activation_l)  (lower = better)

Profiles come from three sources:
  * analytic layer math (VGG16, benchmarks — deterministic),
  * measured dcor on real forward passes (reduced-width nets on CPU),
  * compiled cost_analysis of LM blocks (launch/roofline calibration).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.energy import DeviceProfile


@dataclasses.dataclass
class SplitProfile:
    name: str
    flops_head: np.ndarray  # (L,) cumulative
    data_bytes: np.ndarray  # (L,)
    privacy: np.ndarray  # (L,) in [0,1]
    layer_names: list[str]

    @property
    def n_splits(self) -> int:
        return len(self.flops_head)

    @property
    def total_flops(self) -> float:
        return float(self.flops_head[-1])

    def d_ue(self, ue: DeviceProfile) -> np.ndarray:
        return self.flops_head / ue.flops_per_s

    def d_ser(self, server: DeviceProfile) -> np.ndarray:
        rem = self.total_flops - self.flops_head
        return server.fixed_latency_s + rem / server.flops_per_s

    def d_trx(self, tp_bps: np.ndarray) -> np.ndarray:
        """(L, T) transmission latency for throughputs tp_bps (bits/s)."""
        return self.data_bytes[:, None] * 8.0 / np.asarray(tp_bps)[None, :]

    def e_ue(self, ue: DeviceProfile) -> np.ndarray:
        return ue.tdp_w / ue.threads * self.d_ue(ue)

    def scaled(self, codec_ratio: float) -> "SplitProfile":
        """Profile under a boundary codec that shrinks activations."""
        return dataclasses.replace(
            self, data_bytes=self.data_bytes * codec_ratio,
            name=f"{self.name}|codec x{codec_ratio:.3f}")

