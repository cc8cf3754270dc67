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


def lm_split_profile(cfg, seq: int, batch: int, *, bytes_per_el: int = 2,
                     privacy: np.ndarray | None = None) -> SplitProfile:
    """Analytic profile for an assigned LM architecture split at megablock
    boundaries. Activation size is constant in l (the d_model residual
    stream): the transformer-specific PSO regime."""
    L = cfg.n_layers
    per_layer = []
    for i in range(L):
        b = cfg.pattern[i % len(cfg.pattern)]
        if b.kind in ("attn", "local", "cross"):
            attn = 2 * cfg.d_model * (cfg.n_heads + 2 * cfg.kv_heads) * (
                cfg.head_dim) + 2 * cfg.n_heads * cfg.head_dim * cfg.d_model
            ctx = min(seq, b.window) if b.window else seq
            attn += 4 * cfg.n_heads * cfg.head_dim * ctx  # qk^T + av
            ff_mult = cfg.top_k if cfg.is_moe else 1
            ff = 6 * cfg.d_model * cfg.d_ff * ff_mult
            per_layer.append((attn + ff) * 2 * seq * batch / 2)
        elif b.kind == "rec":
            w = cfg.lru_width
            per_layer.append((2 * cfg.d_model * w * 3 + 2 * w * w * 2 +
                              6 * cfg.d_model * cfg.d_ff) * seq * batch)
        elif b.kind == "ssd":
            core = 2 * cfg.d_model * (2 * cfg.d_inner) + 2 * cfg.d_inner * (
                cfg.d_model)
            ssd = 4 * cfg.d_inner * cfg.ssm_state * min(seq, cfg.ssm_chunk)
            per_layer.append((core + ssd) * seq * batch)
    flops_head = np.cumsum(per_layer)
    data = np.full(L, seq * batch * cfg.d_model * bytes_per_el, float)
    if privacy is None:
        # deep layers leak less; exponential-ish decay matching Fig. 5b shape
        privacy = 0.95 * np.exp(-2.2 * np.arange(1, L + 1) / L) + 0.20
    return SplitProfile(
        name=f"{cfg.name}-s{seq}b{batch}", flops_head=flops_head.astype(float),
        data_bytes=data, privacy=np.asarray(privacy, float),
        layer_names=[f"block{i+1}" for i in range(L)])
