"""Vectorized gNB PRB schedulers (fluid / time-averaged model).

One 0.1 s estimator report period spans ~100 TTI-level scheduling rounds,
so what the fleet engine needs per period is each UE's time-averaged
share of its cell's PRB budget, not per-TTI grants. The three classic
policies are modelled in their fluid limit: a per-UE weight, normalized
within each cell, is the fraction of the cell's ``n_prb`` budget the UE
holds this period:

  rr      round-robin: equal weights (equal time-share among attached).
  pf      proportional-fair: w = r / max(avg, eps) with the classic EWMA
          of served throughput. Self-balancing: a UE whose average decays
          sees its weight grow.
  maxsinr max C/I: the whole budget goes to the cell's highest-rate UE(s);
          exact-rate ties split the budget equally.

Everything is tensor math on (N,) fleet tensors: cells are handled with
segment reductions over the (N,) cell-index vector, never a loop over
cells, so the whole multi-cell fleet advances as one set of launches per
report period. ``SchedulerConfig(fused=True)`` runs those reductions
through the ``segsum`` kernel; ``fused=False`` through its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.segsum import segment_reduce

POLICIES = ("rr", "pf", "maxsinr")

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static scheduler parameters."""

    policy: str = "rr"  # one of POLICIES
    n_prb: int = 100  # cell PRB budget per period (alloc = share * n_prb)
    pf_beta: float = 0.1  # EWMA weight of the newest served-rate sample
    eps: float = 1e-6  # floor for PF averages / empty-cell denominators
    fused: bool = False  # per-cell reductions through the segsum kernel

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown policy {self.policy!r}; pick one of {POLICIES}")
        if self.n_prb <= 0:
            raise ValueError(f"n_prb must be positive: {self.n_prb}")
        if not 0.0 < self.pf_beta <= 1.0:
            raise ValueError(f"pf_beta must be in (0, 1]: {self.pf_beta}")


class SchedulerState(NamedTuple):
    """Per-fleet scheduler state carried across report periods."""

    avg_tp: torch.Tensor  # (N,) f32 PF average of served throughput (Mbps)
    step: torch.Tensor  # i32, periods scheduled so far


def scheduler_init(n_ues: int, avg0: float = 1.0, *,
                   device="cuda") -> SchedulerState:
    """Fresh state: neutral PF averages (no UE starts privileged)."""
    dev = resolve_device(device)
    return SchedulerState(
        avg_tp=torch.full((n_ues,), avg0, dtype=F32, device=dev),
        step=torch.zeros((), dtype=I32, device=dev))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with the reference's gather semantics: a negative index
    counts from the end, and an index still out of range clamps."""
    n = a.shape[0]
    return a[idx.clamp(-n, n - 1).long()]


def cell_shares(weights, cell_idx, n_cells: int, eps: float = 1e-6,
                fused: bool = False) -> torch.Tensor:
    """Normalize per-UE weights into per-cell PRB shares:
    ``share_u = w_u / max(sum_{v in cell(u)} w_v, eps)``. ``fused`` runs
    the normalizer sum through the segsum kernel."""
    w = torch.as_tensor(weights).to(F32)
    g = torch.as_tensor(cell_idx, device=w.device).to(I32)
    denom = segment_reduce(w, g, n_cells, op="sum", use_kernel=fused)
    return w / torch.clamp_min(_take(denom, g), eps)


def scheduler_step(cfg: SchedulerConfig, n_cells: int, state: SchedulerState,
                   cell_idx, rate_mbps, active=None
                   ) -> tuple[SchedulerState, torch.Tensor]:
    """Advance the whole fleet's scheduler by one report period.

    ``cell_idx``: (N,) cell of each UE this period; ``rate_mbps``: (N,) the
    gNB's CQI view (each UE's max achievable rate at a full grant).
    Returns the new state and the (N,) f32 PRB share granted to each UE.

    ``active``: optional (N,) bool slot mask. Masked rows get weight 0 and
    are redirected to a dummy segment ``n_cells``, so empty slots never
    receive PRBs, never shape a cell's normalizer or max-C/I winner, and
    their PF averages are held. ``active=None`` is the fixed-fleet step."""
    dev = state.avg_tp.device
    r = torch.as_tensor(rate_mbps, device=dev).to(F32)
    cell_idx = torch.as_tensor(cell_idx, device=dev).to(I32)
    # f32 values held as Python floats (exact): a scalar operand runs in
    # the tensor's f32 with no copy to the card, and 1 - beta rounds in
    # f32 as the reference's does
    beta = float(np.float32(cfg.pf_beta))
    keep = float(np.float32(1.0) - np.float32(cfg.pf_beta))
    if active is None:
        if cfg.policy == "rr":
            w = torch.ones_like(r)
        elif cfg.policy == "pf":
            w = r / torch.clamp_min(state.avg_tp, cfg.eps)
        else:  # maxsinr (validated in __post_init__)
            cmax = segment_reduce(r, cell_idx, n_cells, op="max",
                                  use_kernel=cfg.fused)
            w = (r >= _take(cmax, cell_idx)).to(F32)
        share = cell_shares(w, cell_idx, n_cells, cfg.eps, cfg.fused)
        # one rounding per operation, in the reference's order
        avg = keep * state.avg_tp + beta * r * share
        return SchedulerState(avg_tp=avg, step=state.step + 1), share
    act = torch.as_tensor(active, device=dev).to(torch.bool)
    actf = act.to(F32)
    cell_m = torch.where(act, cell_idx, n_cells)  # dummy segment: empties
    if cfg.policy == "rr":
        w = actf
    elif cfg.policy == "pf":
        w = actf * (r / torch.clamp_min(state.avg_tp, cfg.eps))
    else:  # maxsinr
        cmax = segment_reduce(r, cell_m, n_cells + 1, op="max",
                              use_kernel=cfg.fused)
        w = ((r >= _take(cmax, cell_m)) & act).to(F32)
    share = cell_shares(w, cell_m, n_cells + 1, cfg.eps, cfg.fused)
    avg = torch.where(act, keep * state.avg_tp + beta * r * share,
                      state.avg_tp)
    return SchedulerState(avg_tp=avg, step=state.step + 1), share
