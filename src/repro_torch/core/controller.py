"""Adaptive runtime controller (the AF in Fig. 1).

Consumes throughput estimates from the RAN estimator every 0.1 s, smooths
them (EWMA), queries the PSO lookup table, and re-splits with hysteresis so
transient estimate noise does not thrash the deployment.

The decision logic is a pure state machine — ``ControllerState`` (a tuple
of tensors) advanced by ``controller_step`` — written over a leading batch
dimension, so a whole fleet of controllers advances as one set of tensor
ops per report period (the reference's ``vmap``). Scalar (shape ``()``)
states run the same code, which is what the stateful
``AdaptiveSplitController`` wrapper uses, so the sequential and batched
paths cannot drift apart.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core.pso import NO_SPLIT, LookupTable

# ``pending_split`` sentinel. NO_SPLIT (-1) is a legal proposal (when the
# fallback is NO_SPLIT itself), so "nothing pending" needs its own value.
PENDING_NONE = -2

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass
class ControllerConfig:
    ewma_alpha: float = 0.5  # weight of the newest estimate
    hysteresis_steps: int = 2  # consecutive agreeing decisions to switch
    fallback_split: int = NO_SPLIT  # used when no feasible split exists


class ControllerState(NamedTuple):
    """One or N controllers' full decision state: every field is a tensor
    of the batch shape (``()`` for one controller, ``(N,)`` for a fleet)."""

    tp_ewma: torch.Tensor  # f32, EWMA of the throughput estimates (Mbps)
    has_ewma: torch.Tensor  # bool, False until the first report lands
    current_split: torch.Tensor  # i32, deployed split (NO_SPLIT allowed)
    pending_split: torch.Tensor  # i32, proposal under hysteresis
    pending_count: torch.Tensor  # i32, consecutive agreeing reports
    step: torch.Tensor  # i32, reports consumed so far


def controller_init(warm_split=NO_SPLIT, batch_shape=(), *,
                    device="cuda") -> ControllerState:
    """Fresh state, optionally warm-started at a deployed split.

    ``warm_split`` may be a scalar or an (N,)-shaped array; ``batch_shape``
    broadcasts every field for fleet use."""
    dev = resolve_device(device)
    warm = torch.as_tensor(warm_split, dtype=I32, device=dev)
    warm = warm.broadcast_to(batch_shape).clone()
    z = torch.zeros(batch_shape, dtype=I32, device=dev)
    return ControllerState(
        tp_ewma=torch.zeros(batch_shape, dtype=F32, device=dev),
        has_ewma=torch.zeros(batch_shape, dtype=torch.bool, device=dev),
        current_split=warm,
        pending_split=torch.full(batch_shape, PENDING_NONE, dtype=I32,
                                 device=dev),
        pending_count=z,
        step=z.clone(),
    )


def controller_step(table: torch.Tensor, state: ControllerState, tp_mbps,
                    *, cfg: ControllerConfig
                    ) -> tuple[ControllerState, torch.Tensor]:
    """Advance the controllers by one estimator report: (state, tp) ->
    (state, split). ``table`` is (tp_max+1,) int32 for one controller or a
    stacked (N, tp_max+1) array whose rows map alongside the (N,) states."""
    tp = torch.as_tensor(tp_mbps, dtype=F32, device=table.device)
    a = cfg.ewma_alpha
    # f32 EWMA, one rounding per operation: f32(a) * tp, f32(1 - a) * ewma,
    # then the sum, as the reference computes it
    ewma = torch.where(state.has_ewma, a * tp + (1 - a) * state.tp_ewma, tp)
    # LookupTable.query semantics: round half to even to the integer Mbps
    # bucket, clamp into the table; bucket 0 is never filled => NO_SPLIT.
    bucket = torch.round(ewma).to(I32).clamp(0, table.shape[-1] - 1)
    proposal = torch.gather(table, -1, bucket.long().unsqueeze(-1)) \
        .squeeze(-1).to(I32)
    proposal = torch.where(proposal == NO_SPLIT,
                           torch.tensor(cfg.fallback_split, dtype=I32,
                                        device=table.device), proposal)
    differs = proposal != state.current_split
    count = torch.where(proposal == state.pending_split,
                        state.pending_count + 1, 1).to(I32)
    switch = differs & (count >= cfg.hysteresis_steps)
    # a switch or a revert-to-current clears the pending proposal entirely;
    # a stale pending_split must never survive
    keep_pending = differs & ~switch
    none = torch.tensor(PENDING_NONE, dtype=I32, device=table.device)
    new = ControllerState(
        tp_ewma=ewma,
        has_ewma=torch.ones_like(state.has_ewma),
        current_split=torch.where(switch, proposal, state.current_split),
        pending_split=torch.where(keep_pending, proposal, none),
        pending_count=torch.where(keep_pending, count, 0).to(I32),
        step=state.step + 1,
    )
    return new, new.current_split


class AdaptiveSplitController:
    """Stateful convenience wrapper over ``controller_step`` (one UE)."""

    def __init__(self, table: LookupTable,
                 cfg: Optional[ControllerConfig] = None, *, device="cuda"):
        self.table = table
        self.cfg = cfg or ControllerConfig()
        self.device = resolve_device(device)
        self._table_arr = torch.as_tensor(table.table, dtype=I32,
                                          device=self.device)
        self.switches: list[tuple[int, float, int]] = []  # (step, tp, l)
        self.state = controller_init(device=self.device)

    @property
    def tp_ewma(self) -> Optional[float]:
        return float(self.state.tp_ewma) if bool(self.state.has_ewma) else None

    @property
    def current_split(self) -> int:
        return int(self.state.current_split)

    @current_split.setter
    def current_split(self, l: int) -> None:
        # legacy warm-start poke; prefer reset(warm_split=...)
        self.state = self.state._replace(current_split=torch.tensor(
            l, dtype=I32, device=self.device))

    @property
    def pending_split(self) -> Optional[int]:
        p = int(self.state.pending_split)
        return None if p == PENDING_NONE else p

    @property
    def pending_count(self) -> int:
        return int(self.state.pending_count)

    def reset(self, warm_split: int = NO_SPLIT) -> None:
        """Return to a fresh state, deployed at ``warm_split`` (the AF warm
        start). Clears the EWMA, hysteresis and switch history."""
        self.state = controller_init(warm_split, device=self.device)
        self.switches = []

    def update(self, tp_estimate_mbps: float) -> int:
        """Feed one estimator report; returns the split to use now."""
        prev = int(self.state.current_split)
        step = int(self.state.step)
        self.state, split = controller_step(
            self._table_arr, self.state, float(tp_estimate_mbps),
            cfg=self.cfg)
        l = int(split)
        if l != prev:
            self.switches.append((step, float(self.state.tp_ewma), l))
        return l
