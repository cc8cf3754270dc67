"""Multi-cell fleet layer over ``repro_torch.sim.engine``.

Assigns the fleet's N UEs to C cells, couples the cells through load-
dependent interference, and runs each cell's gNB PRB scheduler inside the
engine's per-period loop:

  * **Attach + handover.** ``attach_ring`` spreads UEs over a ring of
    cells; ``handover_grid`` makes a fraction of them hand over to the
    next cell mid-episode, producing the (N, T + WINDOW) per-period cell
    grid every other piece consumes.
  * **Interference coupling.** A (C, C) matrix (``ring_coupling``) maps
    each cell's aggregate offered load to the interference power (mW) its
    neighbours' UEs see. ``coupled_interference_mw`` turns the cell grid
    and per-UE loads into the (N, T + WINDOW) floor that
    ``gen_episode_batch(extra_int_mw=...)`` power-sums onto every trace,
    so KPMs, IQ and the ground-truth labels all see the coupling.
  * **Scheduling.** ``simulate_cells`` hands the per-period cell grid and
    a ``SchedulerConfig`` to the engine, whose loop co-evolves PRB
    allocation and splitting (``repro_torch.sim.sched``) on the card.

The numpy parts are copies of the reference's, so the same ``rng`` gives
the same grid and the same episode. With ``sched=None`` the layer
delegates to the engine's default path: one cell, no coupling and no
scheduler give the plain ``simulate_fleet`` results.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.channel import throughput as tpmod
from repro_torch.channel.scenarios import WINDOW, EpisodeBatch, \
    gen_episode_batch
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE, DeviceProfile
from repro_torch.core.profiles import SplitProfile
from repro_torch.kernels.segsum import segment_reduce
from repro_torch.sim.engine import FleetResult, simulate_fleet
from repro_torch.sim.sched import SchedulerConfig


def jain_index(x: np.ndarray, active: np.ndarray | None = None) -> float:
    """Jain fairness of an allocation vector: 1 = perfectly even, 1/n =
    one UE holds everything. ``active`` selects the slots that held a UE;
    an all-empty selection is vacuously fair (1.0)."""
    x = np.asarray(x, float)
    if active is not None:
        x = x[np.asarray(active, bool)]
    if x.size == 0:
        return 1.0
    s = float(x.sum())
    return s * s / (len(x) * float((x * x).sum()) + 1e-300)


def ring_coupling(n_cells: int, neighbor_dbm: float = -12.0,
                  decay: float = 0.5) -> np.ndarray:
    """(C, C) inter-cell coupling on a ring: entry [i, j] is the
    interference power (mW at cell i's gNB) a fully-loaded cell j injects.
    Immediate neighbours inject ``10**(neighbor_dbm/10)`` mW, then a
    geometric ``decay`` per extra ring hop; the diagonal is zero."""
    d = np.abs(np.arange(n_cells)[:, None] - np.arange(n_cells)[None])
    d = np.minimum(d, n_cells - d)  # ring distance
    coup = 10 ** (neighbor_dbm / 10) * decay ** (d - 1.0)
    return np.where(d == 0, 0.0, coup)


def attach_ring(n_ues: int, n_cells: int) -> np.ndarray:
    """(N,) initial attach: UEs spread round-robin over the cells."""
    return np.arange(n_ues) % n_cells


def handover_grid(cell0: np.ndarray, n_steps: int, frac: float,
                  rng: np.random.Generator, t_h: int | None = None,
                  n_cells: int | None = None) -> np.ndarray:
    """(N, n_steps) cell grid where ``frac`` of the fleet hands over to the
    next ring cell at step ``t_h``. Pass ``n_steps = T + WINDOW`` so the
    grid aligns with the episode traces; the default ``t_h`` is then the
    middle of the report window. ``n_cells`` defaults to
    ``cell0.max() + 1``."""
    cell0 = np.asarray(cell0)
    n = len(cell0)
    if n_cells is None:
        n_cells = int(cell0.max()) + 1 if n else 1
    grid = np.repeat(cell0[:, None], n_steps, axis=1)
    n_h = int(round(n * frac))
    if n_h:
        hover = rng.choice(n, n_h, replace=False)
        if t_h is None:
            t_h = (WINDOW + (n_steps - WINDOW) // 2 if n_steps > WINDOW
                   else n_steps // 2)
        grid[hover, t_h:] = (cell0[hover, None] + 1) % n_cells
    return grid


def cell_load(cell_grid: np.ndarray, demand: np.ndarray, n_cells: int, *,
              use_kernel: bool = False, device="cuda") -> np.ndarray:
    """(C, T) aggregate offered load per cell per step: the mean UL load
    ratio of the attached UEs (0 for an empty cell), in [0, 1].

    ``use_kernel`` aggregates on ``device`` through the segsum kernel, as
    (T, N) rows of f32 demands; otherwise a float64 one-hot program runs
    on the host."""
    grid = np.asarray(cell_grid)
    if use_kernel:
        dev = resolve_device(device)
        ids = torch.from_numpy(np.ascontiguousarray(grid.T, np.int32)).to(dev)
        dem = torch.from_numpy(np.asarray(demand, np.float32)).to(dev)
        dem = dem.broadcast_to(ids.shape).contiguous()
        tot = segment_reduce(dem, ids, n_cells, op="sum").cpu().numpy()
        cnt = segment_reduce(torch.ones_like(dem), ids, n_cells,
                             op="sum").cpu().numpy()
        return np.asarray((tot / np.maximum(cnt, 1)).T, float)  # (C, T)
    onehot = grid[..., None] == np.arange(n_cells)  # (N, T, C)
    tot = (np.asarray(demand, float)[:, None, None] * onehot).sum(axis=0)
    cnt = onehot.sum(axis=0)
    return (tot / np.maximum(cnt, 1)).T  # (C, T)


def coupled_interference_mw(cell_grid: np.ndarray, demand: np.ndarray,
                            coupling: np.ndarray, *, use_kernel: bool = False,
                            device="cuda") -> np.ndarray:
    """(N, T) neighbour-cell interference floor (linear mW) per UE: each
    cell's aggregate load, pushed through the (C, C) coupling matrix, read
    back at every UE through its per-period cell assignment."""
    coupling = np.asarray(coupling, float)
    n_cells = coupling.shape[0]
    load = cell_load(cell_grid, demand, n_cells, use_kernel=use_kernel,
                     device=device)  # (C, T)
    at_cell = coupling @ load  # (C, T) extra power at each victim cell
    return at_cell[np.asarray(cell_grid),
                   np.arange(cell_grid.shape[1])[None]]


def build_cells_episode(scenarios, T: int, rng: np.random.Generator,
                        cell_grid: np.ndarray,
                        coupling: np.ndarray | None = None,
                        load_ratio=None, include_iq: bool = False,
                        **gen_kwargs) -> EpisodeBatch:
    """``gen_episode_batch`` with the load-coupled interference floor.

    ``cell_grid``: (N, T + WINDOW) per-period cell of each UE. Loads are
    drawn here because the coupling needs them first. ``coupling=None``
    generates exactly what the uncoupled call would."""
    n = len(cell_grid)
    lr = (rng.uniform(0.05, 1.0, n) if load_ratio is None
          else np.broadcast_to(np.asarray(load_ratio, float), (n,)))
    extra = (coupled_interference_mw(cell_grid, lr, coupling)
             if coupling is not None else None)
    return gen_episode_batch(scenarios, T, rng, load_ratio=lr,
                             include_iq=include_iq, extra_int_mw=extra,
                             **gen_kwargs)


@dataclasses.dataclass
class CellsResult:
    """A fleet result plus the cell topology it ran under."""

    fleet: FleetResult
    cell_idx: np.ndarray  # (N, T) per-period cell over the report window
    n_cells: int
    sched: Optional[SchedulerConfig]

    @property
    def served_mbps(self) -> np.ndarray:
        """(N, T) throughput actually served (full-grant truth scaled by
        the granted PRB share; the truth itself without a scheduler)."""
        if self.fleet.prb_share is None:
            return self.fleet.true_tp
        return tpmod.prb_scaled_mbps(self.fleet.true_tp,
                                     self.fleet.prb_share)

    def jain(self) -> float:
        """Fairness of the per-UE mean served throughput."""
        return jain_index(self.served_mbps.mean(axis=1))

    def share_sums(self) -> np.ndarray:
        """(C, T) per-cell PRB share totals: 1.0 for every non-empty cell
        if the scheduler conserves its budget; empty cells report 1.0."""
        if self.fleet.prb_share is None:
            return np.ones((self.n_cells, self.cell_idx.shape[1]))
        onehot = self.cell_idx[..., None] == np.arange(self.n_cells)
        sums = (self.fleet.prb_share[..., None] * onehot).sum(axis=0).T
        return np.where(onehot.any(axis=0).T, sums, 1.0)


def simulate_cells(episode: EpisodeBatch, cell_grid: np.ndarray, table,
                   profile: SplitProfile, cfg: ControllerConfig, *,
                   sched: Optional[SchedulerConfig] = None,
                   n_cells: int | None = None, warm_split=None,
                   estimator=None, fixed_split: Optional[int] = None,
                   ue: DeviceProfile = UE_VM_2CORE,
                   server: DeviceProfile = EDGE_A40X2,
                   device="cuda") -> CellsResult:
    """Run a multi-cell fleet through the engine on ``device``.

    ``cell_grid`` may cover the full trace ((N, T + WINDOW), as built for
    the interference coupling) or just the report window ((N, T)); the
    scheduler consumes the report-window slice. ``sched=None`` runs the
    engine without a scheduler."""
    grid = np.asarray(cell_grid)
    t_steps = episode.n_steps
    if grid.shape[1] == t_steps + WINDOW:
        grid = grid[:, WINDOW:]
    if grid.shape != (episode.n_ues, t_steps):
        raise ValueError(f"cell_grid shape {grid.shape} does not match "
                         f"({episode.n_ues}, {t_steps}) or the full trace")
    if n_cells is None:
        n_cells = int(grid.max()) + 1
    fleet = simulate_fleet(episode, table, profile, cfg,
                           warm_split=warm_split, estimator=estimator,
                           fixed_split=fixed_split, ue=ue, server=server,
                           sched=sched, cell_idx=grid, n_cells=n_cells,
                           device=device)
    return CellsResult(fleet=fleet, cell_idx=grid, n_cells=n_cells,
                       sched=sched)
