"""Pre-Filtered Split Optimization (PSO) — Algorithm 1, vectorised.

For each UE: (1) prefilter split points violating privacy/energy constraints,
(2) compute the minimal throughput TP_min(l) that keeps the latency constraint
satisfiable, (3) for every integer TP in {1..TP_max} pick
l* = argmin over feasible l of F(l, TP). The result is an O(1)-lookup table
the Application Function queries with the estimated throughput.

``pso_vectorized`` is the production path and ``pso_reference`` the
direct transcription of Algorithm 1 it is checked against; both are
float64 numpy copies of the reference's: the same inputs give
bit-identical tables. ``build_tables`` is the outer loop over the UE set.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.energy import DeviceProfile
from repro_torch.core.objective import Constraints, Weights, evaluate
from repro_torch.core.profiles import SplitProfile

NO_SPLIT = -1  # no feasible split at this throughput

# Clamp range for throughput estimates before they hit a lookup table:
# 1 Mbps is the first bucket the sweep fills (bucket 0 stays NO_SPLIT),
# 130 Mbps the paper's peak rate (channel.throughput.PEAK_MBPS) and the
# tp_max the production tables are built with. This is part of the sweep
# config — ``repro_torch.sim`` imports it rather than re-declaring
# the range.
TP_CLIP_MBPS = (1.0, 130.0)


@dataclasses.dataclass
class LookupTable:
    """tp (Mbps, rounded int) -> optimal split index (0-based; NO_SPLIT)."""

    ue_name: str
    table: np.ndarray  # (tp_max+1,) int32; index tp in Mbps
    tp_min_mbps: np.ndarray  # (L,) minimal feasible throughput per split
    feasible_prefilter: np.ndarray  # (L,) bool after privacy/energy filter

    def query(self, tp_mbps: float) -> int:
        """Rounded-bucket lookup. Near-zero throughput rounds to bucket 0,
        which the sweep never fills (it starts at 1 Mbps) and therefore
        reads NO_SPLIT — clamping up to bucket 1 would return a split
        whose TP_min may be unmet at the actual throughput."""
        tp = int(np.clip(round(tp_mbps), 0, len(self.table) - 1))
        return int(self.table[tp])


@dataclasses.dataclass
class StackedLookupTable:
    """Many UE lookup tables stacked for fleet-scale vectorized queries.

    ``tables[u, tp]`` is UE ``u``'s optimal split at (rounded-int) ``tp``
    Mbps — the same layout as ``LookupTable.table`` with a leading UE axis,
    so it drops straight into the batched ``controller_step`` rows.
    All stacked tables must share ``tp_max`` (and, for the per-split
    metadata, the same number of split points L).
    """

    ue_names: list[str]
    tables: np.ndarray  # (U, tp_max+1) int32
    tp_min_mbps: np.ndarray  # (U, L)
    feasible_prefilter: np.ndarray  # (U, L) bool

    @classmethod
    def stack(cls, tables: list[LookupTable]) -> "StackedLookupTable":
        assert tables, "need at least one table"
        widths = {len(t.table) for t in tables}
        assert len(widths) == 1, f"mixed tp_max across tables: {widths}"
        return cls(ue_names=[t.ue_name for t in tables],
                   tables=np.stack([t.table for t in tables]),
                   tp_min_mbps=np.stack([t.tp_min_mbps for t in tables]),
                   feasible_prefilter=np.stack(
                       [t.feasible_prefilter for t in tables]))

    @property
    def n_ues(self) -> int:
        return self.tables.shape[0]

    def row(self, u: int) -> LookupTable:
        return LookupTable(self.ue_names[u], self.tables[u],
                           self.tp_min_mbps[u], self.feasible_prefilter[u])

    def query_many(self, tp_mbps: np.ndarray,
                   ue_idx: np.ndarray | None = None) -> np.ndarray:
        """Vectorized ``LookupTable.query``: one gather for the whole fleet.

        ``tp_mbps``: (...,) throughput estimates; ``ue_idx``: matching table
        row per estimate (default ``arange`` — one estimate per stacked UE).
        Keeps the 0-bucket semantics: near-zero throughput rounds to bucket
        0, which the sweep never fills, and therefore reads NO_SPLIT."""
        tp = np.asarray(tp_mbps, float)
        if ue_idx is None:
            assert tp.shape == (self.n_ues,), (
                f"default ue_idx needs one estimate per UE, got {tp.shape}")
            ue_idx = np.arange(self.n_ues)
        buckets = np.clip(np.round(tp), 0,
                          self.tables.shape[1] - 1).astype(np.int64)
        return self.tables[np.asarray(ue_idx), buckets]


def _tp_min(profile: SplitProfile, ue: DeviceProfile, server: DeviceProfile,
            cons: Constraints) -> np.ndarray:
    """Line 5-6: minimal throughput (bps) that meets the latency budget."""
    slack = cons.tau_max_s - profile.d_ue(ue) - profile.d_ser(server)
    with np.errstate(divide="ignore"):
        tp = np.where(slack > 0, profile.data_bytes * 8.0 / np.maximum(
            slack, 1e-12), np.inf)
    return tp


def pso_reference(profile: SplitProfile, ue: DeviceProfile,
                  server: DeviceProfile, weights: Weights, cons: Constraints,
                  tp_max_mbps: int) -> LookupTable:
    """Direct pseudocode transcription of Algorithm 1 (single UE)."""
    L = profile.n_splits
    d_ue = profile.d_ue(ue)
    d_ser = profile.d_ser(server)
    e_ue = profile.e_ue(ue)
    p = profile.privacy
    # lines 2-7: prefilter + minimal throughput per split
    feas: list[tuple[int, float]] = []
    for l in range(L):
        if p[l] <= cons.rho_max and e_ue[l] <= cons.e_max_j:
            slack = cons.tau_max_s - d_ue[l] - d_ser[l]
            tp_min = (profile.data_bytes[l] * 8.0 / slack if slack > 0
                      else np.inf)
            feas.append((l, tp_min))
    # lines 8-13: sweep integer throughputs
    table = np.full(tp_max_mbps + 1, NO_SPLIT, np.int32)
    for tp in range(1, tp_max_mbps + 1):
        tp_bps = tp * 1e6
        cand = [l for (l, tpm) in feas if tpm <= tp_bps]
        if not cand:
            continue
        terms = evaluate(profile, ue, server, np.array([tp_bps]), weights,
                         cons)
        fvals = terms.f[cand, 0]
        best = int(np.argmin(fvals))
        if np.isfinite(fvals[best]):
            table[tp] = cand[best]
    tp_min_all = _tp_min(profile, ue, server, cons)
    pre = (p <= cons.rho_max) & (e_ue <= cons.e_max_j)
    return LookupTable(profile.name, table, tp_min_all / 1e6, pre)


def pso_vectorized(profile: SplitProfile, ue: DeviceProfile,
                   server: DeviceProfile, weights: Weights, cons: Constraints,
                   tp_max_mbps: int) -> LookupTable:
    """Vectorised Algorithm 1: one (L, T) objective evaluation."""
    tps = np.arange(1, tp_max_mbps + 1) * 1e6
    terms = evaluate(profile, ue, server, tps, weights, cons)
    pre = ((profile.privacy <= cons.rho_max)
           & (profile.e_ue(ue) <= cons.e_max_j))
    tp_min = _tp_min(profile, ue, server, cons)
    # a split is usable at tp if prefiltered AND tp >= TP_min(l)
    usable = pre[:, None] & (tp_min[:, None] <= tps[None, :]) & terms.feasible
    f = np.where(usable, terms.f, np.inf)
    best = np.argmin(f, axis=0)
    ok = np.isfinite(f[best, np.arange(len(tps))])
    table = np.full(tp_max_mbps + 1, NO_SPLIT, np.int32)
    table[1:] = np.where(ok, best, NO_SPLIT)
    return LookupTable(profile.name, table, tp_min / 1e6, pre)



def build_tables(profiles: dict[str, SplitProfile], ue: DeviceProfile,
                 server: DeviceProfile, weights: Weights, cons: Constraints,
                 tp_max_mbps: int) -> dict[str, LookupTable]:
    """Algorithm 1 outer loop over the UE set."""
    return {name: pso_vectorized(p, ue, server, weights, cons, tp_max_mbps)
            for name, p in profiles.items()}
