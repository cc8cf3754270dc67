"""The paper's joint objective F(l, TP) and constraints (Sec. V).

F(l,TP) = w1*D_E2E(l,TP) + w2*P(l) + w3*E_UE(l)
D_E2E   = d_UE(l) + d_TRX(l,TP) + d_ser(l)
s.t. D_E2E <= tau_max, P <= rho_max, E_UE <= E_max.

Everything is vectorised over (l, TP) so lookup-table construction is one
matrix pass (numpy for the host-side planner; jnp mirrors for tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.energy import DeviceProfile
from repro_torch.core.profiles import SplitProfile

INFEASIBLE = np.inf


@dataclasses.dataclass(frozen=True)
class Constraints:
    tau_max_s: float = np.inf  # latency
    rho_max: float = 1.0  # privacy (dCor)
    e_max_j: float = np.inf  # UE energy


@dataclasses.dataclass(frozen=True)
class Weights:
    """w1..w3. The paper normalises each metric so contributions balance;
    normalise=True divides by the metric's per-profile max."""

    w_delay: float = 1.0
    w_privacy: float = 0.0
    w_energy: float = 0.0
    normalize: bool = True


@dataclasses.dataclass
class ObjectiveTerms:
    d_ue: np.ndarray  # (L,)
    d_ser: np.ndarray  # (L,)
    d_trx: np.ndarray  # (L, T)
    d_e2e: np.ndarray  # (L, T)
    privacy: np.ndarray  # (L,)
    e_ue: np.ndarray  # (L,)
    f: np.ndarray  # (L, T)
    feasible: np.ndarray  # (L, T) bool


def evaluate(profile: SplitProfile, ue: DeviceProfile, server: DeviceProfile,
             tp_bps: np.ndarray, weights: Weights,
             cons: Constraints) -> ObjectiveTerms:
    tp_bps = np.asarray(tp_bps, float)
    d_ue = profile.d_ue(ue)
    d_ser = profile.d_ser(server)
    d_trx = profile.d_trx(tp_bps)
    d_e2e = d_ue[:, None] + d_ser[:, None] + d_trx
    p = profile.privacy
    e = profile.e_ue(ue)
    if weights.normalize:
        nd = max(float(np.max(d_ue + d_ser)), 1e-9)
        np_ = max(float(np.max(p)), 1e-9)
        ne = max(float(np.max(e)), 1e-9)
    else:
        nd = np_ = ne = 1.0
    f = (weights.w_delay * d_e2e / nd
         + weights.w_privacy * (p / np_)[:, None]
         + weights.w_energy * (e / ne)[:, None])
    feasible = ((d_e2e <= cons.tau_max_s)
                & (p <= cons.rho_max)[:, None]
                & (e <= cons.e_max_j)[:, None])
    return ObjectiveTerms(d_ue, d_ser, d_trx, d_e2e, p, e,
                          np.where(feasible, f, INFEASIBLE), feasible)
