"""KPM trace synthesis (gNB-side, 0.1 s reporting period, Near-RT RIC xApp).

Feature sets:
  KPMS_7   — Minovski et al. [8]: RSRP, RSRQ, SINR, P_a, RI, CQI, CRI
  KPMS_8   — the paper's additions: PUSCH-SINR, TPC, UL-MCS, UL-BLER,
             HARQ-RV0..3 counters
  KPMS_15  — both.

Key modelled effect (Fig. 2b): under LOW UL load the UE's few allocated PRBs
dodge the interference, so the 15 numerical KPMs stay nominal while the max
*achievable* throughput collapses — only the IQ spectrogram reveals it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.channel import throughput as tp

KPMS_7 = ["rsrp", "rsrq", "sinr", "p_a", "ri", "cqi", "cri"]
KPMS_8 = ["pusch_sinr", "tpc", "ul_mcs", "ul_bler",
          "harq_rv0", "harq_rv1", "harq_rv2", "harq_rv3"]
KPMS_15 = KPMS_7 + KPMS_8


# How much of the interference footprint overlaps the low PRBs that carry a
# small grant: barrage jamming hits them too; CCI blocks dodge them; TDD
# cross-link hits trailing symbols only.
SCENARIO_OVERLAP = {"none": 0.0, "jamming": 0.8, "cci": 0.35, "tdd": 0.6}


def scenario_overlap(scenario) -> np.ndarray:
    """SCENARIO_OVERLAP lookup for a scalar / array of scenario names."""
    scen = np.asarray(scenario)
    if scen.ndim == 0:
        return np.float64(SCENARIO_OVERLAP.get(str(scen), 0.3))
    flat = [SCENARIO_OVERLAP.get(str(s), 0.3) for s in scen.ravel()]
    return np.asarray(flat, float).reshape(scen.shape)


def kpm_window_batch(int_dbm: np.ndarray, load_ratio,
                     rng: np.random.Generator, scenario="cci") -> np.ndarray:
    """(N, T, 15) KPM reports for N UEs' interference traces in one shot.

    ``int_dbm``: (N, T) traces; ``load_ratio``: scalar or (N,);
    ``scenario``: one name, (N,) per-UE names, or an (N, T) per-step grid
    (mid-episode scenario handover changes the interference footprint that
    overlaps a small grant, hence the per-step form). HARQ RV counters
    accumulate along T like a per-trace running state: rv0 = new TBs,
    rv1 = first retx (rv0 * BLER), rv2/3 appear when BLER saturates (the
    paper's OOC-zone estimator signal).
    """
    x = np.asarray(int_dbm, float)
    assert x.ndim == 2, f"int_dbm must be (N, T), got {x.shape}"
    N, T = x.shape
    lr = np.broadcast_to(np.asarray(load_ratio, float), (N,))
    ov = np.asarray(scenario_overlap(scenario), float)
    ov = np.broadcast_to(ov[..., None] if ov.ndim == 1 else ov, (N, T))

    def n(s, shape=(N, T)):
        return rng.normal(0.0, s, shape)

    out = np.empty((N, T, len(KPMS_15)), np.float32)
    col = {k: i for i, k in enumerate(KPMS_15)}
    # DL-side metrics: unaffected by UL interference (paper's 7-KPM baseline
    # fails exactly because of this)
    out[:, :, col["rsrp"]] = -85.0 + n(1.0)
    out[:, :, col["rsrq"]] = -10.5 + n(0.5)
    out[:, :, col["sinr"]] = 22.0 + n(1.0)
    out[:, :, col["p_a"]] = -3.0 + n(0.2)
    out[:, :, col["ri"]] = 2.0 + (rng.random((N, T)) < 0.05)
    out[:, :, col["cqi"]] = 13.0 + np.round(n(0.6))
    out[:, :, col["cri"]] = 1.0
    # UL metrics see the interference hitting the *allocated* PRBs
    visible = np.maximum(np.clip((lr - 0.15) / 0.85, 0.0, 1.0)[:, None], ov)
    eff_int = x * visible + (-60.0) * (1 - visible)
    b = tp.bler(eff_int)
    out[:, :, col["pusch_sinr"]] = tp.sinr_db(eff_int) + n(0.8)
    out[:, :, col["tpc"]] = tp.tpc_boost_db(eff_int) + n(0.3)
    out[:, :, col["ul_mcs"]] = tp.mcs_index(eff_int)
    out[:, :, col["ul_bler"]] = np.clip(b + n(0.02), 0, 1)
    # HARQ RV chains: per-step new TBs and retx draws, then a cumulative
    # sum along T reproduces the sequential harq_state accumulator
    bp = np.minimum(b, 1.0)
    tbs = rng.poisson(80 * lr[:, None] + 1, (N, T))
    rv1 = rng.binomial(tbs, bp)
    rv2 = rng.binomial(rv1, bp)
    rv3 = rng.binomial(rv2, bp)
    for k, inc in (("harq_rv0", tbs), ("harq_rv1", rv1),
                   ("harq_rv2", rv2), ("harq_rv3", rv3)):
        out[:, :, col[k]] = np.cumsum(inc, axis=1)
    return out


def kpm_window(int_dbm_trace: np.ndarray, load_ratio: float,
               rng: np.random.Generator, scenario: str = "cci") -> np.ndarray:
    """(T, 15) float array for a trace of interference powers (shim over
    the batched path)."""
    return kpm_window_batch(np.asarray(int_dbm_trace, float)[None],
                            load_ratio, rng, scenario)[0]


# The fixed affine normalisation (deployment can't peek at test stats).
# Module-level so the fused featurize kernel
# (repro_torch.kernels.featurize) and this host path share one definition —
# drift here would silently break the fused-vs-unfused bit-equality pins.
KPM_CENTER = np.array([-85, -10.5, 22, -3, 2, 13, 1,
                       15, 7, 14, 0.5, 400, 40, 8, 2], np.float32)
KPM_SCALE = np.array([5, 2, 5, 1, 1, 3, 1,
                      15, 7, 14, 0.5, 400, 60, 15, 6], np.float32)


def normalize_kpms(x: np.ndarray) -> np.ndarray:
    """Fixed affine normalisation (deployment can't peek at test stats)."""
    return (x - KPM_CENTER) / KPM_SCALE
