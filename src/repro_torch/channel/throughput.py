"""Ground-truth maximum achievable UL throughput vs interference power.

Shannon-style per-PRB capacity with the gNB control loops of Fig. 2a:
  Negligible zone   : peak throughput (SINR >> target)
  Power-Control zone: TPC raises UE tx power, SINR held at target -> peak
                      (high load); for LOW load the un-allocated PRBs are
                      already degraded, so the *max achievable* rate drops
  MCS-Control zone  : power headroom exhausted; MCS steps down
  OOC zone          : BLER -> 100%, only HARQ retransmissions survive
"""
from __future__ import annotations

import numpy as np

# zone boundaries in interference power dBm (at the gNB receiver)
NEGLIGIBLE_MAX = -20.0
POWER_CTRL_MAX = -5.0
MCS_CTRL_MAX = 8.0

PEAK_MBPS = 130.0
SIG_DBM_BASE = -10.0  # received signal power without TPC boost
TPC_MAX_DB = 15.0  # power-control headroom
NOISE_FLOOR_DBM = -35.0


def tpc_boost_db(int_dbm: np.ndarray) -> np.ndarray:
    """gNB-commanded UE power boost (consumed in the Power-Control zone)."""
    x = (np.asarray(int_dbm, float) - NEGLIGIBLE_MAX) / (
        POWER_CTRL_MAX - NEGLIGIBLE_MAX)
    return TPC_MAX_DB * np.clip(x, 0.0, 1.0)


def sinr_db(int_dbm: np.ndarray, *, with_tpc: bool = True) -> np.ndarray:
    int_dbm = np.asarray(int_dbm, float)
    sig = SIG_DBM_BASE + (tpc_boost_db(int_dbm) if with_tpc else 0.0)
    noise_mw = 10 ** (NOISE_FLOOR_DBM / 10) + 10 ** (int_dbm / 10)
    return sig - 10 * np.log10(noise_mw)


def max_throughput_mbps(int_dbm: np.ndarray) -> np.ndarray:
    """Max achievable UL rate if the UE used the full grant."""
    s = sinr_db(int_dbm)
    snr = 10 ** (s / 10)
    cap = np.log2(1 + snr)
    peak_cap = np.log2(1 + 10 ** (sinr_db(np.array(-60.0)) / 10))
    tp = PEAK_MBPS * np.minimum(cap / peak_cap, 1.0)
    # OOC collapse: BLER saturates, effective goodput crumbles
    ooc = np.clip((np.asarray(int_dbm, float) - MCS_CTRL_MAX) / 4.0, 0, 1)
    return np.maximum(tp * (1 - 0.97 * ooc), 0.5)


PRB_FLOOR_MBPS = 0.01  # scheduling crumbs: even a starved UE sees a trickle


def prb_scaled_mbps(tp_mbps: np.ndarray, prb_share,
                    floor_mbps: float = PRB_FLOOR_MBPS) -> np.ndarray:
    """Throughput on a fractional PRB grant (fluid gNB scheduler model).

    ``tp_mbps`` is the full-grant max achievable rate; capacity scales
    linearly with the granted share of the cell's PRBs. Floored so a
    starved UE (max-C/I losers get share 0) keeps a finite E2E delay."""
    share = np.clip(np.asarray(prb_share, float), 0.0, 1.0)
    return np.maximum(np.asarray(tp_mbps, float) * share, floor_mbps)


def shared_throughput_mbps(int_dbm: np.ndarray, prb_share,
                           floor_mbps: float = PRB_FLOOR_MBPS) -> np.ndarray:
    """Max achievable UL rate on a fractional PRB grant."""
    return prb_scaled_mbps(max_throughput_mbps(int_dbm), prb_share,
                           floor_mbps)


def bler(int_dbm: np.ndarray) -> np.ndarray:
    """UL block error rate: ~10% target until OOC, then -> 1.0."""
    x = np.clip((np.asarray(int_dbm, float) - MCS_CTRL_MAX) / 3.0, 0, 1)
    return 0.1 + 0.9 * x**2


def mcs_index(int_dbm: np.ndarray) -> np.ndarray:
    """UL MCS: 28 until the MCS-Control zone, stepping to 0 at its end."""
    x = np.clip((np.asarray(int_dbm, float) - POWER_CTRL_MAX) / (
        MCS_CTRL_MAX - POWER_CTRL_MAX), 0, 1)
    return np.round(28 * (1 - x)).astype(int)
