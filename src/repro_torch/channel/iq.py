"""Fronthaul IQ spectrogram synthesis for UL slots.

Grid: (2 [I/Q], 273 PRB * 12 subcarriers = 3276, 14 OFDM symbols) — the
paper's Table I input. Per-RE complex samples with power from: the UE's
allocated transmission, the interference source (scenario-shaped footprint),
and the thermal noise floor.
"""
from __future__ import annotations

import numpy as np

N_PRB = 273
N_SC = N_PRB * 12  # 3276
N_SYM = 14


def footprint_batch(scenario: str, m: int, rng: np.random.Generator,
                    n_sc: int = N_SC, n_sym: int = N_SYM) -> np.ndarray:
    """(m, n_sc, n_sym) in [0,1]: where the interference lands on the
    grid, for m slots of one scenario drawn in one shot.

    Footprint geometry is always sampled in full-resolution (N_SC)
    coordinates and evaluated at the ``n_sc`` retained subcarrier rows, so
    reduced-width test grids see the same spatial statistics as the full
    grid after row subsampling."""
    sc = (np.arange(n_sc) if n_sc == N_SC
          else np.linspace(0, N_SC - 1, n_sc).astype(int))  # (n_sc,) rows
    if scenario == "none":
        return np.zeros((m, n_sc, n_sym), np.float32)
    if scenario == "jamming":  # barrage: wide band, bursty in time
        f0 = rng.integers(0, N_SC // 4, m)
        f1 = rng.integers(3 * N_SC // 4, N_SC, m)
        band = (sc[None] >= f0[:, None]) & (sc[None] < f1[:, None])
        sym = rng.random((m, n_sym)) < 0.8
        return (band[:, :, None] & sym[:, None, :]).astype(np.float32)
    if scenario == "cci":  # neighbouring UE: PRB-block granular
        prb = sc // 12  # blocks start above N_PRB // 8: avoids the low PRBs
        max_blocks = 5  # n_blocks ~ U{2..5}; extra draws masked out
        n_blocks = rng.integers(2, 6, m)
        p0 = rng.integers(N_PRB // 8, N_PRB, (m, max_blocks))
        w = rng.integers(8, 40, (m, max_blocks))
        live = np.arange(max_blocks)[None] < n_blocks[:, None]
        hit = (live[:, :, None] & (prb[None, None] >= p0[:, :, None])
               & (prb[None, None] < (p0 + w)[:, :, None])).any(axis=1)
        return np.broadcast_to(hit[:, :, None].astype(np.float32),
                               (m, n_sc, n_sym)).copy()
    if scenario == "tdd":  # aggressor DL symbols overlap victim UL
        one = ((sc[:, None] >= N_SC // 10)  # victim's protected low PRBs
               & (np.arange(n_sym)[None] >= 8)).astype(np.float32)
        return np.broadcast_to(one[None], (m, n_sc, n_sym)).copy()
    raise ValueError(scenario)


def spectrogram_batch(int_dbm: np.ndarray, scenario, load_ratio,
                      rng: np.random.Generator, n_sc: int = N_SC,
                      n_sym: int = N_SYM) -> np.ndarray:
    """(m, 2, n_sc, n_sym) float32 IQ grids for m UL slots in one shot.

    ``scenario``: one name or an (m,) array of per-slot names (mixed-fleet
    batches draw each scenario group's footprints together)."""
    x = np.atleast_1d(np.asarray(int_dbm, float))
    m = len(x)
    lr = np.broadcast_to(np.asarray(load_ratio, float), (m,))
    scen = np.broadcast_to(np.asarray(scenario), (m,))
    fp = np.empty((m, n_sc, n_sym), np.float32)
    for s in np.unique(scen):
        idx = np.flatnonzero(scen == s)
        fp[idx] = footprint_batch(str(s), len(idx), rng, n_sc, n_sym)
    alloc = np.zeros((m, n_sc, n_sym), np.float32)
    n_alloc = np.maximum(1, (lr * n_sc).astype(int))
    alloc[np.arange(n_sc)[None] < n_alloc[:, None]] = 1.0  # low PRBs upward
    sig_p = 10 ** (-10.0 / 10) * alloc
    int_p = 10 ** (x / 10)[:, None, None] * fp
    noise_p = 10 ** (-35.0 / 10)
    std = np.sqrt((sig_p + int_p + noise_p) / 2.0)
    iq = rng.normal(size=(m, 2, n_sc, n_sym)).astype(np.float32)
    return iq * std[:, None]


def spectrogram(int_dbm: float, scenario: str, load_ratio: float,
                rng: np.random.Generator, n_sc: int = N_SC,
                n_sym: int = N_SYM) -> np.ndarray:
    """(2, n_sc, n_sym) float32 IQ grid (shim over the batched path)."""
    return spectrogram_batch(np.asarray([int_dbm], float), scenario,
                             load_ratio, rng, n_sc, n_sym)[0]


def to_dbfs(iq: np.ndarray) -> np.ndarray:
    """Log-power image (the CNN sees spectrogram magnitudes)."""
    p = iq[0] ** 2 + iq[1] ** 2
    return (10 * np.log10(np.maximum(p, 1e-12))).astype(np.float32)
