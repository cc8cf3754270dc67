"""Interference scenarios (Fig. 4) and batched episode generation.

S0 none | S1 jamming (signal generator) | S2 UE-to-BS CCI | S3 BS-to-BS TDD
pattern mismatch. Each episode draws an interference-power trajectory,
produces 0.1 s KPM reports, per-period IQ spectrograms, and the ground-truth
max achievable throughput label.

A float64 numpy copy of the reference's host-side generator: the same
``np.random.Generator`` state gives the same episode, array for array.
``gen_episode``/``gen_dataset`` are the per-sample shims the estimator's
trainers read; ``make_churn_schedule`` draws the slot pool's continuous
arrival/departure process (``repro_torch.sim.pool``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.channel import iq as iqmod
from repro_torch.channel import kpm as kpmmod
from repro_torch.channel import throughput as tpmod

SCENARIOS = ("none", "jamming", "cci", "tdd")
WINDOW = 30  # paper: LSTM window=30 KPM reports


@dataclasses.dataclass
class Sample:
    kpms: np.ndarray  # (WINDOW, 15)
    iq: np.ndarray  # (2, n_sc, 14)
    alloc_ratio: float
    tp_mbps: float
    scenario: str
    int_dbm: float


def power_sum_dbm(base_dbm: np.ndarray, extra_mw: np.ndarray) -> np.ndarray:
    """Power-sum an extra interference term (mW) onto a dBm trace.

    Used for the load-dependent inter-cell floor: the scenario's own
    interference and the neighbour-cell contribution add in linear power.
    Clipped to the model's 14 dBm ceiling (deep OOC) like the base traces.
    """
    p_mw = 10 ** (np.asarray(base_dbm, float) / 10) + np.asarray(
        extra_mw, float)
    return np.minimum(10 * np.log10(np.maximum(p_mw, 1e-12)), 14.0)


def interference_trace_batch(scenarios, T: int, rng: np.random.Generator,
                             extra_mw: np.ndarray | None = None
                             ) -> np.ndarray:
    """(N, T) interference power (dBm): one trace per requested scenario.

    ``extra_mw``: optional (N, T) load-dependent floor (linear mW) power-
    summed onto every trace. It raises even the "none" rows: an S0 UE in a
    loaded neighbourhood is no longer quiet.
    """
    scen = np.asarray(scenarios)
    N = len(scen)
    base = rng.uniform(-30, 10, N)
    walk = np.cumsum(rng.normal(0, 1.0, (N, T)), axis=1)
    tr = base[:, None] + walk - walk.mean(axis=1, keepdims=True)
    # bursty on/off jammer
    on = np.sin(np.arange(T)[None] / rng.uniform(3, 10, N)[:, None]) > -0.3
    tr = np.where((scen == "jamming")[:, None] & ~on, -60.0, tr)
    tr = np.where((scen == "none")[:, None], -60.0, np.clip(tr, -60, 14))
    return tr if extra_mw is None else power_sum_dbm(tr, extra_mw)


def interference_trace(scenario: str, T: int,
                       rng: np.random.Generator) -> np.ndarray:
    """(T,) trace for one scenario (shim over the batched path)."""
    return interference_trace_batch([scenario], T, rng)[0]


@dataclasses.dataclass
class EpisodeBatch:
    """N parallel episodes as stacked arrays (the fleet engine's input).

    ``int_dbm``/``kpms`` cover the full ``T + WINDOW`` trace (the warm-up
    prefix fills the first estimator window); labels and spectrograms exist
    for the T reporting steps. ``scenario_idx`` indexes ``SCENARIOS``.
    """

    scenario_idx: np.ndarray  # (N,) int
    alloc_ratio: np.ndarray  # (N,)
    int_dbm: np.ndarray  # (N, T + WINDOW)
    kpms: np.ndarray | None  # (N, T + WINDOW, 15) raw reports, or None
    tp_mbps: np.ndarray  # (N, T) ground-truth labels
    iq: np.ndarray | None  # (N, T, 2, n_sc, 14) or None if not requested

    @property
    def n_ues(self) -> int:
        return self.int_dbm.shape[0]

    @property
    def n_steps(self) -> int:
        return self.tp_mbps.shape[1]

    def kpm_windows(self, normalize: bool = True,
                    method: str = "view") -> np.ndarray:
        """(N, T, WINDOW, 15) rolling estimator windows: step t sees the
        WINDOW reports strictly before trace position ``WINDOW + t``.

        ``method="view"`` (default) is the zero-copy stride-trick form: a
        non-contiguous, non-writable view whose window axis aliases the
        trace axis. ``method="gather"`` is the contiguity-safe fancy-index
        form: a fresh C-contiguous, writable array, WINDOW x the memory.
        The two are bit-equal element for element."""
        if self.kpms is None:
            raise ValueError("episode was generated with include_kpms=False")
        k = kpmmod.normalize_kpms(self.kpms) if normalize else self.kpms
        if method == "view":
            win = np.lib.stride_tricks.sliding_window_view(k, WINDOW, axis=1)
            return win.transpose(0, 1, 3, 2)[:, :self.n_steps]
        if method == "gather":
            t_idx = (np.arange(self.n_steps)[:, None]
                     + np.arange(WINDOW)[None, :])  # (T, WINDOW)
            return np.ascontiguousarray(k[:, t_idx])
        raise ValueError(f"method must be 'view' or 'gather': {method!r}")


def gen_episode_batch(scenarios, T: int, rng: np.random.Generator,
                      load_ratio=None, n_sc: int = iqmod.N_SC,
                      include_iq: bool = True, include_kpms: bool = True,
                      int_dbm: np.ndarray | None = None,
                      extra_int_mw: np.ndarray | None = None) -> EpisodeBatch:
    """Generate N episodes in one vectorized pass.

    Returns an ``EpisodeBatch`` of stacked arrays: ``int_dbm``
    (N, T + WINDOW) interference traces in dBm, ``kpms``
    (N, T + WINDOW, 15) raw KPM reports, ``tp_mbps`` (N, T) ground-truth
    throughput labels in Mbps, and (when ``include_iq``) ``iq``
    (N, T, 2, n_sc, 14) spectrograms. The first WINDOW trace steps are
    warm-up that fills the estimator's first KPM window; the T remaining
    steps are the 0.1 s report periods.

    ``scenarios``: (N,) scenario names, or an (N, T + WINDOW) name grid for
    mid-episode scenario handover. ``load_ratio``: None (drawn per UE),
    scalar, or (N,) — the UE's UL PRB allocation ratio in [0, 1].
    ``int_dbm`` overrides the drawn interference traces (shape
    (N, T + WINDOW), dBm). ``extra_int_mw``: optional (N, T + WINDOW)
    load-dependent interference floor (linear mW) power-summed onto the
    traces before KPMs, IQ and labels are derived. ``include_kpms=False``
    skips KPM-report synthesis (``kpms`` is None).
    """
    scen = np.asarray(scenarios)
    scen_grid = scen if scen.ndim == 2 else None
    scen0 = scen[:, 0] if scen.ndim == 2 else scen  # for trace + labels
    N = len(scen0)
    lr = (rng.uniform(0.05, 1.0, N) if load_ratio is None
          else np.broadcast_to(np.asarray(load_ratio, float), (N,)).copy())
    if int_dbm is None:
        if scen_grid is None:
            tr = interference_trace_batch(scen0, T + WINDOW, rng,
                                          extra_mw=extra_int_mw)
            extra_int_mw = None  # already folded in
        else:  # handover: every cell reads its row's trace for its scenario
            tr = np.empty((N, T + WINDOW))
            for s in np.unique(scen_grid):
                mask = scen_grid == s
                seg = interference_trace_batch(np.full(N, s), T + WINDOW, rng)
                tr[mask] = seg[mask]
    else:
        tr = np.asarray(int_dbm, float)
        if tr.shape != (N, T + WINDOW):
            raise ValueError(f"int_dbm must be {(N, T + WINDOW)}, "
                             f"got {tr.shape}")
    if extra_int_mw is not None:
        tr = power_sum_dbm(tr, extra_int_mw)
    kpms = None
    if include_kpms:
        kpms = kpmmod.kpm_window_batch(tr, lr, rng,
                                       scen_grid if scen_grid is not None
                                       else scen0)
    tp = tpmod.max_throughput_mbps(tr[:, WINDOW:])
    iq = None
    if include_iq:
        rep = (scen_grid[:, WINDOW:] if scen_grid is not None
               else np.repeat(scen0, T).reshape(N, T))
        iq = iqmod.spectrogram_batch(
            tr[:, WINDOW:].ravel(), rep.ravel(), np.repeat(lr, T), rng,
            n_sc=n_sc).reshape(N, T, 2, n_sc, iqmod.N_SYM)
    sidx = np.array([SCENARIOS.index(s) if s in SCENARIOS else -1
                     for s in scen0])
    return EpisodeBatch(scenario_idx=sidx, alloc_ratio=lr, int_dbm=tr,
                        kpms=kpms, tp_mbps=tp, iq=iq)


def gen_episode(scenario: str, T: int, rng: np.random.Generator,
                load_ratio: float | None = None, n_sc: int = iqmod.N_SC
                ) -> list[Sample]:
    """The per-sample episode API (shim over the batched path)."""
    ep = gen_episode_batch([scenario], T, rng, load_ratio=load_ratio,
                           n_sc=n_sc)
    windows = ep.kpm_windows(normalize=False)[0]  # (T, WINDOW, 15)
    return [Sample(kpms=windows[t], iq=ep.iq[0, t],
                   alloc_ratio=float(ep.alloc_ratio[0]),
                   tp_mbps=float(ep.tp_mbps[0, t]), scenario=scenario,
                   int_dbm=float(ep.int_dbm[0, WINDOW + t]))
            for t in range(T)]


def gen_dataset(n_per_scenario: int, rng: np.random.Generator,
                scenarios=SCENARIOS, episode_len: int = 20,
                low_load_only: bool = False, n_sc: int = iqmod.N_SC) -> dict:
    """Arrays ready for the estimator: a dict of stacked, shuffled fields
    ``kpms`` (n, WINDOW, 15) normalized, ``iq`` (n, 2, n_sc, 14), ``alloc``
    (n,), ``tp`` (n,) in f32 and ``scenario`` (n,) indices.

    One batched pass: enough whole episodes per scenario to reach
    ``n_per_scenario`` samples each (episodes are never truncated, so a
    scenario may exceed the target). ``low_load_only`` draws the PRB
    allocation ratio from [0.05, 0.2], Table II's low-load regime."""
    n_eps = math.ceil(n_per_scenario / episode_len)
    scen = np.repeat(np.asarray(scenarios), n_eps)
    lr = rng.uniform(0.05, 0.2, len(scen)) if low_load_only else None
    ep = gen_episode_batch(scen, episode_len, rng, load_ratio=lr, n_sc=n_sc)
    n = ep.n_ues * ep.n_steps
    perm = rng.permutation(n)
    kpms = ep.kpm_windows(normalize=True).reshape(n, WINDOW, -1)[perm]
    return {"kpms": kpms.astype(np.float32),
            "iq": ep.iq.reshape((n,) + ep.iq.shape[2:])[perm]
            .astype(np.float32),
            "alloc": np.repeat(ep.alloc_ratio, ep.n_steps)[perm]
            .astype(np.float32),
            "tp": ep.tp_mbps.reshape(n)[perm].astype(np.float32),
            "scenario": np.repeat(ep.scenario_idx, ep.n_steps)[perm]}


# --------------------------------------------------------------------------
# Continuous UE arrival/departure (slot-pool churn)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Knobs of the continuous UE arrival/departure process.

    Arrivals are Poisson per report period with an optional diurnal
    (sinusoidal) modulation of the rate; session lengths are geometric
    with mean ``mean_dwell`` periods, capped at ``max_dwell`` (which also
    bounds the per-session trace length the engine must generate).
    ``max_admits`` is the number of admission lanes a period: arrivals
    beyond it (or beyond free capacity) queue in the global FIFO and show
    up as admission latency. Zero means "derive from the realised
    process".
    """

    arrival_rate: float = 8.0  # mean UE arrivals per report period
    diurnal_amplitude: float = 0.0  # 0 = homogeneous Poisson, (0, 1] = tide
    diurnal_period: int = 0  # periods per load cycle (0 -> one per horizon)
    mean_dwell: float = 20.0  # mean session length in report periods
    max_dwell: int = 0  # trace-length cap L (0 -> ceil(3 * mean_dwell))
    max_admits: int = 0  # admission lanes A per period (0 -> auto)

    def __post_init__(self):
        if self.arrival_rate < 0:
            raise ValueError(f"arrival_rate must be >= 0: {self.arrival_rate}")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError(
                f"diurnal_amplitude must be in [0, 1]: {self.diurnal_amplitude}")
        if self.mean_dwell < 1.0:
            raise ValueError(f"mean_dwell must be >= 1: {self.mean_dwell}")


@dataclasses.dataclass
class ChurnSchedule:
    """A realised arrival process: the slot pool's global admission FIFO.

    Sessions are sorted by arrival period; the pool admits them in order
    as capacity frees up. ``ready_end[t]`` counts sessions with
    ``arrival_t <= t``: the FIFO prefix eligible for admission at period
    t.
    """

    arrival_t: np.ndarray  # (M,) int32, sorted arrival period per session
    dwell: np.ndarray  # (M,) int32 session length in periods, >= 1
    ready_end: np.ndarray  # (T,) int32 cumulative arrivals through period t
    horizon: int  # T report periods
    max_admits: int  # A admission lanes per period

    @property
    def n_sessions(self) -> int:
        return int(self.arrival_t.shape[0])

    @property
    def max_dwell(self) -> int:
        return int(self.dwell.max()) if self.dwell.size else 1


def diurnal_arrival_rate(cfg: ChurnConfig, T: int) -> np.ndarray:
    """(T,) per-period Poisson arrival rate with diurnal modulation."""
    lam = np.full(T, float(cfg.arrival_rate))
    if cfg.diurnal_amplitude > 0.0:
        period = cfg.diurnal_period if cfg.diurnal_period > 0 else T
        phase = 2.0 * np.pi * np.arange(T) / max(period, 1)
        lam = lam * (1.0 + cfg.diurnal_amplitude * np.sin(phase))
    return np.maximum(lam, 0.0)


def make_churn_schedule(cfg: ChurnConfig, T: int,
                        rng: np.random.Generator) -> ChurnSchedule:
    """Draw a concrete arrival/departure realisation over T periods.

    The auto ``max_admits`` is twice the busiest period's arrivals (at
    least 1): wide enough that a drained pool catches up on a backlog
    within a few periods, narrow enough to keep the admission lanes
    cheap.
    """
    lam = diurnal_arrival_rate(cfg, T)
    counts = rng.poisson(lam).astype(np.int64)
    arrival_t = np.repeat(np.arange(T, dtype=np.int32),
                          counts).astype(np.int32)
    m = int(arrival_t.shape[0])
    max_dwell = cfg.max_dwell if cfg.max_dwell > 0 else int(
        math.ceil(3.0 * cfg.mean_dwell))
    max_dwell = max(max_dwell, 1)
    if m:
        dwell = rng.geometric(1.0 / float(cfg.mean_dwell), m)
        dwell = np.clip(dwell, 1, max_dwell).astype(np.int32)
    else:
        dwell = np.zeros(0, np.int32)
    ready_end = np.cumsum(counts).astype(np.int32)
    max_admits = cfg.max_admits if cfg.max_admits > 0 else max(
        1, 2 * int(counts.max(initial=0)))
    return ChurnSchedule(arrival_t=arrival_t, dwell=dwell,
                         ready_end=ready_end, horizon=int(T),
                         max_admits=int(max_admits))
