"""Fleet-scale adaptive-splitting simulation engine (main path).

Runs N UEs through the paper's adaptive path — channel -> KPM/IQ ->
throughput estimate -> EWMA/hysteresis controller -> PSO lookup -> split
metrics — as one batched program on the card:

  * episodes come in as an ``EpisodeBatch`` ((N, T, ...) numpy arrays,
    see ``repro_torch.channel.scenarios.gen_episode_batch``),
  * the fleet's throughput estimates come from one estimator forward per
    chunk of report periods (``estimate_fleet``); with ``fused=True`` the
    ``featurize`` kernel cuts the KPM windows on the card,
  * the N controllers advance as one batched ``controller_step`` per
    report period,
  * delay/privacy/energy are gathered for the fleet in one float64 pass.

``simulate_fleet_looped`` is the per-UE, per-step loop kept as the
equivalence reference; both paths give identical split decisions (they
share ``controller_step``) and identical metrics.

``quant="int8"`` serves the estimator through the int8 kernels
(``estimator.serve``). The arguments of later slices (``serving``,
``online``, ``sched``, ``cell_idx``/``n_cells``, ``churn``/``capacity``,
``telemetry``, a recurrent SSM estimator) raise ``NotImplementedError``
naming their ``ROADMAP.md`` queue item; none is ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.channel import kpm as kpmmod
from repro_torch.channel.scenarios import SCENARIOS, WINDOW, EpisodeBatch
from repro_torch.core.controller import (AdaptiveSplitController,
                                         ControllerConfig, controller_init,
                                         controller_step)
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE, DeviceProfile
from repro_torch.core.objective import Constraints, Weights, evaluate
from repro_torch.core.profiles import SplitProfile
# the estimator clamp range is part of the PSO sweep config, not ours
from repro_torch.core.pso import TP_CLIP_MBPS, StackedLookupTable
from repro_torch.estimator.model import EstimatorConfig
from repro_torch.estimator.serve import (check_quant, fwd_int8,
                                         quantize_estimator)
from repro_torch.estimator.train import fwd
from repro_torch.kernels.featurize import kpm_feature_windows


def _not_ported(arg: str, item: str):
    return NotImplementedError(
        f"{arg} is not ported to repro_torch yet: ROADMAP.md module queue "
        f"item {item}")


@dataclasses.dataclass
class FleetResult:
    """Per-UE, per-report-period outcome of a fleet simulation."""

    splits: np.ndarray  # (N, T) int32 — deployed split per period
    true_tp: np.ndarray  # (N, T) Mbps ground truth
    est_tp: np.ndarray  # (N, T) Mbps fed to the controllers
    delay_s: np.ndarray  # (N, T) E2E delay at the deployed split
    privacy: np.ndarray  # (N, T) dCor leak at the deployed split
    energy_j: np.ndarray  # (N, T) UE energy at the deployed split
    fixed: Optional["FleetResult"] = None  # fixed-split baseline, same shapes

    @property
    def n_ues(self) -> int:
        return self.splits.shape[0]

    @property
    def n_steps(self) -> int:
        return self.splits.shape[1]

    def scenario_means(self, scenario_idx: np.ndarray) -> dict:
        """Per-scenario (delay, privacy, energy) means, keyed by name."""
        out = {}
        for i in np.unique(np.asarray(scenario_idx)):
            rows = scenario_idx == i
            name = SCENARIOS[i] if 0 <= i < len(SCENARIOS) else str(i)
            out[name] = np.array([self.delay_s[rows].mean(),
                                  self.privacy[rows].mean(),
                                  self.energy_j[rows].mean()])
        return out


# Transmission-delay guard: an idle slot or a zero-PRB grant has no link,
# and dividing by its 0 bps would poison delay means with inf. Any real
# link is floored far above this, so clamping at 1 bps is bit-invisible to
# live traffic.
TP_FLOOR_BPS = 1.0


def split_metrics(profile: SplitProfile, splits: np.ndarray,
                  tp_mbps: np.ndarray, ue: DeviceProfile = UE_VM_2CORE,
                  server: DeviceProfile = EDGE_A40X2, *, device="cuda"
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(delay_s, privacy, energy_j) for a whole fleet in one gather.

    Float64 on ``device``, the same operations in the same order as the
    reference (and as ``evaluate`` at the chosen split), so the results
    are bit-identical. A split index reads like a numpy index: NO_SPLIT
    (-1) reads the last split point. Throughput is floored at
    ``TP_FLOOR_BPS``."""
    dev = resolve_device(device)
    n_splits = profile.n_splits
    l = torch.as_tensor(np.asarray(splits), dtype=torch.int64, device=dev)
    if bool(((l < -n_splits) | (l >= n_splits)).any()):
        raise IndexError(f"split index outside [-{n_splits}, {n_splits})")
    l = torch.remainder(l, n_splits)

    def col(a):
        return torch.as_tensor(np.asarray(a, float), device=dev)

    tp_bps = torch.clamp_min(col(tp_mbps) * 1e6, TP_FLOOR_BPS)
    delay = (col(profile.d_ue(ue))[l] + col(profile.d_ser(server))[l]
             + col(profile.data_bytes)[l] * 8.0 / tp_bps)
    return (delay.cpu().numpy(), col(profile.privacy)[l].cpu().numpy(),
            col(profile.e_ue(ue))[l].cpu().numpy())


def run_controllers(tables: np.ndarray, est_tp: np.ndarray,
                    cfg: ControllerConfig, warm_split, *,
                    device="cuda") -> np.ndarray:
    """(N, T) int32 splits: N controllers over T periods, batched.

    ``tables``: (N, tp_max+1) stacked lookup rows (``StackedLookupTable
    .tables``); ``est_tp``: (N, T) estimates, taken as float32 like the
    reference's; ``warm_split``: scalar or (N,) deployed-split warm
    start."""
    dev = resolve_device(device)
    tab = torch.as_tensor(np.array(tables, np.int32), device=dev)
    est = torch.as_tensor(np.asarray(est_tp, np.float32), device=dev)
    n, t_steps = est.shape
    state = controller_init(np.asarray(warm_split, np.int32),
                            batch_shape=(n,), device=dev)
    splits = torch.empty((n, t_steps), dtype=torch.int32, device=dev)
    for t in range(t_steps):
        state, splits[:, t] = controller_step(tab, state, est[:, t], cfg=cfg)
    return splits.cpu().numpy()


def emit_period_samples(episode: EpisodeBatch, t: int,
                        wins: Optional[np.ndarray] = None, *,
                        trace: Optional[np.ndarray] = None) -> dict:
    """The (kpms, iq, alloc -> measured tp) sample batch report period
    ``t`` emits: N rows of estimator inputs plus the period's measured
    throughput in Mbps (numpy, float32).

    ``wins``: optionally the precomputed float32
    ``episode.kpm_windows(normalize=True)``. ``trace``: the fused
    alternative — the (N, T + WINDOW, 15) normalized float32 KPM trace;
    period ``t``'s window is then the ``trace[:, t:t+WINDOW]`` view, the
    same f32 elements as ``wins[:, t]``."""
    if trace is not None:
        kp = trace[:, t:t + WINDOW]
    else:
        if wins is None:
            wins = episode.kpm_windows(normalize=True).astype(np.float32)
        kp = wins[:, t]
    return {"kpms": kp,
            "iq": episode.iq[:, t].astype(np.float32),
            "alloc": episode.alloc_ratio.astype(np.float32),
            "tp": episode.tp_mbps[:, t].astype(np.float32)}


# Rows (UE x period) per chunk of ``estimate_fleet``: one featurize launch
# and one estimator forward per chunk. The CNN inside the forward further
# caps its rows by bytes (``estimator.model.CNN_CHUNK_BYTES``).
EST_CHUNK_ROWS = 8192


def estimate_fleet(episode: EpisodeBatch, estimator, tp_clip=TP_CLIP_MBPS,
                   *, serving=None, quant: Optional[str] = None,
                   fused: bool = False, device="cuda") -> np.ndarray:
    """(N, T) estimated throughput in Mbps, clipped into ``tp_clip``.

    Period ``t`` sees each UE's (WINDOW, 15) KPM window ending just before
    ``t`` plus its (2, n_sc, 14) IQ spectrogram. As many whole periods as
    fit in ``EST_CHUNK_ROWS`` rows go through one forward; inside a chunk,
    row ``u * b + j`` is UE ``u`` at period ``t0 + j``. The forward is
    row-wise, so the chunking moves a number only as far as a product
    blocked for another row count rounds differently (last bits of f32).

    ``estimator``: an ``(EstimatorConfig, params)`` pair with ``params``
    on ``device``. ``fused=False`` builds the windows on the host
    (``EpisodeBatch.kpm_windows``) and ships them; ``fused=True`` ships the
    raw KPM trace once and the ``featurize`` kernel cuts each chunk's
    windows on the card. The two give bit-equal windows.

    ``quant="int8"`` quantizes the weights once a call
    (``quantize_estimator``) and serves every chunk through ``fwd_int8``:
    the ``lstm_scan_q``, ``quantize`` and ``qmm`` kernels."""
    ecfg, params = estimator
    if not isinstance(ecfg, EstimatorConfig):
        raise _not_ported(f"estimator config {type(ecfg).__name__} (the "
                          "recurrent SSM estimator)", "9")
    if serving is not None:
        raise _not_ported("serving (multi-GPU estimator serving)", "12")
    check_quant(quant)
    dev = resolve_device(device)
    if fused and episode.kpms is None:
        raise ValueError("fused featurize needs raw KPM reports: generate "
                         "the episode with include_kpms=True")
    if episode.iq is None:
        raise ValueError(
            "estimator inference needs IQ spectrograms: generate the episode "
            "with include_iq=True")
    n, t_steps = episode.n_ues, episode.n_steps
    alloc = torch.from_numpy(episode.alloc_ratio.astype(np.float32)).to(dev)
    qparams = quantize_estimator(params) if quant == "int8" else None
    if fused:
        kpms_d = torch.from_numpy(
            np.asarray(episode.kpms, np.float32)).to(dev)
    else:
        wins = episode.kpm_windows(normalize=True).astype(np.float32)
    est = np.empty((n, t_steps))
    periods = max(1, min(t_steps, EST_CHUNK_ROWS // max(n, 1)))
    for t0 in range(0, t_steps, periods):
        b = min(periods, t_steps - t0)
        sl = slice(t0, t0 + b)
        rows = n * b
        if fused:
            # window j of the chunk covers trace steps [t0+j, t0+j+WINDOW)
            kw = kpm_feature_windows(kpms_d[:, t0:t0 + b + WINDOW - 1],
                                     kpmmod.KPM_CENTER, kpmmod.KPM_SCALE,
                                     WINDOW)
            kpms_rows = kw.reshape(rows, WINDOW, kw.shape[-1])
        else:
            kpms_rows = np.ascontiguousarray(wins[:, sl]).reshape(
                rows, *wins.shape[2:])
        iq_rows = np.asarray(episode.iq[:, sl], np.float32).reshape(
            rows, *episode.iq.shape[2:])
        alloc_rows = alloc.repeat_interleave(b)
        if quant == "int8":
            out = fwd_int8(ecfg, qparams, kpms_rows, iq_rows, alloc_rows,
                           device=dev)
        else:
            out = fwd(ecfg, params, kpms_rows, iq_rows, alloc_rows,
                      device=dev)
        est[:, sl] = out.cpu().numpy().reshape(n, b)
    return np.clip(est, tp_clip[0], tp_clip[1])


def simulate_fleet(episode: EpisodeBatch, table, profile: SplitProfile,
                   cfg: ControllerConfig, *, warm_split=None, estimator=None,
                   serving=None, online=None,
                   fixed_split: Optional[int] = None,
                   ue: DeviceProfile = UE_VM_2CORE,
                   server: DeviceProfile = EDGE_A40X2,
                   sched=None, cell_idx=None, n_cells: int = 1,
                   churn=None, capacity: Optional[int] = None,
                   quant: Optional[str] = None, fused: bool = False,
                   telemetry=None, device="cuda") -> FleetResult:
    """Batched fleet simulation (the production path).

    Consumes an ``EpisodeBatch`` of N UEs over T report periods (0.1 s
    each) and returns a ``FleetResult`` of (N, T) arrays: int32 split
    decisions, throughputs in Mbps, E2E delay in seconds, dCor privacy
    leakage in [0, 1], and per-inference UE energy in joules.

    ``table``: one ``LookupTable`` shared by the fleet or a
    ``StackedLookupTable`` with one row per UE. ``warm_split`` defaults to
    ``fixed_split`` or the controller's fallback. ``estimator``: optional
    (EstimatorConfig, params); without it the controllers see the
    ground-truth throughput. ``fused`` selects the on-card featurize and
    ``quant="int8"`` the int8 serving forward (see ``estimate_fleet``).
    ``fixed_split`` also attaches the fixed-policy
    baseline metrics as ``result.fixed``. Everything runs on ``device``.
    """
    for arg, value, item in (("serving", serving, "12"),
                             ("online", online, "10"),
                             ("sched", sched, "6"),
                             ("cell_idx", cell_idx, "6"),
                             ("churn", churn, "8"),
                             ("capacity", capacity, "8"),
                             ("telemetry", telemetry, "11")):
        if value is not None:
            raise _not_ported(arg, item)
    if n_cells != 1:
        raise _not_ported("n_cells", "6")
    check_quant(quant)
    dev = resolve_device(device)
    tables = (table.tables if isinstance(table, StackedLookupTable)
              else np.broadcast_to(table.table,
                                   (episode.n_ues, len(table.table))))
    true_tp = np.asarray(episode.tp_mbps, float)
    est_tp = (estimate_fleet(episode, estimator, quant=quant, fused=fused,
                             device=dev)
              if estimator is not None else true_tp)
    if warm_split is None:
        warm_split = cfg.fallback_split if fixed_split is None else fixed_split
    splits = run_controllers(tables, est_tp, cfg, warm_split, device=dev)
    delay, priv, energy = split_metrics(profile, splits, true_tp, ue, server,
                                        device=dev)
    fixed = None
    if fixed_split is not None:
        fsplits = np.full_like(splits, fixed_split)
        fd, fp, fe = split_metrics(profile, fsplits, true_tp, ue, server,
                                   device=dev)
        fixed = FleetResult(fsplits, true_tp, est_tp, fd, fp, fe)
    return FleetResult(splits, true_tp, est_tp, delay, priv, energy, fixed)


def simulate_fleet_looped(episode: EpisodeBatch, table,
                          profile: SplitProfile, cfg: ControllerConfig, *,
                          warm_split=None, est_tp: Optional[np.ndarray] = None,
                          fixed_split: Optional[int] = None,
                          ue: DeviceProfile = UE_VM_2CORE,
                          server: DeviceProfile = EDGE_A40X2,
                          device="cuda") -> FleetResult:
    """The per-UE, per-report-period loop: one ``AdaptiveSplitController``
    per UE (its state on ``device``), one objective ``evaluate`` per UE
    per period. Kept as the equivalence reference for ``simulate_fleet``."""
    dev = resolve_device(device)
    n, t_steps = episode.n_ues, episode.n_steps
    true_tp = np.asarray(episode.tp_mbps, float)
    if est_tp is None:
        est_tp = true_tp
    if warm_split is None:
        warm_split = cfg.fallback_split if fixed_split is None else fixed_split
    warm = np.broadcast_to(np.asarray(warm_split), (n,))
    splits = np.empty((n, t_steps), np.int32)
    acc = np.empty((n, t_steps, 3))
    facc = np.empty((n, t_steps, 3)) if fixed_split is not None else None
    for u in range(n):
        row = table.row(u) if isinstance(table, StackedLookupTable) else table
        ctl = AdaptiveSplitController(row, cfg, device=dev)
        ctl.reset(warm_split=int(warm[u]))
        for t in range(t_steps):
            l = ctl.update(float(est_tp[u, t]))
            splits[u, t] = l
            terms = evaluate(profile, ue, server,
                             np.array([true_tp[u, t] * 1e6]),
                             Weights(1, 0, 0), Constraints())
            acc[u, t] = (terms.d_e2e[l, 0], profile.privacy[l], terms.e_ue[l])
            if facc is not None:
                facc[u, t] = (terms.d_e2e[fixed_split, 0],
                              profile.privacy[fixed_split],
                              terms.e_ue[fixed_split])
    fixed = None
    if facc is not None:
        fixed = FleetResult(np.full_like(splits, fixed_split), true_tp,
                            est_tp, facc[..., 0], facc[..., 1], facc[..., 2])
    return FleetResult(splits, true_tp, est_tp, acc[..., 0], acc[..., 1],
                       acc[..., 2], fixed)
