"""Slot-pool fleet engine: continuous UE arrival and departure at fixed
shapes.

The batch engine (``sim.engine``) marches one fixed N-UE cohort through T
report periods in lockstep. Real traffic churns: UEs attach, live for a
while and detach. This module keeps the shapes fixed and lets the
population move: a device-resident pool of ``capacity`` UE slots, an
active mask and a free-list stack of slot indices go through one step a
period, a host loop of torch ops on the device (the reference's
``lax.scan``):

  admit    pop free slots for the FIFO's ready arrivals through
           ``max_admits`` lanes (excess arrivals queue and show up as
           admission latency) and reset the admitted slots' controller
           and scheduler state;
  serve    gather each active slot's session trace at its age, run the
           gNB scheduler masked to the active slots
           (``scheduler_step(active=...)``: empty slots get no PRBs and
           shape no cell's normalizer) and the split controllers over
           all slots;
  retire   push the slots whose sessions reached their dwell back onto
           the free stack (packed by a cumsum) and clear their mask.

The reference's scatters drop their unused lanes (``mode="drop"``): here
the admitted slots become a mask (one scatter into a row of S + 1, whose
last element takes the unused lanes and is sliced off) that selects the
reset values, and the free stack keeps one more element, index S, where
retire's non-departures write.

Sessions come from ``channel.scenarios.make_churn_schedule`` (the
arrival/dwell realisation) plus an ``EpisodeBatch`` with one row per
session (its channel life). ``simulate_fleet(churn=..., capacity=...)``
is the public entry. Online adaptation (``online=``, ROADMAP.md module
queue item 10) and the telemetry plane (``telemetry=``, item 11) through
the pool are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.channel import throughput as tpmod
from repro_torch.channel.scenarios import ChurnSchedule, EpisodeBatch
from repro_torch.core.controller import (PENDING_NONE, ControllerConfig,
                                         ControllerState, controller_init,
                                         controller_step)
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE, DeviceProfile
from repro_torch.core.profiles import SplitProfile
from repro_torch.core.pso import NO_SPLIT, StackedLookupTable
from repro_torch.sim.engine import (FleetResult, _not_ported, estimate_fleet,
                                    split_metrics)
from repro_torch.sim.sched import (SchedulerConfig, SchedulerState,
                                   scheduler_init, scheduler_step)

F32 = torch.float32
I32 = torch.int32


class PoolState(NamedTuple):
    """The device-resident slot pool carried across report periods.

    ``free[:n_free]`` is a stack of the empty slots' indices; every slot
    is either active or on the stack, never both. ``free`` has S + 1
    elements: index S takes retire's writes for the slots that stay.
    ``next_arrival`` is the pool's cursor into the admission FIFO."""

    active: torch.Tensor  # (S,) bool, the slot holds a live session
    sid: torch.Tensor  # (S,) i32, the session occupying the slot
    age: torch.Tensor  # (S,) i32, periods served so far (0 on admission)
    free: torch.Tensor  # (S + 1,) i32, stack of free slot indices
    n_free: torch.Tensor  # i32 scalar, the stack's depth
    next_arrival: torch.Tensor  # i32 scalar, the FIFO cursor
    ctl: ControllerState  # (S,)-batched controller states
    sched: SchedulerState  # (S,)-batched scheduler state


def pool_init(capacity: int, warm_split=NO_SPLIT, avg0: float = 1.0, *,
              device="cuda") -> PoolState:
    """An empty pool: every slot on the free stack, ordered so slot 0 is
    admitted first."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive: {capacity}")
    dev = resolve_device(device)
    s = int(capacity)
    z = torch.zeros((s,), dtype=I32, device=dev)
    return PoolState(
        active=torch.zeros((s,), dtype=torch.bool, device=dev),
        sid=z, age=z.clone(),
        free=torch.cat([torch.arange(s - 1, -1, -1, dtype=I32, device=dev),
                        torch.zeros((1,), dtype=I32, device=dev)]),
        n_free=torch.tensor(s, dtype=I32, device=dev),
        next_arrival=torch.zeros((), dtype=I32, device=dev),
        ctl=controller_init(warm_split, batch_shape=(s,), device=dev),
        sched=scheduler_init(s, avg0, device=dev))


def _clip_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` clamped into [0, n) as a gather index (the reference's
    ``jnp.clip`` before a take)."""
    return torch.clamp(idx, 0, n - 1).long()


class PoolPrograms(NamedTuple):
    """The per-period steps of one (controller, scheduler, lanes)
    configuration. ``sweep`` runs the whole horizon, a period as
    ``admit``, then the estimates' gather, then ``serve_retire``."""

    sweep: object
    admit: object
    serve_retire: object


def pool_programs(ewma_alpha: float, hysteresis_steps: int,
                  fallback_split: int,
                  sched: Optional[SchedulerConfig] = None, n_cells: int = 1,
                  max_admits: int = 1, telem=None) -> PoolPrograms:
    """The pool's steps for one configuration, as the reference's
    ``pool_programs``. ``telem`` (the telemetry variant of ``sweep``) is
    not ported yet."""
    if telem is not None:
        raise _not_ported("telemetry (through the slot pool)", "11")
    cfg = ControllerConfig(ewma_alpha, hysteresis_steps, fallback_split)
    a_lanes = int(max_admits)

    def admit(st: PoolState, t: int, ready_end_t: int, arrival_t, warm):
        s = st.active.shape[0]
        m = arrival_t.shape[0]
        dev = st.active.device
        lane = torch.arange(a_lanes, dtype=I32, device=dev)
        k = torch.clamp_max(torch.minimum(ready_end_t - st.next_arrival,
                                          st.n_free), a_lanes)
        valid = lane < k
        sid_new = st.next_arrival + lane
        slot = st.free[_clip_index(st.n_free - 1 - lane, s)]
        tgt = torch.where(valid, slot, s).long()  # s: the unused lanes
        fresh = torch.zeros((s + 1,), dtype=torch.bool, device=dev) \
            .index_put_((tgt,), valid)[:s]
        sid_at = torch.zeros((s + 1,), dtype=I32, device=dev) \
            .index_put_((tgt,), sid_new)[:s]
        warm_i = torch.as_tensor(warm, dtype=I32, device=dev)
        c = st.ctl
        ctl = ControllerState(
            tp_ewma=torch.where(fresh, 0.0, c.tp_ewma),
            has_ewma=c.has_ewma & ~fresh,
            current_split=torch.where(fresh, warm_i, c.current_split),
            pending_split=torch.where(fresh, PENDING_NONE, c.pending_split),
            pending_count=torch.where(fresh, 0, c.pending_count),
            step=torch.where(fresh, 0, c.step))
        ssched = st.sched._replace(
            avg_tp=torch.where(fresh, 1.0, st.sched.avg_tp))
        lat = torch.where(valid, t - arrival_t[_clip_index(sid_new, m)],
                          -1).to(I32)
        new = st._replace(
            active=st.active | fresh,
            sid=torch.where(fresh, sid_at, st.sid),
            age=torch.where(fresh, 0, st.age),
            n_free=st.n_free - k,
            next_arrival=st.next_arrival + k,
            ctl=ctl, sched=ssched)
        return new, lat

    def serve(st: PoolState, tables, est_t, true_t, cell_t):
        s = st.active.shape[0]
        act = st.active
        if tables.shape[0] == 1:  # one shared lookup row
            tab_t = tables[0].expand(s, tables.shape[1])
        else:
            tab_t = tables[_clip_index(st.sid, tables.shape[0])]
        if sched is None:
            share = act.to(F32)  # informational; the engine discards it
            eff_est = est_t
            new_ss = st.sched
        else:
            new_ss, share = scheduler_step(sched, n_cells, st.sched,
                                           cell_t, true_t, active=act)
            eff_est = est_t * share
        ctl, split = controller_step(tab_t, st.ctl, eff_est, cfg=cfg)
        split = torch.where(act, split, NO_SPLIT)
        return st._replace(ctl=ctl, sched=new_ss), split, share

    def retire(st: PoolState, dwell):
        s = st.active.shape[0]
        dep = st.active & (st.age + 1 >= dwell[_clip_index(st.sid,
                                                            dwell.shape[0])])
        n_dep = dep.sum(dtype=I32)
        pos = torch.cumsum(dep.to(I32), 0, dtype=I32) - 1  # pack onto stack
        tgt = torch.where(dep, st.n_free + pos, s).long()
        active = st.active & ~dep
        free = st.free.index_put(
            (tgt,), torch.arange(s, dtype=I32, device=st.free.device))
        return st._replace(
            active=active,
            age=torch.where(active, st.age + 1, st.age),
            free=free, n_free=st.n_free + n_dep), n_dep

    def gather_tp(st: PoolState, arr):
        m, el = arr.shape
        val = arr[_clip_index(st.sid, m), _clip_index(st.age, el)]
        return torch.where(st.active, val.to(F32), 0.0)

    def serve_retire(st, tables, est_t, true, cell, dwell):
        act, sid, age = st.active, st.sid, st.age
        true_t = gather_tp(st, true)
        cell_t = cell[_clip_index(sid, cell.shape[0])]
        st, split, share = serve(st, tables, est_t, true_t, cell_t)
        st, n_dep = retire(st, dwell)
        return st, (act, sid, age, split, share, n_dep)

    def sweep(st0, tables, warm, est, true, cell, dwell, arrival_t,
              ready_end):
        """The whole horizon, one period after the other on the pool's
        device: (final state, per-period (T, ...) tensors of the active
        mask, session ids, ages, splits, shares, lane latencies and
        departures)."""
        t_steps = len(ready_end)
        s = st0.active.shape[0]
        dev = st0.active.device
        act_ts = torch.empty((t_steps, s), dtype=torch.bool, device=dev)
        sid_ts = torch.empty((t_steps, s), dtype=I32, device=dev)
        age_ts = torch.empty_like(sid_ts)
        split_ts = torch.empty_like(sid_ts)
        share_ts = torch.empty((t_steps, s), dtype=F32, device=dev)
        lat_ts = torch.empty((t_steps, a_lanes), dtype=I32, device=dev)
        dep_ts = torch.empty((t_steps,), dtype=I32, device=dev)
        st = st0
        for t in range(t_steps):
            st, lat_ts[t] = admit(st, t, int(ready_end[t]), arrival_t, warm)
            st, (act_ts[t], sid_ts[t], age_ts[t], split_ts[t], share_ts[t],
                 dep_ts[t]) = serve_retire(st, tables, gather_tp(st, est),
                                           true, cell, dwell)
        return st, (act_ts, sid_ts, age_ts, split_ts, share_ts, lat_ts,
                    dep_ts)

    return PoolPrograms(sweep=sweep, admit=admit, serve_retire=serve_retire)


@dataclasses.dataclass
class LifecycleStats:
    """Per-slot lifecycle accounting of one churned run
    (``FleetResult.lifecycle``)."""

    capacity: int  # pool slots S
    n_sessions: int  # sessions in the admission FIFO
    n_admitted: int  # sessions admitted within the horizon
    occupancy: np.ndarray  # (T,) active slots per period
    admitted: np.ndarray  # (T,) admissions per period
    departed: np.ndarray  # (T,) departures per period
    admit_latency: np.ndarray  # (n_admitted,) periods queued, in
    # admission order; 0 means admitted the period it arrived

    @property
    def ue_steps(self) -> int:
        """Slot-periods actually served (the churn throughput's
        numerator)."""
        return int(self.occupancy.sum())

    def p99_admit_latency(self) -> float:
        """99th-percentile admission queue time in periods."""
        if self.admit_latency.size == 0:
            return 0.0
        return float(np.percentile(self.admit_latency, 99))


def _pool_validate(sessions: EpisodeBatch, schedule: ChurnSchedule,
                   capacity: int, cell, sched) -> None:
    if capacity <= 0:
        raise ValueError(f"capacity must be positive: {capacity}")
    m = schedule.n_sessions
    if m == 0:
        raise ValueError("churn schedule has no sessions; raise the "
                         "arrival rate or the horizon")
    if sessions.n_ues != m:
        raise ValueError(
            f"episode has {sessions.n_ues} session rows but the schedule "
            f"has {m}; generate one episode row per scheduled session")
    if int(schedule.dwell.min(initial=1)) < 1:
        raise ValueError("session dwell times must be >= 1 period")
    if schedule.max_dwell > sessions.n_steps:
        raise ValueError(
            f"longest dwell ({schedule.max_dwell} periods) exceeds the "
            f"session trace length ({sessions.n_steps}); generate episodes "
            "with T >= ChurnConfig.max_dwell")
    if sched is not None:
        if cell is None:
            raise ValueError("a scheduler needs an (M,) per-session cell")
        if np.shape(cell) != (m,):
            raise ValueError(f"cell must be (M,) = ({m},): {np.shape(cell)}")


def _pool_tables(table, n_sessions: int) -> np.ndarray:
    if isinstance(table, StackedLookupTable):
        tables = np.asarray(table.tables)
        if tables.shape[0] != n_sessions:
            raise ValueError(
                f"stacked table has {tables.shape[0]} rows for "
                f"{n_sessions} sessions")
        return tables
    return np.asarray(table.table)[None]  # shared row, expanded on device


def simulate_pool(sessions: EpisodeBatch, schedule: ChurnSchedule, table,
                  profile: SplitProfile, cfg: ControllerConfig, *,
                  capacity: int, warm_split=None, estimator=None,
                  serving=None, online=None,
                  fixed_split: Optional[int] = None,
                  ue: DeviceProfile = UE_VM_2CORE,
                  server: DeviceProfile = EDGE_A40X2,
                  sched: Optional[SchedulerConfig] = None,
                  cell: Optional[np.ndarray] = None, n_cells: int = 1,
                  quant: Optional[str] = None, fused: bool = False,
                  telemetry=None, device="cuda") -> FleetResult:
    """Run a churning UE population through the slot pool on ``device``.

    ``sessions``: an ``EpisodeBatch`` with one row per scheduled session;
    row ``i`` is session ``i``'s channel life, read from trace step 0 at
    admission whenever the session is admitted. ``schedule``: the
    realised arrival/dwell process (``make_churn_schedule``). ``table``
    may be shared or a ``StackedLookupTable`` with one row per session.

    The result is a ``FleetResult`` whose rows are the pool's ``capacity``
    slots over ``schedule.horizon`` periods: ``result.active`` marks
    occupancy (metrics are NaN and splits ``NO_SPLIT`` on empty cells),
    ``result.lifecycle`` carries the admission and departure accounting.
    ``sched``/``estimator``/``fixed_split``/``quant``/``fused`` compose
    as in ``simulate_fleet`` (the estimates come from one
    ``estimate_fleet`` over the sessions); ``cell`` is a static (M,)
    per-session attach. ``serving``, ``online`` and ``telemetry`` are not
    ported yet."""
    for arg, value, item in (("serving", serving, "12"),
                             ("online", online, "10"),
                             ("telemetry", telemetry, "11")):
        if value is not None:
            raise _not_ported(arg, item)
    _pool_validate(sessions, schedule, capacity, cell, sched)
    dev = resolve_device(device)
    m = schedule.n_sessions
    true_np = np.asarray(sessions.tp_mbps, float)  # (M, L)
    if warm_split is None:
        warm_split = cfg.fallback_split if fixed_split is None else fixed_split
    programs = pool_programs(cfg.ewma_alpha, cfg.hysteresis_steps,
                             cfg.fallback_split, sched, int(n_cells),
                             int(schedule.max_admits))
    st0 = pool_init(capacity, warm_split, device=dev)

    def on_dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    est_np = (estimate_fleet(sessions, estimator, quant=quant, fused=fused,
                             device=dev)
              if estimator is not None else true_np)
    _, ys = programs.sweep(
        st0, on_dev(_pool_tables(table, m), np.int32),
        torch.tensor(int(warm_split), dtype=I32, device=dev),
        on_dev(est_np, np.float32), on_dev(true_np, np.float32),
        on_dev(cell if cell is not None else np.zeros(m), np.int32),
        on_dev(schedule.dwell, np.int32), on_dev(schedule.arrival_t,
                                                 np.int32),
        np.asarray(schedule.ready_end))
    act_ts, sid_ts, age_ts, split_ts, share_ts, lat_ts, dep_ts = (
        y.cpu().numpy() for y in ys)

    act = act_ts.T  # (S, T)
    sid = np.clip(sid_ts.T, 0, m - 1)
    age = np.clip(age_ts.T, 0, sessions.n_steps - 1)
    splits = split_ts.T.astype(np.int32)
    true_tp = np.where(act, true_np[sid, age], 0.0)
    est_tp = np.where(act, np.asarray(est_np, float)[sid, age], 0.0)
    shares = None
    if sched is not None:
        shares = np.where(act, share_ts.T, 0.0)
        eff_tp = tpmod.prb_scaled_mbps(true_tp, shares)
        est_tp = est_tp * shares  # what the controllers consumed
    else:
        eff_tp = true_tp

    def _metrics(l):
        d, p, e = split_metrics(profile, np.where(act, l, 0), eff_tp,
                                ue, server, device=dev)
        nan = np.nan
        return (np.where(act, d, nan), np.where(act, p, nan),
                np.where(act, e, nan))

    delay, priv, energy = _metrics(splits)
    fixed = None
    if fixed_split is not None:
        fsplits = np.where(act, fixed_split, NO_SPLIT).astype(np.int32)
        fd, fp, fe = _metrics(fsplits)
        fixed = FleetResult(fsplits, true_tp, est_tp, fd, fp, fe,
                            prb_share=shares, active=act)
    lat_valid = lat_ts >= 0
    stats = LifecycleStats(
        capacity=int(capacity), n_sessions=m,
        n_admitted=int(lat_valid.sum()),
        occupancy=act_ts.sum(axis=1).astype(np.int64),
        admitted=lat_valid.sum(axis=1).astype(np.int64),
        departed=dep_ts.astype(np.int64),
        admit_latency=lat_ts[lat_valid].astype(np.int64))
    return FleetResult(splits, true_tp, est_tp, delay, priv, energy, fixed,
                       prb_share=shares, active=act, lifecycle=stats)
