"""Port parity for the slot-pool churn engine (``repro_torch.sim.pool``)
and the churn schedule generator, against ``repro.sim.pool`` on the same
schedules and sessions.

Held: the schedules array for array; splits, the active mask and every
``LifecycleStats`` field equal; metrics within rtol 1e-5 (the pf
scheduler's masked shares round in another order on XLA, as the
reference's own full-pool test allows); with an estimator (the
reference's weights carried over) the estimates within 1e-4 of their
scale and the splits equal. The full-pool degenerate schedule equals the
port's batch engine: splits bit for bit, metrics equal."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.channel import scenarios as rsc
from repro.core.controller import ControllerConfig as RefCtlConfig
from repro.core.energy import EDGE_A40X2 as REF_EDGE
from repro.core.energy import UE_VM_2CORE as REF_UE
from repro.core.objective import Constraints as RefCons
from repro.core.objective import Weights as RefWeights
from repro.core.pso import StackedLookupTable as RefStacked
from repro.core.pso import pso_vectorized as ref_pso
from repro.estimator.model import EstimatorConfig as RefEConfig
from repro.estimator.model import init_estimator as ref_init
from repro.models.vgg import FULL as REF_FULL
from repro.models.vgg import vgg_split_profile as ref_profile
from repro.sim import SchedulerConfig as RefSched
from repro.sim import simulate_fleet as ref_simulate_fleet
from repro_torch.channel import scenarios as sc
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE
from repro_torch.core.objective import Constraints, Weights
from repro_torch.core.pso import NO_SPLIT, StackedLookupTable, pso_vectorized
from repro_torch.estimator.model import EstimatorConfig
from repro_torch.models.vgg import FULL, vgg_split_profile
from repro_torch.sim import (SchedulerConfig, pool_init, pool_programs,
                             simulate_fleet, simulate_pool)
from repro_torch.weights import params_from_reference

METRICS = ("true_tp", "est_tp", "delay_s", "privacy", "energy_j")
LIFECYCLE = ("occupancy", "admitted", "departed", "admit_latency")
SMALL = dict(n_sc=16, lstm_hidden=8, hidden=8)


@pytest.fixture(scope="module")
def both():
    """(port (profile, table, cfg), reference's)."""
    def make(vsp, full, pso, ue, edge, w, cons, ccfg):
        prof = vsp(full)
        table = pso(prof, ue, edge, w(1.0, 0.15, 0.1),
                    cons(rho_max=0.92, tau_max_s=6.0, e_max_j=40.0), 130)
        return prof, table, ccfg(ewma_alpha=0.6, hysteresis_steps=2,
                                 fallback_split=int(table.query(130.0)))

    return (make(vgg_split_profile, FULL, pso_vectorized, UE_VM_2CORE,
                 EDGE_A40X2, Weights, Constraints, ControllerConfig),
            make(ref_profile, REF_FULL, ref_pso, REF_UE, REF_EDGE,
                 RefWeights, RefCons, RefCtlConfig))


def _schedules(seed, T=25, **kw):
    """The same churn realisation and session traces from both packages'
    generators: (port's, reference's), each (schedule, sessions)."""
    kw = dict(dict(arrival_rate=3.0, mean_dwell=4.0, max_dwell=8), **kw)
    out = []
    for mod in (sc, rsc):
        rng = np.random.default_rng(seed)
        schedule = mod.make_churn_schedule(mod.ChurnConfig(**kw), T, rng)
        scen = np.asarray(mod.SCENARIOS)[
            np.arange(schedule.n_sessions) % len(mod.SCENARIOS)]
        sessions = mod.gen_episode_batch(scen, schedule.max_dwell, rng,
                                         n_sc=16, include_iq=False,
                                         include_kpms=False)
        out.append((schedule, sessions))
    return out


def _assert_same_run(got, want, rtol=1e-5):
    np.testing.assert_array_equal(got.splits, want.splits)
    np.testing.assert_array_equal(got.active, want.active)
    if want.lifecycle is None:  # a fixed-split baseline
        assert got.lifecycle is None
    else:
        for f in LIFECYCLE:
            np.testing.assert_array_equal(getattr(got.lifecycle, f),
                                          getattr(want.lifecycle, f))
        for f in ("capacity", "n_sessions", "n_admitted"):
            assert getattr(got.lifecycle, f) == getattr(want.lifecycle, f)
    for f in METRICS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=rtol, equal_nan=True)


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("kw", [
    dict(arrival_rate=8.0, mean_dwell=20.0),
    dict(arrival_rate=3.0, mean_dwell=4.0, max_dwell=8, diurnal_amplitude=0.5),
    dict(arrival_rate=1024.0, mean_dwell=3.4, diurnal_amplitude=0.25,
         diurnal_period=40),
    dict(arrival_rate=2.0, mean_dwell=1.0, max_admits=3),
    dict(arrival_rate=0.0)],
    ids=["default", "diurnal", "sweep_cell", "dwell1", "empty"])
def test_churn_schedule_array_equal(kw):
    for seed in (0, 1):
        ccfg, rcfg = sc.ChurnConfig(**kw), rsc.ChurnConfig(**kw)
        np.testing.assert_array_equal(sc.diurnal_arrival_rate(ccfg, 40),
                                      rsc.diurnal_arrival_rate(rcfg, 40))
        got = sc.make_churn_schedule(ccfg, 40, np.random.default_rng(seed))
        want = rsc.make_churn_schedule(rcfg, 40, np.random.default_rng(seed))
        for f in ("arrival_t", "dwell", "ready_end"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (got.horizon, got.max_admits, got.n_sessions,
                got.max_dwell) == (want.horizon, want.max_admits,
                                   want.n_sessions, want.max_dwell)


@pytest.mark.parametrize("kw,match", [
    (dict(arrival_rate=-1.0), "arrival_rate"),
    (dict(diurnal_amplitude=2.0), "diurnal_amplitude"),
    (dict(mean_dwell=0.5), "mean_dwell")])
def test_churn_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        sc.ChurnConfig(**kw)


# ----------------------------------------------------- against the reference
@pytest.mark.parametrize("policy", [None, "rr", "pf", "maxsinr"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_matches_reference(both, policy, seed):
    (prof, table, cfg), (rprof, rtable, rcfg) = both
    (schedule, sessions), (rschedule, rsessions) = _schedules(
        seed, diurnal_amplitude=0.5)
    kw, rkw = {}, {}
    if policy is not None:
        cell = np.arange(schedule.n_sessions) % 3
        kw = dict(sched=SchedulerConfig(policy, pf_beta=0.3, fused=True),
                  cell_idx=cell, n_cells=3)
        rkw = dict(sched=RefSched(policy, pf_beta=0.3), cell_idx=cell,
                   n_cells=3)
    got = simulate_fleet(sessions, table, prof, cfg, churn=schedule,
                         capacity=7, fixed_split=3, device="cpu", **kw)
    want = ref_simulate_fleet(rsessions, rtable, rprof, rcfg,
                              churn=rschedule, capacity=7, fixed_split=3,
                              **rkw)
    _assert_same_run(got, want)
    _assert_same_run(got.fixed, want.fixed)
    assert got.lifecycle.ue_steps == want.lifecycle.ue_steps
    assert got.lifecycle.p99_admit_latency() == \
        want.lifecycle.p99_admit_latency()
    if policy is None:
        assert got.prb_share is None
    else:
        np.testing.assert_allclose(got.prb_share, want.prb_share, rtol=1e-5,
                                   atol=1e-7)


def test_pool_with_stacked_tables_matches_reference(both):
    (prof, table, cfg), (rprof, rtable, rcfg) = both
    (schedule, sessions), (rschedule, rsessions) = _schedules(2)
    m = schedule.n_sessions
    rows = np.stack([np.roll(table.table, i)
                     for i in range(m)]).astype(np.int32)
    meta = (np.tile(table.tp_min_mbps, (m, 1)),
            np.tile(table.feasible_prefilter, (m, 1)))
    got = simulate_pool(sessions, schedule,
                        StackedLookupTable(["s"] * m, rows, *meta), prof,
                        cfg, capacity=5, device="cpu")
    want = ref_simulate_fleet(rsessions, RefStacked(["s"] * m, rows, *meta),
                              rprof, rcfg, churn=rschedule, capacity=5)
    _assert_same_run(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_pool_with_estimator_matches_reference(both, fused):
    """The windowed estimator over the sessions (carried weights; the
    untrained head rescaled so estimates spread over the table)."""
    (prof, table, cfg), (rprof, rtable, rcfg) = both
    e_ref, e = RefEConfig(**SMALL), EstimatorConfig(**SMALL)
    tree = jax.tree.map(np.asarray, ref_init(e_ref, jax.random.PRNGKey(0)))
    tree["head"]["w2"] = tree["head"]["w2"] * 40.0
    tree["head"]["b2"] = tree["head"]["b2"] + 60.0
    runs = []
    for mod in (sc, rsc):
        rng = np.random.default_rng(3)
        schedule = mod.make_churn_schedule(
            mod.ChurnConfig(arrival_rate=2.0, mean_dwell=3.0, max_dwell=6),
            12, rng)
        scen = np.asarray(mod.SCENARIOS)[
            np.arange(schedule.n_sessions) % 4]
        runs.append((schedule, mod.gen_episode_batch(
            scen, schedule.max_dwell, rng, n_sc=16)))
    (schedule, sessions), (rschedule, rsessions) = runs
    got = simulate_fleet(sessions, table, prof, cfg, churn=schedule,
                         capacity=4, fused=fused, device="cpu",
                         estimator=(e, params_from_reference(tree,
                                                             device="cpu")))
    want = ref_simulate_fleet(rsessions, rtable, rprof, rcfg,
                              churn=rschedule, capacity=4, fused=fused,
                              estimator=(e_ref, tree))
    act = want.active
    np.testing.assert_allclose(got.est_tp[act], want.est_tp[act], rtol=0,
                               atol=1e-4 * np.abs(want.est_tp).max())
    np.testing.assert_array_equal(got.splits, want.splits)
    np.testing.assert_array_equal(got.active, want.active)
    for f in LIFECYCLE:
        np.testing.assert_array_equal(getattr(got.lifecycle, f),
                                      getattr(want.lifecycle, f))


# ------------------------------------------------ against the batch engine
def _full_pool_schedule(n, T):
    """Every session arrives at t = 0 and stays for the whole horizon."""
    return sc.ChurnSchedule(arrival_t=np.zeros(n, np.int32),
                            dwell=np.full(n, T, np.int32),
                            ready_end=np.full(T, n, np.int32),
                            horizon=T, max_admits=n)


@pytest.mark.parametrize("policy", [None, "rr", "pf", "maxsinr"])
def test_full_pool_matches_batch_engine(both, policy):
    """The degenerate schedule through the pool is the batch engine:
    splits bit for bit, metrics equal (rtol 1e-6 for pf's masked
    shares), the pool full every period."""
    prof, table, cfg = both[0]
    rng = np.random.default_rng(4)
    n, T, n_cells = 8, 15, 3
    scen = np.asarray(sc.SCENARIOS)[np.arange(n) % 4]
    ep = sc.gen_episode_batch(scen, T, rng, n_sc=16, include_iq=False)
    schedule = _full_pool_schedule(n, T)
    if policy is None:
        base = simulate_fleet(ep, table, prof, cfg, fixed_split=3,
                              device="cpu")
        pool = simulate_fleet(ep, table, prof, cfg, fixed_split=3,
                              churn=schedule, capacity=n, device="cpu")
    else:
        cell = np.arange(n) % n_cells
        grid = np.repeat(cell[:, None], T, axis=1)
        scfg = SchedulerConfig(policy, pf_beta=0.3)
        base = simulate_fleet(ep, table, prof, cfg, sched=scfg,
                              cell_idx=grid, n_cells=n_cells, device="cpu")
        pool = simulate_fleet(ep, table, prof, cfg, sched=scfg,
                              cell_idx=cell, n_cells=n_cells,
                              churn=schedule, capacity=n, device="cpu")
    assert pool.active.all() and base.active is None
    np.testing.assert_array_equal(base.splits, pool.splits)
    for f in METRICS:
        np.testing.assert_allclose(getattr(pool, f), getattr(base, f),
                                   rtol=1e-6)
    lc = pool.lifecycle
    assert lc.n_admitted == n and (lc.admit_latency == 0).all()
    assert (lc.occupancy == n).all() and lc.departed.sum() == n


# --------------------------------------------------- the pool's own steps
def _drive(seed, capacity, T=25):
    """The pool a period at a time through ``admit`` and ``serve_retire``,
    the slot invariants checked after every step; returns the splits and
    masks for comparison with the sweep."""
    (schedule, sessions), _ = _schedules(seed, T=T)
    m = schedule.n_sessions
    programs = pool_programs(0.6, 2, 3, None, 1, schedule.max_admits)
    true = torch.from_numpy(np.asarray(sessions.tp_mbps, np.float32))
    tables = torch.full((1, 131), NO_SPLIT, dtype=torch.int32)
    tables[0, 10:] = 3
    arrival = torch.from_numpy(schedule.arrival_t)
    dwell = torch.from_numpy(schedule.dwell)
    st = pool_init(capacity, warm_split=3, device="cpu")
    splits, actives = [], []
    for t in range(T):
        st, lat = programs.admit(st, t, int(schedule.ready_end[t]), arrival,
                                 3)
        act = st.active.numpy()
        free = st.free[:int(st.n_free)].numpy()
        assert len(free) + act.sum() == capacity
        assert len(set(free.tolist())) == len(free)
        assert not act[free].any()
        valid = lat.numpy() >= 0
        assert (lat.numpy()[valid] <= t).all()
        sid = st.sid.clamp(0, m - 1).long()
        age = st.age.clamp(0, true.shape[1] - 1).long()
        est = torch.where(st.active, true[sid, age], 0.0)
        st, ys = programs.serve_retire(st, tables, est, true,
                                       torch.zeros(m, dtype=torch.int32),
                                       dwell)
        actives.append(ys[0].numpy())
        splits.append(ys[3].numpy())
        assert int(st.n_free) + int(st.active.sum()) == capacity
    return schedule, sessions, np.stack(splits).T, np.stack(actives).T


@pytest.mark.parametrize("seed,capacity", [(0, 4), (1, 9), (2, 16)])
def test_pool_steps_keep_the_invariants(seed, capacity):
    _drive(seed, capacity)


def test_pool_sweep_matches_stepwise(both):
    """``simulate_pool``'s (UE, T) splits and mask are the period steps'
    outputs, slot by slot, as a host loop of ``admit`` and
    ``serve_retire`` yields them."""
    prof, _, _ = both[0]
    schedule, sessions, splits, actives = _drive(5, 6)
    table = pso_vectorized(prof, UE_VM_2CORE, EDGE_A40X2,
                           Weights(1.0, 0.15, 0.1), Constraints(), 130)
    row = np.full(131, NO_SPLIT, np.int32)
    row[10:] = 3
    table = dataclasses.replace(table, table=row)
    res = simulate_pool(sessions, schedule, table, prof,
                        ControllerConfig(0.6, 2, 3), capacity=6,
                        warm_split=3, device="cpu")
    np.testing.assert_array_equal(res.splits, splits)
    np.testing.assert_array_equal(res.active, actives)


def test_pool_lifecycle_accounting(both):
    """Admissions less departures is the occupancy; empty cells carry NaN
    metrics and NO_SPLIT; a saturated pool queues."""
    prof, table, cfg = both[0]
    (schedule, sessions), _ = _schedules(6, T=30, arrival_rate=4.0,
                                         mean_dwell=6.0, max_dwell=10)
    res = simulate_pool(sessions, schedule, table, prof, cfg, capacity=6,
                        fixed_split=3, device="cpu")
    lc = res.lifecycle
    assert (lc.occupancy <= 6).all() and lc.n_admitted <= lc.n_sessions
    assert lc.ue_steps == res.active.sum() == lc.occupancy.sum()
    np.testing.assert_array_equal(
        lc.occupancy, np.cumsum(lc.admitted) - np.concatenate(
            [[0], np.cumsum(lc.departed)[:-1]]))
    empty = ~res.active
    assert (res.splits[empty] == NO_SPLIT).all()
    assert np.isnan(res.delay_s[empty]).all()
    assert lc.p99_admit_latency() > 0


# ---------------------------------------------------------- what raises
def test_pool_validation_raises(both):
    prof, table, cfg = both[0]
    (schedule, sessions), _ = _schedules(8, T=10, arrival_rate=2.0,
                                         mean_dwell=3.0, max_dwell=5)
    with pytest.raises(TypeError, match="capacity"):
        simulate_fleet(sessions, table, prof, cfg, churn=schedule,
                       device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        simulate_pool(sessions, schedule, table, prof, cfg, capacity=0,
                      device="cpu")
    rng = np.random.default_rng(8)
    bad = sc.gen_episode_batch(["none"] * (schedule.n_sessions + 1),
                               schedule.max_dwell, rng, include_iq=False,
                               include_kpms=False)
    with pytest.raises(ValueError, match="session rows"):
        simulate_pool(bad, schedule, table, prof, cfg, capacity=4,
                      device="cpu")
    with pytest.raises(ValueError, match="cell"):
        simulate_pool(sessions, schedule, table, prof, cfg, capacity=4,
                      sched=SchedulerConfig("rr"), device="cpu")
    with pytest.raises(ValueError, match="cell must be"):
        simulate_pool(sessions, schedule, table, prof, cfg, capacity=4,
                      sched=SchedulerConfig("rr"), cell=np.zeros(2),
                      device="cpu")
    short = sc.gen_episode_batch(["none"] * schedule.n_sessions,
                                 schedule.max_dwell - 1, rng,
                                 include_iq=False, include_kpms=False)
    with pytest.raises(ValueError, match="dwell"):
        simulate_pool(short, schedule, table, prof, cfg, capacity=4,
                      device="cpu")
    empty = sc.make_churn_schedule(sc.ChurnConfig(arrival_rate=0.0), 5, rng)
    with pytest.raises(ValueError, match="no sessions"):
        simulate_pool(sessions, empty, table, prof, cfg, capacity=4,
                      device="cpu")
    with pytest.raises(ValueError, match="stacked table"):
        simulate_pool(sessions, schedule,
                      StackedLookupTable(["s"] * 2,
                                         np.zeros((2, 131), np.int32),
                                         np.zeros((2, 43)),
                                         np.ones((2, 43), bool)),
                      prof, cfg, capacity=4, device="cpu")


@pytest.mark.parametrize("kw,item", [
    ({"online": object()}, "10"), ({"telemetry": object()}, "11"),
    ({"serving": object()}, "12")])
def test_pool_later_slices_raise(both, kw, item):
    prof, table, cfg = both[0]
    (schedule, sessions), _ = _schedules(9, T=8)
    with pytest.raises(NotImplementedError, match=f"queue item {item}"):
        simulate_pool(sessions, schedule, table, prof, cfg, capacity=4,
                      device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="queue item 11"):
        pool_programs(0.5, 2, 3, telem=object())
