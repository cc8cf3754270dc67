"""Port parity for the multi-cell layer: the numpy topology and episode
are bit-equal for the same ``rng``; ``simulate_cells`` with a scheduler,
driven by the ground truth and by the recurrent SSM estimator, against
the JAX package (splits equal on these seeds; rr and maxsinr shares
bit-equal, pf shares within rtol 1e-5, atol 1e-6; estimates and served
throughput within 1e-4); ``sched=None`` on one cell is the plain
``simulate_fleet``."""
import jax
import numpy as np
import pytest

from repro.channel import scenarios as sc_ref
from repro.core.controller import ControllerConfig as RefCfg
from repro.core.energy import EDGE_A40X2 as REF_EDGE
from repro.core.energy import UE_VM_2CORE as REF_UE
from repro.core.objective import Constraints as RefConstraints
from repro.core.objective import Weights as RefWeights
from repro.core.pso import pso_vectorized as ref_pso
from repro.estimator import ssm as ssm_ref
from repro.models import vgg as vgg_ref
from repro.sim import cells as cells_ref
from repro.sim import sched as sched_ref
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE
from repro_torch.core.objective import Constraints, Weights
from repro_torch.core.pso import pso_vectorized
from repro_torch.estimator import ssm
from repro_torch.models import vgg as vgg_t
from repro_torch.sim import cells, sched, simulate_fleet
from repro_torch.weights import params_from_reference

W = sc_ref.WINDOW
N, T, C = 24, 8, 3
WTS, CONS = (1.0, 0.15, 0.1), dict(rho_max=0.92, tau_max_s=6.0, e_max_j=40.0)


def _topology(pkg, seed, include_iq=False):
    rng = np.random.default_rng(seed)
    grid = pkg.handover_grid(pkg.attach_ring(N, C), T + W, 0.25, rng,
                             n_cells=C)
    names = np.asarray(sc_ref.SCENARIOS)[np.arange(N) % 4]
    ep = pkg.build_cells_episode(names, T, rng, grid,
                                 coupling=pkg.ring_coupling(C), n_sc=16,
                                 include_iq=include_iq)
    return grid, ep


@pytest.fixture(scope="module")
def planning():
    prof_r = vgg_ref.vgg_split_profile(vgg_ref.FULL)
    prof_t = vgg_t.vgg_split_profile(vgg_t.FULL)
    tab_r = ref_pso(prof_r, REF_UE, REF_EDGE, RefWeights(*WTS),
                    RefConstraints(**CONS), 130)
    tab_t = pso_vectorized(prof_t, UE_VM_2CORE, EDGE_A40X2, Weights(*WTS),
                           Constraints(**CONS), 130)
    fixed = tab_t.query(130.0)
    return ((tab_r, prof_r, RefCfg(0.6, 2, fixed)),
            (tab_t, prof_t, ControllerConfig(0.6, 2, fixed)), fixed)


@pytest.mark.parametrize("include_iq", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_topology_and_episode_bit_equal(seed, include_iq):
    grid_r, ep_r = _topology(cells_ref, seed, include_iq)
    grid_t, ep_t = _topology(cells, seed, include_iq)
    np.testing.assert_array_equal(grid_t, grid_r)
    for name in ("alloc_ratio", "int_dbm", "kpms", "tp_mbps", "iq",
                 "scenario_idx"):
        a, b = getattr(ep_t, name), getattr(ep_r, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(cells.ring_coupling(5),
                                  cells_ref.ring_coupling(5))
    np.testing.assert_array_equal(cells.attach_ring(7, 3),
                                  cells_ref.attach_ring(7, 3))
    x = np.random.default_rng(seed).uniform(size=9)
    act = x > 0.4
    assert cells.jain_index(x) == cells_ref.jain_index(x)
    assert cells.jain_index(x, act) == cells_ref.jain_index(x, act)


def _compare(got, want, policy):
    f, rf = got.fleet, want.fleet
    np.testing.assert_array_equal(f.splits, rf.splits)
    if policy == "pf":
        np.testing.assert_allclose(f.prb_share, rf.prb_share, rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(f.prb_share, rf.prb_share)
    np.testing.assert_allclose(f.est_tp, rf.est_tp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.served_mbps, want.served_mbps, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(f.delay_s, rf.delay_s, rtol=1e-5)
    np.testing.assert_array_equal(f.privacy, rf.privacy)
    np.testing.assert_allclose(got.share_sums(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got.jain(), want.jain(), rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("policy", sched.POLICIES)
def test_simulate_cells_truth_driven_matches_reference(planning, policy,
                                                       fused):
    (tab_r, prof_r, cfg_r), (tab_t, prof_t, cfg_t), fixed = planning
    grid_r, ep_r = _topology(cells_ref, 1)
    grid_t, ep_t = _topology(cells, 1)
    want = cells_ref.simulate_cells(
        ep_r, grid_r, tab_r, prof_r, cfg_r, n_cells=C, fixed_split=fixed,
        sched=sched_ref.SchedulerConfig(policy, pf_beta=0.3, fused=fused))
    got = cells.simulate_cells(
        ep_t, grid_t, tab_t, prof_t, cfg_t, n_cells=C, fixed_split=fixed,
        sched=sched.SchedulerConfig(policy, pf_beta=0.3, fused=fused),
        device="cpu")
    _compare(got, want, policy)
    np.testing.assert_allclose(got.fleet.fixed.delay_s,
                               want.fleet.fixed.delay_s, rtol=1e-5)


@pytest.mark.parametrize("policy", sched.POLICIES)
def test_simulate_cells_ssm_driven_matches_reference(planning, policy):
    (tab_r, prof_r, cfg_r), (tab_t, prof_t, cfg_t), _ = planning
    kw = dict(use_kernel=True, forecast_horizon=3, forecast_policy="discount",
              chunk=16)
    rc, c = ssm_ref.SSMConfig(**kw), ssm.SSMConfig(**kw)
    tree = jax.tree.map(np.array, ssm_ref.init_ssm(rc, jax.random.PRNGKey(1)))
    tree["head"]["w2"] *= 40.0
    tree["head"]["b2"] += 60.0
    params = params_from_reference(tree, device="cpu")
    grid_r, ep_r = _topology(cells_ref, 2)
    grid_t, ep_t = _topology(cells, 2)
    want = cells_ref.simulate_cells(
        ep_r, grid_r, tab_r, prof_r, cfg_r, n_cells=C, estimator=(rc, tree),
        sched=sched_ref.SchedulerConfig(policy, fused=True))
    got = cells.simulate_cells(
        ep_t, grid_t, tab_t, prof_t, cfg_t, n_cells=C, estimator=(c, params),
        sched=sched.SchedulerConfig(policy, fused=True), device="cpu")
    _compare(got, want, policy)
    assert len(np.unique(got.fleet.splits)) > 1


def test_no_scheduler_on_one_cell_is_plain_simulate_fleet(planning):
    (tab_r, prof_r, cfg_r), (tab_t, prof_t, cfg_t), fixed = planning
    _, ep_r = _topology(cells_ref, 3)
    _, ep_t = _topology(cells, 3)
    one = np.zeros((N, T + W), np.int64)
    got = cells.simulate_cells(ep_t, one, tab_t, prof_t, cfg_t,
                               fixed_split=fixed, device="cpu")
    plain = simulate_fleet(ep_t, tab_t, prof_t, cfg_t, fixed_split=fixed,
                           device="cpu")
    want = cells_ref.simulate_cells(ep_r, one, tab_r, prof_r, cfg_r,
                                    fixed_split=fixed)
    assert got.fleet.prb_share is None and got.n_cells == 1
    for name in ("splits", "est_tp", "delay_s", "privacy", "energy_j"):
        np.testing.assert_array_equal(getattr(got.fleet, name),
                                      getattr(plain, name))
        np.testing.assert_array_equal(getattr(got.fleet, name),
                                      getattr(want.fleet, name))
    np.testing.assert_array_equal(got.served_mbps, ep_t.tp_mbps)
    np.testing.assert_array_equal(got.share_sums(), np.ones((1, T)))


def test_cell_grid_shape_is_checked(planning):
    _, (tab_t, prof_t, cfg_t), _ = planning
    _, ep_t = _topology(cells, 4)
    with pytest.raises(ValueError, match="does not match"):
        cells.simulate_cells(ep_t, np.zeros((N, T + 1), np.int64), tab_t,
                             prof_t, cfg_t, device="cpu")
