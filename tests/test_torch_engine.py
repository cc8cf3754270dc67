"""The whole slice: the port's ``simulate_fleet(..., fused=True)`` against
the reference's on a mixed 8-UE, 6-period episode with reference weights.
Estimates agree to 1e-4; splits, delay, privacy and energy are equal."""
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
from repro.estimator.model import EstimatorConfig as RefConfig
from repro.estimator.model import init_estimator as ref_init
from repro.models import vgg as vgg_ref
from repro.sim import emit_period_samples as ref_emit
from repro.sim import estimate_fleet as ref_estimate_fleet
from repro.sim import simulate_fleet as ref_simulate_fleet
from repro_torch.channel import scenarios as sc_t
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE
from repro_torch.core.objective import Constraints, Weights
from repro_torch.core.pso import pso_vectorized
from repro_torch.estimator.model import EstimatorConfig
from repro_torch.models import vgg as vgg_t
from repro_torch.sim import (emit_period_samples, estimate_fleet,
                             run_controllers, simulate_fleet,
                             simulate_fleet_looped)
from repro_torch.sim import engine
from repro_torch.weights import params_from_reference

SMALL = dict(n_sc=16, lstm_hidden=8, hidden=8)
W, CONS = (1.0, 0.15, 0.1), dict(rho_max=0.92, tau_max_s=6.0, e_max_j=40.0)


@pytest.fixture(scope="module")
def slice_inputs():
    """Both packages' inputs for one fig6-configured, estimator-driven run.
    The untrained head is rescaled (same numbers on both sides) so the
    estimates spread over the table's 1-130 Mbps range."""
    names = np.asarray(sc_ref.SCENARIOS)[np.arange(8) % 4]
    ep_r = sc_ref.gen_episode_batch(names, 6, np.random.default_rng(21),
                                    n_sc=16)
    ep_t = sc_t.gen_episode_batch(names, 6, np.random.default_rng(21),
                                  n_sc=16)
    tree = jax.tree.map(np.array, ref_init(RefConfig(**SMALL),
                                           jax.random.PRNGKey(0)))
    tree["head"]["w2"] *= 40.0
    tree["head"]["b2"] += 60.0
    prof_r = vgg_ref.vgg_split_profile(vgg_ref.FULL)
    prof_t = vgg_t.vgg_split_profile(vgg_t.FULL)
    tab_r = ref_pso(prof_r, REF_UE, REF_EDGE, RefWeights(*W),
                    RefConstraints(**CONS), 130)
    tab_t = pso_vectorized(prof_t, UE_VM_2CORE, EDGE_A40X2, Weights(*W),
                           Constraints(**CONS), 130)
    fixed = tab_t.query(130.0)
    ref = dict(episode=ep_r, table=tab_r, profile=prof_r,
               cfg=RefCfg(0.6, 2, fixed),
               estimator=(RefConfig(**SMALL), tree))
    port = dict(episode=ep_t, table=tab_t, profile=prof_t,
                cfg=ControllerConfig(0.6, 2, fixed),
                estimator=(EstimatorConfig(**SMALL),
                           params_from_reference(tree, device="cpu")))
    return ref, port, fixed


def _run(pkg, fn, **kw):
    return fn(pkg["episode"], pkg["table"], pkg["profile"], pkg["cfg"],
              estimator=pkg["estimator"], **kw)


def test_simulate_fleet_fused_matches_reference(slice_inputs):
    ref, port, fixed = slice_inputs
    want = _run(ref, ref_simulate_fleet, fused=True, warm_split=fixed,
                fixed_split=fixed)
    got = _run(port, simulate_fleet, fused=True, warm_split=fixed,
               fixed_split=fixed, device="cpu")
    assert got.est_tp.shape == (8, 6)
    np.testing.assert_allclose(got.est_tp, want.est_tp, rtol=1e-4,
                               atol=1e-4)
    # the estimates cross buckets, so the split pin is not vacuous
    assert len(np.unique(np.round(got.est_tp))) > 5
    assert got.splits.dtype == np.int32
    for f in ("splits", "true_tp", "delay_s", "privacy", "energy_j"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got.fixed, f),
                                      getattr(want.fixed, f), err_msg=f)
    # independent of rounding edges: the reference's own estimates through
    # the port's controllers give the reference's splits exactly
    tables = np.broadcast_to(ref["table"].table, (8, 131))
    np.testing.assert_array_equal(
        run_controllers(tables, want.est_tp, port["cfg"], fixed,
                        device="cpu"), want.splits)
    scen = port["episode"].scenario_idx
    np.testing.assert_array_equal(got.scenario_means(scen)["jamming"],
                                  want.scenario_means(scen)["jamming"])


def test_fused_equals_unfused(slice_inputs):
    _, port, _ = slice_inputs
    a = _run(port, simulate_fleet, fused=True, device="cpu")
    b = _run(port, simulate_fleet, fused=False, device="cpu")
    np.testing.assert_array_equal(a.est_tp, b.est_tp)
    np.testing.assert_array_equal(a.splits, b.splits)


def test_looped_equals_batched(slice_inputs):
    _, port, fixed = slice_inputs
    res = _run(port, simulate_fleet, fused=True, fixed_split=fixed,
               device="cpu")
    loop = simulate_fleet_looped(port["episode"], port["table"],
                                 port["profile"], port["cfg"],
                                 est_tp=res.est_tp, fixed_split=fixed,
                                 device="cpu")
    for f in ("splits", "delay_s", "privacy", "energy_j"):
        np.testing.assert_array_equal(getattr(loop, f), getattr(res, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(loop.fixed, f),
                                      getattr(res.fixed, f), err_msg=f)


def test_no_estimator_runs_on_ground_truth(slice_inputs):
    ref, port, _ = slice_inputs
    want = ref_simulate_fleet(ref["episode"], ref["table"], ref["profile"],
                              ref["cfg"])
    got = simulate_fleet(port["episode"], port["table"], port["profile"],
                         port["cfg"], device="cpu")
    np.testing.assert_array_equal(got.splits, want.splits)
    np.testing.assert_array_equal(got.delay_s, want.delay_s)


@pytest.mark.parametrize("chunk_rows", [8, 24, 1])
def test_estimate_chunking_and_row_packing(slice_inputs, monkeypatch,
                                           chunk_rows):
    """Several chunks (1-3 periods of 8 UEs, or one UE-period a chunk)
    give the one-chunk estimates: the row packing u * b + j is right."""
    ref, port, _ = slice_inputs
    whole = estimate_fleet(port["episode"], port["estimator"], fused=True,
                           device="cpu")
    monkeypatch.setattr(engine, "EST_CHUNK_ROWS", chunk_rows)
    for fused in (True, False):
        got = estimate_fleet(port["episode"], port["estimator"], fused=fused,
                             device="cpu")
        np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-5)
    want = ref_estimate_fleet(ref["episode"], ref["estimator"], fused=True)
    np.testing.assert_allclose(whole, want, rtol=1e-4, atol=1e-4)


def test_emit_period_samples_identical(slice_inputs):
    ref, port, _ = slice_inputs
    for t in (0, 5):
        a = ref_emit(ref["episode"], t)
        b = emit_period_samples(port["episode"], t)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
