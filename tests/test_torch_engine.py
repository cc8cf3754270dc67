"""The whole slice: the port's ``simulate_fleet(..., fused=True)`` against
the reference's on a mixed 8-UE, 6-period episode with reference weights.
Estimates agree to 1e-4; splits, delay, privacy and energy are equal. The
same holds for int8 serving (``quant="int8"``), fused and unfused, and
int8 stays within the reference's 1 Mbps RMSE bar of the port's fp32."""
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


# int8 serving. The estimates agree to 1e-4 as on the fp32 path (measured
# max 7.6e-6 on the head's x40 scale): the int8 codes agree, and a code
# flipped by a last-bit difference of the convolutions or of sigmoid/tanh
# would show here.
@pytest.mark.parametrize("fused", [False, True])
def test_estimate_fleet_int8_matches_reference(slice_inputs, fused):
    ref, port, _ = slice_inputs
    want = ref_estimate_fleet(ref["episode"], ref["estimator"], quant="int8",
                              fused=fused)
    got = estimate_fleet(port["episode"], port["estimator"], quant="int8",
                         fused=fused, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    f32 = estimate_fleet(port["episode"], port["estimator"], fused=fused,
                         device="cpu")
    assert not np.array_equal(got, f32)  # the int8 path really ran


def test_simulate_fleet_int8_matches_reference(slice_inputs):
    ref, port, fixed = slice_inputs
    want = _run(ref, ref_simulate_fleet, fused=True, quant="int8",
                warm_split=fixed, fixed_split=fixed)
    got = _run(port, simulate_fleet, fused=True, quant="int8",
               warm_split=fixed, fixed_split=fixed, device="cpu")
    np.testing.assert_allclose(got.est_tp, want.est_tp, rtol=1e-4,
                               atol=1e-4)
    assert len(np.unique(np.round(got.est_tp))) > 5
    for f in ("splits", "delay_s", "privacy", "energy_j"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    # independent of rounding edges: the reference's int8 estimates
    # through the port's controllers give the reference's splits exactly
    tables = np.broadcast_to(ref["table"].table, (8, 131))
    np.testing.assert_array_equal(
        run_controllers(tables, want.est_tp, port["cfg"], fixed,
                        device="cpu"), want.splits)


def test_int8_within_1mbps_rmse_of_fp32():
    """The reference's serving-accuracy bar (tests/test_sim_fused.py):
    16 UEs x 6 periods, the unscaled reference init, int8 against the
    port's own fp32, unfused and fused."""
    e = EstimatorConfig(**SMALL)
    params = params_from_reference(
        jax.tree.map(np.array, ref_init(RefConfig(**SMALL),
                                        jax.random.PRNGKey(0))),
        device="cpu")
    names = np.asarray(sc_t.SCENARIOS)[np.arange(16) % 4]
    ep = sc_t.gen_episode_batch(names, 6, np.random.default_rng(5), n_sc=16)
    f = estimate_fleet(ep, (e, params), device="cpu")
    q = estimate_fleet(ep, (e, params), quant="int8", device="cpu")
    assert float(np.sqrt(np.mean((q - f) ** 2))) < 1.0
    qf = estimate_fleet(ep, (e, params), quant="int8", fused=True,
                        device="cpu")
    np.testing.assert_allclose(qf, q, rtol=1e-6, atol=1e-6)
