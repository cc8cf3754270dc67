"""Port parity for the host-side planning and the controller: episodes,
PSO tables, the VGG profile, controller splits and split metrics are all
exactly equal to the reference's."""
import numpy as np
import pytest
import torch

from repro.channel import scenarios as sc_ref
from repro.core import controller as ctl_ref
from repro.core import pso as pso_ref
from repro.core.energy import EDGE_A40X2 as REF_EDGE
from repro.core.energy import UE_VM_2CORE as REF_UE
from repro.core.objective import Constraints as RefConstraints
from repro.core.objective import Weights as RefWeights
from repro.models import vgg as vgg_ref
from repro.sim import run_controllers as ref_run_controllers
from repro.sim import split_metrics as ref_split_metrics
from repro_torch.channel import scenarios as sc_t
from repro_torch.core import controller as ctl_t
from repro_torch.core import pso as pso_t
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE
from repro_torch.core.objective import Constraints, Weights
from repro_torch.models import vgg as vgg_t
from repro_torch.sim import run_controllers, split_metrics


def _episode_pair(seed, n=6, t=5, **kw):
    names = np.asarray(sc_ref.SCENARIOS)[np.arange(n) % 4]
    a = sc_ref.gen_episode_batch(names, t, np.random.default_rng(seed),
                                 n_sc=16, **kw)
    b = sc_t.gen_episode_batch(names, t, np.random.default_rng(seed),
                               n_sc=16, **kw)
    return a, b


@pytest.mark.parametrize("kw", [
    {}, {"load_ratio": 0.12}, {"include_iq": False},
    {"extra_int_mw": np.full((6, 5 + sc_ref.WINDOW), 0.3)},
    {"int_dbm": np.linspace(-40, 10, 6 * (5 + sc_ref.WINDOW))
     .reshape(6, -1)}], ids=["drawn", "load", "no_iq", "extra", "traces"])
def test_episode_identical_for_same_seed(kw):
    a, b = _episode_pair(11, **kw)
    for f in ("scenario_idx", "alloc_ratio", "int_dbm", "kpms", "tp_mbps",
              "iq"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None
            continue
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.kpm_windows(), b.kpm_windows())
    np.testing.assert_array_equal(a.kpm_windows(method="gather"),
                                  b.kpm_windows(method="gather"))


def test_handover_grid_episode_identical():
    grid = np.repeat(np.array([["cci"] * 20 + ["tdd"] * 15]), 3, axis=0)
    a = sc_ref.gen_episode_batch(grid, 5, np.random.default_rng(2), n_sc=16)
    b = sc_t.gen_episode_batch(grid, 5, np.random.default_rng(2), n_sc=16)
    np.testing.assert_array_equal(a.iq, b.iq)
    np.testing.assert_array_equal(a.kpms, b.kpms)


def test_vgg_profile_identical():
    a = vgg_ref.vgg_split_profile(vgg_ref.FULL)
    b = vgg_t.vgg_split_profile(vgg_t.FULL)
    for f in ("flops_head", "data_bytes", "privacy"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.layer_names == b.layer_names and a.name == b.name
    assert vgg_ref._shapes(vgg_ref.FULL) == vgg_t._shapes(vgg_t.FULL)


# fig6's operating configuration (benchmarks/fig6_adaptive.py::fig6_table)
# and two others
PSO_SETTINGS = [((1.0, 0.15, 0.1), dict(rho_max=0.92, tau_max_s=6.0,
                                         e_max_j=40.0)),
                ((1.0, 0.0, 0.0), {}),
                ((0.5, 0.5, 0.2), dict(rho_max=0.5, tau_max_s=2.0))]


@pytest.mark.parametrize("w,cons", PSO_SETTINGS, ids=["fig6", "delay",
                                                       "mixed"])
def test_pso_tables_identical(w, cons):
    prof_r = vgg_ref.vgg_split_profile(vgg_ref.FULL)
    prof_t = vgg_t.vgg_split_profile(vgg_t.FULL)
    a = pso_ref.pso_vectorized(prof_r, REF_UE, REF_EDGE, RefWeights(*w),
                               RefConstraints(**cons), 130)
    b = pso_t.pso_vectorized(prof_t, UE_VM_2CORE, EDGE_A40X2, Weights(*w),
                             Constraints(**cons), 130)
    for f in ("table", "tp_min_mbps", "feasible_prefilter"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for tp in (0.2, 0.5, 1.5, 2.5, 37.0, 200.0):
        assert a.query(tp) == b.query(tp)


@pytest.mark.parametrize("w,cons", PSO_SETTINGS, ids=["fig6", "delay",
                                                       "mixed"])
def test_pso_reference_and_build_tables_identical(w, cons):
    """Algorithm 1's direct transcription and the outer loop over UEs,
    against the reference's and against the vectorised sweep, on the
    paper's profile and on one whose privacy is the measured kind (the
    input near 1, a slow decay)."""
    measured = np.linspace(1.0, 0.3, 43)
    profs_r = {"paper": vgg_ref.vgg_split_profile(vgg_ref.FULL),
               "measured": vgg_ref.vgg_split_profile(vgg_ref.FULL,
                                                     privacy=measured)}
    profs_t = {"paper": vgg_t.vgg_split_profile(vgg_t.FULL),
               "measured": vgg_t.vgg_split_profile(vgg_t.FULL,
                                                   privacy=measured)}
    args_r = (REF_UE, REF_EDGE, RefWeights(*w), RefConstraints(**cons), 130)
    args_t = (UE_VM_2CORE, EDGE_A40X2, Weights(*w), Constraints(**cons), 130)
    built_r = pso_ref.build_tables(profs_r, *args_r)
    built_t = pso_t.build_tables(profs_t, *args_t)
    assert list(built_t) == list(built_r)
    for name in profs_t:
        a = pso_ref.pso_reference(profs_r[name], *args_r)
        b = pso_t.pso_reference(profs_t[name], *args_t)
        v = pso_t.pso_vectorized(profs_t[name], *args_t)
        for f in ("table", "tp_min_mbps", "feasible_prefilter"):
            for got in (getattr(b, f), getattr(built_t[name], f)):
                assert got.dtype == getattr(a, f).dtype
                np.testing.assert_array_equal(got, getattr(a, f))
            np.testing.assert_array_equal(getattr(built_t[name], f),
                                          getattr(built_r[name], f))
        np.testing.assert_array_equal(b.table, v.table)


def test_constants_identical():
    assert pso_t.TP_CLIP_MBPS == pso_ref.TP_CLIP_MBPS
    assert pso_t.NO_SPLIT == pso_ref.NO_SPLIT
    assert ctl_t.PENDING_NONE == ctl_ref.PENDING_NONE


def random_tables(rng, n_ues, width=40, n_splits=12):
    """The fixture of tests/test_sim_fleet.py::random_stacked: bucket 0
    NO_SPLIT, other buckets NO_SPLIT or any split index."""
    tables = rng.integers(-1, n_splits, (n_ues, width + 1)).astype(np.int32)
    tables[:, 0] = pso_ref.NO_SPLIT
    return tables


CTL_SETTINGS = [(0.5, 2, -1), (0.6, 2, 3), (1.0, 1, -1), (0.3, 3, 5),
                (0.25, 4, 0), (0.9, 2, 11)]


@pytest.mark.parametrize("alpha,hyst,fallback", CTL_SETTINGS)
def test_run_controllers_identical(alpha, hyst, fallback):
    rng = np.random.default_rng(int(alpha * 100) + hyst)
    tables = random_tables(rng, 7)
    est = rng.uniform(0.0, tables.shape[1] + 5.0, (7, 40))
    # estimates on the half-integer rounding edges, in f32
    est[:, ::7] = np.round(est[:, ::7]) + 0.5
    warm = rng.integers(-1, 12, 7)
    for w in (-1, warm):
        want = ref_run_controllers(
            tables, est, ctl_ref.ControllerConfig(alpha, hyst, fallback), w)
        got = run_controllers(tables, est,
                              ctl_t.ControllerConfig(alpha, hyst, fallback),
                              w, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_controller_class_identical():
    rng = np.random.default_rng(3)
    table = random_tables(rng, 1)[0]
    lt_r = pso_ref.LookupTable("u", table, np.zeros(12), np.ones(12, bool))
    lt_t = pso_t.LookupTable("u", table, np.zeros(12), np.ones(12, bool))
    a = ctl_ref.AdaptiveSplitController(lt_r, ctl_ref.ControllerConfig(
        0.6, 2, 4))
    b = ctl_t.AdaptiveSplitController(lt_t, ctl_t.ControllerConfig(
        0.6, 2, 4), device="cpu")
    a.reset(warm_split=9)
    b.reset(warm_split=9)
    ewma = None
    for tp in rng.uniform(0.0, 45.0, 60):
        assert a.update(tp) == b.update(tp)
        # the port's EWMA is the f32 transcription with one rounding per
        # operation (what the batched reference computes); the reference's
        # scalar jitted step may differ from it in the last bit
        t32 = np.float32(tp)
        ewma = t32 if ewma is None else (np.float32(0.6) * t32
                                         + np.float32(0.4) * ewma)
        assert b.tp_ewma == float(ewma)
        np.testing.assert_allclose(a.tp_ewma, b.tp_ewma, rtol=1e-6)
        assert (a.pending_split, a.pending_count) == (b.pending_split,
                                                      b.pending_count)
    assert [s[::2] for s in a.switches] == [s[::2] for s in b.switches]
    assert a.switches


def test_controller_state_batched():
    st = ctl_t.controller_init(np.array([1, 2, 3]), batch_shape=(3,),
                               device="cpu")
    assert st.current_split.dtype == torch.int32
    assert st.current_split.tolist() == [1, 2, 3]
    assert st.pending_split.tolist() == [ctl_t.PENDING_NONE] * 3
    assert not st.has_ewma.any()


@pytest.mark.parametrize("with_no_split", [False, True])
def test_split_metrics_identical(with_no_split):
    rng = np.random.default_rng(5)
    prof_r = vgg_ref.vgg_split_profile(vgg_ref.FULL)
    prof_t = vgg_t.vgg_split_profile(vgg_t.FULL)
    splits = rng.integers(-1 if with_no_split else 0, 43, (9, 11))
    tp = rng.uniform(0.0, 130.0, (9, 11))
    tp[0, :3] = 0.0  # below the floor
    want = ref_split_metrics(prof_r, splits.astype(np.int32), tp)
    got = split_metrics(prof_t, splits.astype(np.int32), tp, device="cpu")
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == np.float64
        np.testing.assert_array_equal(x, y)
    with pytest.raises(IndexError):
        split_metrics(prof_t, np.full((1, 1), 43), tp[:1, :1], device="cpu")
