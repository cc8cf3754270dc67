"""Port parity for the estimator forward: reference weights carried into
the port (in process and through a reference checkpoint on disk) give the
reference's predictions to f32 tolerance (the convolutions sum in another
order, hence 1e-4)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import save as ref_save
from repro.estimator.model import EstimatorConfig as RefConfig
from repro.estimator.model import init_estimator as ref_init
from repro.estimator.train import fwd as ref_fwd
from repro.estimator.train import r2_rmse as ref_r2_rmse
from repro_torch.estimator.model import (EstimatorConfig, estimator_forward,
                                         estimator_template, init_estimator)
from repro_torch.estimator.train import fwd, predict, r2_rmse
from repro_torch.weights import (load_reference_checkpoint,
                                 params_from_reference)

SMALL = dict(n_sc=16, lstm_hidden=8, hidden=8)


def _inputs(e, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, e.window, e.n_kpms)).astype(np.float32),
            rng.normal(size=(b, 2, e.n_sc, e.n_sym)).astype(np.float32),
            rng.uniform(0.0, 1.0, b).astype(np.float32))


def _ref_tree(e, seed=0):
    return jax.tree.map(np.asarray, ref_init(e, jax.random.PRNGKey(seed)))


def test_config_defaults_match_reference():
    assert (dataclasses.asdict(EstimatorConfig())
            == dataclasses.asdict(RefConfig()))
    assert EstimatorConfig().cnn_flat == RefConfig().cnn_flat == 78624


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "paper_width"])
def test_forward_matches_reference(kw):
    e_ref, e = RefConfig(**kw), EstimatorConfig(**kw)
    tree = _ref_tree(e_ref)
    kpms, iq, alloc = _inputs(e, 2 if not kw else 6, seed=3)
    want = np.asarray(ref_fwd(e_ref, tree, kpms, iq, alloc))
    got = estimator_forward(e, params_from_reference(tree, device="cpu"),
                            kpms, iq, alloc, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_reference_checkpoint_loads_without_jax(tmp_path):
    e_ref, e = RefConfig(**SMALL), EstimatorConfig(**SMALL)
    params_ref = ref_init(e_ref, jax.random.PRNGKey(4))
    ref_save(tmp_path, 7, params_ref, blocking=True)
    loaded = load_reference_checkpoint(tmp_path / "step_00000007",
                                       device="cpu")
    direct = params_from_reference(jax.tree.map(np.asarray, params_ref),
                                   device="cpu")
    assert loaded.keys() == direct.keys()
    for g in direct:
        assert loaded[g].keys() == direct[g].keys()
        for k in direct[g]:
            assert torch.equal(loaded[g][k], direct[g][k])
    kpms, iq, alloc = _inputs(e, 5, seed=5)
    want = np.asarray(ref_fwd(e_ref, params_ref, kpms, iq, alloc))
    got = fwd(e, loaded, kpms, iq, alloc, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_init_matches_reference_layout_and_seed():
    e = EstimatorConfig(**SMALL)
    tree = _ref_tree(RefConfig(**SMALL))
    a = init_estimator(e, torch.Generator().manual_seed(0), device="cpu")
    b = init_estimator(e, torch.Generator().manual_seed(0), device="cpu")
    assert a.keys() == tree.keys() == estimator_template(e).keys()
    for g in tree:
        assert a[g].keys() == tree[g].keys()
        for k in tree[g]:
            assert tuple(a[g][k].shape) == tree[g][k].shape
            assert torch.equal(a[g][k], b[g][k])
    assert not a["lstm"]["b"].any() and a["lstm"]["wx"].std() > 0


def test_predict_chunks_and_metrics():
    e = EstimatorConfig(**SMALL)
    params = init_estimator(e, torch.Generator().manual_seed(1),
                            device="cpu")
    kpms, iq, alloc = _inputs(e, 7, seed=6)
    data = {"kpms": kpms, "iq": iq, "alloc": alloc,
            "tp": np.arange(7, dtype=np.float32)}
    whole = predict(e, params, data, batch=None, device="cpu")
    # rows are independent; only the products' blocking moves last bits
    np.testing.assert_allclose(predict(e, params, data, batch=3,
                                       device="cpu"), whole,
                               rtol=1e-6, atol=1e-6)
    assert r2_rmse(whole, data["tp"]) == ref_r2_rmse(whole, data["tp"])


def test_forward_rejects_params_on_another_device():
    e = EstimatorConfig(**SMALL)
    params = init_estimator(e, torch.Generator().manual_seed(0),
                            device="cpu")
    params["head"]["w1"] = params["head"]["w1"].to("meta")
    kpms, iq, alloc = _inputs(e, 2, seed=0)
    with pytest.raises(ValueError, match="w1"):
        estimator_forward(e, params, kpms, iq, alloc, device="cpu")
