"""Port parity for int8 estimator serving: the port's
``quantize_estimator`` is bit-equal to the reference's tree carried across
by ``qparams_from_reference``, and ``fwd_int8`` / ``predict_int8`` give the
reference's int8 predictions at small widths (to 1e-4: the convolutions
sum in another order, which could flip an int8 code of the trunk; none
flips at these seeds, measured max 1.2e-7)."""
import jax
import numpy as np
import pytest
import torch

from repro.estimator.model import EstimatorConfig as RefConfig
from repro.estimator.model import init_estimator as ref_init
from repro.estimator.serve import fwd_int8 as ref_fwd_int8
from repro.estimator.serve import predict_int8 as ref_predict_int8
from repro.estimator.serve import quantize_estimator as ref_quantize_estimator
from repro_torch.estimator.model import EstimatorConfig, estimator_forward
from repro_torch.estimator.serve import (QUANT_MODES, check_quant, fwd_int8,
                                         predict_int8, quantize_estimator)
from repro_torch.weights import params_from_reference, qparams_from_reference

SMALL = dict(n_sc=16, lstm_hidden=8, hidden=8)


def _ref_tree(seed=0, **widths):
    return jax.tree.map(np.asarray, ref_init(RefConfig(**widths),
                                             jax.random.PRNGKey(seed)))


def _inputs(e, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, e.window, e.n_kpms)).astype(np.float32),
            rng.normal(size=(b, 2, e.n_sc, e.n_sym)).astype(np.float32),
            rng.uniform(0.0, 1.0, b).astype(np.float32))


@pytest.mark.parametrize("widths", [SMALL, dict(n_sc=32, lstm_hidden=124,
                                                hidden=124)])
def test_quantize_estimator_equals_reference(widths):
    tree = _ref_tree(**widths)
    want = qparams_from_reference(
        jax.tree.map(np.asarray, ref_quantize_estimator(tree)), device="cpu")
    got = quantize_estimator(params_from_reference(tree, device="cpu"))
    assert got.keys() == want.keys()
    for group in want:
        assert got[group].keys() == want[group].keys()
        for name, leaf in want[group].items():
            mine = got[group][name]
            assert type(mine) is type(leaf), name
            for a, b in zip(mine if isinstance(mine, tuple) else (mine,),
                            leaf if isinstance(leaf, tuple) else (leaf,)):
                assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got["cnn"]["fc"][0].dtype == torch.int8
    assert got["cnn"]["fc"][0].shape == (widths["hidden"],
                                         RefConfig(**widths).cnn_flat)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fwd_int8_matches_reference(seed):
    e = EstimatorConfig(**SMALL)
    tree = _ref_tree(seed, **SMALL)
    kpms, iq, alloc = _inputs(e, 64, seed)
    want = np.asarray(ref_fwd_int8(RefConfig(**SMALL),
                                   ref_quantize_estimator(tree), kpms, iq,
                                   alloc))
    qp = quantize_estimator(params_from_reference(tree, device="cpu"))
    got = fwd_int8(e, qp, kpms, iq, alloc, device="cpu")
    assert got.shape == (64,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_predict_int8_batches_and_tracks_fp32():
    e = EstimatorConfig(**SMALL)
    tree = _ref_tree(3, **SMALL)
    kpms, iq, alloc = _inputs(e, 20, 3)
    data = {"kpms": kpms, "iq": iq, "alloc": alloc,
            "tp": np.zeros(20, np.float32)}
    params = params_from_reference(tree, device="cpu")
    qp = quantize_estimator(params)
    got = predict_int8(e, qp, data, batch=7, device="cpu")
    whole = predict_int8(e, qp, data, batch=None, device="cpu")
    np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-6)
    want = ref_predict_int8(RefConfig(**SMALL),
                            ref_quantize_estimator(tree), data, batch=7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    f32 = estimator_forward(e, params, kpms, iq, alloc, device="cpu")
    assert float(np.abs(got - f32.numpy()).max()) < 0.1


def test_check_quant():
    assert QUANT_MODES == (None, "int8")
    for mode in QUANT_MODES:
        check_quant(mode)
    with pytest.raises(ValueError, match="quant must be one of"):
        check_quant("int4")


def test_qparams_from_reference_rejects_malformed_leaves():
    codes = np.zeros((3, 4), np.int8)
    scales = np.ones((3, 1), np.float32)
    good = qparams_from_reference({"g": {"w": (codes, scales)}},
                                  device="cpu")
    assert good["g"]["w"][0].dtype == torch.int8
    for bad in ((codes.astype(np.float32), scales),
                (codes, scales[:2]), (codes, scales, scales)):
        with pytest.raises((TypeError, ValueError)):
            qparams_from_reference({"g": {"w": bad}}, device="cpu")
    with pytest.raises(TypeError, match="float32"):  # the fp32 tree as is
        params_from_reference({"g": {"w": (codes, scales)}}, device="cpu")
