"""Port parity for the LSTM scan: the plain PyTorch scan matches the JAX
kernel (Pallas, interpret mode) at a small width and at the paper's
H = 124, and ``lstm_hidden(...) @ proj`` is the port's ``lstm_branch``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.estimator.model import EstimatorConfig as RefConfig
from repro.estimator.model import init_estimator as ref_init
from repro.estimator.model import lstm_branch as ref_lstm_branch
from repro.kernels.lstm import lstm_hidden as ref_lstm_hidden
from repro_torch.estimator.model import lstm_branch
from repro_torch.kernels.lstm import lstm_hidden, lstm_scan, lstm_scan_ref
from repro_torch.weights import params_from_reference


def _inputs(b, h, seed, k=15, t=30):
    rng = np.random.default_rng(seed)
    kpms = rng.normal(size=(b, t, k)).astype(np.float32)
    wx = (0.3 * rng.normal(size=(k, 4 * h))).astype(np.float32)
    wh = (0.3 * rng.normal(size=(h, 4 * h))).astype(np.float32)
    bias = np.linspace(-0.5, 0.5, 4 * h, dtype=np.float32)
    return kpms, wx, wh, bias


@pytest.mark.parametrize("b,h", [(5, 8), (3, 124), (17, 124)])
def test_lstm_scan_ref_matches_reference_kernel(b, h):
    arrays = _inputs(b, h, seed=b + h)
    want = np.asarray(ref_lstm_hidden(*map(jnp.asarray, arrays)))
    got = lstm_scan_ref(*map(torch.from_numpy, arrays))
    assert got.shape == (b, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper runs exactly the plain version for CPU tensors
    assert torch.equal(lstm_scan(*map(torch.from_numpy, arrays)), got)


def test_lstm_hidden_proj_is_lstm_branch():
    e = RefConfig(n_sc=16, lstm_hidden=8, hidden=8)
    tree = jax.tree.map(np.asarray, ref_init(e, jax.random.PRNGKey(0)))
    p = params_from_reference(tree, device="cpu")["lstm"]
    kpms = np.random.default_rng(1).normal(
        size=(6, e.window, 15)).astype(np.float32)
    x = torch.from_numpy(kpms)
    got = lstm_hidden(x, p["wx"], p["wh"], p["b"]) @ p["proj"]
    assert torch.equal(got, lstm_branch(p, x))
    want = np.asarray(ref_lstm_branch(tree["lstm"], jnp.asarray(kpms)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "wh_shape", "rank"])
def test_wrapper_rejects_malformed_input(bad):
    kpms, wx, wh, bias = map(torch.from_numpy, _inputs(2, 8, seed=0))
    if bad == "dtype":
        wx = wx.double()
    elif bad == "contiguous":
        kpms = kpms.transpose(0, 1)
    elif bad == "wh_shape":
        wh = wh[:7]
    else:
        kpms = kpms[0]
    with pytest.raises((TypeError, ValueError)):
        lstm_scan(kpms, wx, wh, bias)
