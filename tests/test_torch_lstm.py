"""Port parity for the LSTM scans: the plain PyTorch scan matches the JAX
kernel (Pallas, interpret mode) at a small width and at the paper's
H = 124, and ``lstm_hidden(...) @ proj`` is the port's ``lstm_branch``.
For the int8 scan, one step's integer dots and pre-activations are
bit-equal to the JAX oracle's, and the 30-step scan agrees with the JAX
kernel to a stated tolerance: sigmoid and tanh differ between XLA and
PyTorch by an ulp, which now and then flips one int8 code of h in the
next step's quantization."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.estimator.model import EstimatorConfig as RefConfig
from repro.estimator.model import init_estimator as ref_init
from repro.estimator.model import lstm_branch as ref_lstm_branch
from repro.kernels.lstm import lstm_hidden as ref_lstm_hidden
from repro.kernels.lstm import lstm_hidden_q as ref_lstm_hidden_q
from repro.kernels.lstm import qdot_ref as ref_qdot_ref
from repro.kernels.qmm import quantize_weight as ref_quantize_weight
from repro_torch.estimator.model import lstm_branch
from repro_torch.kernels.lstm import (lstm_hidden, lstm_hidden_q, lstm_route,
                                      lstm_scan, lstm_scan_q, lstm_scan_q_ref,
                                      lstm_scan_ref, lstm_scan_route,
                                      qdot_ref)
from repro_torch.kernels.qmm import quantize_weight
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


def _q_inputs(b, h, seed, k=15, t=30):
    """Fan-in scaled weights (std 1/sqrt(fan_in), the estimator's init),
    quantized by the reference: numpy arrays for both packages."""
    rng = np.random.default_rng(seed)
    kpms = rng.normal(size=(b, t, k)).astype(np.float32)
    wx = (rng.normal(size=(k, 4 * h)) / np.sqrt(k)).astype(np.float32)
    wh = (rng.normal(size=(h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    bias = np.linspace(-0.5, 0.5, 4 * h, dtype=np.float32)
    wxq, wxs = map(np.array, ref_quantize_weight(jnp.asarray(wx)))
    whq, whs = map(np.array, ref_quantize_weight(jnp.asarray(wh)))
    return kpms, (wxq, wxs, whq, whs, bias), (wx, wh)


def test_qdot_and_one_step_bit_equal():
    """One step's inputs: the dynamic int8 dots and the full pre-activation
    z = qdot(x_t, wx) + qdot(h, wh) + b, bit-equal to the JAX oracle."""
    kpms, (wxq, wxs, whq, whs, bias), _ = _q_inputs(33, 124, seed=1)
    h = np.tanh(np.random.default_rng(2).normal(
        size=(33, 124))).astype(np.float32)
    x_t = np.ascontiguousarray(kpms[:, 7])
    jx, jh = ref_qdot_ref(x_t, wxq, wxs), ref_qdot_ref(h, whq, whs)
    t = torch.from_numpy
    tx = qdot_ref(t(x_t), t(wxq), t(wxs))
    th = qdot_ref(t(h), t(whq), t(whs))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal((tx + th + t(bias)).numpy(),
                                  np.asarray(jx + jh + bias))


# Measured at B = 257, H = 124 over seeds 0-7: max |err| 1.1e-3 - 1.8e-3
# (seed 0: 1.67e-3), 0-6 rows (at most 2.3%) beyond 1e-5, about 26% of the
# elements exactly equal. The bound leaves about 2.7x room on the largest
# error; a wrong scale, order or rounding breaks every row.
Q_SCAN_ATOL = 5e-3
Q_SCAN_ROWS_OFF = 0.05


@pytest.mark.parametrize("seed", [0, 3])
def test_lstm_scan_q_matches_reference_kernel(seed):
    kpms, qw, _ = _q_inputs(257, 124, seed=seed)
    want = np.asarray(ref_lstm_hidden_q(jnp.asarray(kpms),
                                        *map(jnp.asarray, qw)))
    got = lstm_hidden_q(torch.from_numpy(kpms), *map(torch.from_numpy, qw))
    assert got.shape == (257, 124) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    assert err.max() <= Q_SCAN_ATOL
    assert (err.max(axis=1) > 1e-5).mean() <= Q_SCAN_ROWS_OFF
    # the wrapper runs exactly the plain version for CPU tensors
    t = [torch.from_numpy(a) for a in (kpms, *qw)]
    assert torch.equal(lstm_scan_q(*t), lstm_scan_q_ref(*t))


@pytest.mark.parametrize("b,h", [(8, 16), (64, 124)])
def test_lstm_int8_close_to_fp32(b, h):
    """Quantization noise stays small on fan-in weights: within 0.15 of
    the fp32 scan (the reference's bar, tests/test_kernels_fused.py)."""
    kpms, qw, (wx, wh) = _q_inputs(b, h, seed=5)
    t = torch.from_numpy
    q = lstm_hidden_q(t(kpms), *map(t, qw))
    f = lstm_hidden(t(kpms), t(wx), t(wh), t(qw[-1]))
    assert float((q - f).abs().max()) < 0.15


def test_quantize_weight_layout_feeds_the_scan():
    """The port's own ``quantize_weight`` gives the reference's operands."""
    _, (wxq, wxs, whq, whs, _), (wx, wh) = _q_inputs(2, 8, seed=0)
    for (q, s), (rq, rs) in ((quantize_weight(torch.from_numpy(wx)),
                              (wxq, wxs)),
                             (quantize_weight(torch.from_numpy(wh)),
                              (whq, whs))):
        np.testing.assert_array_equal(q.numpy(), rq)
        np.testing.assert_array_equal(s.numpy(), rs)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "whq_shape", "rank",
                                 "scale_shape"])
def test_q_wrapper_rejects_malformed_input(bad):
    kpms, qw, _ = _q_inputs(2, 8, seed=0)
    kpms, wxq, wxs, whq, whs, bias = map(torch.from_numpy, (kpms, *qw))
    if bad == "dtype":
        whq = whq.float()
    elif bad == "contiguous":
        kpms = kpms.transpose(0, 1)
    elif bad == "whq_shape":
        whq = whq[:31]
    elif bad == "rank":
        kpms = kpms[0]
    else:
        wxs = wxs[:, 0]
    with pytest.raises((TypeError, ValueError)):
        lstm_scan_q(kpms, wxq, wxs, whq, whs, bias)


@pytest.mark.parametrize("hidden,want", [(1, "mma"), (124, "mma"),
                                         (128, "mma"), (129, "dp4a"),
                                         (224, "dp4a")])
def test_lstm_scan_q_route_by_hidden(hidden, want):
    """The estimator's H 124 takes the tensor-core route; every hidden size
    the wrapper takes has a route."""
    assert lstm_route(hidden) == want


@pytest.mark.parametrize("hidden,k_in,want", [
    (124, 15, "cluster"),  # the estimator's: the fp32 path's scan
    (1, 1, "cluster"), (128, 16, "cluster"), (129, 1, "block"),
    (200, 15, "block"), (1024, 16, "block")])
def test_lstm_scan_route_by_hidden(hidden, k_in, want):
    """The estimator's H 124 takes the cluster route; every hidden size and
    input width the wrapper takes has a route."""
    assert lstm_scan_route(hidden, k_in) == want
