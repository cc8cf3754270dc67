"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card (sm_90a) and nvcc; elsewhere they skip. On the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.channel import kpm, scenarios as sc
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.pso import LookupTable
from repro_torch.estimator.model import EstimatorConfig, init_estimator
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.featurize import featurize, featurize_ref
from repro_torch.kernels.lstm import (lstm_scan, lstm_scan_q,
                                      lstm_scan_q_ref, lstm_scan_ref)
from repro_torch.kernels.qmm import qmm, qmm_ref, quantize_weight
from repro_torch.kernels.quant import quantize, quantize_ref
from repro_torch.models.vgg import FULL, vgg_split_profile
from repro_torch.sim import simulate_fleet

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,length", [(128, 45), (3, 30), (7, 91)])
def test_featurize_kernel_bit_equal(card, n, length):
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.normal(size=(n, length, 15)) * 50)
                         .astype(np.float32)).to(card)
    c = torch.from_numpy(kpm.KPM_CENTER).to(card)
    s = torch.from_numpy(kpm.KPM_SCALE).to(card)
    got = featurize(x, c, s, sc.WINDOW)
    torch.cuda.synchronize()
    assert torch.equal(got, featurize_ref(x, c, s, sc.WINDOW))


@pytest.mark.parametrize("b,h", [(2048, 124), (37, 124), (5, 8), (16, 31)])
def test_lstm_kernel_matches_plain(card, b, h):
    rng = np.random.default_rng(b + h)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32)).to(card)

    x, wx, wh = t(b, 30, 15), t(15, 4 * h, scale=0.3), t(h, 4 * h, scale=0.3)
    bias = t(4 * h, scale=0.1)
    got = lstm_scan(x, wx, wh, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lstm_scan_ref(x, wx, wh, bias),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,d", [(365, 78624), (2048, 124), (496, 15),
                                 (3, 1025), (5, 4099), (1, 1)])
def test_quantize_kernel_bit_equal(card, n, d):
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy((rng.normal(size=(n, d))
                          * rng.uniform(0.01, 100.0, size=(n, 1)))
                         .astype(np.float32)).to(card)
    x[0] = 0.0  # an all-zero row: the 1e-8 scale floor
    q, s = quantize(x)
    torch.cuda.synchronize()
    rq, rs = quantize_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)


@pytest.mark.parametrize("m,n,k", [(8, 32, 15), (100, 17, 33),
                                   (257, 96, 64), (365, 124, 78624),
                                   (223, 124, 78624), (2048, 124, 124),
                                   (2048, 1, 124), (1, 1, 1)])
def test_qmm_kernel_bit_equal(card, m, n, k):
    g = torch.Generator().manual_seed(m + n + k)

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g,
                             dtype=torch.int8).to(card)

    xq, wq = codes(m, k), codes(n, k)
    sx = (torch.rand((m, 1), generator=g) + 0.01).to(card)
    sw = (torch.rand((n, 1), generator=g) + 0.01).to(card)
    got = qmm(xq, sx, wq, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, qmm_ref(xq, sx, wq, sw))


# The kernel and the plain version compute sigmoid and tanh with the
# card's libm on both sides; where an ulp differs, an int8 code of h can
# flip and carry through the later steps. Bounds as for the CPU parity of
# tests/test_torch_lstm.py: max 5e-3, at most 5% of rows beyond 1e-5.
@pytest.mark.parametrize("b,h", [(2048, 124), (37, 124), (5, 8), (16, 31)])
def test_lstm_q_kernel_matches_plain(card, b, h):
    rng = np.random.default_rng(b + h)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32)).to(card)

    x = t(b, 30, 15)
    wxq, wxs = quantize_weight(t(15, 4 * h, scale=15 ** -0.5))
    whq, whs = quantize_weight(t(h, 4 * h, scale=h ** -0.5))
    bias = t(4 * h, scale=0.1)
    got = lstm_scan_q(x, wxq, wxs, whq, whs, bias)
    torch.cuda.synchronize()
    err = (got - lstm_scan_q_ref(x, wxq, wxs, whq, whs, bias)).abs()
    assert float(err.max()) <= 5e-3
    assert float((err.amax(dim=1) > 1e-5).float().mean()) <= 0.05


def test_slice_on_card_matches_cpu(card):
    e = EstimatorConfig(n_sc=64)
    params = init_estimator(e, torch.Generator().manual_seed(0),
                            device="cpu")
    params["head"]["w2"] *= 40.0
    params["head"]["b2"] += 60.0
    names = np.asarray(sc.SCENARIOS)[np.arange(16) % 4]
    ep = sc.gen_episode_batch(names, 5, np.random.default_rng(1), n_sc=64)
    prof = vgg_split_profile(FULL)
    table = LookupTable("t", np.arange(131, dtype=np.int32) % 43,
                        np.zeros(43), np.ones(43, bool))
    cfg = ControllerConfig(0.6, 2, 3)
    gpu_params = {g: {k: v.to(card) for k, v in d.items()}
                  for g, d in params.items()}
    reset_launches()
    got = simulate_fleet(ep, table, prof, cfg, estimator=(e, gpu_params),
                         fused=True)
    assert LAUNCHES["featurize"] > 0 and LAUNCHES["lstm_scan"] > 0
    want = simulate_fleet(ep, table, prof, cfg, estimator=(e, params),
                          fused=True, device="cpu")
    np.testing.assert_allclose(got.est_tp, want.est_tp, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got.splits, want.splits)
    np.testing.assert_array_equal(got.delay_s, want.delay_s)


def test_int8_slice_on_card_matches_cpu(card):
    e = EstimatorConfig(n_sc=64)
    params = init_estimator(e, torch.Generator().manual_seed(0),
                            device="cpu")
    names = np.asarray(sc.SCENARIOS)[np.arange(16) % 4]
    ep = sc.gen_episode_batch(names, 5, np.random.default_rng(1), n_sc=64)
    prof = vgg_split_profile(FULL)
    table = LookupTable("t", np.arange(131, dtype=np.int32) % 43,
                        np.zeros(43), np.ones(43, bool))
    cfg = ControllerConfig(0.6, 2, 3)
    gpu_params = {g: {k: v.to(card) for k, v in d.items()}
                  for g, d in params.items()}
    reset_launches()
    got = simulate_fleet(ep, table, prof, cfg, estimator=(e, gpu_params),
                         fused=True, quant="int8")
    for name in ("featurize", "quantize", "qmm", "lstm_scan_q"):
        assert LAUNCHES[name] > 0, name
    assert LAUNCHES["lstm_scan"] == 0
    want = simulate_fleet(ep, table, prof, cfg, estimator=(e, params),
                          fused=True, quant="int8", device="cpu")
    # a code flipped by another order of the conv sums or by an ulp of
    # sigmoid/tanh moves an unscaled estimate by far less than 0.05 Mbps
    np.testing.assert_allclose(got.est_tp, want.est_tp, rtol=1e-3,
                               atol=0.05)
