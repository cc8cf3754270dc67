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
from repro_torch.core.privacy import layer_privacy_profile
from repro_torch.estimator.ssm import SSMConfig, init_ssm
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.dcor import (dcor_kernel, pairwise_dists,
                                      pairwise_dists_ref)
from repro_torch.kernels.featurize import featurize, featurize_ref
from repro_torch.kernels.lstm import (lstm_scan, lstm_scan_q,
                                      lstm_scan_q_ref, lstm_scan_ref)
from repro_torch.kernels.qmm import qmm, qmm_ref, quantize_weight
from repro_torch.kernels.quant import quantize, quantize_ref
from repro_torch.kernels.segsum import (segment_reduce_batched,
                                        segment_reduce_ref)
from repro_torch.kernels.ssd import ssd, ssd_ref
from repro_torch.models.vgg import (FULL, REDUCED, forward, init_vgg,
                                    vgg_split_profile)
from repro_torch.sim import (SchedulerConfig, attach_ring,
                             build_cells_episode, handover_grid,
                             ring_coupling, simulate_cells, simulate_fleet)

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


# the boundary codec's rows: NHWC channel rows of VGG16 activations at
# a few splits (8 images) and a flat fc row; qmax 7 is the INT4 codec
@pytest.mark.parametrize("qmax", [7, 127])
@pytest.mark.parametrize("n,d", [(8 * 224 * 224, 64), (8 * 56 * 56, 256),
                                 (8 * 7 * 7, 512), (8, 4096), (8, 25088),
                                 (5, 3)])
def test_quantize_kernel_qmax_bit_equal(card, qmax, n, d):
    rng = np.random.default_rng(n + d + qmax)
    x = torch.from_numpy((rng.normal(size=(n, d))
                          * rng.uniform(0.01, 100.0, size=(n, 1)))
                         .astype(np.float32)).to(card)
    x[0] = 0.0
    q, s = quantize(x, qmax)
    torch.cuda.synchronize()
    rq, rs = quantize_ref(x, qmax)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert int(q.min()) >= -qmax - 1 and int(q.max()) <= qmax


# The kernel sums x_i . x_j in its own order (a split of d across blocks,
# FP32 FMAs) and the plain version through cuBLAS: squared distances agree
# to 1e-4 of the rows' squared norms, the scale of the terms that cancel.
@pytest.mark.parametrize("n,d", [(48, 150528), (48, 3211264), (48, 802816),
                                 (48, 25088), (48, 4096), (48, 1000),
                                 (200, 300), (33, 70), (64, 128), (100, 300),
                                 (129, 77), (1, 5), (2, 1)])
def test_pairwise_dists_kernel_matches_plain(card, n, d):
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                         + np.float32(0.5)).to(card)
    got = pairwise_dists(x)
    torch.cuda.synchronize()
    want = pairwise_dists_ref(x)
    assert torch.equal(torch.diagonal(got), torch.zeros(n, device=card))
    assert torch.equal(got, got.T)  # x_i . x_j and x_j . x_i round alike
    assert torch.equal(got, pairwise_dists(x))  # no atomics
    sq = (x.double() ** 2).sum(1)
    err = (got.double() ** 2 - want.double() ** 2).abs()
    assert bool((err <= 1e-4 * (sq[:, None] + sq[None, :])).all())


def test_pairwise_dists_kernel_odd_alignment(card):
    """A row pitch that is not a multiple of four floats, and a base that
    is not 16-byte aligned, take the scalar loads."""
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.normal(size=(40 * 1001 + 1,))
                            .astype(np.float32)).to(card)
    x = base[1:].view(40, 1001)
    got = pairwise_dists(x)
    torch.cuda.synchronize()
    want = pairwise_dists_ref(x)
    sq = (x.double() ** 2).sum(1)
    err = (got.double() ** 2 - want.double() ** 2).abs()
    assert bool((err <= 1e-4 * (sq[:, None] + sq[None, :])).all())


def test_split_slice_on_card_matches_cpu(card):
    """REDUCED VGG16 forward, the measured 43-split dCor profile through
    the kernel, and its plain profile: card against the port on the
    CPU."""
    params = init_vgg(REDUCED, torch.Generator().manual_seed(0),
                      device="cpu")
    gparams = {k: v.to(card) for k, v in params.items()}
    rng = np.random.default_rng(0)
    xs = np.cumsum(np.cumsum(rng.normal(size=(16, 32, 32, 3)), 1), 2)
    xs = (xs * 0.05).astype(np.float32)
    acts = forward(REDUCED, gparams, xs, collect=True)
    cacts = forward(REDUCED, params, xs, collect=True, device="cpu")
    x = torch.from_numpy(xs).to(card)
    reset_launches()
    got = torch.stack([dcor_kernel(x.reshape(16, -1), a.reshape(16, -1))
                       for a in acts])
    assert LAUNCHES["pairwise_dists"] == 86
    plain = layer_privacy_profile(x, acts)
    cpu = layer_privacy_profile(torch.from_numpy(xs), cacts)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), atol=1e-4)


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


# max is exact in any order; a sum of 1024 values in another order is
# within 1e-6 relative (atol for the random-sign case's cancellation)
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("t,n,c", [(1, 1024, 4), (130, 1024, 4),
                                   (5, 200, 7), (3, 33, 1), (2, 3000, 19)])
def test_segsum_kernel_matches_plain(card, op, t, n, c):
    rng = np.random.default_rng(t * n + c)
    v = torch.from_numpy(rng.normal(size=(t, n)).astype(np.float32)).to(card)
    g = torch.from_numpy(rng.integers(-2, c + 2, (t, n)).astype(np.int32)
                         ).to(card)  # ids outside [0, c) included
    got = segment_reduce_batched(v, g, c, op=op)
    torch.cuda.synchronize()
    want = segment_reduce_ref(v, g, c, op=op)
    if op == "max":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
        assert torch.equal(got, segment_reduce_batched(v, g, c, op=op))


@pytest.mark.parametrize("B,S,L,nh,hd,G,N", [
    (1024, 192, 64, 4, 8, 1, 8), (2, 64, 16, 4, 16, 1, 8),
    (2, 128, 32, 8, 32, 2, 16), (2, 96, 96, 2, 8, 1, 4),
    (3, 256, 256, 2, 8, 1, 8)])
def test_ssd_kernel_matches_plain(card, B, S, L, nh, hd, G, N):
    rng = np.random.default_rng(S + L + nh)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(card)

    x, Bm, Cm = t(B, S, nh, hd), t(B, S, G, N), t(B, S, G, N)
    dt = torch.nn.functional.softplus(t(B, S, nh)) * 0.5
    A = -torch.exp(t(nh) * 0.3)
    y, st = ssd(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, L)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sr, rtol=1e-3, atol=1e-3)


def test_ssd_kernel_large_dt_and_padding_finite(card):
    """dt = 40 drives the decay to 0 without overflow; dt = 0 rows (the
    padding to a chunk multiple) leave the state as it is."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 128, 4, 8)).astype(np.float32)
                         ).to(card)
    bm = torch.from_numpy(rng.normal(size=(2, 128, 1, 8)).astype(np.float32)
                          ).to(card)
    dt = torch.full((2, 128, 4), 40.0, device=card)
    dt[:, 100:] = 0.0
    A = -torch.ones(4, device=card)
    y, st = ssd(x, dt, A, bm, bm, chunk=64)
    y100, st100 = ssd(x[:, :100].contiguous(), dt[:, :100].contiguous(), A,
                      bm[:, :100].contiguous(), bm[:, :100].contiguous(),
                      chunk=100)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(st, st100, rtol=1e-4, atol=1e-4)


def test_cells_ssm_slice_on_card_matches_cpu(card):
    n, T, C = 64, 12, 4
    rng = np.random.default_rng(3)
    grid = handover_grid(attach_ring(n, C), T + sc.WINDOW, 0.25, rng,
                         n_cells=C)
    names = np.asarray(sc.SCENARIOS)[np.arange(n) % 4]
    ep = build_cells_episode(names, T, rng, grid, coupling=ring_coupling(C))
    c = SSMConfig(use_kernel=True, forecast_horizon=3,
                  forecast_policy="discount")
    params = init_ssm(c, torch.Generator().manual_seed(0), device="cpu")
    params["head"]["w2"] *= 40.0
    params["head"]["b2"] += 60.0
    gpu = {g: {k: v.to(card) for k, v in d.items()}
           for g, d in params.items()}
    prof = vgg_split_profile(FULL)
    table = LookupTable("t", np.arange(131, dtype=np.int32) % 43,
                        np.zeros(43), np.ones(43, bool))
    cfg = ControllerConfig(0.6, 2, 3)
    sched = SchedulerConfig("pf", fused=True)
    reset_launches()
    got = simulate_cells(ep, grid, table, prof, cfg, sched=sched,
                         n_cells=C, estimator=(c, gpu))
    assert LAUNCHES["ssd"] == 1 and LAUNCHES["segsum"] == T
    want = simulate_cells(ep, grid, table, prof, cfg, sched=sched,
                          n_cells=C, estimator=(c, params), device="cpu")
    np.testing.assert_allclose(got.fleet.prb_share, want.fleet.prb_share,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.fleet.est_tp, want.fleet.est_tp,
                               rtol=1e-4, atol=1e-4)
    assert (got.fleet.splits == want.fleet.splits).mean() >= 0.99
