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
from repro_torch.kernels import LAUNCHES, ROUTES, reset_launches
from repro_torch.kernels.dcor import (dcor_kernel, pairwise_dists,
                                      pairwise_dists_ref)
from repro_torch.kernels.featurize import (STAGE_MAX, featurize,
                                           featurize_ref)
from repro_torch.kernels.featurize import plan as featurize_plan
from repro_torch.kernels.featurize import _launch as _featurize_launch
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)
from repro_torch.kernels.lstm import (lstm_scan, lstm_scan_q,
                                      lstm_scan_q_ref, lstm_scan_ref)
from repro_torch.kernels.qmm import (K_TILE, card_fit, qmm, qmm_ref,
                                     quantize_weight)
from repro_torch.kernels.qmm import plan as qmm_plan
from repro_torch.kernels.lstm import MMA_MAX_HIDDEN, _launch_q, lstm_route
from repro_torch.kernels.lstm import (CLUSTER_MAX_HIDDEN, _launch,
                                      lstm_scan_route)
from repro_torch.kernels.quant import (BLOCK_MAX_BYTES, CLUSTER_MAX,
                                       CLUSTER_SLICE_MAX, SCALAR_MAX,
                                       WARP_MAX_BYTES, quantize, quantize_ref)
from repro_torch.kernels.quant import route as quant_route
from repro_torch.kernels.segsum import (empty_launch, segment_reduce_batched,
                                        segment_reduce_ref, segsum_route)
from repro_torch.kernels.segsum import _launch as _segsum_launch
from repro_torch.kernels.ssd import fused_instance, route, ssd, ssd_ref
from repro_torch.configs import get_config
from repro_torch.core import boundary
from repro_torch.core.splitting import lm_split_infer
from repro_torch.models import init_params, lm
from repro_torch.models.template import tree_map
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


def _featurize_case(card, n, length, k, seed):
    """x (n, length, k) and the KPM center and scale at K 15, random ones
    at another K."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(n, length, k)) * 50)
                         .astype(np.float32)).to(card)
    if k == 15:
        c, s = kpm.KPM_CENTER, kpm.KPM_SCALE
    else:
        c = rng.normal(size=k).astype(np.float32)
        s = rng.uniform(0.5, 9.0, k).astype(np.float32)
    return x, torch.from_numpy(c).to(card), torch.from_numpy(s).to(card)


# the path's slab, small traces, a K whose windows and UEs fall off the
# 16-byte grid (15 x 3 = 45 floats a window, 11 windows a UE), one-step
# windows, the largest staged traces (3072 values), and traces past the
# stage budget (the first version)
@pytest.mark.parametrize("n,length,k,window", [
    (128, 45, 15, 30), (3, 30, 15, 30), (7, 91, 15, 30), (5, 25, 3, 15),
    (6, 9, 5, 1), (1, 33, 1, 30), (3, STAGE_MAX // 15, 15, 30),
    (2, STAGE_MAX, 1, 7), (2, STAGE_MAX // 15 + 1, 15, 30),
    (3, STAGE_MAX + 5, 1, 30), (2, 400, 7, 30), (2, 300, 15, 210)])
def test_featurize_kernel_bit_equal(card, n, length, k, window):
    x, c, s = _featurize_case(card, n, length, k, n)
    reset_launches()
    got = featurize(x, c, s, window)
    torch.cuda.synchronize()
    which = featurize_plan(length, k)
    assert LAUNCHES["featurize"] == 1 and ROUTES["featurize"][which] == 1
    assert torch.equal(got, featurize_ref(x, c, s, window))


@pytest.mark.parametrize("which", ["staged", "generic"])
@pytest.mark.parametrize("n,length,k", [(128, 45, 15), (5, 25, 3)])
def test_featurize_routes_bit_equal(card, which, n, length, k):
    """Each route on the same staged-size traces, into an output filled
    with NaN first: every value written, bit-equal to plain."""
    x, c, s = _featurize_case(card, n, length, k, length)
    want = featurize_ref(x, c, s, 15)
    out = torch.full_like(want, float("nan"))
    _featurize_launch(x, c, s, 15, out, which)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


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


def _lstm_inputs(card, b, t, h, k=15):
    """Windows and weights at the usual LSTM scale, 1 / sqrt(fan-in), as
    the int8 scan's tests have them: with test_lstm_kernel_matches_plain's
    0.3 the random recurrence at H 200 over 64 steps is chaotic, and two
    f32 sum orders (the plain version's products, float64) drift apart by
    10^-4 and more."""
    rng = np.random.default_rng(b + 7 * t + h + k)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32)).to(card)

    return (f(b, t, k), f(k, 4 * h, scale=k ** -0.5),
            f(h, 4 * h, scale=h ** -0.5), f(4 * h, scale=0.1))


# lstm_scan on its route at the edges of a cluster's 32 rows and a block's
# 16 (batch 1, 31, 2047, 2048, 2049), one step and 64, the estimator's
# H 124, the cluster route's widest 128 and the block route's 200, with
# the bounds of test_lstm_kernel_matches_plain; at H <= 128 the block
# route on the same inputs too
@pytest.mark.parametrize("h", [124, CLUSTER_MAX_HIDDEN, 200])
@pytest.mark.parametrize("t", [1, 64])
@pytest.mark.parametrize("b", [1, 31, 2047, 2048, 2049])
def test_lstm_kernel_routes_match_plain(card, b, t, h):
    x, wx, wh, bias = _lstm_inputs(card, b, t, h)
    reset_launches()
    got = lstm_scan(x, wx, wh, bias)
    torch.cuda.synchronize()
    which = lstm_scan_route(h, 15)
    assert which == ("cluster" if h <= CLUSTER_MAX_HIDDEN else "block")
    assert LAUNCHES["lstm_scan"] == 1 and ROUTES["lstm_scan"][which] == 1
    want = lstm_scan_ref(x, wx, wh, bias)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    if which == "cluster":
        out = torch.empty_like(got)
        _launch("block", x, wx, wh, bias, out)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)


# one input feature and the most the kernel takes, on both routes
@pytest.mark.parametrize("h", [124, 200])
@pytest.mark.parametrize("k", [1, 16])
def test_lstm_kernel_input_widths_match_plain(card, k, h):
    x, wx, wh, bias = _lstm_inputs(card, 2049, 30, h, k)
    got = lstm_scan(x, wx, wh, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lstm_scan_ref(x, wx, wh, bias),
                               rtol=1e-4, atol=1e-5)


# The two routes run the same sums in the same order and the same gate
# chain: the same bits at every hidden size the cluster route takes (at
# H 1 the second block of a cluster owns no unit)
@pytest.mark.parametrize("h", [1, 8, 31, 33, 124, CLUSTER_MAX_HIDDEN])
def test_lstm_routes_bit_equal(card, h):
    x, wx, wh, bias = _lstm_inputs(card, 300, 30, h)
    outs = []
    for which in ("cluster", "block"):
        out = torch.empty((300, h), dtype=torch.float32, device=card)
        _launch(which, x, wx, wh, bias, out)
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


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
    is not 16-byte aligned: the split route's scalar loads (d 10,001) and
    the tile route (d 1,001, which loads floats alone)."""
    rng = np.random.default_rng(5)
    for d in (1001, 10001):
        base = torch.from_numpy(rng.normal(size=(40 * d + 1,))
                                .astype(np.float32)).to(card)
        x = base[1:].view(40, d)
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


def _qmm_operands(card, m, n, k, seed, fill=None):
    g = torch.Generator().manual_seed(seed)

    def codes(*shape):
        if fill is not None:
            return torch.full(shape, fill, dtype=torch.int8, device=card)
        return torch.randint(-128, 128, shape, generator=g,
                             dtype=torch.int8).to(card)

    return (codes(m, k), (torch.rand((m, 1), generator=g) + 0.01).to(card),
            codes(n, k), (torch.rand((n, 1), generator=g) + 0.01).to(card))


# the tensor-core route's edges: one M tile short or over (63, 65), the
# fc's passes (223, 365), N under, at and over one 128-wide tile, one k
# tile (16, 32 bytes: the tensor map's zero fill) and the fc's 615
@pytest.mark.parametrize("k", [16, 32, 78624])
@pytest.mark.parametrize("n", [1, 124, 129, 200])
@pytest.mark.parametrize("m", [1, 63, 65, 223, 365])
def test_qmm_tensor_core_route_bit_equal(card, m, n, k):
    xq, sx, wq, sw = _qmm_operands(card, m, n, k, m + n + k)
    assert qmm_plan(m, n, k, card_fit(card.index or 0))[0] == "wgmma"
    got = qmm(xq, sx, wq, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, qmm_ref(xq, sx, wq, sw))
    assert torch.equal(got, qmm(xq, sx, wq, sw))  # the workspace left zero


def test_qmm_split_of_one_k_tile_bit_equal(card):
    """A K whose last split with any k tile holds a single one, itself
    ragged."""
    fit = card_fit(card.index or 0)
    _, per, splits, _ = qmm_plan(365, 124, 78624, fit)
    k = K_TILE * per * (splits - 2) + 48
    route, per2, splits2, _ = qmm_plan(365, 124, k, fit)
    full = -(-k // K_TILE) // per2  # splits of per2 whole k tiles
    assert route == "wgmma" and -(-k // K_TILE) == per2 * full + 1
    xq, sx, wq, sw = _qmm_operands(card, 365, 124, k, 11)
    got = qmm(xq, sx, wq, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, qmm_ref(xq, sx, wq, sw))


def test_qmm_largest_accumulator_exact(card):
    """All -128 codes at the fc's K: every sum is 128 * 128 * 78624, the
    largest, which the splits must add exactly in int32."""
    xq, sx, wq, sw = _qmm_operands(card, 365, 124, 78624, 0, fill=-128)
    got = qmm(xq, sx, wq, sw)
    torch.cuda.synchronize()
    assert torch.equal(got, qmm_ref(xq, sx, wq, sw))
    acc = torch.full((365, 124), 128 * 128 * 78624, dtype=torch.int32,
                     device=card)
    assert torch.equal(got, acc.float() * sx * sw.T)


# tile pairs off the diagonal (n 129: three tiles, 200: five) at a d whose
# last slab of the ring is ragged (d % 96 != 0), on the ring's 16-byte
# loads (d % 4 == 0) and on the scalar loads; two calls bit-equal
@pytest.mark.parametrize("d", [96 * 37 + 52, 96 * 200 + 3])
@pytest.mark.parametrize("n", [129, 200])
def test_pairwise_dists_kernel_off_diagonal_tiles(card, n, d):
    rng = np.random.default_rng(n * d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card)
    got = pairwise_dists(x)
    again = pairwise_dists(x)
    torch.cuda.synchronize()
    want = pairwise_dists_ref(x)
    assert torch.equal(got, again) and torch.equal(got, got.T)
    assert torch.equal(torch.diagonal(got), torch.zeros(n, device=card))
    sq = (x.double() ** 2).sum(1)
    err = (got.double() ** 2 - want.double() ** 2).abs()
    assert bool((err <= 1e-4 * (sq[:, None] + sq[None, :])).all())


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


def _segsum_case(card, t, n, c, seed):
    """(t, n) values and ids in [-2, c + 2) (outside [0, c) included), the
    middle row's ids all outside where t >= 3 (every segment empty)."""
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.normal(size=(t, n)).astype(np.float32)).to(card)
    g = rng.integers(-2, c + 2, (t, n)).astype(np.int32)
    if t >= 3:
        g[t // 2] = rng.choice([-1, c], n)
    return v, torch.from_numpy(g).to(card)


def _segsum_held(got, again, want, op):
    """max bit-equal; a sum within rtol 1e-6 of plain (atol for the random
    signs' cancellation) and the same bits on a second call."""
    if op == "max":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
        assert torch.equal(got, again)


# max is exact in any order; a sum of 1024 values in another order is
# within 1e-6 relative (atol for the random-sign case's cancellation).
# Shapes: the paths' (1, 1024) and (130, 1024); each vec4 instance the
# paths run (C 4, 5) and its edges (1, 8) and the first generic C (9) at
# 4 warps a row (1024), 16 (4096), past the route (4100) and off a
# multiple of 4 (33); rows that share a block (T past the card's SMs: 10
# rows of 1 warp, 4 of 4, 2 of 8), a row's last warp part-filled (3072:
# 12 of 16 warps), one vector (4); other generic shapes
SEGSUM_SHAPES = ([(1, 1024, 4), (130, 1024, 4), (5, 200, 7), (2, 3000, 19),
                  (1400, 256, 3), (600, 1024, 4), (300, 2048, 5),
                  (200, 3072, 3), (400, 4096, 8), (1, 4, 1)]
                 + [(3, n, c) for c in (1, 4, 5, 8, 9)
                    for n in (1024, 4096, 4100, 33)])


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("t,n,c", SEGSUM_SHAPES)
def test_segsum_kernel_matches_plain(card, op, t, n, c):
    v, g = _segsum_case(card, t, n, c, t * n + c)
    reset_launches()
    got = segment_reduce_batched(v, g, c, op=op)
    torch.cuda.synchronize()
    assert LAUNCHES["segsum"] == 1
    assert ROUTES["segsum"][segsum_route(n, c)] == 1
    if t >= 3:
        assert (got[t // 2] == (0.0 if op == "sum" else float("-inf"))).all()
    _segsum_held(got, segment_reduce_batched(v, g, c, op=op),
                 segment_reduce_ref(v, g, c, op=op), op)


def test_segsum_off_the_16_byte_grid_takes_generic(card):
    """Values a view 4 bytes past an allocation: the generic route."""
    v, g = _segsum_case(card, 1, 1028, 4, 7)
    v1, g1 = v[0, 1:1025][None], g[0, 1:1025][None]
    reset_launches()
    got = segment_reduce_batched(v1, g1, 4)
    torch.cuda.synchronize()
    assert ROUTES["segsum"] == {"vec4": 0, "generic": 1}
    _segsum_held(got, segment_reduce_batched(v1, g1, 4),
                 segment_reduce_ref(v1, g1, 4), "sum")


@pytest.mark.parametrize("which", ["vec4", "generic"])
def test_segsum_vec4_launches_behind_torch_ops(card, which):
    """Each route launched right behind the torch ops that write its
    inputs (vec4 with programmatic dependent launch): it reads what they
    wrote."""
    v, g = _segsum_case(card, 1, 1024, 4, 11)
    for i in range(20):
        w = torch.clamp_min(v * (i + 1), -1.0)
        ids = torch.where(g >= 0, g, 4)
        out = torch.empty((1, 4), device=card)
        _segsum_launch(w, ids, out, "sum", which)
        torch.testing.assert_close(out, segment_reduce_ref(w, ids, 4),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("pdl", [False, True])
def test_empty_launch_runs(card, pdl):
    reset_launches()
    for _ in range(3):
        empty_launch(card, pdl)
    torch.cuda.synchronize()
    assert all(n == 0 for n in LAUNCHES.values())


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


# The fused route's calls (B, S, L, nh, hd, G, N) and the kernel of the
# route each takes (kernels/ssd::fused_instance): the cells path's call,
# batch 1 and 1025 around it, one chunk of the whole sequence, L 256 at the
# widest (hpg, hd, N) route() still sends to the fused route, the widest
# instance, and shapes of the generic kernel (hd 24 with N 12; hpg 2)
FUSED_SHAPES = [((1024, 192, 64, 4, 8, 1, 8), "4x8x8"),
                ((1, 192, 64, 4, 8, 1, 8), "4x8x8"),
                ((1025, 192, 64, 4, 8, 1, 8), "4x8x8"),
                ((3, 64, 64, 4, 8, 1, 8), "4x8x8"),
                ((2, 512, 256, 4, 16, 1, 8), "4x16x8"),
                ((2, 128, 32, 8, 32, 2, 16), "4x32x16"),
                ((2, 128, 64, 4, 24, 1, 12), "generic"),
                ((2, 256, 256, 2, 8, 1, 8), "generic")]


@pytest.mark.parametrize("shape,instance", FUSED_SHAPES)
def test_ssd_fused_route_matches_plain(card, shape, instance):
    """One launch on the fused route, y within 1e-4 and the state within
    1e-3 of the plain version (test_ssd_kernel_matches_plain's bounds)."""
    B, S, L, nh, hd, G, N = shape
    rng = np.random.default_rng(B + S + L + hd + N)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(card)

    x, Bm, Cm = t(B, S, nh, hd), t(B, S, G, N), t(B, S, G, N)
    dt = torch.nn.functional.softplus(t(B, S, nh)) * 0.5
    A = -torch.exp(t(nh) * 0.3)
    assert route(torch.float32, nh // G, hd, N, L) == "fused"
    assert fused_instance(nh // G, hd, N, L) == instance
    reset_launches()
    y, st = ssd(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    assert ROUTES["ssd"] == {"fused": 1, "chunked": 0, "chunked_wgmma": 0}
    assert LAUNCHES["ssd"] == 1
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, L)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sr, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("hd,N", [(8, 8), (24, 12)])
def test_ssd_fused_large_dt_and_padding_match_plain(card, hd, N):
    """dt = 40 (decays far below f32's range) and dt = 0 padding rows,
    as test_ssd_kernel_large_dt_and_padding_finite has them, on an
    instance and on the generic kernel: finite and within the fused
    route's bounds of the plain version, one fused launch."""
    rng = np.random.default_rng(hd + N)
    x = torch.from_numpy(rng.normal(size=(2, 128, 4, hd)).astype(np.float32)
                         ).to(card)
    bm = torch.from_numpy(rng.normal(size=(2, 128, 1, N)).astype(np.float32)
                          ).to(card)
    dt = torch.full((2, 128, 4), 40.0, device=card)
    dt[:, 100:] = 0.0
    A = -torch.ones(4, device=card)
    reset_launches()
    y, st = ssd(x, dt, A, bm, bm, chunk=64)
    torch.cuda.synchronize()
    assert ROUTES["ssd"]["fused"] == 1 and LAUNCHES["ssd"] == 1
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yr, sr = ssd_ref(x, dt, A, bm, bm, 64)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sr, rtol=1e-3, atol=1e-3)


def bf16_close(got, want):
    """Each element within one bf16 ulp of its own magnitude (the f32 sum
    runs in another order, so a rounding can flip), over a floor of 1e-5
    of the largest magnitude for elements near 0. Shared with the CPU
    tests of the ssd kernel and the SSD block."""
    err = (got.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp_min(1e-30))) - 7)
    return bool((err <= ulp + 1e-5 * want.float().abs().max()).all())


@pytest.mark.parametrize("B,S,L,nh,hd,G,N,dtype", [
    (2, 512, 512, 4, 16, 2, 16, torch.float32),
    (2, 512, 512, 4, 16, 2, 16, torch.bfloat16),
    (1, 512, 256, 32, 64, 1, 128, torch.float32),
    (1, 512, 256, 32, 64, 1, 128, torch.bfloat16),
    (2, 160, 40, 6, 24, 3, 20, torch.bfloat16),
    (1, 384, 192, 5, 80, 1, 72, torch.float32),
    (3, 256, 256, 2, 8, 1, 8, torch.bfloat16)])
def test_ssd_chunked_route_matches_plain(card, B, S, L, nh, hd, G, N, dtype):
    """The chunk-parallel routes (bf16, chunks above 256 steps, working sets
    beyond a block, ragged tiles of t, d, N and heads) against the plain
    version: the state within 1e-4 of its largest magnitude; f32 y within
    1e-4 of its largest magnitude (sums of up to L * N terms in another
    order cancel near 0), bf16 y within one bf16 ulp of each element. A
    second call repeats bit for bit. bf16 shapes whose hd, N and chunk
    are multiples of 16 take the tensor cores; f32 and the ragged bf16
    shapes the CUDA cores."""
    rng = np.random.default_rng(S + L + nh + hd)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(card)

    x, Bm, Cm = (t(B, S, nh, hd).to(dtype), t(B, S, G, N).to(dtype),
                 t(B, S, G, N).to(dtype))
    dt = torch.nn.functional.softplus(t(B, S, nh)) * 0.5
    A = -torch.exp(t(nh) * 0.3)
    tiles = dtype == torch.bfloat16 and not (hd % 16 or N % 16 or L % 16)
    want = "chunked_wgmma" if tiles else "chunked"
    assert route(dtype, nh // G, hd, N, L) == want
    reset_launches()
    y, st = ssd(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    assert ROUTES["ssd"] == {"fused": 0, "chunked": int(not tiles),
                             "chunked_wgmma": int(tiles)}
    assert LAUNCHES["ssd"] == 1
    assert y.dtype == dtype and st.dtype == torch.float32
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, L)
    if dtype == torch.float32:
        assert (y - yr).abs().max() <= 1e-4 * yr.abs().max()
    else:
        assert bf16_close(y, yr)
    assert (st - sr).abs().max() <= 1e-4 * sr.abs().max()
    y2, st2 = ssd(x, dt, A, Bm, Cm, chunk=L)
    assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.parametrize("B,S,L,nh,hd,G,N,dt_scale", [
    (4, 4096, 256, 32, 64, 1, 128, 0.5),  # the SSD LM's call (mamba2-370m)
    (2, 64, 16, 4, 32, 1, 16, 0.5),       # its reduced() configuration
    (2, 512, 64, 8, 32, 2, 16, 40.0)])    # decays far below 2^-100
def test_ssd_wgmma_route_matches_plain(card, B, S, L, nh, hd, G, N,
                                       dt_scale):
    """The tensor-core route at the SSD LM's shape, at its reduced
    configuration's and with steps of ~40, whose decays fall below 2^-100
    where the pieces stop being exact: y finite and within one bf16 ulp of
    each element of the plain version, the state within 1e-4 of its
    largest magnitude, a second call bit for bit."""
    rng = np.random.default_rng(S + L + nh + hd + int(dt_scale))

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(card)

    bf16 = torch.bfloat16
    x, Bm, Cm = (t(B, S, nh, hd).to(bf16), t(B, S, G, N).to(bf16),
                 t(B, S, G, N).to(bf16))
    dt = torch.nn.functional.softplus(t(B, S, nh)) * dt_scale
    A = -torch.exp(t(nh) * 0.3)
    assert route(bf16, nh // G, hd, N, L) == "chunked_wgmma"
    reset_launches()
    y, st = ssd(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    assert ROUTES["ssd"] == {"fused": 0, "chunked": 0, "chunked_wgmma": 1}
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yr, sr = ssd_ref(x, dt, A, Bm, Cm, L)
    assert bf16_close(y, yr)
    assert (st - sr).abs().max() <= 1e-4 * sr.abs().max()
    y2, st2 = ssd(x, dt, A, Bm, Cm, chunk=L)
    assert torch.equal(y2, y) and torch.equal(st2, st)


def test_ssd_routes_follow_shape_and_dtype(card):
    """The recurrent estimator's f32 shape takes the fused route; the same
    inputs in bf16 take the chunked one, and agree with it."""
    rng = np.random.default_rng(5)
    x, Bm, Cm = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(card) for s in ((64, 192, 4, 8), (64, 192, 1, 8),
                                     (64, 192, 1, 8)))
    dt = torch.full((64, 192, 4), 0.3, device=card)
    A = -torch.ones(4, device=card)
    assert route(torch.float32, 4, 8, 8, 64) == "fused"
    reset_launches()
    ssd(x, dt, A, Bm, Cm, chunk=64)
    yb, stb = ssd(x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16),
                  Cm.to(torch.bfloat16), chunk=64)
    torch.cuda.synchronize()
    assert ROUTES["ssd"] == {"fused": 1, "chunked": 1, "chunked_wgmma": 0}
    assert LAUNCHES["ssd"] == 2
    yr, sr = ssd_ref(x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16),
                     Cm.to(torch.bfloat16), 64)
    assert bf16_close(yb, yr)
    assert (stb - sr).abs().max() <= 1e-4 * sr.abs().max()


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


def _attention_close(got, want):
    """f32: within 1e-5 of max|o|. bf16: ``bf16_close``."""
    if want.dtype == torch.float32:
        err = (got - want).abs().max()
        return bool(err <= 1e-5 * want.abs().max())
    return bf16_close(got, want)


@pytest.mark.parametrize("bh,s,dh,dtype,causal,window", [
    (8, 256, 64, torch.float32, True, 0),
    (8, 256, 64, torch.float32, False, 8),
    (8, 256, 128, torch.float32, True, 100),
    (8, 256, 64, torch.bfloat16, True, 8),
    (8, 256, 80, torch.bfloat16, False, 0),
    (8, 256, 256, torch.bfloat16, True, 0),
    (8, 256, 256, torch.float32, True, 0),
    (4, 100, 128, torch.bfloat16, True, 0),
    (4, 16, 64, torch.float32, True, 0),
    (32, 2048, 128, torch.bfloat16, True, 1024),
    (32, 1024, 80, torch.bfloat16, False, 0)])
def test_flash_attention_kernel_matches_plain(card, bh, s, dh, dtype, causal,
                                              window):
    g = torch.Generator(device=card).manual_seed(bh + s + dh)
    q, k, v = (torch.randn((bh, s, dh), generator=g, device=card).to(dtype)
               for _ in range(3))
    reset_launches()
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert _attention_close(got, attention_ref(q, k, v, causal=causal,
                                               window=window))


@pytest.mark.parametrize("bh,s,dh,causal,window", [
    (2, 4096, 128, True, 0),
    (8, 384, 256, True, 200),
    (4, 72, 80, False, 0)], ids=["ring-wraps", "dh256-window", "dh80-ragged"])
def test_flash_attention_hopper_tiling_matches_plain(card, bh, s, dh, causal,
                                                     window):
    """The bf16 kernel's tiling: 32 kv tiles through the ring of K/V
    stages, a window narrower than the q block at dh 256 (64-row kv
    tiles), and a ragged sequence at dh 80 (columns padded to 128)."""
    g = torch.Generator(device=card).manual_seed(bh + s + dh + window)
    q, k, v = (torch.randn((bh, s, dh), generator=g, device=card).to(
        torch.bfloat16) for _ in range(3))
    reset_launches()
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _attention_close(got, attention_ref(q, k, v, causal=causal,
                                               window=window))


def test_flash_attention_kernel_refuses_other_head_dims(card):
    q = torch.zeros((2, 16, 16), device=card)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("n,d", [(16384, 4096), (37, 200), (5, 4099)])
@pytest.mark.parametrize("qmax", [127, 7])
def test_quantize_kernel_bf16_bit_equal(card, n, d, qmax):
    g = torch.Generator(device=card).manual_seed(n + d)
    x = (torch.randn((n, d), generator=g, device=card) * 7).to(
        torch.bfloat16)
    q, s = quantize(x, qmax)
    torch.cuda.synchronize()
    rq, rs = quantize_ref(x, qmax)
    assert torch.equal(q, rq) and torch.equal(s, rs)


# quantize's routes at each route's threshold of d (on the 16-byte grid: a
# vector of values below, at and above it; one value either side, off the
# grid), in f32 and bf16 and at qmax 127 and 7, from a 16-byte-aligned base
# and from one that is not (a flat buffer's element 1 on): the rows hold a
# zero row, a row whose amax is a negative value, a row of exact .5
# quotients (round half to even), and random rows of spread scales
def _route_thresholds():
    cases = []
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        w = 16 // size
        for top in (WARP_MAX_BYTES, BLOCK_MAX_BYTES,
                    CLUSTER_MAX * CLUSTER_SLICE_MAX):
            t = top // size
            cases += [(dtype, d) for d in (t - w, t, t + w, t - 1, t + 1)]
        cases += [(dtype, d) for d in (SCALAR_MAX - 1, SCALAR_MAX,
                                       SCALAR_MAX + 1)]
    return cases


def _quant_rows(card, n, d, dtype, qmax, aligned, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=card) * torch.exp2(
        torch.randint(-6, 7, (n, 1), generator=g, device=card).float())
    x[0] = 0.0
    x[1, d // 2] = -3.0 * float(x[1].abs().max()) - 1.0
    if d >= 2:  # amax qmax, so the scale is 1 or within an ulp of it, and
        # values k + 0.5: ties, or quotients within 2^-16 of one
        ks = np.arange(d - 1) % (2 * qmax) - qmax + 0.5
        x[2] = torch.from_numpy(np.concatenate([[qmax], ks]).astype(
            np.float32))
    x = x.to(dtype)
    if aligned:
        return x
    buf = torch.empty(n * d + 8, dtype=dtype, device=card)
    out = buf[1:1 + n * d].view(n, d)
    out.copy_(x)
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("dtype,d", _route_thresholds())
def test_quantize_routes_at_thresholds_bit_equal(card, dtype, d, qmax,
                                                 aligned):
    n = 5 if d * 4 <= 4 * 2**20 else 3
    x = _quant_rows(card, n, d, dtype, qmax, aligned, d + qmax)
    reset_launches()
    q, s = quantize(x, qmax)
    torch.cuda.synchronize()
    rq, rs = quantize_ref(x, qmax)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    which = quant_route(n, d, dtype, x.data_ptr() % 16 == 0)
    assert LAUNCHES["quantize"] == 1 and ROUTES["quantize"][which] == 1
    assert aligned or which in ("warp_scalar", "two_pass")


# the fc's passes and its weight, in f32 and bf16, on the cluster route,
# with the special rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [124, 223])
def test_quantize_cluster_route_bit_equal(card, n, dtype):
    d = 78624
    x = _quant_rows(card, n, d, dtype, 127, True, n)
    assert quant_route(n, d, dtype) == "cluster"
    reset_launches()
    q, s = quantize(x, 127)
    torch.cuda.synchronize()
    rq, rs = quantize_ref(x, 127)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert LAUNCHES["quantize"] == 1 and ROUTES["quantize"]["cluster"] == 1


# a row past the cluster route's reach takes the two-pass route
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_two_pass_route_bit_equal(card, dtype):
    d = CLUSTER_MAX * CLUSTER_SLICE_MAX // 2 + 8
    x = _quant_rows(card, 3, d, dtype, 127, True, 7)
    assert quant_route(3, d, dtype) == "two_pass"
    q, s = quantize(x)
    torch.cuda.synchronize()
    rq, rs = quantize_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)


# lstm_scan_q at the edges of a block's 16 rows (batch 1, 2047, 2048), one
# step and 64, on the tensor-core route (hidden 124) and the CUDA-core one
# (224), with the bounds of test_lstm_q_kernel_matches_plain
@pytest.mark.parametrize("h", [124, 224])
@pytest.mark.parametrize("t", [1, 64])
@pytest.mark.parametrize("b", [1, 2047, 2048])
def test_lstm_q_kernel_routes_match_plain(card, b, t, h):
    rng = np.random.default_rng(b + t + h)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32)).to(card)

    x = f(b, t, 15)
    wxq, wxs = quantize_weight(f(15, 4 * h, scale=15 ** -0.5))
    whq, whs = quantize_weight(f(h, 4 * h, scale=h ** -0.5))
    bias = f(4 * h, scale=0.1)
    reset_launches()
    got = lstm_scan_q(x, wxq, wxs, whq, whs, bias)
    torch.cuda.synchronize()
    assert ROUTES["lstm_scan_q"][lstm_route(h)] == 1
    err = (got - lstm_scan_q_ref(x, wxq, wxs, whq, whs, bias)).abs()
    assert float(err.max()) <= 5e-3
    assert float((err.amax(dim=1) > 1e-5).float().mean()) <= 0.05


# The two routes sum the same int32 products and run the same f32 chain:
# the same bits at every hidden size the tensor-core route takes
@pytest.mark.parametrize("h", [1, 8, 31, 33, 124, MMA_MAX_HIDDEN])
def test_lstm_q_routes_bit_equal(card, h):
    rng = np.random.default_rng(h)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32)).to(card)

    x = f(300, 30, 15)
    wxq, wxs = quantize_weight(f(15, 4 * h, scale=15 ** -0.5))
    whq, whs = quantize_weight(f(h, 4 * h, scale=h ** -0.5))
    bias = f(4 * h, scale=0.1)
    outs = []
    for which in ("mma", "dp4a"):
        out = torch.empty((300, h), dtype=torch.float32, device=card)
        _launch_q(which, x, wxq, wxs, whq, whs, bias, out)
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_lm_slice_on_card_matches_cpu(card):
    """granite-8b reduced with its head dim at 64 (a kernel head dim), bf16
    weights copied bit for bit: split inference through each codec on the
    card (the kernel, 2 launches a run) against the port on the CPU."""
    cfg = get_config("granite-8b").reduced(head_dim=64)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.bfloat16)
    gpu = tree_map(lambda t: t.to(card), cpu)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)).astype(np.int32)}
    for codec in (boundary.FP16, boundary.INT8, boundary.INT4):
        reset_launches()
        got = lm_split_infer(cfg, gpu, batch, 1, codec)
        assert LAUNCHES["flash_attention"] == cfg.n_layers
        assert LAUNCHES["quantize"] == (codec.bits < 16)
        want = lm_split_infer(cfg, cpu, batch, 1, codec, device="cpu")
        err = (got.cpu().float() - want.float()).abs().max()
        assert err <= 0.05 * want.float().abs().max(), codec
    full = lm.forward(cfg, gpu, batch, logits_mode="last")
    assert torch.equal(full, lm_split_infer(cfg, gpu, batch, 1))


def test_ssd_lm_slice_on_card_matches_cpu(card):
    """mamba2-370m reduced, bf16 weights copied bit for bit: split
    inference through each codec on the card (the tensor-core ssd route,
    one call a layer) against the port on the CPU, and the XLA route on the
    card against the kernel route."""
    cfg = get_config("mamba2-370m").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.bfloat16)
    gpu = tree_map(lambda t: t.to(card), cpu)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)}
    for codec in (boundary.FP16, boundary.INT8, boundary.INT4):
        reset_launches()
        got = lm_split_infer(cfg, gpu, batch, 1, codec)
        assert LAUNCHES["ssd"] == cfg.n_layers
        assert ROUTES["ssd"]["chunked_wgmma"] == cfg.n_layers
        assert LAUNCHES["quantize"] == (codec.bits < 16)
        assert LAUNCHES["flash_attention"] == 0
        want = lm_split_infer(cfg, cpu, batch, 1, codec, device="cpu")
        err = (got.cpu().float() - want.float()).abs().max()
        assert err <= 0.05 * want.float().abs().max(), codec
    full = lm.forward(cfg, gpu, batch, logits_mode="last")
    assert torch.equal(full, lm_split_infer(cfg, gpu, batch, 1))
    off = lm.forward(cfg, gpu, batch, logits_mode="last", use_kernel=False)
    assert ((off.float() - full.float()).abs().max()
            <= 0.05 * full.float().abs().max())


@pytest.mark.parametrize("b,h", [(24, 124), (7, 8)])
def test_lstm_scan_function_gradient_on_card(card, b, h):
    """``LstmScan`` on the card: the kernel forward (one launch, counted)
    and the backward through the plain version, against the plain
    version's own autograd on the same inputs."""
    from repro_torch.kernels.lstm import lstm_hidden_train
    rng = np.random.default_rng(b + h)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(
            np.float32)).to(card).requires_grad_()

    x, wx, wh = t(b, 30, 15), t(15, 4 * h, scale=0.3), t(h, 4 * h, scale=0.3)
    bias = t(4 * h, scale=0.1)
    cot = torch.randn((b, h), device=card)
    reset_launches()
    out = lstm_hidden_train(x, wx, wh, bias)
    grads = torch.autograd.grad((out * cot).sum(), (x, wx, wh, bias))
    assert LAUNCHES["lstm_scan"] == 1
    want = torch.autograd.grad((lstm_scan_ref(x, wx, wh, bias) * cot).sum(),
                               (x, wx, wh, bias))
    for g, w in zip(grads, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_train_step_on_card_matches_cpu(card):
    """One estimator training step at a small width from one init and one
    injected mask: loss, gradients and the updated parameters on the card
    against the port on the CPU."""
    from repro_torch.estimator.train import (BATCH_KEYS, estimator_loss,
                                             loss_and_grads, to_device)
    from repro_torch.optim import AdamW, tree_leaves
    e = EstimatorConfig(n_sc=64, lstm_hidden=16, hidden=16)
    cpu_p = init_estimator(e, torch.Generator().manual_seed(0), device="cpu")
    gpu_p = tree_map(lambda v: v.to(card), cpu_p)
    data = sc.gen_dataset(4, np.random.default_rng(0), episode_len=4,
                          n_sc=64)
    keep = torch.rand((8, e.hidden), generator=torch.Generator()
                      .manual_seed(1)) < 1 - e.dropout
    out = {}
    for dev, p in (("cpu", cpu_p), ("cuda", gpu_p)):
        batch = {k: v[:8] for k, v in to_device(data, BATCH_KEYS,
                                                torch.device(dev)).items()}
        out[dev] = loss_and_grads(
            lambda q: estimator_loss(e, q, batch, keep.to(dev)), p)
    assert abs(float(out["cuda"][0]) - float(out["cpu"][0])) <= 1e-5 * float(
        out["cpu"][0])
    # of each leaf's largest magnitude (a conv weight's gradient measured
    # 1.6e-5 on an H100, its f32 sums in another order than the CPU's)
    for g, w in zip(tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1])):
        assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()
    opt = AdamW(lr=1e-3)
    new_gpu, _, _ = opt.update(out["cuda"][1], opt.init(gpu_p), gpu_p)
    new_cpu, _, _ = opt.update(tree_map(lambda v: v.cpu(), out["cuda"][1]),
                               opt.init(cpu_p), cpu_p)
    for a, b in zip(tree_leaves(new_gpu), tree_leaves(new_cpu)):
        assert (a.cpu() - b).abs().max() <= 1e-6 * max(b.abs().max(), 1e-3)


def test_pool_on_card_matches_cpu(card):
    """A churned pool with the pf scheduler on the segsum kernel, one
    launch a period: splits and lifecycle equal to the CPU's."""
    schedule = sc.make_churn_schedule(
        sc.ChurnConfig(arrival_rate=16.0, mean_dwell=3.0,
                       diurnal_amplitude=0.25), 20, np.random.default_rng(0))
    sessions = sc.gen_episode_batch(
        np.asarray(sc.SCENARIOS)[np.arange(schedule.n_sessions) % 4],
        schedule.max_dwell, np.random.default_rng(1), include_iq=False,
        include_kpms=False)
    prof = vgg_split_profile(FULL)
    table = LookupTable("t", np.where(np.arange(131) > 20, 3, 10).astype(
        np.int32), np.zeros(43), np.ones(43, bool))
    cfg = ControllerConfig(0.5, 2, 3)
    cell = np.arange(schedule.n_sessions) % 4
    kw = dict(churn=schedule, capacity=48, cell_idx=cell, n_cells=4,
              sched=SchedulerConfig("pf", fused=True))
    reset_launches()
    got = simulate_fleet(sessions, table, prof, cfg, **kw)
    assert LAUNCHES["segsum"] == schedule.horizon
    want = simulate_fleet(sessions, table, prof, cfg, device="cpu", **kw)
    np.testing.assert_array_equal(got.splits, want.splits)
    np.testing.assert_array_equal(got.active, want.active)
    np.testing.assert_array_equal(got.lifecycle.admit_latency,
                                  want.lifecycle.admit_latency)
