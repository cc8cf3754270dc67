"""Port parity for rowwise int8 quantization: codes and scales bit-equal
to the JAX package's ``quantize_rows`` (its Pallas kernel in interpret
mode) on random rows, all-zero rows, a row holding -amax, exact .5 ties
after the division, and every dense weight of the estimator at the
paper's width. And the kernel's route on a card (``route``, pure
Python): every shape the repository's paths quantize reads each value
once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.estimator.model import EstimatorConfig as RefConfig
from repro.estimator.model import init_estimator as ref_init
from repro.kernels.qmm import quantize_weight as ref_quantize_weight
from repro.kernels.quant import quantize_rows as ref_quantize_rows
from repro_torch.kernels.qmm import quantize_weight
from repro_torch.kernels.quant import (BLOCK_MAX_BYTES, CLUSTER_MAX,
                                       CLUSTER_SLICE_MAX, SCALAR_MAX,
                                       WARP_MAX_BYTES, quantize, quantize_ref,
                                       quantize_rows, route)


def _assert_same(x: np.ndarray):
    want_q, want_s = map(np.asarray, ref_quantize_rows(jnp.asarray(x)))
    got_q, got_s = quantize_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    return got_q.numpy(), got_s.numpy()


def _ties(scale: np.float32) -> np.ndarray:
    """Values whose f32 division by ``scale`` is exactly k + 0.5."""
    ks = np.arange(-20, 20, dtype=np.float32) + np.float32(0.5)
    xs = ks * scale
    return xs[xs / scale == ks]


@pytest.mark.parametrize("shape,spread", [((37, 200), 1.0), ((5, 15), 50.0),
                                          ((2, 3, 124), 1e-3),
                                          ((1, 4099), 3.0)])
def test_random_rows_bit_equal(shape, spread):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * spread
         * rng.uniform(0.1, 10.0, size=shape[:-1] + (1,))).astype(np.float32)
    q, s = _assert_same(x)
    assert q.shape == shape and s.shape == shape[:-1] + (1,)


def test_zero_rows_and_negative_amax():
    x = np.zeros((4, 33), np.float32)
    x[1, :] = np.linspace(-3.0, 2.0, 33, dtype=np.float32)  # amax at -3
    x[2, 5] = -1e-12  # below the 1e-8 scale floor
    x[3, :] = -7.25
    q, s = _assert_same(x)
    assert not q[0].any() and s[0, 0] == np.float32(1e-8) * np.float32(
        1.0 / 127)
    # -amax maps to -127, not -128: the -128 clip is unreachable for the
    # symmetric scale (|x| / scale <= 127 up to one rounding)
    assert q[1].min() == -127 and q[3].min() == -127 and q.min() >= -127
    assert q[2, 5] == 0


def test_half_ties_round_to_even():
    amax = np.float32(127.0)
    scale = np.maximum(amax, np.float32(1e-8)) * np.float32(1.0 / 127)
    ties = _ties(scale)
    assert len(ties) >= 20  # the construction is not vacuous
    x = np.concatenate([[amax], ties]).astype(np.float32)[None, :]
    q, s = _assert_same(x)
    assert s[0, 0] == scale
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2
    np.testing.assert_array_equal(q[0, 1:], np.round(ties / scale))
    assert (q[0, 1:] % 2 == 0).all()


def test_estimator_weights_at_paper_width_bit_equal():
    """Every dense weight of ``EstimatorConfig()`` (the fc's 78,624 x 124
    included), quantized per output channel: ``quantize_rows(w.T)``."""
    e = RefConfig()
    tree = ref_init(e, jax.random.PRNGKey(0))
    for group, name in (("lstm", "wx"), ("lstm", "wh"), ("lstm", "proj"),
                        ("cnn", "fc"), ("head", "w1"), ("head", "w2")):
        w = tree[group][name]
        want_q, want_s = map(np.asarray, ref_quantize_weight(w))
        got_q, got_s = quantize_weight(torch.from_numpy(np.array(w)))
        np.testing.assert_array_equal(got_q.numpy(), want_q, err_msg=name)
        np.testing.assert_array_equal(got_s.numpy(), want_s, err_msg=name)
    assert got_q.shape == (1, e.hidden)  # the last: head.w2 (124, 1)


def test_cpu_wrapper_is_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(9, 31)).astype(np.float32))
    for a, b in zip(quantize(x), quantize_ref(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "rank", "contiguous", "empty",
                                 "qmax"])
def test_wrapper_rejects_malformed_input(bad):
    x = torch.ones((4, 8), dtype=torch.float32)
    if bad == "dtype":
        x = x.double()
    elif bad == "rank":
        x = x[0]
    elif bad == "contiguous":
        x = x.T
    elif bad == "empty":
        x = x[:, :0]
    with pytest.raises((TypeError, ValueError)):
        quantize(x, 128 if bad == "qmax" else 127)


F32, BF16 = torch.float32, torch.bfloat16
# every quantize of one run of the int8 path (128 UEs x 16 periods: 2048
# estimator rows, the fc in CNN passes of 365 rows) with its count: the
# six weights, rowwise per output channel, then the activations
INT8_RUN = [((496, 15), 1), ((496, 124), 1), ((124, 124), 2),
            ((124, 78624), 1), ((1, 124), 1), ((2048, 124), 3),
            ((365, 78624), 5), ((223, 78624), 1)]
# the boundary codec's rows: VGG16's activations at every split for 8
# images as NHWC channel rows (the input's 3 channels at split 0) and the
# flat ones' 8 rows; granite-8b's and mamba2-370m's bf16 boundary
# activations (4 x 4096 tokens)
VGG_BOUNDARY = [(401408, 3), (401408, 64), (100352, 64), (100352, 128),
                (25088, 128), (25088, 256), (6272, 256), (6272, 512),
                (1568, 512), (392, 512), (8, 25088), (8, 4096), (8, 1000)]
LM_BOUNDARY = [(16384, 4096), (16384, 1024)]
MAIN_ROUTES = {(496, 15): "warp_scalar", (401408, 3): "warp_scalar",
               (124, 78624): "cluster", (365, 78624): "cluster",
               (223, 78624): "cluster", (8, 25088): "block",
               (8, 4096): "block", (8, 1000): "block", (16384, 4096): "block"}


def test_int8_run_counts_fifteen_quantizes():
    assert sum(c for _, c in INT8_RUN) == 15


@pytest.mark.parametrize("shape,dtype", [(nd, F32) for nd, _ in INT8_RUN]
                         + [(nd, F32) for nd in VGG_BOUNDARY]
                         + [(nd, BF16) for nd in LM_BOUNDARY])
def test_main_path_shapes_take_a_one_read_route(shape, dtype):
    which = route(*shape, dtype)
    assert which != "two_pass"
    assert which == MAIN_ROUTES.get(shape, "warp")


@pytest.mark.parametrize("dtype,size", [(F32, 4), (BF16, 2)])
def test_route_thresholds(dtype, size):
    w = 16 // size  # values a 16-byte vector
    want = [(WARP_MAX_BYTES, "warp", "block"),
            (BLOCK_MAX_BYTES, "block", "cluster"),
            (CLUSTER_MAX * CLUSTER_SLICE_MAX, "cluster", "two_pass")]
    for top, below, above in want:
        t = top // size
        assert route(5, t, dtype) == route(5, t - w, dtype) == below
        assert route(5, t + w, dtype) == above
        # off the 16-byte grid: a value a load, up to SCALAR_MAX values
        off = "warp_scalar" if t + 1 <= SCALAR_MAX else "two_pass"
        assert route(5, t + 1, dtype) == off
        assert route(5, t, dtype, aligned=False) == (
            "warp_scalar" if t <= SCALAR_MAX else "two_pass")
    assert route(5, SCALAR_MAX, dtype, aligned=False) == "warp_scalar"
    assert route(5, SCALAR_MAX + 1, dtype) == "two_pass"
    assert route(5, w - 1, dtype) == route(5, w + 1, dtype) == "warp_scalar"
    assert route(5, w, dtype) == "warp"


# the cluster route's shortest row, the fc's and its longest, in f32: each
# of a cluster's CLUSTER_MAX blocks gets a slice of 16-byte vectors, none
# past CLUSTER_SLICE_MAX (what the C entry checks)
@pytest.mark.parametrize("d", [BLOCK_MAX_BYTES // 4 + 4, 78624,
                               CLUSTER_MAX * CLUSTER_SLICE_MAX // 4])
def test_cluster_route_rows_fill_every_block_of_a_cluster(d):
    assert route(5, d, F32) == "cluster"
    chunks = d * 4 // 16
    per = -(-chunks // CLUSTER_MAX)
    assert per * 16 <= CLUSTER_SLICE_MAX
    assert per * (CLUSTER_MAX - 1) < chunks
