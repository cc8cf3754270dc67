"""Port parity for rowwise int8 quantization: codes and scales bit-equal
to the JAX package's ``quantize_rows`` (its Pallas kernel in interpret
mode) on random rows, all-zero rows, a row holding -amax, exact .5 ties
after the division, and every dense weight of the estimator at the
paper's width."""
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
from repro_torch.kernels.quant import quantize, quantize_ref, quantize_rows


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
