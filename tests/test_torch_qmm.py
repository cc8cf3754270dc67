"""Port parity for the int8 matrix product: ``int8_matmul`` bit-equal to
the JAX package's (its Pallas ``qmm`` in interpret mode) at the
reference's test shapes and at the CNN fc's K = 78,624; the int32
accumulators and ``qmm_ref`` bit-equal to the JAX oracle's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.kernels.qmm import int8_matmul as ref_int8_matmul
from repro.kernels.qmm import qmm_ref as ref_qmm_ref
from repro.kernels.qmm import quantize_weight as ref_quantize_weight
from repro.kernels.quant import quantize_rows as ref_quantize_rows
from repro_torch.kernels.qmm import (int8_matmul, int_dot, k_splits, qmm,
                                     qmm_ref, quantize_weight)

SHAPES = [(8, 15, 32), (100, 33, 17), (257, 64, 96), (3, 78624, 124)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (0.2 * rng.normal(size=(k, n))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_bit_equal(m, k, n):
    x, w = _operands(m, k, n, seed=m + k + n)
    wq, sw = ref_quantize_weight(jnp.asarray(w))
    want = np.asarray(ref_int8_matmul(jnp.asarray(x), wq, sw))
    twq, tsw = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(sw))
    got = int8_matmul(torch.from_numpy(x), twq, tsw)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", SHAPES[1:])
def test_accumulator_and_qmm_ref_bit_equal(m, k, n):
    x, w = _operands(m, k, n, seed=7)
    xq, sx = ref_quantize_rows(jnp.asarray(x))
    wq, sw = ref_quantize_weight(jnp.asarray(w))
    acc = lax.dot_general(xq, wq, (((1,), (1,)), ((), ())),
                          preferred_element_type=jnp.int32)
    t = [torch.from_numpy(np.array(a)) for a in (xq, sx, wq, sw)]
    got_acc = int_dot(t[0], t[2])
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc))
    np.testing.assert_array_equal(qmm_ref(*t).numpy(),
                                  np.asarray(ref_qmm_ref(xq, sx, wq, sw)))
    assert torch.equal(qmm(*t), qmm_ref(*t))  # the CPU wrapper is plain


def test_extreme_codes_are_exact():
    """All-(-128) rows against all-(-128) weights at the fc's K: the
    largest accumulator (128 * 128 * 78624 < 2**31), exact in float64."""
    k = 78624
    xq = torch.full((2, k), -128, dtype=torch.int8)
    wq = torch.full((3, k), -128, dtype=torch.int8)
    acc = int_dot(xq, wq)
    assert acc.dtype == torch.int32 and int(acc.min()) == 128 * 128 * k


def test_k_splits_fill_the_card_on_the_fc_only():
    assert k_splits(365, 124, 78624) == 22  # the fc pass: 12 tiles x 22
    assert k_splits(2048, 124, 124) == 1  # projection and head
    assert k_splits(8, 15, 32) == 1
    for m, n, k in ((365, 124, 78624), (223, 124, 78624), (1, 1, 513)):
        s = k_splits(m, n, k)
        assert 1 <= s <= -(-k // 512)


@pytest.mark.parametrize("bad", ["xq_dtype", "sx_shape", "wq_k",
                                 "contiguous", "rank"])
def test_wrapper_rejects_malformed_input(bad):
    xq = torch.zeros((4, 8), dtype=torch.int8)
    sx = torch.ones((4, 1))
    wq = torch.zeros((3, 8), dtype=torch.int8)
    sw = torch.ones((3, 1))
    if bad == "xq_dtype":
        xq = xq.float()
    elif bad == "sx_shape":
        sx = sx[:3]
    elif bad == "wq_k":
        wq = wq[:, :7]
    elif bad == "contiguous":
        xq = torch.zeros((8, 4), dtype=torch.int8).T
    else:
        xq = xq[0]
    with pytest.raises((TypeError, ValueError)):
        qmm(xq, sx, wq, sw)
