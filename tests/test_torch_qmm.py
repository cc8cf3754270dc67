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
from repro_torch.kernels.qmm import (CLUSTER, K_TILE, TILE, int8_matmul,
                                     int_dot, plan, qmm, qmm_ref,
                                     quantize_weight)

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


# clusters of c blocks of the wgmma route that run at once: as an H100
# runs them (one block an SM, clusters of 8 within a GPC), on 114 SMs
# packed perfectly, and on a card that runs one
FITS = {"h100": {8: 15, 4: 33, 2: 66}.get, "sms114": lambda c: 114 // c,
        "one": lambda c: 1}


# the int8 path's products (chip_smoke.py's int8_shapes): the CNN fc in
# passes of 365 and 223 rows on the tensor cores, the 124-deep LSTM
# projection and head layers on dp4a
@pytest.mark.parametrize("m,n,k,route", [(365, 124, 78624, "wgmma"),
                                         (223, 124, 78624, "wgmma"),
                                         (2048, 124, 124, "dp4a"),
                                         (2048, 1, 124, "dp4a")])
def test_plan_routes_the_int8_path(m, n, k, route):
    assert plan(m, n, k, FITS["h100"])[0] == route
    # TMA needs 16-byte-aligned bases: an unaligned operand takes dp4a
    assert plan(m, n, k, FITS["h100"], aligned=False) == ("dp4a", 0, 1, 1)


def test_plan_fills_the_card_on_the_fc():
    # 3 M tiles x 5 clusters of 8 splits of 16 k tiles (the 39th 7, the
    # 40th none) = 120 blocks; 2 x 7 clusters in the 223-row pass
    assert plan(365, 124, 78624, FITS["h100"]) == ("wgmma", 16, 40, 8)
    assert plan(223, 124, 78624, FITS["h100"]) == ("wgmma", 11, 56, 8)


@pytest.mark.parametrize("m,n,k", [(365, 124, 78624), (223, 124, 78624),
                                   (1, 1, 16), (63, 200, 32),
                                   (65, 129, 78624), (5, 7, 144),
                                   (4096, 4096, 4096), (365, 124, 77184)])
@pytest.mark.parametrize("fit", sorted(FITS))
def test_plan_covers_every_k_byte_once(m, n, k, fit):
    route, per, splits, cluster = plan(m, n, k, FITS[fit])
    assert route == "wgmma" and per >= 1 and 1 <= splits <= 65535
    assert splits % cluster == 0 and cluster in (1, 2, 4, CLUSTER)
    assert TILE % cluster == 0  # the ranks split a tile's rows evenly
    cover = np.zeros(k, np.int64)
    for s in range(splits):
        lo, hi = s * per * K_TILE, min((s + 1) * per * K_TILE, k)
        cover[lo:hi] += 1
    assert (cover == 1).all()
    # only the last cluster's trailing splits may be empty
    assert (splits - cluster) * per * K_TILE < k
    tiles = -(-m // TILE) * -(-n // TILE)
    if cluster > 1:  # one wave
        assert tiles * splits // cluster <= FITS[fit](cluster)


def test_plan_can_leave_a_split_one_k_tile():
    k = K_TILE * (16 * 38 + 1)  # 609 k tiles: 38 splits of 16, then 1
    assert plan(365, 124, k, FITS["h100"]) == ("wgmma", 16, 40, 8)


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
