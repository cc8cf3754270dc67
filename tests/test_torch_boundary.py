"""Port parity for the split-boundary codec: rowwise integer codes and
scales bit-equal to the reference's at qmax 127 and 7 (its formula and its
Pallas kernel in interpret mode), the bf16 "fp16" round trip bit-equal,
the int8/int4 round trips, the transmitted bytes, and split inference
through each codec at split 17 against the reference with the same
weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundary as boundary_ref
from repro.core.splitting import vgg_split_infer as ref_split_infer
from repro.kernels.quant.kernel import quantize as ref_quant_kernel
from repro.models import vgg as vgg_ref
from repro_torch.core import boundary
from repro_torch.core.splitting import vgg_split_infer
from repro_torch.kernels.quant import quantize_rows
from repro_torch.models import vgg
from repro_torch.weights import vgg_params_from_reference

CODECS = ["FP16", "INT8", "INT4"]


def _rows(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(0.01, 1e3, size=shape[:-1]
                                              + (1,))).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0  # an all-zero row: the 1e-8 floor
    return x


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("shape", [(4, 6, 6, 16), (37, 200), (3, 4099),
                                   (2, 5, 3)])
def test_rowwise_quant_bit_equal(qmax, shape):
    x = _rows(qmax + sum(shape), shape)
    want_q, want_s = map(np.asarray, boundary_ref.rowwise_quant(
        jnp.asarray(x), qmax))
    got_q, got_s = boundary.rowwise_quant(torch.from_numpy(x), qmax)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    flat = x.reshape(-1, shape[-1])
    kq, ks = map(np.asarray, ref_quant_kernel(jnp.asarray(flat), qmax=qmax,
                                              interpret=True))
    np.testing.assert_array_equal(got_q.numpy().reshape(flat.shape), kq)
    np.testing.assert_array_equal(got_s.numpy().reshape(-1, 1), ks)
    assert not got_q.numpy().reshape(flat.shape)[0].any()
    assert got_q.min() >= -qmax - 1 and got_q.max() <= qmax


def test_int4_half_ties_round_to_even():
    """Values whose division by the qmax-7 scale is exactly k + 0.5."""
    amax = np.float32(7.0)
    scale = np.maximum(amax, np.float32(1e-8)) * np.float32(1.0 / 7)
    ks = np.arange(-7, 7, dtype=np.float32) + np.float32(0.5)
    ties = (ks * scale)[(ks * scale) / scale == ks]
    assert len(ties) >= 8
    x = np.concatenate([[amax], ties]).astype(np.float32)[None]
    q, s = quantize_rows(torch.from_numpy(x), 7)
    want_q, want_s = map(np.asarray, boundary_ref.rowwise_quant(
        jnp.asarray(x), 7))
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy(), want_s)
    assert (q.numpy()[0, 1:] % 2 == 0).all()


@pytest.mark.parametrize("codec", CODECS)
def test_roundtrip_bit_equal(codec):
    x = _rows(5, (3, 7, 7, 32)) * np.float32(1e-3)
    x[0, 0, 0, :4] = [1.0, 1.00390625, 1.01171875, -3e38]  # bf16 ties, range
    want = np.asarray(boundary_ref.roundtrip(
        jnp.asarray(x), getattr(boundary_ref, codec)))
    got = boundary.roundtrip(torch.from_numpy(x), getattr(boundary, codec))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dequantize_to_bf16_matches():
    x = _rows(9, (6, 40))
    q, s = boundary.quantize(torch.from_numpy(x), 8)
    rq, rs = boundary_ref.quantize(jnp.asarray(x), 8)
    got = boundary.dequantize(q, s).float().numpy()
    want = np.asarray(boundary_ref.dequantize(rq, rs).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", [(8, 56, 56, 256), (8, 4096), (1, 3),
                                   (2, 16, 128)])
def test_transmit_bytes_and_ratio_equal(codec, shape):
    a, b = getattr(boundary_ref, codec), getattr(boundary, codec)
    assert boundary.transmit_bytes(shape, b) == \
        boundary_ref.transmit_bytes(shape, a)
    assert (b.name, b.bits, b.ratio) == (a.name, a.bits, a.ratio)


def test_quantize_rejects_other_widths():
    with pytest.raises(ValueError, match="4 or 8 bits"):
        boundary.quantize(torch.zeros(2, 3), 6)


@pytest.fixture(scope="module")
def weights():
    tree = vgg_ref.init_vgg(vgg_ref.REDUCED, jax.random.PRNGKey(2))
    tree = {k: np.array(v) for k, v in tree.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    return tree, vgg_params_from_reference(tree, device="cpu"), x


# the split-17 activation's int8/int4 codes are bit-equal whenever the
# head's activation is; the forward's own sums differ in order (held to
# 1e-5 of an activation's magnitude in tests/test_torch_vgg.py), and the
# saturated softmax leaves the output within 1e-5
@pytest.mark.parametrize("codec", CODECS)
def test_split_infer_at_17_matches_reference(weights, codec):
    tree, params, x = weights
    want = np.asarray(ref_split_infer(vgg_ref.REDUCED, tree, jnp.asarray(x),
                                      17, getattr(boundary_ref, codec)))
    got = vgg_split_infer(vgg.REDUCED, params, x, 17,
                          getattr(boundary, codec), device="cpu").numpy()
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = vgg.forward(vgg.REDUCED, params, x, device="cpu").numpy()
    # the reference's own bar for a codec at split 17 (probabilities)
    assert np.abs(got - full).max() < 0.05
