"""Port parity for distance correlation, the split-computing privacy
metric: pairwise distances against the JAX oracle and the JAX Pallas
kernel (interpret mode) at the reference's shapes, dCor and
``dcor_kernel`` against the reference's, the isometry invariance, and
``layer_privacy_profile`` on REDUCED VGG16 activations. The same numpy
inputs go to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as privacy_ref
from repro.kernels.dcor import dcor_kernel as ref_dcor_kernel
from repro.kernels.dcor import pairwise_dists as ref_pairwise_kernel
from repro.models import vgg as vgg_ref
from repro_torch.core import privacy
from repro_torch.kernels.dcor import (BLOCKS_PER_SM, SLAB, dcor_kernel,
                                      pairwise_dists, pairwise_dists_ref,
                                      plan)


def _x(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# the reference's kernel test shapes (tests/test_kernels.py) with their
# block sizes; atol 2e-2 and rtol 1e-4 are its bar: the expansion cancels
# near the diagonal in both implementations and sqrt amplifies the residue
@pytest.mark.parametrize("n,d,bn,bd", [(64, 128, 32, 64), (100, 300, 64, 128),
                                       (33, 70, 32, 512)])
def test_pairwise_dists_match_reference(n, d, bn, bd):
    x = _x(n, d, n + d)
    got = pairwise_dists(torch.from_numpy(x)).numpy()
    oracle = np.asarray(privacy_ref.pairwise_dists(jnp.asarray(x)))
    kernel = np.asarray(ref_pairwise_kernel(jnp.asarray(x), block_n=bn,
                                            block_d=bd, interpret=True))
    np.testing.assert_allclose(got, oracle, atol=2e-2, rtol=1e-4)
    np.testing.assert_allclose(got, kernel, atol=2e-2, rtol=1e-4)
    np.testing.assert_array_equal(np.diagonal(got), np.zeros(n, np.float32))
    exact = np.linalg.norm(x[:, None].astype(np.float64) - x[None], axis=-1)
    np.testing.assert_allclose(got, exact, atol=2e-2, rtol=1e-4)


def test_cpu_wrapper_is_the_plain_version():
    x = torch.from_numpy(_x(9, 31, 3))
    assert torch.equal(pairwise_dists(x), pairwise_dists_ref(x))
    assert pairwise_dists_ref is privacy.pairwise_dists


@pytest.mark.parametrize("bad", ["dtype", "rank", "contiguous", "rows",
                                 "cols"])
def test_wrapper_rejects_malformed_input(bad):
    x = torch.ones((4, 8), dtype=torch.float32)
    x = {"dtype": x.double(), "rank": x[0], "contiguous": x.T,
         "rows": x[:0], "cols": x[:, :0]}[bad]
    with pytest.raises((TypeError, ValueError)):
        pairwise_dists(x)


# the launch plan the CUDA entry point checks: column ranges that cover d
# exactly once, each a whole number of staged slabs
@pytest.mark.parametrize("n,d", [(48, 3211264), (48, 150528), (48, 1000),
                                 (200, 300), (33, 70), (1, 1), (2, 33),
                                 (129, 77), (4096, 10), (48, 4096)])
@pytest.mark.parametrize("sms", [132, 1])
def test_launch_plan_covers_d(n, d, sms):
    tile, chunk, splits = plan(n, d, sms)
    assert tile % 16 == 0 and min(n, 128) <= tile <= 128 and tile < n + 16
    assert chunk % SLAB == 0 and chunk >= SLAB
    assert (splits - 1) * chunk < d <= splits * chunk
    tiles = -(-n // tile)
    full = BLOCKS_PER_SM * sms
    if tiles ** 2 < full and d >= full * SLAB:
        # about BLOCKS_PER_SM blocks an SM
        assert full - sms < tiles ** 2 * splits <= full


def _dcor_pair():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(48, 96)).astype(np.float32)
    y = (x @ rng.normal(size=(96, 32)) * 0.5).astype(np.float32)
    return x, y


def test_dcor_matches_reference():
    x, y = _dcor_pair()
    want = float(privacy_ref.dcor(jnp.asarray(x), jnp.asarray(y)))
    got = float(privacy.dcor(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - want) < 1e-4
    want_k = float(ref_dcor_kernel(jnp.asarray(x), jnp.asarray(y),
                                   interpret=True))
    got_k = float(dcor_kernel(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got_k - want_k) < 1e-4 and abs(got_k - want) < 1e-4


def test_dcor_isometry_invariant_and_self_is_one():
    x = np.random.default_rng(2).normal(size=(48, 6)).astype(np.float32)
    y = x[:, ::-1] + np.float32(3.0)  # permutation + shift = isometry
    xt = torch.from_numpy(x)
    assert abs(float(privacy.dcor(xt, torch.from_numpy(y.copy()))) - 1.0) \
        < 1e-4
    assert abs(float(dcor_kernel(xt, xt)) - 1.0) < 1e-5


def test_dcor_independent_is_small():
    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.normal(size=(128, 4)).astype(np.float32))
            for _ in range(2))
    assert float(privacy.dcor(x, y)) < 0.35


@pytest.fixture(scope="module")
def reduced_acts():
    """The reference's REDUCED VGG16 activations at all 43 splits for 12
    textured images (fig5's recipe, numpy), as numpy."""
    params = vgg_ref.init_vgg(vgg_ref.REDUCED, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    xs = np.cumsum(np.cumsum(rng.normal(size=(12, 32, 32, 3)), 1), 2)
    xs = (xs * 0.05).astype(np.float32)
    fwd = jax.jit(lambda p, x: vgg_ref.forward(vgg_ref.REDUCED, p, x,
                                               collect=True))
    return xs, [np.array(a) for a in fwd(params, jnp.asarray(xs))]


def test_layer_privacy_profile_matches_reference(reduced_acts):
    xs, acts = reduced_acts
    want = np.asarray(privacy_ref.layer_privacy_profile(
        jnp.asarray(xs), [jnp.asarray(a) for a in acts]))
    got = privacy.layer_privacy_profile(torch.from_numpy(xs),
                                        [torch.from_numpy(a) for a in acts])
    assert got.shape == (43,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert abs(float(got[0]) - 1.0) < 1e-5  # split 1 is the input itself
