"""Port parity for distance correlation, the split-computing privacy
metric: pairwise distances against the JAX oracle and the JAX Pallas
kernel (interpret mode) at the reference's shapes, dCor and
``dcor_kernel`` against the reference's, the isometry invariance, and
``layer_privacy_profile`` on REDUCED VGG16 activations. The same numpy
inputs go to both packages."""
from collections import Counter

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
from repro_torch.kernels.dcor import (CLUSTER, MIN_SLABS, ROWS, SHORT_D,
                                      SLAB, TILE_GROUP, dcor_kernel,
                                      pairwise_dists, pairwise_dists_ref,
                                      plan, register_tiles, tile_pairs)


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


def _fit(sms):
    """Clusters that run at once on a card of ``sms`` SMs packed perfectly:
    two blocks an SM at one tile pair, one at more."""
    return lambda c, two_tiles: sms * (1 if two_tiles else 2) // c


# the launch plan the CUDA entry point checks: column ranges that cover d
# exactly once, each a whole number of staged slabs
@pytest.mark.parametrize("n,d", [(48, 3211264), (48, 150528), (48, 1000),
                                 (200, 300), (33, 70), (1, 1), (2, 33),
                                 (129, 77), (4096, 10), (48, 4096)])
@pytest.mark.parametrize("sms", [132, 1])
def test_launch_plan_covers_d(n, d, sms):
    fit = _fit(sms)
    route, tiles, chunk, splits, cluster = plan(n, d, fit)
    assert tiles == -(-n // ROWS)
    if d <= SHORT_D:  # one block a register tile, over all of d
        assert (route, chunk, splits, cluster) == ("tiles", d, 1, 1)
        return
    assert route == "splits"
    assert chunk % SLAB == 0 and chunk // SLAB >= MIN_SLABS
    # every column in exactly one split's range; only the last cluster's
    # trailing splits may hold none
    assert splits % cluster == 0 and 1 <= cluster <= CLUSTER
    assert (splits - cluster) * chunk < d <= splits * chunk
    pairs = tiles * (tiles + 1) // 2
    if cluster > 1:  # clusters of the whole grid in one wave
        assert pairs * splits // cluster <= fit(cluster, tiles > 1)
    if pairs == 1 and d >= MIN_SLABS * SLAB * 2 * sms and sms > 1:
        assert splits >= 2 * sms - CLUSTER  # two blocks an SM


def test_launch_plan_prefers_large_clusters():
    # an H100 runs 30 clusters of 8 two-block SMs at once (240 blocks),
    # 62 of 4, 132 of 2: 240 is within 90% of 264, so clusters of 8
    h100 = {8: 30, 4: 62, 2: 132}.get
    assert plan(48, 3211264, lambda c, t: h100(c)) == \
        ("splits", 1, 13440, 240, 8)
    # a card whose clusters of 8 would hold a third of the blocks
    sparse = {8: 10, 4: 62, 2: 132}.get
    assert plan(48, 3211264, lambda c, t: sparse(c))[3:] == (248, 4)
    # the profile's input (d 150,528): 224 splits of 7 slabs
    assert plan(48, 150528, lambda c, t: h100(c)) == \
        ("splits", 1, 672, 224, 8)
    # short rows take the tile route
    assert plan(48, 4096, lambda c, t: h100(c))[0] == "tiles"


@pytest.mark.parametrize("group", [8, TILE_GROUP])
@pytest.mark.parametrize("n", [1, 2, 33, 47, 48, 49, 129, 200])
def test_tiles_cover_every_pair_once(n, group):
    """The tile pairs and their register tiles (the split route's threads,
    the tile route's blocks) own each pair i <= j of rows exactly once."""
    k = ROWS // group
    owned = Counter()
    for ti, tj in tile_pairs(plan(n, 10**6, _fit(132))[1]):
        for a, b in register_tiles(ti == tj, group):
            for ii in range(group):
                for jj in range(group):
                    if ti == tj and a == b and ii > jj:
                        continue
                    i = ti * ROWS + a + k * ii
                    j = tj * ROWS + b + k * jj
                    if i < n and j < n:
                        owned[min(i, j), max(i, j)] += 1
    assert owned == Counter({(i, j): 1 for i in range(n)
                             for j in range(i, n)})
    # the split route: 21 x 12 and 36 x 7 column groups, 252 threads
    assert len(register_tiles(True)) * 12 == 252
    assert len(register_tiles(False)) * 7 == 252


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
