"""Port parity for the featurize stage: the plain PyTorch featurize is
bit-equal to the JAX kernel (Pallas, interpret mode) and to the numpy host
windows, and the wrapper runs it for CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channel import kpm as kpm_ref
from repro.channel import scenarios as sc_ref
from repro.kernels.featurize import kpm_feature_windows as ref_windows
from repro_torch.channel import kpm as kpm_t
from repro_torch.kernels.featurize import (featurize, featurize_ref,
                                           kpm_feature_windows)

W = sc_ref.WINDOW


def _episode(n, t, seed):
    rng = np.random.default_rng(seed)
    names = np.asarray(sc_ref.SCENARIOS)[np.arange(n) % 4]
    return sc_ref.gen_episode_batch(names, t, rng, n_sc=16, include_iq=False)


def _consts():
    return (torch.from_numpy(kpm_t.KPM_CENTER),
            torch.from_numpy(kpm_t.KPM_SCALE))


def test_kpm_affine_identical():
    for a, b in ((kpm_t.KPM_CENTER, kpm_ref.KPM_CENTER),
                 (kpm_t.KPM_SCALE, kpm_ref.KPM_SCALE)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,t,seed", [(1, 1, 0), (4, 6, 1), (9, 17, 2)])
def test_featurize_ref_bit_equal_to_reference(n, t, seed):
    ep = _episode(n, t, seed)
    want_kernel = np.array(ref_windows(
        jnp.asarray(ep.kpms), jnp.asarray(kpm_ref.KPM_CENTER),
        jnp.asarray(kpm_ref.KPM_SCALE), W))  # Pallas, interpret mode
    want_host = ep.kpm_windows(normalize=True).astype(np.float32)
    center, scale = _consts()
    got = featurize_ref(torch.from_numpy(ep.kpms), center, scale, W)
    assert got.shape == (n, t + 1, W, 15) and got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(want_kernel))
    assert torch.equal(got[:, :t], torch.from_numpy(want_host))


def test_wrapper_runs_plain_version_on_cpu():
    ep = _episode(5, 8, 3)
    center, scale = _consts()
    x = torch.from_numpy(ep.kpms)
    assert torch.equal(featurize(x, center, scale, W),
                       featurize_ref(x, center, scale, W))
    # the engine's chunk slab: a non-contiguous slice, numpy constants
    slab = x[:, 2:2 + 3 + W - 1]
    assert not slab.is_contiguous()
    assert torch.equal(
        kpm_feature_windows(slab, kpm_t.KPM_CENTER, kpm_t.KPM_SCALE, W),
        featurize_ref(slab, center, scale, W))


def test_short_trace_raises():
    center, scale = _consts()
    x = torch.zeros((2, W - 1, 15))
    with pytest.raises(ValueError, match="holds no"):
        featurize_ref(x, center, scale, W)
    with pytest.raises(ValueError, match="holds no"):
        featurize(x, center, scale, W)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape", "rank"])
def test_wrapper_rejects_malformed_input(bad):
    center, scale = _consts()
    x = torch.zeros((2, W + 3, 15))
    if bad == "dtype":
        x = x.double()
    elif bad == "contiguous":
        x = torch.zeros((2, 15, W + 3)).transpose(1, 2)
    elif bad == "shape":
        center = center[:14]
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        featurize(x, center, scale, W)
