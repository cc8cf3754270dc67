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
from repro_torch.kernels.featurize import (STAGE_MAX, featurize,
                                           featurize_ref,
                                           kpm_feature_windows, plan)

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


@pytest.mark.parametrize("length,k,want", [
    (45, 15, "staged"), (3 + W - 1, 15, "staged"), (91, 15, "staged"),
    (STAGE_MAX // 15, 15, "staged"), (STAGE_MAX, 1, "staged"),
    (STAGE_MAX // 3, 3, "staged"),
    # past the budget: the first version
    (STAGE_MAX // 15 + 1, 15, "generic"), (400, 15, "generic"),
    (STAGE_MAX + 1, 1, "generic"), (STAGE_MAX // 3 + 1, 3, "generic"),
    (3000, 2, "generic")])
def test_plan_stages_traces_within_the_budget(length, k, want):
    """A UE's (L, K) trace of up to STAGE_MAX values is staged in shared
    memory by one block; a longer one takes the first version."""
    assert plan(length, k) == want
    assert (want == "staged") == (length * k <= STAGE_MAX)


@pytest.mark.parametrize("n,length,k,window", [
    (128, 45, 15, W), (3, 40, 3, W), (2, 300, 15, W), (4, 9, 5, 1)])
def test_wrapper_runs_plain_version_on_cpu_at_route_shapes(n, length, k,
                                                           window):
    """On CPU tensors the wrapper is the plain version for traces of
    either route, outputs on and off the 16-byte grid."""
    rng = np.random.default_rng(n + length)
    x = torch.from_numpy((rng.normal(size=(n, length, k)) * 50)
                         .astype(np.float32))
    c = torch.from_numpy(rng.normal(size=k).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 9.0, k).astype(np.float32))
    got = featurize(x, c, s, window)
    assert got.shape == (n, length - window + 1, window, k)
    assert torch.equal(got, featurize_ref(x, c, s, window))


@pytest.mark.parametrize("bad,match", [
    ("center_dtype", "center must be float32"),
    ("scale_device", "scale is on"), ("device", "no featurize kernel")])
def test_wrapper_raises_on_constants_and_devices(bad, match):
    center, scale = _consts()
    x = torch.zeros((2, W + 3, 15))
    if bad == "center_dtype":
        center = center.double()
    elif bad == "scale_device":
        scale = scale.to("meta")
    else:
        x, center, scale = x.to("meta"), center.to("meta"), scale.to("meta")
    with pytest.raises((TypeError, ValueError), match=match):
        featurize(x, center, scale, W)
