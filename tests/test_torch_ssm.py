"""Port parity for the recurrent SSM estimator: report-stream features
equal to the reference's; the sequence pass (K = 0 and K = 3 under every
forecast policy, the ssd kernel's plain version and the plain ssd alike)
within 1e-4 of the JAX forward on weights carried by
``params_from_reference``; the forecast reduction exact; the O(1) step and
the warm state against the sequence pass; ``estimate_fleet`` with the SSM
against the JAX one."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.channel import scenarios as sc_ref
from repro.estimator import ssm as ssm_ref
from repro.sim import estimate_fleet as ref_estimate_fleet
from repro_torch.channel import scenarios as sc_t
from repro_torch.estimator import ssm
from repro_torch.sim import estimate_fleet
from repro_torch.weights import params_from_reference

W = sc_ref.WINDOW


def _cfgs(**kw):
    return ssm_ref.SSMConfig(**kw), ssm.SSMConfig(**kw)


def _params(rc, seed=0, scale_head=False):
    tree = jax.tree.map(np.array, ssm_ref.init_ssm(rc, jax.random.PRNGKey(
        seed)))
    if scale_head:
        tree["head"]["w2"] *= 40.0
        tree["head"]["b2"] += 60.0
    return tree, params_from_reference(tree, device="cpu")


def _episode(pkg, n, t, seed, n_sc=16, include_iq=False):
    names = np.asarray(sc_ref.SCENARIOS)[np.arange(n) % 4]
    return pkg.gen_episode_batch(names, t, np.random.default_rng(seed),
                                 n_sc=n_sc, include_iq=include_iq)


def test_config_and_template_match_reference():
    for kw in ({}, {"include_iq": True, "n_groups": 2, "state_dim": 4}):
        rc, c = _cfgs(**kw)
        assert dataclasses.asdict(rc) == dataclasses.asdict(c)
        assert (c.n_feats, c.state_shape(), c.state_bytes()) == (
            rc.n_feats, rc.state_shape(), rc.state_bytes())
        tmpl = ssm_ref.ssm_template(rc)
        port = ssm.ssm_template(c)
        assert tmpl.keys() == port.keys()
        for g in tmpl:
            assert tmpl[g].keys() == port[g].keys()
            for name, spec in tmpl[g].items():
                assert port[g][name] == (spec.shape, spec.init)
    with pytest.raises(ValueError, match="forecast_policy"):
        ssm.SSMConfig(forecast_policy="mean")
    with pytest.raises(ValueError, match="n_groups"):
        ssm.SSMConfig(n_heads=4, n_groups=3)
    with pytest.raises(ValueError, match="forecast_horizon"):
        ssm.SSMConfig(forecast_horizon=-1)


def test_init_ssm_is_seeded_with_the_template_kinds():
    c = ssm.SSMConfig()
    p = ssm.init_ssm(c, torch.Generator().manual_seed(3), device="cpu")
    q = ssm.init_ssm(c, torch.Generator().manual_seed(3), device="cpu")
    for g, leaves in ssm.ssm_template(c).items():
        for name, (shape, init) in leaves.items():
            t = p[g][name]
            assert tuple(t.shape) == shape and t.dtype == torch.float32
            assert torch.equal(t, q[g][name])
            if init == "zeros":
                assert not t.any()
            elif init == "ones":
                assert (t == 1).all()
            else:
                fan = shape[-2] if len(shape) >= 2 else shape[-1]
                assert 0.5 < float(t.std() * fan ** 0.5) < 1.5


def test_params_from_reference_carries_the_ssm_tree():
    rc, _ = _cfgs()
    tree, params = _params(rc)
    for g, leaves in tree.items():
        for name, arr in leaves.items():
            assert torch.equal(params[g][name], torch.from_numpy(arr))


@pytest.mark.parametrize("include_iq", [False, True])
def test_episode_features_equal_reference(include_iq):
    ep = _episode(sc_ref, 5, 4, 1, include_iq=include_iq)
    iq = ep.iq if include_iq else None
    got = ssm.episode_features(ep.kpms, ep.alloc_ratio, iq)
    want = ssm_ref.episode_features(ep.kpms, ep.alloc_ratio, iq)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if include_iq:
        np.testing.assert_array_equal(ssm.iq_features(ep.iq),
                                      ssm_ref.iq_features(ep.iq))
        with pytest.raises(ValueError, match="periods"):
            ssm.episode_features(ep.kpms[:, :W + 2], ep.alloc_ratio, ep.iq)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("k,policy", [(0, "last"), (3, "last"), (3, "min"),
                                      (3, "discount"), (0, "discount")])
def test_forward_seq_matches_reference(use_kernel, k, policy):
    rc, c = _cfgs(forecast_horizon=k, forecast_policy=policy,
                  use_kernel=use_kernel, chunk=16)
    tree, params = _params(rc, seed=k)
    feats = np.random.default_rng(k).normal(size=(3, 45, c.n_feats)).astype(
        np.float32)  # 45 steps: padded to 48 with dt = 0 rows
    want_fc, want_s = ssm_ref.ssm_forward_seq(rc, tree, feats)
    got_fc, got_s = ssm.ssm_forward_seq(c, params, feats, device="cpu")
    assert got_fc.shape == (3, 45, k + 1)
    np.testing.assert_allclose(got_fc.numpy(), np.asarray(want_fc),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(
        ssm.reduce_forecasts(c, np.asarray(want_fc)),
        ssm_ref.reduce_forecasts(rc, np.asarray(want_fc)))


@pytest.mark.parametrize("policy", ["last", "min", "discount"])
def test_reduce_forecasts_exact(policy):
    fc = np.random.default_rng(4).normal(size=(6, 9, 4)).astype(np.float32)
    for k in (0, 3):
        rc, c = _cfgs(forecast_horizon=k, forecast_policy=policy)
        got = ssm.reduce_forecasts(c, fc[..., :k + 1])
        want = ssm_ref.reduce_forecasts(rc, fc[..., :k + 1])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_step_scan_and_warm_state_match_sequence_pass():
    rc, c = _cfgs(forecast_horizon=2, forecast_policy="min", chunk=8)
    tree, params = _params(rc, seed=5)
    feats = np.random.default_rng(5).normal(size=(4, 32, c.n_feats)).astype(
        np.float32)
    fc_seq, s_seq = ssm.ssm_forward_seq(c, params, feats, device="cpu")
    state = ssm.ssm_state_init(c, (4,), device="cpu")
    for i in range(32):
        state, fc = ssm.ssm_step(c, params, state, feats[:, i], device="cpu")
        torch.testing.assert_close(fc, fc_seq[:, i], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, s_seq, rtol=1e-4, atol=1e-4)
    warm = ssm.ssm_warm_state(c, params, feats[:, :W - 1], device="cpu")
    _, s_ref = ssm_ref.ssm_forward_seq(rc, tree, feats[:, :W - 1])
    np.testing.assert_allclose(warm.numpy(),
                               np.asarray(ssm_ref.ssm_warm_state(
                                   rc, tree, feats[:, :W - 1])),
                               rtol=1e-4, atol=1e-4)
    # one step against the reference's step
    st0 = np.asarray(s_ref)
    want_s, want_fc = ssm_ref.ssm_step(rc, tree, st0, feats[:, W - 1])
    got_s, got_fc = ssm.ssm_step(c, params, torch.from_numpy(st0.copy()),
                                 feats[:, W - 1], device="cpu")
    np.testing.assert_allclose(got_fc.numpy(), np.asarray(want_fc),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(use_kernel=True, forecast_horizon=3, forecast_policy="discount"),
    dict(use_kernel=False), dict(include_iq=True, forecast_horizon=1)])
def test_estimate_fleet_ssm_matches_reference(kw):
    rc, c = _cfgs(**kw)
    tree, params = _params(rc, seed=2, scale_head=True)
    iq = kw.get("include_iq", False)
    ep_r = _episode(sc_ref, 6, 7, 9, include_iq=iq)
    ep_t = _episode(sc_t, 6, 7, 9, include_iq=iq)
    want = ref_estimate_fleet(ep_r, (rc, tree))
    got = estimate_fleet(ep_t, (c, params), device="cpu")
    assert got.shape == (6, 7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the estimates spread over many 1-Mbps buckets, not one clip value
    assert len(np.unique(np.round(got))) > 5


def test_estimate_fleet_ssm_refuses_as_the_reference():
    rc, c = _cfgs(include_iq=True)
    _, params = _params(rc)
    ep = _episode(sc_t, 2, 3, 0)  # no IQ
    with pytest.raises(ValueError, match="include_iq=True"):
        estimate_fleet(ep, (c, params), device="cpu")
    with pytest.raises(ValueError, match="fp32"):
        estimate_fleet(ep, (c, params), quant="int8", device="cpu")
