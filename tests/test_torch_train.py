"""Port parity for offline training: the numpy dataset generators, the
``LstmScan`` gradient, the windowed estimator's loss, gradients, steps and
trainer, the recurrent estimator's losses, steps, trainer and predictions,
and the Table II baselines, each against ``repro`` on the same numpy
inputs (the reference's weights carried over with
``weights.params_from_reference``).

Tolerances, stated where they are held: gradients within 1e-5 of each
leaf's largest magnitude (the two libraries sum convolutions and products
in other orders; measured at most 1.8e-6); a loss within rtol 1e-6; one
AdamW update from the same gradients within 1e-6 of each leaf's
magnitude. A trajectory of steps (losses, parameters, histories) drifts
further: XLA's and torch's gradients round differently, and Adam's first
updates follow each element's sign, so an element whose gradient is below
the two libraries' rounding could move by up to lr either way. No element
of these seeds does: trajectories hold the losses at rtol 1e-5 and every
parameter within 1e-5 of its leaf's largest magnitude (measured: 1.5e-7
and 1.8e-6 over ten steps), a tenth of one step's largest move."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.estimator.train as ref_train
from repro.channel import scenarios as rsc
from repro.estimator import baselines as ref_base
from repro.estimator import ssm as ref_ssm
from repro.estimator.model import EstimatorConfig as RefConfig
from repro.estimator.model import init_estimator as ref_init
from repro.estimator.model import lstm_branch as ref_lstm_branch
from repro.optim import AdamW as RefAdamW
from repro_torch.channel import scenarios as sc
from repro_torch.estimator import baselines as base
from repro_torch.estimator import ssm as pssm
from repro_torch.estimator import train as pt
from repro_torch.estimator.model import EstimatorConfig
from repro_torch.kernels.lstm import LstmScan, lstm_hidden_train
from repro_torch.optim import AdamW, tree_leaves
from repro_torch.weights import params_from_reference

SMALL = dict(n_sc=16, lstm_hidden=8, hidden=8)
LR = 1e-3
TRAJ_PARAM_TOL = 1e-5
CPU = torch.device("cpu")


def _dataset(seed=0, n=10, episode_len=6):
    return sc.gen_dataset(n, np.random.default_rng(seed),
                          episode_len=episode_len, n_sc=16)


def _ref_tree(e_ref, seed=1):
    return jax.tree.map(np.asarray, ref_init(e_ref, jax.random.PRNGKey(seed)))


def _grad_close(ref_tree, port_tree, rtol=1e-5):
    for g in ref_tree:
        for k in ref_tree[g]:
            a = np.asarray(ref_tree[g][k])
            b = port_tree[g][k].numpy()
            assert a.shape == b.shape, (g, k)
            bound = rtol * max(np.abs(a).max(), 1e-30)
            assert np.abs(a - b).max() <= bound, (g, k, np.abs(a - b).max())


def _params_close(ref_tree, port_tree, tol):
    for g in ref_tree:
        for k in ref_tree[g]:
            a = np.asarray(ref_tree[g][k])
            b = port_tree[g][k].numpy()
            assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30), \
                (g, k)


# ------------------------------------------------------------ datasets
@pytest.mark.parametrize("kw", [
    dict(n_per_scenario=10, episode_len=6),
    dict(n_per_scenario=7, episode_len=4, low_load_only=True),
    dict(n_per_scenario=5, episode_len=5, scenarios=("cci", "tdd"))],
    ids=["default", "low_load", "two_scenarios"])
def test_gen_dataset_array_equal(kw):
    n = kw.pop("n_per_scenario")
    want = rsc.gen_dataset(n, np.random.default_rng(3), n_sc=16, **kw)
    got = sc.gen_dataset(n, np.random.default_rng(3), n_sc=16, **kw)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("scenario", sc.SCENARIOS)
def test_gen_episode_array_equal(scenario):
    want = rsc.gen_episode(scenario, 5, np.random.default_rng(4), n_sc=16)
    got = sc.gen_episode(scenario, 5, np.random.default_rng(4), n_sc=16)
    assert len(got) == len(want) == 5
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.kpms, a.kpms)
        np.testing.assert_array_equal(b.iq, a.iq)
        assert (b.alloc_ratio, b.tp_mbps, b.scenario, b.int_dbm) == (
            a.alloc_ratio, a.tp_mbps, a.scenario, a.int_dbm)
    np.testing.assert_array_equal(
        sc.interference_trace(scenario, 12, np.random.default_rng(5)),
        rsc.interference_trace(scenario, 12, np.random.default_rng(5)))


# ------------------------------------------------------------- LstmScan
def test_lstm_scan_gradient_matches_reference():
    """``LstmScan``'s gradient (the plain version's autograd at the saved
    inputs) against ``jax.grad`` of the reference's ``lstm_branch``."""
    rng = np.random.default_rng(6)
    b, t, k, h = 5, 30, 15, 8
    x = rng.normal(size=(b, t, k)).astype(np.float32)
    p = {"wx": rng.normal(size=(k, 4 * h)).astype(np.float32) / k ** 0.5,
         "wh": rng.normal(size=(h, 4 * h)).astype(np.float32) / h ** 0.5,
         "b": rng.normal(size=(4 * h,)).astype(np.float32) * 0.1,
         "proj": rng.normal(size=(h, 3)).astype(np.float32)}
    cot = rng.normal(size=(b, 3)).astype(np.float32)

    def ref_loss(p, x):
        return jnp.sum(ref_lstm_branch(p, x) * cot)

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = lstm_hidden_train(tx, tp["wx"], tp["wh"], tp["b"]) @ tp["proj"]
    (out * torch.from_numpy(cot)).sum().backward()
    for n in p:
        a = np.asarray(want_p[n])
        np.testing.assert_allclose(tp[n].grad.numpy(), a, rtol=0,
                                   atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-5 * np.abs(want_x).max())


def test_lstm_scan_needs_no_input_gradient():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 4, 2)).astype(np.float32))
    wx = torch.randn(2, 12, requires_grad=True)
    wh, b = torch.randn(3, 12), torch.zeros(12)
    LstmScan.apply(x, wx, wh, b).sum().backward()
    assert wx.grad is not None and x.grad is None


# ----------------------------------------------- the windowed estimator
@pytest.mark.parametrize("mask", [False, True], ids=["dropout0", "mask"])
def test_estimator_loss_and_grads_match_reference(mask):
    """``jax.value_and_grad(estimator_loss)`` against ``loss_and_grads``:
    at dropout 0, and with the reference's own ``jax.random.bernoulli``
    mask injected."""
    e_ref = RefConfig(**SMALL, dropout=0.3 if mask else 0.0)
    e = EstimatorConfig(**SMALL, dropout=0.3 if mask else 0.0)
    tree = _ref_tree(e_ref)
    data = _dataset()
    batch = {k: data[k][:8] for k in pt.BATCH_KEYS}
    key = jax.random.PRNGKey(5)
    keep = None
    if mask:
        keep = torch.from_numpy(np.array(jax.random.bernoulli(
            key, 1 - e_ref.dropout, (8, e_ref.hidden))))
        assert 0 < int(keep.sum()) < keep.numel()
    want, gref = jax.value_and_grad(lambda q: ref_train.estimator_loss(
        e_ref, q, jax.tree.map(jnp.asarray, batch), key))(tree)
    got, gport = pt.loss_and_grads(
        lambda q: pt.estimator_loss(e, q, {k: torch.from_numpy(v) for k, v
                                           in batch.items()}, keep),
        params_from_reference(tree, device="cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _grad_close(gref, gport)


def test_train_step_matches_reference():
    """One ``make_train_step`` step; and one AdamW update of the port's
    gradients through both optimizers, held tightly."""
    e_ref, e = RefConfig(**SMALL, dropout=0.0), EstimatorConfig(**SMALL,
                                                                dropout=0.0)
    tree = _ref_tree(e_ref)
    data = _dataset()
    batch = {k: data[k][3:11] for k in pt.BATCH_KEYS}
    ref_opt, opt = RefAdamW(lr=LR), AdamW(lr=LR)
    rp, _, rloss = ref_train.make_train_step(e_ref, ref_opt)(
        tree, ref_opt.init(tree), jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    params = params_from_reference(tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pp, _, loss = pt.make_train_step(e, opt)(params, opt.init(params), tb)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-6)
    _params_close(rp, pp, TRAJ_PARAM_TOL)
    # the same gradients through both optimizers
    _, grads = pt.loss_and_grads(lambda q: pt.estimator_loss(e, q, tb),
                                 params)
    gref = jax.tree.map(lambda t: jnp.asarray(t.numpy()), grads)
    rp1, _, _ = ref_opt.update(gref, ref_opt.init(tree), tree)
    pp1, _, _ = opt.update(grads, opt.init(params), params)
    _params_close(rp1, pp1, 1e-6)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8_rows"])
def test_indexed_step_trajectory_matches_reference(int8):
    """Ten ``make_indexed_step`` steps from carried weights on the same
    index draws; with ``int8``, the iq field is an int8 ``(q, scales)``
    pair, dequantized row by row in the gather."""
    e_ref, e = RefConfig(**SMALL, dropout=0.0), EstimatorConfig(**SMALL,
                                                                dropout=0.0)
    tree = _ref_tree(e_ref, seed=2)
    data = _dataset(seed=1)
    ref_data = {k: jnp.asarray(data[k]) for k in pt.BATCH_KEYS}
    port_data = pt.to_device(data, pt.BATCH_KEYS, CPU)
    if int8:
        iq = data["iq"].reshape(len(data["iq"]), -1)
        scales = (np.abs(iq).max(1, keepdims=True) / 127).astype(np.float32)
        q = np.round(iq / scales).astype(np.int8).reshape(data["iq"].shape)
        ref_data["iq"] = (jnp.asarray(q), jnp.asarray(scales))
        port_data["iq"] = (torch.from_numpy(q), torch.from_numpy(scales))
    ref_opt = RefAdamW(lr=LR, weight_decay=1e-4)
    opt = AdamW(lr=LR, weight_decay=1e-4)
    ref_step = ref_train.make_indexed_step(e_ref, ref_opt)
    step = pt.make_indexed_step(e, opt)
    rp, rs = tree, ref_opt.init(tree)
    pp = params_from_reference(tree, device="cpu")
    ps = opt.init(pp)
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    for _ in range(10):
        idx = rng.integers(0, len(data["tp"]), 8)
        rp, rs, rloss = ref_step(rp, rs, ref_data,
                                 jnp.asarray(idx, jnp.int32), key)
        pp, ps, loss = step(pp, ps, port_data, torch.from_numpy(idx))
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    _params_close(rp, pp, TRAJ_PARAM_TOL)


def test_gather_rows_dequantizes_the_selected_rows():
    q = torch.tensor([[1, -2], [3, 4], [-5, 6]], dtype=torch.int8)
    s = torch.tensor([[0.5], [2.0], [0.25]])
    idx = torch.tensor([2, 0, 2])
    want = np.asarray(jnp.take(jnp.asarray(q.numpy()), jnp.asarray(idx.numpy()),
                               axis=0), np.float32) * s.numpy()[[2, 0, 2]]
    torch.testing.assert_close(pt.gather_rows((q, s), idx),
                               torch.from_numpy(want), rtol=0, atol=0)


def test_train_estimator_history_matches_reference(monkeypatch):
    """``train_estimator`` at dropout 0 from the carried init: the same
    minibatches (``np.random.default_rng(seed)``), so the same history;
    and the same evaluation metrics."""
    e_ref, e = RefConfig(**SMALL, dropout=0.0), EstimatorConfig(**SMALL,
                                                                dropout=0.0)
    tree = _ref_tree(e_ref, seed=3)
    monkeypatch.setattr(ref_train, "init_estimator",
                        lambda e, key: jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(pt, "init_estimator",
                        lambda e, g, device: params_from_reference(
                            tree, device=device))
    data, ev = _dataset(seed=2), _dataset(seed=3, n=4, episode_len=4)
    _, want, (r2_ref, rmse_ref) = ref_train.train_estimator(
        e_ref, data, steps=12, batch=6, seed=4, log_every=5, eval_data=ev)
    _, got, (r2, rmse) = pt.train_estimator(
        e, data, steps=12, batch=6, seed=4, log_every=5, eval_data=ev,
        device="cpu")
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 5, 10, 11]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-5)
    np.testing.assert_allclose((r2, rmse), (r2_ref, rmse_ref), rtol=1e-4)


def test_train_estimator_with_dropout_learns():
    """At the default dropout the masks come from the trainer's own
    generator: the run is repeatable and its loss falls."""
    e = EstimatorConfig(**SMALL)
    data = _dataset(seed=5, n=12)
    runs = [pt.train_estimator(e, data, steps=30, batch=8, lr=3e-2,
                               log_every=29, device="cpu")[1]
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert runs[0][-1][1] < runs[0][0][1]


def test_sharded_step_not_ported():
    e = EstimatorConfig(**SMALL)
    with pytest.raises(NotImplementedError, match="queue item 12"):
        pt.make_indexed_step(e, AdamW(), mesh=object())
    with pytest.raises(NotImplementedError, match="queue item 12"):
        pt.make_indexed_step_ssm(pssm.SSMConfig(), AdamW(), mesh=object())


# ------------------------------------------------ the recurrent estimator
def _ssm_setup(seed=0, chunk=16, **kw):
    c_ref = ref_ssm.SSMConfig(chunk=chunk, **kw)
    c = pssm.SSMConfig(chunk=chunk, **kw)
    tree = jax.tree.map(np.asarray, ref_ssm.init_ssm(
        c_ref, jax.random.PRNGKey(seed)))
    return c_ref, c, tree


def _traces(rng, m, s, t, f):
    return {"feats": rng.normal(size=(m, s, f)).astype(np.float32),
            "tp": rng.uniform(5.0, 60.0, (m, t)).astype(np.float32)}


@pytest.mark.parametrize("kw", [{}, dict(forecast_horizon=2)],
                         ids=["K0", "K2"])
def test_ssm_seq_loss_and_grads_match_reference(kw):
    c_ref, c, tree = _ssm_setup(**kw)
    batch = _traces(np.random.default_rng(1), 4, 40, 10, c.n_feats)
    want, gref = jax.value_and_grad(lambda q: ref_train.ssm_seq_loss(
        c_ref, q, jax.tree.map(jnp.asarray, batch)))(tree)
    got, gport = pt.loss_and_grads(
        lambda q: pt.ssm_seq_loss(c, q, {k: torch.from_numpy(v) for k, v
                                         in batch.items()}),
        params_from_reference(tree, device="cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _grad_close(gref, gport)


def test_ssm_step_loss_and_grads_match_reference():
    """The stored-state step: the state is a constant under the gradient
    (truncated BPTT 1)."""
    c_ref, c, tree = _ssm_setup(seed=1, forecast_horizon=1)
    rng = np.random.default_rng(2)
    batch = {"state": rng.normal(size=(6,) + c.state_shape()).astype(
        np.float32),
        "feats": rng.normal(size=(6, c.n_feats)).astype(np.float32),
        "tp": rng.uniform(5.0, 60.0, 6).astype(np.float32)}
    want, gref = jax.value_and_grad(lambda q: ref_train.ssm_step_loss(
        c_ref, q, jax.tree.map(jnp.asarray, batch)))(tree)
    state = torch.from_numpy(batch["state"]).requires_grad_()
    got, gport = pt.loss_and_grads(
        lambda q: pt.ssm_step_loss(c, q, {
            "state": state, "feats": torch.from_numpy(batch["feats"]),
            "tp": torch.from_numpy(batch["tp"])}),
        params_from_reference(tree, device="cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _grad_close(gref, gport)
    assert state.grad is None


@pytest.mark.parametrize("use_kernel", [False, True])
def test_indexed_step_ssm_trajectory_matches_reference(use_kernel):
    """Ten stored-state steps; step mode never runs the ssd kernel, so the
    kernel config trains as the plain one."""
    c_ref, c, tree = _ssm_setup(seed=2, use_kernel=use_kernel)
    rng = np.random.default_rng(3)
    data = {"state": rng.normal(size=(20,) + c.state_shape()).astype(
        np.float32),
        "feats": rng.normal(size=(20, c.n_feats)).astype(np.float32),
        "tp": rng.uniform(5.0, 60.0, 20).astype(np.float32)}
    ref_opt, opt = RefAdamW(lr=LR), AdamW(lr=LR)
    ref_step = ref_train.make_indexed_step_ssm(c_ref, ref_opt)
    step = pt.make_indexed_step_ssm(c, opt)
    rp, rs = tree, ref_opt.init(tree)
    pp = params_from_reference(tree, device="cpu")
    ps = opt.init(pp)
    ref_data = {k: jnp.asarray(v) for k, v in data.items()}
    port_data = {k: torch.from_numpy(v) for k, v in data.items()}
    for _ in range(10):
        idx = rng.integers(0, 20, 6)
        rp, rs, rloss = ref_step(rp, rs, ref_data,
                                 jnp.asarray(idx, jnp.int32), None)
        pp, ps, loss = step(pp, ps, port_data, torch.from_numpy(idx))
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    _params_close(rp, pp, TRAJ_PARAM_TOL)


def test_train_ssm_history_and_predict_match_reference(monkeypatch):
    """``train_ssm`` from the carried init on the same minibatches, and
    ``ssm_predict`` on the labels' tail (a ragged last batch)."""
    c_ref, c, tree = _ssm_setup(seed=3)
    monkeypatch.setattr(ref_train, "init_ssm",
                        lambda c, key: jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(pt, "init_ssm",
                        lambda c, g, device: params_from_reference(
                            tree, device=device))
    rng = np.random.default_rng(4)
    data, ev = (_traces(rng, 12, 40, 10, c.n_feats),
                _traces(rng, 5, 40, 10, c.n_feats))
    rp, want, (r2_ref, rmse_ref) = ref_train.train_ssm(
        c_ref, data, steps=12, batch=4, log_every=3, eval_data=ev)
    pp, got, (r2, rmse) = pt.train_ssm(c, data, steps=12, batch=4,
                                        log_every=3, eval_data=ev,
                                        device="cpu")
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-5)
    np.testing.assert_allclose((r2, rmse), (r2_ref, rmse_ref), rtol=1e-4)
    # the trained parameters through both predictors, batch 2 (ragged)
    want_pred = ref_train.ssm_predict(c_ref, rp, ev, batch=2)
    got_pred = pt.ssm_predict(c, params_from_reference(
        jax.tree.map(np.asarray, rp), device="cpu"), ev, batch=2,
        device="cpu")
    assert got_pred.shape == want_pred.shape == (5, 10)
    np.testing.assert_allclose(got_pred, want_pred, rtol=1e-5, atol=1e-4)
    # the kernel config (its plain version on the CPU) predicts the same
    kern = pt.ssm_predict(dataclasses.replace(c, use_kernel=True), pp, ev,
                          device="cpu")
    np.testing.assert_allclose(kern, pt.ssm_predict(c, pp, ev, device="cpu"),
                               rtol=1e-5, atol=1e-4)


def test_sequence_training_refuses_the_ssd_kernel():
    """The reference cannot differentiate through its ssd kernel; the
    port's sequence trainers say so and name the way out."""
    c = pssm.SSMConfig(use_kernel=True)
    data = _traces(np.random.default_rng(5), 4, 40, 10, c.n_feats)
    match = "cannot differentiate through its ssd kernel.*use_kernel=False"
    with pytest.raises(ValueError, match=match):
        pt.train_ssm(c, data, steps=1, device="cpu")
    with pytest.raises(ValueError, match=match):
        pt.make_indexed_seq_step(c, AdamW())
    params = pssm.init_ssm(c, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(ValueError, match=match):
        pt.ssm_seq_loss(c, params, {k: torch.from_numpy(v)
                                    for k, v in data.items()})


# ------------------------------------------------------------ baselines
@pytest.mark.parametrize("fs", ["kpm7", "kpm15"])
def test_ridge_baseline_equals_reference(fs):
    tr, te = _dataset(seed=6), _dataset(seed=7, n=4, episode_len=4)
    xtr, xte = (base.summary_features(d["kpms"], fs) for d in (tr, te))
    np.testing.assert_array_equal(
        xtr, ref_base.summary_features(tr["kpms"], fs))
    w = base.ridge_fit(xtr, tr["tp"], lam=0.5)
    np.testing.assert_array_equal(w, ref_base.ridge_fit(xtr, tr["tp"],
                                                        lam=0.5))
    np.testing.assert_array_equal(base.ridge_predict(w, xte),
                                  ref_base.ridge_predict(w, xte))


def test_floor_baselines_equal_reference():
    rng = np.random.default_rng(8)
    ytr, yte = rng.uniform(0, 50, 30), rng.uniform(0, 50, 12)
    assert base.constant_floor(ytr, yte) == ref_base.constant_floor(ytr, yte)
    tp = rng.uniform(0, 50, (6, 9))
    for h in (1, 3, 8):
        assert base.persistence_rmse(tp, h) == ref_base.persistence_rmse(
            tp, h)
    for h in (0, 9):
        with pytest.raises(ValueError, match="horizon"):
            base.persistence_rmse(tp, h)


def test_mlp_baseline_matches_reference(monkeypatch):
    """``mlp_fit_predict`` from the reference's own init on the same
    minibatches: predictions within 1e-5 of their scale."""
    rng = np.random.default_rng(9)
    d = 12
    xtr = rng.normal(size=(80, d)).astype(np.float32)
    ytr = (xtr @ rng.normal(size=d) + 20).astype(np.float32)
    xte = rng.normal(size=(15, d)).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    init = {"w1": np.asarray(jax.random.normal(k1, (d, 64)) / np.sqrt(d)),
            "b1": np.zeros(64, np.float32),
            "w2": np.asarray(jax.random.normal(k2, (64, 1)) / np.sqrt(64)),
            "b2": np.zeros(1, np.float32)}
    monkeypatch.setattr(base, "mlp_init", lambda d, h, s: {
        k: torch.from_numpy(v.copy()) for k, v in init.items()})
    want = ref_base.mlp_fit_predict(xtr, ytr, xte, steps=60, seed=3)
    got = base.mlp_fit_predict(xtr, ytr, xte, steps=60, seed=3, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_mlp_init_is_seeded():
    a, b = base.mlp_init(5, 7, 2), base.mlp_init(5, 7, 2)
    assert [tuple(v.shape) for v in tree_leaves(a)] == [(7,), (1,), (5, 7),
                                                        (7, 1)]
    for k in a:
        assert torch.equal(a[k], b[k])
