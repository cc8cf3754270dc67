"""The port stands alone and says what it cannot do: importing it loads
neither JAX nor the JAX package; its entry points default to the card and
raise without one; every argument of a later slice raises; what the
reference refuses (an unknown ``quant`` mode, a scheduler without cells,
int8 or a KPM-less episode on the recurrent estimator) the port refuses
with the reference's error."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.channel import scenarios as sc
from repro_torch.core.controller import ControllerConfig, controller_init
from repro_torch.core.pso import LookupTable
from repro_torch.estimator.baselines import mlp_fit_predict
from repro_torch.estimator.model import (EstimatorConfig, estimator_forward,
                                         init_estimator)
from repro_torch.estimator.train import train_estimator, train_ssm
from repro_torch.estimator.ssm import (SSMConfig, init_ssm, ssm_forward_seq,
                                       ssm_state_init, ssm_step,
                                       ssm_warm_state)
from repro_torch.core.splitting import vgg_head, vgg_split_infer, vgg_tail
from repro_torch.models.vgg import (FULL, REDUCED, forward, init_vgg,
                                    vgg_split_profile)
from repro_torch.sim import (SchedulerConfig, cell_load,
                             coupled_interference_mw, estimate_fleet,
                             pool_init, ring_coupling, run_controllers,
                             run_scheduled, scheduler_init, simulate_cells,
                             simulate_fleet, simulate_pool)
from repro_torch.weights import (lm_cache_from_reference,
                                 lm_params_from_reference,
                                 params_from_reference,
                                 vgg_params_from_reference)
from repro_torch.configs import get_config
from repro_torch.core.splitting import lm_head, lm_split_infer, lm_tail
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_cache, init_params
from repro_torch.models import lm

SRC = Path(__file__).resolve().parents[1] / "src"
MODULES = [
    "repro_torch", "repro_torch.channel", "repro_torch.channel.iq",
    "repro_torch.channel.kpm", "repro_torch.channel.scenarios",
    "repro_torch.channel.throughput", "repro_torch.core",
    "repro_torch.core.controller", "repro_torch.core.energy",
    "repro_torch.core.objective", "repro_torch.core.profiles",
    "repro_torch.core.pso", "repro_torch.core.privacy",
    "repro_torch.core.boundary", "repro_torch.core.splitting",
    "repro_torch.models", "repro_torch.models.vgg",
    "repro_torch.kernels", "repro_torch.kernels._build",
    "repro_torch.kernels.dcor",
    "repro_torch.kernels.featurize", "repro_torch.kernels.lstm",
    "repro_torch.kernels.quant", "repro_torch.kernels.qmm",
    "repro_torch.kernels.segsum", "repro_torch.kernels.ssd",
    "repro_torch.estimator", "repro_torch.estimator.model",
    "repro_torch.estimator.serve", "repro_torch.estimator.ssm",
    "repro_torch.estimator.train", "repro_torch.estimator.baselines",
    "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.weights",
    "repro_torch.sim", "repro_torch.sim.engine", "repro_torch.sim.sched",
    "repro_torch.sim.pool",
    "repro_torch.sim.cells", "repro_torch.configs",
    "repro_torch.configs.base", "repro_torch.kernels.flash_attention",
    "repro_torch.models.blocks", "repro_torch.models.lm",
    "repro_torch.models.template", "repro_torch.launch",
    "repro_torch.launch.steps"]


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _small():
    e = EstimatorConfig(n_sc=16, lstm_hidden=8, hidden=8)
    params = init_estimator(e, torch.Generator().manual_seed(0),
                            device="cpu")
    names = np.asarray(sc.SCENARIOS)[np.arange(4) % 4]
    ep = sc.gen_episode_batch(names, 3, np.random.default_rng(0), n_sc=16)
    prof = vgg_split_profile(FULL)
    table = LookupTable("t", np.full(131, 3, np.int32), np.zeros(43),
                        np.ones(43, bool))
    return e, params, ep, prof, table, ControllerConfig(0.5, 2, 3)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, each entry point called without ``device=`` raises a
    RuntimeError that names ``device="cpu"``; nothing falls back."""
    e, params, ep, prof, table, cfg = _small()
    c = SSMConfig()
    sp = init_ssm(c, torch.Generator().manual_seed(0), device="cpu")
    grid = np.zeros((4, 3), np.int64)
    sched = SchedulerConfig("pf", fused=True)
    feats = np.zeros((2, 5, c.n_feats), np.float32)
    vp = init_vgg(REDUCED, torch.Generator().manual_seed(0), device="cpu")
    img = np.zeros((1, 32, 32, 3), np.float32)
    lcfg = get_config("granite-8b").reduced()
    lp = init_params(lcfg, torch.Generator().manual_seed(0), device="cpu")
    tok = {"tokens": np.zeros((1, 16), np.int32)}
    lcache = init_cache(lcfg, 1, 20, device="cpu")
    data = {"kpms": np.zeros((4, 30, 15), np.float32),
            "iq": np.zeros((4, 2, 16, 14), np.float32),
            "alloc": np.ones(4, np.float32), "tp": np.ones(4, np.float32)}
    sdata = {"feats": feats, "tp": np.ones((2, 2), np.float32)}
    churn = sc.make_churn_schedule(sc.ChurnConfig(arrival_rate=2.0,
                                                  max_dwell=3), 3,
                                   np.random.default_rng(0))
    sess = sc.gen_episode_batch(["cci"] * churn.n_sessions, 3,
                                np.random.default_rng(0), n_sc=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: simulate_fleet(ep, table, prof, cfg),
        lambda: simulate_fleet(ep, table, prof, cfg, estimator=(e, params)),
        lambda: estimate_fleet(ep, (e, params)),
        lambda: estimate_fleet(ep, (e, params), quant="int8"),
        lambda: run_controllers(np.zeros((2, 5), np.int32),
                                np.ones((2, 3)), cfg, -1),
        lambda: init_estimator(e, torch.Generator()),
        lambda: estimator_forward(e, params, np.zeros((1, 30, 15)),
                                  np.zeros((1, 2, 16, 14)), np.ones(1)),
        lambda: params_from_reference({"a": {"b": np.zeros(2, np.float32)}}),
        lambda: controller_init(),
        lambda: simulate_fleet(ep, table, prof, cfg, sched=sched,
                               cell_idx=grid, n_cells=2),
        lambda: simulate_cells(ep, grid, table, prof, cfg, sched=sched),
        lambda: run_scheduled(np.zeros((4, 5), np.int32), np.ones((4, 3)),
                              cfg, -1, sched, 2, grid, np.ones((4, 3))),
        lambda: scheduler_init(4),
        lambda: cell_load(grid, np.ones(4), 2, use_kernel=True),
        lambda: coupled_interference_mw(grid, np.ones(4), ring_coupling(2),
                                        use_kernel=True),
        lambda: estimate_fleet(ep, (c, sp)),
        lambda: init_ssm(c, torch.Generator()),
        lambda: ssm_state_init(c, (2,)),
        lambda: ssm_forward_seq(c, sp, feats),
        lambda: ssm_step(c, sp, np.zeros((2,) + c.state_shape(), np.float32),
                         feats[:, 0]),
        lambda: ssm_warm_state(c, sp, feats),
        lambda: init_vgg(REDUCED, torch.Generator()),
        lambda: forward(REDUCED, vp, img),
        lambda: vgg_head(REDUCED, vp, img, 5),
        lambda: vgg_tail(REDUCED, vp, np.zeros((1, 10), np.float32), 41),
        lambda: vgg_split_infer(REDUCED, vp, img, 17),
        lambda: vgg_params_from_reference(
            {"op1_b": np.zeros(2, np.float32)}),
        lambda: init_params(lcfg, torch.Generator()),
        lambda: lm.forward(lcfg, lp, tok),
        lambda: lm_head(lcfg, lp, tok, 1),
        lambda: lm_tail(lcfg, lp, torch.zeros((1, 16, 64)), tok, 1),
        lambda: lm_split_infer(lcfg, lp, tok, 1),
        lambda: lm_params_from_reference({"embed": np.zeros((2, 2),
                                                            np.float32)}),
        lambda: lm.prefill(lcfg, lp, tok, max_seq=20),
        lambda: make_prefill_step(lcfg, 20)(lp, tok),
        lambda: init_cache(lcfg, 1, 20),
        lambda: lm.decode_step(lcfg, lp, lcache, tok["tokens"][:, :1], 16),
        lambda: make_decode_step(lcfg)(lp, lcache, tok["tokens"][:, :1], 16),
        lambda: lm_cache_from_reference({"pos": np.zeros(2, np.int32)}),
        lambda: train_estimator(e, data, steps=1, batch=2),
        lambda: train_ssm(c, sdata, steps=1, batch=2),
        lambda: mlp_fit_predict(np.zeros((4, 3), np.float32), np.zeros(4),
                                np.zeros((2, 3), np.float32), steps=1),
        lambda: simulate_fleet(sess, table, prof, cfg, churn=churn,
                               capacity=4),
        lambda: simulate_pool(sess, churn, table, prof, cfg, capacity=4),
        lambda: pool_init(4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


# The cases kw3-6 to kw6-8 once asserted NotImplementedError for churn
# and capacity; the slot pool is ported, so they assert what the reference
# does: churn without capacity raises its TypeError (before any scheduler
# check), capacity without churn is ignored (``error=None``: the run equals
# the plain run). churn with online or telemetry raises for those items.
@pytest.mark.parametrize("kw,error,match", [
    ({"serving": object()}, NotImplementedError, "queue item 12"),
    ({"online": object()}, NotImplementedError, "queue item 10"),
    ({"sched": SchedulerConfig("pf")}, ValueError,
     r"a scheduler needs a \(N, T\) cell_idx"),
    ({"cell_idx": np.zeros((4, 3)), "churn": object()}, TypeError,
     "churn=... needs an explicit capacity"),
    ({"n_cells": 2, "sched": SchedulerConfig("pf"), "churn": object()},
     TypeError, "churn=... needs an explicit capacity"),
    ({"churn": object()}, TypeError, "churn=... needs an explicit capacity"),
    ({"capacity": 4}, None, None),
    ({"serving": object(), "quant": "int8"}, NotImplementedError,
     "queue item 12"),
    ({"telemetry": object()}, NotImplementedError, "queue item 11"),
    ({"online": object(), "quant": "int8"}, NotImplementedError,
     "queue item 10"),
    ({"churn": "schedule", "capacity": 4, "online": object()},
     NotImplementedError, "queue item 10"),
    ({"churn": "schedule", "capacity": 4, "telemetry": object()},
     NotImplementedError, "queue item 11")],
    ids=["kw0-12", "kw1-10", "kw2-6", "kw3-6", "kw4-6", "kw5-8", "kw6-8",
         "kw7-12", "kw8-11", "kw9-10", "churn-online-10",
         "churn-telemetry-11"])
def test_later_slices_raise(kw, error, match):
    e, params, ep, prof, table, cfg = _small()
    if kw.get("churn") == "schedule":
        kw["churn"] = sc.ChurnSchedule(
            arrival_t=np.zeros(4, np.int32), dwell=np.full(4, 3, np.int32),
            ready_end=np.full(3, 4, np.int32), horizon=3, max_admits=4)
    if error is None:
        got = simulate_fleet(ep, table, prof, cfg, estimator=(e, params),
                             device="cpu", **kw)
        plain = simulate_fleet(ep, table, prof, cfg, estimator=(e, params),
                               device="cpu")
        assert got.active is None and got.lifecycle is None
        np.testing.assert_array_equal(got.splits, plain.splits)
        np.testing.assert_array_equal(got.est_tp, plain.est_tp)
        np.testing.assert_array_equal(got.delay_s, plain.delay_s)
        return
    with pytest.raises(error, match=match):
        simulate_fleet(ep, table, prof, cfg, estimator=(e, params),
                       device="cpu", **kw)


def test_cells_without_a_scheduler_are_ignored():
    """As the reference: ``cell_idx``/``n_cells`` without ``sched`` leave
    the plain run as it is."""
    e, params, ep, prof, table, cfg = _small()
    plain = simulate_fleet(ep, table, prof, cfg, device="cpu")
    cells = simulate_fleet(ep, table, prof, cfg, cell_idx=np.ones((4, 3)),
                           n_cells=2, device="cpu")
    assert cells.prb_share is None
    np.testing.assert_array_equal(cells.splits, plain.splits)
    np.testing.assert_array_equal(cells.delay_s, plain.delay_s)


@pytest.mark.parametrize("kw,item", [
    ({"serving": object()}, "12"),
    ({"serving": object(), "quant": "int8"}, "12"),
    ({"serving": object(), "ssm": True}, "12")])
def test_estimate_fleet_later_slices_raise(kw, item):
    e, params, ep, *_ = _small()
    if kw.pop("ssm", False):
        e = SSMConfig()
        params = init_ssm(e, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match=f"queue item {item}"):
        estimate_fleet(ep, (e, params), device="cpu", **kw)


@pytest.mark.parametrize("entry", ["simulate_fleet", "estimate_fleet"])
def test_unknown_quant_mode_raises(entry):
    """As the reference's ``check_quant``: ValueError naming the modes."""
    e, params, ep, prof, table, cfg = _small()
    with pytest.raises(ValueError, match="quant must be one of"):
        if entry == "simulate_fleet":
            simulate_fleet(ep, table, prof, cfg, estimator=(e, params),
                           quant="int4", device="cpu")
        else:
            estimate_fleet(ep, (e, params), quant="int4", device="cpu")


def test_recurrent_estimator_not_ported():
    """The recurrent estimator is ported; what the reference refuses on it
    the port refuses with the reference's ValueError: int8 serving, and an
    episode without KPM reports. An unknown config type is refused."""
    _, _, ep, *_ = _small()
    c = SSMConfig()
    params = init_ssm(c, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="serves fp32 weights"):
        estimate_fleet(ep, (c, params), quant="int8", device="cpu")
    no_kpms = sc.gen_episode_batch(["cci"], 3, np.random.default_rng(0),
                                   n_sc=16, include_kpms=False)
    with pytest.raises(ValueError, match="raw KPM reports"):
        estimate_fleet(no_kpms, (c, params), device="cpu")

    class OtherConfig:
        pass

    with pytest.raises(TypeError, match="EstimatorConfig or an SSMConfig"):
        estimate_fleet(ep, (OtherConfig(), params), device="cpu")


def test_estimate_fleet_input_errors():
    e, params, ep, *_ = _small()
    no_kpms = sc.gen_episode_batch(["cci"], 3, np.random.default_rng(0),
                                   n_sc=16, include_kpms=False)
    with pytest.raises(ValueError, match="raw KPM reports"):
        estimate_fleet(no_kpms, (e, params), fused=True, device="cpu")
    no_iq = sc.gen_episode_batch(["cci"], 3, np.random.default_rng(0),
                                 n_sc=16, include_iq=False)
    with pytest.raises(ValueError, match="IQ spectrograms"):
        estimate_fleet(no_iq, (e, params), device="cpu")
