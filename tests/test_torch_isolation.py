"""The port stands alone and says what it cannot do: importing it loads
neither JAX nor the JAX package; its entry points default to the card and
raise without one; every argument of a later slice raises."""
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
from repro_torch.estimator.model import (EstimatorConfig, estimator_forward,
                                         init_estimator)
from repro_torch.models.vgg import FULL, vgg_split_profile
from repro_torch.sim import estimate_fleet, run_controllers, simulate_fleet
from repro_torch.weights import params_from_reference

SRC = Path(__file__).resolve().parents[1] / "src"
MODULES = [
    "repro_torch", "repro_torch.channel", "repro_torch.channel.iq",
    "repro_torch.channel.kpm", "repro_torch.channel.scenarios",
    "repro_torch.channel.throughput", "repro_torch.core",
    "repro_torch.core.controller", "repro_torch.core.energy",
    "repro_torch.core.objective", "repro_torch.core.profiles",
    "repro_torch.core.pso", "repro_torch.models", "repro_torch.models.vgg",
    "repro_torch.kernels", "repro_torch.kernels._build",
    "repro_torch.kernels.featurize", "repro_torch.kernels.lstm",
    "repro_torch.estimator", "repro_torch.estimator.model",
    "repro_torch.estimator.train", "repro_torch.weights",
    "repro_torch.sim", "repro_torch.sim.engine"]


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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: simulate_fleet(ep, table, prof, cfg),
        lambda: simulate_fleet(ep, table, prof, cfg, estimator=(e, params)),
        lambda: estimate_fleet(ep, (e, params)),
        lambda: run_controllers(np.zeros((2, 5), np.int32),
                                np.ones((2, 3)), cfg, -1),
        lambda: init_estimator(e, torch.Generator()),
        lambda: estimator_forward(e, params, np.zeros((1, 30, 15)),
                                  np.zeros((1, 2, 16, 14)), np.ones(1)),
        lambda: params_from_reference({"a": {"b": np.zeros(2, np.float32)}}),
        lambda: controller_init(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.parametrize("kw,item", [
    ({"serving": object()}, "12"), ({"online": object()}, "10"),
    ({"sched": object()}, "6"), ({"cell_idx": np.zeros((4, 3))}, "6"),
    ({"n_cells": 2}, "6"), ({"churn": object()}, "8"),
    ({"capacity": 4}, "8"), ({"quant": "int8"}, "7"),
    ({"telemetry": object()}, "11")])
def test_later_slices_raise(kw, item):
    e, params, ep, prof, table, cfg = _small()
    with pytest.raises(NotImplementedError, match=f"queue item {item}"):
        simulate_fleet(ep, table, prof, cfg, estimator=(e, params),
                       device="cpu", **kw)


@pytest.mark.parametrize("kw,item", [({"serving": object()}, "12"),
                                     ({"quant": "int8"}, "7")])
def test_estimate_fleet_later_slices_raise(kw, item):
    e, params, ep, *_ = _small()
    with pytest.raises(NotImplementedError, match=f"queue item {item}"):
        estimate_fleet(ep, (e, params), device="cpu", **kw)


def test_recurrent_estimator_not_ported():
    class SSMConfig:  # stands in for the reference's recurrent config
        pass

    _, params, ep, *_ = _small()
    with pytest.raises(NotImplementedError, match="queue item 9"):
        estimate_fleet(ep, (SSMConfig(), params), device="cpu")


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
