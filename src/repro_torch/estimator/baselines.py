"""Table II baselines.

The paper compares XGBoost on 7 KPMs and on 15 KPMs against the proposed
two-branch model. The reference replaces the tree learner (xgboost is not
available offline) by (a) closed-form ridge regression and (b) a small MLP
on the same summary features: the reproduction target is the feature-set
ordering (7 KPMs < 15 KPMs < KPM time series + IQ). The numpy functions
are copies of the reference's; ``mlp_fit_predict`` trains with the port's
AdamW on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.channel.kpm import KPMS_15, KPMS_7
from repro_torch.estimator.model import full_f32
from repro_torch.estimator.train import loss_and_grads
from repro_torch.optim import AdamW

F32 = torch.float32


def summary_features(kpms: np.ndarray, feature_set: str) -> np.ndarray:
    """(B, W, 15) windows -> per-sample features: last, mean, std, delta."""
    idx = {
        "kpm7": [KPMS_15.index(k) for k in KPMS_7],
        "kpm15": list(range(len(KPMS_15))),
    }[feature_set]
    x = kpms[:, :, idx]
    feats = np.concatenate([
        x[:, -1], x.mean(1), x.std(1), x[:, -1] - x[:, 0]], axis=1)
    return feats.astype(np.float32)


def ridge_fit(X: np.ndarray, y: np.ndarray, lam: float = 1.0):
    Xb = np.concatenate([X, np.ones((len(X), 1), X.dtype)], axis=1)
    A = Xb.T @ Xb + lam * np.eye(Xb.shape[1], dtype=X.dtype)
    w = np.linalg.solve(A, Xb.T @ y)
    return w


def ridge_predict(w: np.ndarray, X: np.ndarray) -> np.ndarray:
    Xb = np.concatenate([X, np.ones((len(X), 1), X.dtype)], axis=1)
    return Xb @ w


def constant_floor(ytr: np.ndarray, yte: np.ndarray) -> float:
    """RMSE of the train-mean constant predictor: the floor any learned
    estimator must beat for its Table II row to mean anything."""
    ytr, yte = np.asarray(ytr, float), np.asarray(yte, float)
    return float(np.sqrt(np.mean((yte - ytr.mean()) ** 2)))


def persistence_rmse(tp: np.ndarray, horizon: int = 1) -> float:
    """RMSE of the persistence predictor ``est_t = tp_{t-horizon}`` over
    an (N, T) throughput trace (the first ``horizon`` periods skipped: no
    prediction exists there). The naive temporal floor the recurrent
    estimator's K-period forecasts are judged against."""
    tp = np.asarray(tp, float)
    if horizon < 1 or horizon >= tp.shape[1]:
        raise ValueError(f"horizon must be in [1, T): {horizon}")
    err = tp[:, horizon:] - tp[:, :-horizon]
    return float(np.sqrt(np.mean(err ** 2)))


def mlp_init(d: int, hidden: int, seed: int) -> dict:
    """The MLP's initial parameters, drawn on the CPU from a
    ``torch.Generator(seed)``: normal weights over sqrt(fan-in), zero
    biases (the reference's init, from another generator)."""
    g = torch.Generator().manual_seed(seed)
    return {"w1": torch.randn((d, hidden), generator=g) / np.sqrt(d),
            "b1": torch.zeros(hidden),
            "w2": torch.randn((hidden, 1), generator=g) / np.sqrt(hidden),
            "b2": torch.zeros(1)}


def _mlp(p: dict, X: torch.Tensor) -> torch.Tensor:
    h = F.relu(X @ p["w1"] + p["b1"])
    return (h @ p["w2"] + p["b2"])[:, 0]


def mlp_fit_predict(Xtr, ytr, Xte, *, hidden: int = 64, steps: int = 400,
                    seed: int = 0, device="cuda") -> np.ndarray:
    """2-layer MLP regressor (the stronger non-tree baseline): AdamW on
    minibatches of 64 rows drawn by ``np.random.default_rng(seed)``, as
    the reference; returns the predictions on ``Xte``."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in
              mlp_init(Xtr.shape[1], hidden, seed).items()}
    opt = AdamW(lr=3e-3, weight_decay=1e-4)
    st = opt.init(params)
    Xtr_d = torch.as_tensor(np.asarray(Xtr, np.float32)).to(dev)
    ytr_d = torch.as_tensor(np.asarray(ytr, np.float32)).to(dev)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(Xtr), 64)).to(dev)
        X, y = Xtr_d.index_select(0, idx), ytr_d.index_select(0, idx)
        _, g = loss_and_grads(
            lambda p: torch.mean((_mlp(p, X) - y) ** 2), params)
        params, st, _ = opt.update(g, st, params)
    with torch.no_grad(), full_f32(dev):
        Xte_d = torch.as_tensor(np.asarray(Xte, np.float32)).to(dev)
        return _mlp(params, Xte_d).cpu().numpy()
