"""Inference helpers and metrics for the throughput estimator.

Training (the estimator loss, the AdamW step and the trainers) waits for
the training slice; this module holds what the fleet engine and an
evaluation need: ``fwd``, ``predict`` and ``r2_rmse``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.estimator.model import EstimatorConfig, estimator_forward


def r2_rmse(pred: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    pred, y = np.asarray(pred, float), np.asarray(y, float)
    ss_res = float(np.sum((pred - y) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-9
    return 1.0 - ss_res / ss_tot, float(np.sqrt(np.mean((pred - y) ** 2)))


def fwd(e: EstimatorConfig, params: dict, kpms, iq, alloc, *,
        device="cuda") -> torch.Tensor:
    """One inference forward (the fleet engine's per-chunk call)."""
    return estimator_forward(e, params, kpms, iq, alloc, device=device)


def predict(e: EstimatorConfig, params: dict, data: dict,
            batch: int | None = 64, *, device="cuda") -> np.ndarray:
    """Predicted throughput (Mbps) for every row of ``data``.

    ``batch=None`` runs the whole input through one forward pass; an int
    chunks the input to bound peak memory."""
    outs = []
    n = len(data["tp"])
    batch = max(n, 1) if batch is None else batch
    for i in range(0, n, batch):
        outs.append(fwd(e, params, data["kpms"][i:i + batch],
                        data["iq"][i:i + batch], data["alloc"][i:i + batch],
                        device=device).cpu().numpy())
    return np.concatenate(outs)
