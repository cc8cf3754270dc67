"""int8 estimator serving: quantized weights, integer products, f32 out.

``quantize_estimator`` quantizes every dense weight of the estimator
(LSTM input and recurrent weights, LSTM projection, CNN fc, both head
layers) rowwise per output channel into an (int8 (OUT, IN), f32 (OUT, 1))
pair; biases and the two 3x3 conv filters stay f32. ``fwd_int8`` then
serves the forward through the int8 kernels: the ``lstm_scan_q`` scan for
the temporal branch and ``int8_matmul`` (the ``quantize`` and ``qmm``
kernels) for every dense product. The convolutions run in full f32, as on
the fp32 path.

The tree keeps the reference's names, and a quantized leaf is a tuple, as
the reference's ``quantize_estimator`` tree is (``repro_torch.weights
.qparams_from_reference`` carries one across).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.estimator.model import (EstimatorConfig, as_f32, cat_rows,
                                         check_params_device, conv_trunk,
                                         full_f32)
from repro_torch.kernels.lstm import lstm_hidden_q
from repro_torch.kernels.qmm import int8_matmul, quantize_weight

QUANT_MODES = (None, "int8")


def check_quant(quant) -> None:
    """Validate a ``quant=`` argument (shared by every serving entry)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}: {quant!r}")


def quantize_estimator(params: dict) -> dict:
    """f32 estimator params -> the int8 serving tree, on the params'
    device (the weights are quantized there, by the ``quantize`` kernel on
    a card)."""
    lstm, cnn, head = params["lstm"], params["cnn"], params["head"]
    q = quantize_weight
    return {
        "lstm": {"wx": q(lstm["wx"]), "wh": q(lstm["wh"]), "b": lstm["b"],
                 "proj": q(lstm["proj"])},
        "cnn": {"conv1": cnn["conv1"], "b1": cnn["b1"],
                "conv2": cnn["conv2"], "b2": cnn["b2"], "fc": q(cnn["fc"]),
                "fcb": cnn["fcb"]},
        "head": {"w1": q(head["w1"]), "b1": head["b1"], "w2": q(head["w2"]),
                 "b2": head["b2"]},
    }


def estimator_forward_int8(e: EstimatorConfig, qparams: dict, kpms, iq,
                           alloc, *, device="cuda") -> torch.Tensor:
    """The serving forward on a ``quantize_estimator`` tree: predicted
    max throughput in Mbps, shape (B,), on ``device``.

    Mirrors ``estimator_forward`` with every dense product through the
    int8 kernels, in the reference's order of operations. The CNN trunk
    runs in the fp32 path's byte-capped row passes; each pass's output is
    quantized and multiplied by the int8 ``fc``."""
    dev = resolve_device(device)
    check_params_device(qparams, dev)
    kpms, iq, alloc = (as_f32(a, dev) for a in (kpms, iq, alloc))
    lq, cq, hq = qparams["lstm"], qparams["cnn"], qparams["head"]
    with torch.inference_mode(), full_f32(dev):
        h = lstm_hidden_q(kpms, *lq["wx"], *lq["wh"], lq["b"])
        v_t = int8_matmul(h, *lq["proj"])
        v_s = cat_rows([F.relu(int8_matmul(x, *cq["fc"]) + cq["fcb"])
                        for x in conv_trunk(cq, iq)])
        w = alloc.clamp(0.0, 1.0)[:, None]
        fused = w * v_t + (1.0 - w) * v_s
        hh = F.relu(int8_matmul(fused, *hq["w1"]) + hq["b1"])
        out = int8_matmul(hh, *hq["w2"]) + hq["b2"]
    return out[:, 0]


def fwd_int8(e: EstimatorConfig, qparams: dict, kpms, iq, alloc, *,
             device="cuda") -> torch.Tensor:
    """One int8 inference forward (the fleet engine's per-chunk call)."""
    return estimator_forward_int8(e, qparams, kpms, iq, alloc,
                                  device=device)


def predict_int8(e: EstimatorConfig, qparams: dict, data: dict,
                 batch: int | None = 64, *, device="cuda") -> np.ndarray:
    """int8 twin of ``estimator.train.predict``: Mbps for every row."""
    outs = []
    n = len(data["tp"])
    batch = max(n, 1) if batch is None else batch
    for i in range(0, n, batch):
        outs.append(fwd_int8(e, qparams, data["kpms"][i:i + batch],
                             data["iq"][i:i + batch],
                             data["alloc"][i:i + batch],
                             device=device).cpu().numpy())
    return np.concatenate(outs)
