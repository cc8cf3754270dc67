"""AI-based throughput estimator (paper Fig. 3 + Table I).

Branch 1: LSTM (hidden 124, window 30) over the 15 numerical KPMs, run by
the ``lstm_scan`` kernel (``lstm_branch``; in training through its
autograd Function ``LstmScan``).
Branch 2: CNN over the (2, 273*12, 14) IQ spectrogram:
    conv3x3(16) - relu - maxpool2 - conv3x3(32) - relu - maxpool2 -
    flatten - linear(hidden) - relu - dropout (training only)
Fusion: weighted sum with w = allocated-PRB ratio, then an FC head.

``forward_core`` is the differentiable forward. ``estimator_forward``
runs it for inference (``torch.inference_mode``, full f32 on the card);
``estimator_forward_train`` runs it with autograd on, the LSTM branch
through ``LstmScan`` and dropout from an explicit keep mask.

Parameters are a nested dict of tensors with the reference's names,
shapes and layouts (``estimator_template``): conv weights HWIO, and the
rows of ``cnn.fc`` in the (h, w, c) order of an NHWC flatten, so a
reference parameter tree carries over as it is (``repro_torch.weights``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.kernels.lstm import lstm_hidden, lstm_hidden_train

F32 = torch.float32

# Rows per CNN pass, bounded by the bytes of the first conv's f32 output
# (the largest activation: c1 * n_sc * n_sym * 4 B a row, 2.9 MB at the
# paper's width). Each row's result depends on that row alone, so the split
# changes a number only as far as a product blocked for another row count
# rounds differently (last bits of f32).
CNN_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    n_kpms: int = 15
    window: int = 30
    lstm_hidden: int = 124
    hidden: int = 124
    n_sc: int = 3276
    n_sym: int = 14
    cnn_ch: tuple = (16, 32)
    dropout: float = 0.1

    @property
    def cnn_flat(self) -> int:
        return self.cnn_ch[1] * (self.n_sc // 4) * (self.n_sym // 4)


def estimator_template(e: EstimatorConfig) -> dict:
    """{group: {name: (shape, init)}}: the reference's parameter leaves."""
    c1, c2 = e.cnn_ch
    h = e.lstm_hidden
    return {
        "lstm": {
            "wx": ((e.n_kpms, 4 * h), "fan_in"),
            "wh": ((h, 4 * h), "fan_in"),
            "b": ((4 * h,), "zeros"),
            "proj": ((h, e.hidden), "fan_in"),
        },
        "cnn": {
            "conv1": ((3, 3, 2, c1), "fan_in"),
            "b1": ((c1,), "zeros"),
            "conv2": ((3, 3, c1, c2), "fan_in"),
            "b2": ((c2,), "zeros"),
            "fc": ((e.cnn_flat, e.hidden), "fan_in"),
            "fcb": ((e.hidden,), "zeros"),
        },
        "head": {
            "w1": ((e.hidden, e.hidden), "fan_in"),
            "b1": ((e.hidden,), "zeros"),
            "w2": ((e.hidden, 1), "fan_in"),
            "b2": ((1,), "zeros"),
        },
    }


def init_estimator(e: EstimatorConfig, generator: torch.Generator, *,
                   device="cuda") -> dict:
    """Random parameters: fan-in normal (std 1/sqrt(shape[-2]) for a
    matrix or an HWIO kernel, as the reference's template init) and zero
    biases. Drawn on the CPU from ``generator``, so a seed gives the same
    weights on every device, then moved to ``device``."""
    dev = resolve_device(device)
    params = {}
    for group, leaves in estimator_template(e).items():
        params[group] = {}
        for name, (shape, init) in leaves.items():
            if init == "zeros":
                t = torch.zeros(shape, dtype=F32)
            else:
                fan = shape[-2] if len(shape) >= 2 else shape[-1]
                t = torch.randn(shape, generator=generator, dtype=F32) \
                    / max(fan, 1) ** 0.5
            params[group][name] = t.to(dev)
    return params


def lstm_branch(p: dict, kpms: torch.Tensor,
                train: bool = False) -> torch.Tensor:
    """kpms: (B, T, K) -> (B, hidden), through the ``lstm_scan`` kernel
    (``train``: through ``LstmScan``, which has a gradient)."""
    scan = lstm_hidden_train if train else lstm_hidden
    return scan(kpms, p["wx"], p["wh"], p["b"]) @ p["proj"]


def conv_trunk(p: dict, iq: torch.Tensor):
    """The conv/pool trunk of the CNN branch, in byte-capped row passes:
    yields, pass by pass, the (rows, cnn_flat) f32 input of the ``fc``
    layer for consecutive rows of ``iq`` (B, 2, S, 14). Shared by the fp32
    ``cnn_branch`` and the int8 serving forward, which runs ``fc``
    quantized.

    The reference convolves NHWC with HWIO kernels; NCHW with the kernels
    permuted to OIHW is the same sum. "SAME" 3x3 at stride 1 is padding 1;
    the 2x2 max pool floors (3276 -> 1638 -> 819, 14 -> 7 -> 3). The
    flatten is channels-last, matching the rows of ``fc``."""
    c1 = p["conv1"].shape[-1]
    per_row = 4 * c1 * iq.shape[2] * iq.shape[3]
    step = max(1, CNN_CHUNK_BYTES // per_row)
    w1 = p["conv1"].permute(3, 2, 0, 1)
    w2 = p["conv2"].permute(3, 2, 0, 1)
    for r0 in range(0, iq.shape[0], step):
        x = iq[r0:r0 + step]
        for w, b in ((w1, p["b1"]), (w2, p["b2"])):
            x = F.max_pool2d(F.relu(F.conv2d(x, w, b, padding=1)), 2)
        yield x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def cat_rows(outs: list) -> torch.Tensor:
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def cnn_branch(p: dict, iq: torch.Tensor, keep=None,
               rate: float = 0.0) -> torch.Tensor:
    """iq: (B, 2, S, 14) -> (B, hidden). With a (B, hidden) bool ``keep``
    mask and ``rate`` > 0, dropout after the fc's relu as the
    reference's: ``x * keep / (1 - rate)``."""
    x = cat_rows([F.relu(x @ p["fc"] + p["fcb"]) for x in conv_trunk(p, iq)])
    if keep is not None and rate:
        x = x * keep / (1 - rate)
    return x


@contextlib.contextmanager
def full_f32(device: torch.device):
    """Full-f32 arithmetic on the card: cuDNN runs f32 convolutions in TF32
    by default (``torch.backends.cudnn.allow_tf32``), which is turned off
    here; f32 matrix products must not use TF32 either
    (``torch.backends.cuda.matmul.allow_tf32``), which is held False and
    restored on exit. On the CPU neither applies."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def check_params_device(params: dict, dev: torch.device) -> None:
    """Raise unless every leaf of ``params`` (a tensor, or a tuple of
    tensors for a quantized weight) lies on ``dev``'s kind of device."""
    for group in params.values():
        for name, leaf in group.items():
            for t in leaf if isinstance(leaf, tuple) else (leaf,):
                if t.device.type != dev.type:
                    raise ValueError(f"parameter {name} is on {t.device}, "
                                     f"the forward runs on {dev}")


def as_f32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return torch.as_tensor(x).to(device=dev, dtype=F32)


def forward_core(params: dict, kpms, iq, alloc, *, train: bool = False,
                 keep=None, rate: float = 0.0) -> torch.Tensor:
    """The forward on f32 tensors of one device: (B,) Mbps. ``train``
    runs the LSTM branch through ``LstmScan``; ``keep``/``rate`` are the
    CNN branch's dropout."""
    v_t = lstm_branch(params["lstm"], kpms, train)
    v_s = cnn_branch(params["cnn"], iq, keep, rate)
    w = alloc.clamp(0.0, 1.0)[:, None]
    fused = w * v_t + (1.0 - w) * v_s
    h = F.relu(fused @ params["head"]["w1"] + params["head"]["b1"])
    out = h @ params["head"]["w2"] + params["head"]["b2"]
    return out[:, 0]


def estimator_forward(e: EstimatorConfig, params: dict, kpms, iq, alloc, *,
                      device="cuda") -> torch.Tensor:
    """Predicted max throughput in Mbps, shape (B,), on ``device``.

    ``kpms`` (B, window, n_kpms), ``iq`` (B, 2, n_sc, n_sym) and ``alloc``
    (B,) may be numpy arrays or tensors; ``params`` must already be on
    ``device``. Inference only."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    kpms, iq, alloc = (as_f32(a, dev) for a in (kpms, iq, alloc))
    with torch.inference_mode(), full_f32(dev):
        return forward_core(params, kpms, iq, alloc)


def estimator_forward_train(e: EstimatorConfig, params: dict, kpms, iq,
                            alloc, keep=None) -> torch.Tensor:
    """The training-mode forward, with autograd on: (B,) Mbps on the
    device of ``kpms``, which ``iq``, ``alloc``, ``params`` and ``keep``
    share.

    ``keep``: the (B, hidden) bool dropout mask of the CNN branch, or
    None for none; the trainers draw it as ``rand < 1 - e.dropout``, the
    way ``jax.random.bernoulli`` decides. Run the forward and its
    backward inside ``full_f32`` (``estimator.train.loss_and_grads``
    does), or the card's convolutions and products may take TF32."""
    dev = torch.as_tensor(kpms).device
    check_params_device(params, dev)
    kpms, iq, alloc = (as_f32(a, dev) for a in (kpms, iq, alloc))
    return forward_core(params, kpms, iq, alloc, train=True,
                        keep=None if keep is None else keep.to(dev),
                        rate=e.dropout)
