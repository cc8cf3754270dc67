"""Fused fp32 LSTM scan: the estimator's temporal branch minus its
output projection.

``lstm_scan`` is the wrapper of the CUDA kernel ``csrc/lstm_scan.cu``;
``lstm_scan_ref`` is its plain PyTorch version, which the wrapper runs for
tensors on the CPU and the tests hold the kernel to. ``lstm_hidden`` is the
dispatch the estimator calls: ``lstm_hidden(...) @ proj`` is
``estimator.model.lstm_branch``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

F32 = torch.float32


def lstm_scan_ref(kpms, wx, wh, b) -> torch.Tensor:
    """kpms (B, T, K) -> final hidden state (B, H), f32.

    Gates i, f, g, o with one bias and +1.0 on the forget pre-activation,
    so ``torch.nn.LSTM`` (two biases, no offset) is not the same cell."""
    hidden = wh.shape[0]
    h = torch.zeros((kpms.shape[0], hidden), dtype=F32, device=kpms.device)
    c = torch.zeros_like(h)
    for t in range(kpms.shape[1]):
        z = kpms[:, t] @ wx + h @ wh + b
        i, f, g, o = torch.split(z, hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h


def _check(kpms, wx, wh, b):
    if kpms.dim() != 3:
        raise ValueError(f"kpms must be (B, T, K), got {tuple(kpms.shape)}")
    k, hidden = kpms.shape[2], wh.shape[0]
    want = {"wx": (k, 4 * hidden), "wh": (hidden, 4 * hidden),
            "b": (4 * hidden,)}
    for name, t in (("kpms", kpms), ("wx", wx), ("wh", wh), ("b", b)):
        if t.dtype != F32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != kpms.device:
            raise ValueError(f"{name} is on {t.device}, kpms on "
                             f"{kpms.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")


def lstm_scan(kpms: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The LSTM kernel: contiguous f32 kpms (B, T, K), wx (K, 4H),
    wh (H, 4H), b (4H,) -> final h (B, H) f32.

    Tensors on the CPU run ``lstm_scan_ref``; on a card the CUDA kernel
    runs, or this raises."""
    _check(kpms, wx, wh, b)
    if kpms.device.type == "cpu":
        return lstm_scan_ref(kpms, wx, wh, b)
    if kpms.device.type != "cuda":
        raise ValueError(f"no lstm_scan kernel for device {kpms.device}")
    batch, steps, k = kpms.shape
    hidden = wh.shape[0]
    if not (1 <= k <= 16 and 1 <= hidden <= 1024):
        raise ValueError(f"the lstm_scan kernel takes 1-16 input features "
                         f"and hidden sizes 1-1024, got {k} and {hidden}")
    out = torch.empty((batch, hidden), dtype=F32, device=kpms.device)
    if batch == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(kpms.device):
        rc = lib.repro_lstm_scan_f32(
            kpms.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            out.data_ptr(), batch, steps, k, hidden,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "lstm_scan")
    _build.LAUNCHES["lstm_scan"] += 1
    return out


def lstm_hidden(kpms, wx, wh, b) -> torch.Tensor:
    """(B, T, K) windows -> (B, H) final hidden state, fp32, on the
    windows' device."""
    return lstm_scan(kpms.to(F32).contiguous(), wx.contiguous(),
                     wh.contiguous(), b.contiguous())
