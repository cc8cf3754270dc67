"""Fused LSTM scans: the estimator's temporal branch minus its output
projection, in fp32 and in int8 for serving.

``lstm_scan`` is the wrapper of the CUDA kernel ``csrc/lstm_scan.cu``;
``lstm_scan_ref`` is its plain PyTorch version, which the wrapper runs for
tensors on the CPU and the tests hold the kernel to. On a card
``lstm_scan_route`` picks the kernel's route from the hidden size:
``"cluster"`` (a cluster of two blocks holds wh in shared memory, hidden up
to ``CLUSTER_MAX_HIDDEN``: the estimator's) or ``"block"`` (the first
version, wh read through the L2, up to 1024); both give the same bits.
``lstm_hidden`` is the dispatch the estimator calls: ``lstm_hidden(...) @
proj`` is ``estimator.model.lstm_branch``.

The int8 serving scan is ``lstm_scan_q`` (kernel ``csrc/lstm_scan_q.cu``),
``lstm_scan_q_ref`` and the dispatch ``lstm_hidden_q``: the weights come
pre-quantized rowwise per output channel (``qmm.quantize_weight``, so
``wxq`` (4H, K) and ``whq`` (4H, H) int8 with (4H, 1) f32 scales), and
each step quantizes x_t and h per row before two int8 x int8 -> int32
dots (``qdot_ref``); the gates run in f32. On a card ``lstm_route`` picks
the kernel's route from the hidden size: ``"mma"`` (the int8 tensor cores,
hidden up to ``MMA_MAX_HIDDEN``) or ``"dp4a"`` (the CUDA cores, up to
``Q_MAX_HIDDEN``); both give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qmm import int_dot
from repro_torch.kernels.quant import quantize_ref

F32 = torch.float32
I8 = torch.int8
# lstm_scan_q's routes: 8 hidden units a warp of at most 16 on the tensor
# cores; the CUDA-core route for the rest
MMA_MAX_HIDDEN = 128
Q_MAX_HIDDEN = 224
# lstm_scan's routes: 64 hidden units a block of a cluster of two; the
# first version for the rest
CLUSTER_MAX_HIDDEN = 128
MAX_HIDDEN = 1024


def lstm_scan_route(hidden: int, k_in: int) -> str:
    """The route of ``lstm_scan`` on a card at this hidden size and input
    width (both routes take 1-16 inputs)."""
    del k_in
    return "cluster" if hidden <= CLUSTER_MAX_HIDDEN else "block"


def lstm_route(hidden: int) -> str:
    """The route of ``lstm_scan_q`` on a card at this hidden size."""
    return "mma" if hidden <= MMA_MAX_HIDDEN else "dp4a"


def _gates(z, c, hidden):
    """One cell update: gates i, f, g, o with +1.0 on the forget
    pre-activation -> (h, c)."""
    i, f, g, o = torch.split(z, hidden, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_scan_ref(kpms, wx, wh, b) -> torch.Tensor:
    """kpms (B, T, K) -> final hidden state (B, H), f32.

    Gates i, f, g, o with one bias and +1.0 on the forget pre-activation,
    so ``torch.nn.LSTM`` (two biases, no offset) is not the same cell."""
    hidden = wh.shape[0]
    h = torch.zeros((kpms.shape[0], hidden), dtype=F32, device=kpms.device)
    c = torch.zeros_like(h)
    for t in range(kpms.shape[1]):
        h, c = _gates(kpms[:, t] @ wx + h @ wh + b, c, hidden)
    return h


def qdot_ref(a, wq, ws) -> torch.Tensor:
    """Dynamic-activation int8 dot: a (B, K) f32, quantized per row, x
    wq (OUT, K) int8 with per-output scales ws (OUT, 1) -> (B, OUT) f32,
    scaled as ``acc * sa * ws.T``."""
    qa, sa = quantize_ref(a)
    return int_dot(qa, wq).to(F32) * sa * ws.to(F32).T


def lstm_scan_q_ref(kpms, wxq, wxs, whq, whs, b) -> torch.Tensor:
    """int8 serving scan: kpms (B, T, K) -> final h (B, H) f32, with
    ``z = qdot(x_t, wx) + qdot(h, wh) + b`` each step."""
    hidden = whq.shape[1]
    h = torch.zeros((kpms.shape[0], hidden), dtype=F32, device=kpms.device)
    c = torch.zeros_like(h)
    for t in range(kpms.shape[1]):
        z = qdot_ref(kpms[:, t], wxq, wxs) + qdot_ref(h, whq, whs) + b
        h, c = _gates(z, c, hidden)
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
    if not (1 <= k <= 16 and 1 <= hidden <= MAX_HIDDEN):
        raise ValueError(f"the lstm_scan kernel takes 1-16 input features "
                         f"and hidden sizes 1-{MAX_HIDDEN}, got {k} and "
                         f"{hidden}")
    out = torch.empty((batch, hidden), dtype=F32, device=kpms.device)
    if batch == 0:
        return out
    _launch(lstm_scan_route(hidden, k), kpms, wx, wh, b, out)
    return out


def _launch(which: str, kpms, wx, wh, b, out) -> None:
    """One launch of ``lstm_scan``'s route ``which`` on checked inputs,
    counted."""
    batch, steps, k = kpms.shape
    lib = _build.library()
    entry = (lib.repro_lstm_scan_f32_cluster if which == "cluster"
             else lib.repro_lstm_scan_f32)
    with torch.cuda.device(kpms.device):
        rc = entry(kpms.data_ptr(), wx.data_ptr(), wh.data_ptr(),
                   b.data_ptr(), out.data_ptr(), batch, steps, k,
                   wh.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "lstm_scan")
    _build.LAUNCHES["lstm_scan"] += 1
    _build.ROUTES["lstm_scan"][which] += 1


def lstm_hidden(kpms, wx, wh, b) -> torch.Tensor:
    """(B, T, K) windows -> (B, H) final hidden state, fp32, on the
    windows' device."""
    return lstm_scan(kpms.to(F32).contiguous(), wx.contiguous(),
                     wh.contiguous(), b.contiguous())


def _check_q(kpms, wxq, wxs, whq, whs, b):
    if kpms.dim() != 3:
        raise ValueError(f"kpms must be (B, T, K), got {tuple(kpms.shape)}")
    if whq.dim() != 2:
        raise ValueError(f"whq must be (4H, H), got {tuple(whq.shape)}")
    k, hidden = kpms.shape[2], whq.shape[1]
    g = 4 * hidden
    want = {"kpms": (F32, tuple(kpms.shape)), "wxq": (I8, (g, k)),
            "wxs": (F32, (g, 1)), "whq": (I8, (g, hidden)),
            "whs": (F32, (g, 1)), "b": (F32, (g,))}
    for name, t in (("kpms", kpms), ("wxq", wxq), ("wxs", wxs),
                    ("whq", whq), ("whs", whs), ("b", b)):
        dtype, shape = want[name]
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != kpms.device:
            raise ValueError(f"{name} is on {t.device}, kpms on "
                             f"{kpms.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lstm_scan_q(kpms: torch.Tensor, wxq: torch.Tensor, wxs: torch.Tensor,
                whq: torch.Tensor, whs: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The int8 LSTM kernel: contiguous f32 kpms (B, T, K), int8 wxq
    (4H, K) and whq (4H, H), f32 scales wxs and whs (4H, 1), f32 b (4H,)
    -> final h (B, H) f32.

    Tensors on the CPU run ``lstm_scan_q_ref``; on a card the CUDA kernel
    runs, or this raises."""
    _check_q(kpms, wxq, wxs, whq, whs, b)
    if kpms.device.type == "cpu":
        return lstm_scan_q_ref(kpms, wxq, wxs, whq, whs, b)
    if kpms.device.type != "cuda":
        raise ValueError(f"no lstm_scan_q kernel for device {kpms.device}")
    batch, steps, k = kpms.shape
    hidden = whq.shape[1]
    if not (1 <= k <= 16 and 1 <= hidden <= Q_MAX_HIDDEN):
        raise ValueError(f"the lstm_scan_q kernel takes 1-16 input features "
                         f"and hidden sizes 1-{Q_MAX_HIDDEN}, got {k} and "
                         f"{hidden}")
    out = torch.empty((batch, hidden), dtype=F32, device=kpms.device)
    if batch == 0:
        return out
    _launch_q(lstm_route(hidden), kpms, wxq, wxs, whq, whs, b, out)
    return out


def _launch_q(which: str, kpms, wxq, wxs, whq, whs, b, out) -> None:
    """One launch of ``lstm_scan_q``'s route ``which`` on checked inputs,
    counted."""
    batch, steps, k = kpms.shape
    lib = _build.library()
    entry = (lib.repro_lstm_scan_q_s8_mma if which == "mma"
             else lib.repro_lstm_scan_q_s8)
    with torch.cuda.device(kpms.device):
        rc = entry(
            kpms.data_ptr(), wxq.data_ptr(), wxs.data_ptr(), whq.data_ptr(),
            whs.data_ptr(), b.data_ptr(), out.data_ptr(), batch, steps, k,
            whq.shape[1], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "lstm_scan_q")
    _build.LAUNCHES["lstm_scan_q"] += 1
    _build.ROUTES["lstm_scan_q"][which] += 1


def lstm_hidden_q(kpms, wxq, wxs, whq, whs, b) -> torch.Tensor:
    """int8 serving: (B, T, K) windows and ``quantize_weight`` pairs ->
    (B, H) final hidden state, f32, on the windows' device."""
    return lstm_scan_q(kpms.to(F32).contiguous(), wxq.contiguous(),
                       wxs.to(F32).contiguous(), whq.contiguous(),
                       whs.to(F32).contiguous(), b.to(F32).contiguous())
