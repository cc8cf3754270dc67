"""Fused KPM-window featurize: normalise the raw trace and cut windows.

``featurize`` is the wrapper of the CUDA kernel ``csrc/featurize.cu``
(route ``staged`` or ``generic``, picked by ``plan``);
``featurize_ref`` is its plain PyTorch version, which the wrapper runs for
tensors on the CPU and the tests hold the kernel to.
``kpm_feature_windows`` is the dispatch the fleet engine calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

F32 = torch.float32
# the routes of csrc/featurize.cu and their codes in its C entry point
ROUTE_IDS = {"generic": 0, "staged": 1}
# trace values a block of the staged kernel holds in shared memory
# (csrc/featurize.cu kStageMax: 256 threads x 12)
STAGE_MAX = 3072


def plan(length: int, k: int) -> str:
    """The kernel a card runs for a UE's (length, k) trace:

    - "staged": traces of up to STAGE_MAX values, a block a UE that
      normalises each value once in shared memory and writes the UE's
      windows with 16-byte stores;
    - "generic": longer traces, the first version (a block a window)."""
    return "staged" if length * k <= STAGE_MAX else "generic"


def featurize_ref(kpms, center, scale, window: int) -> torch.Tensor:
    """kpms (N, L, K) raw -> (N, L - window + 1, window, K) normalized.

    Window ``b`` covers trace steps ``[b, b + window)``, normalized by the
    fixed affine of ``channel.kpm`` with a true division."""
    x = (kpms.to(F32) - center.to(F32)) / scale.to(F32)
    b = x.shape[1] - window + 1
    if b < 1:
        raise ValueError(f"trace of {x.shape[1]} steps holds no "
                         f"{window}-window")
    idx = (torch.arange(b, device=x.device)[:, None]
           + torch.arange(window, device=x.device)[None, :])
    return x[:, idx]  # (N, B, window, K) one gather


def _check(kpms, center, scale, window):
    if kpms.dim() != 3:
        raise ValueError(f"kpms must be (N, L, K), got {tuple(kpms.shape)}")
    k = kpms.shape[2]
    for name, t in (("kpms", kpms), ("center", center), ("scale", scale)):
        if t.dtype != F32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != kpms.device:
            raise ValueError(f"{name} is on {t.device}, kpms on "
                             f"{kpms.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if center.shape != (k,) or scale.shape != (k,):
        raise ValueError(f"center/scale must be ({k},), got "
                         f"{tuple(center.shape)}/{tuple(scale.shape)}")
    if kpms.shape[1] - window + 1 < 1:
        raise ValueError(f"trace of {kpms.shape[1]} steps holds no "
                         f"{window}-window")


def featurize(kpms: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
              window: int) -> torch.Tensor:
    """The featurize kernel: contiguous f32 (N, L, K) kpms and (K,)
    center/scale -> (N, L - window + 1, window, K) f32 windows.

    Tensors on the CPU run ``featurize_ref``; on a card the CUDA kernel
    runs, or this raises."""
    _check(kpms, center, scale, window)
    if kpms.device.type == "cpu":
        return featurize_ref(kpms, center, scale, window)
    if kpms.device.type != "cuda":
        raise ValueError(f"no featurize kernel for device {kpms.device}")
    n, length, k = kpms.shape
    out = torch.empty((n, length - window + 1, window, k), dtype=F32,
                      device=kpms.device)
    if out.numel() == 0:
        return out
    _launch(kpms, center, scale, window, out, plan(length, k))
    return out


def _launch(kpms, center, scale, window: int, out, which: str) -> None:
    """One launch of featurize's route ``which`` on checked inputs,
    counted."""
    n, length, k = kpms.shape
    lib = _build.library()
    ctx, stream = _build.device_stream(kpms.device.index)
    with ctx:
        rc = lib.repro_featurize_f32(
            kpms.data_ptr(), center.data_ptr(), scale.data_ptr(),
            out.data_ptr(), n, length, k, window, ROUTE_IDS[which], stream)
    _build.check_launch(rc, "featurize")
    _build.LAUNCHES["featurize"] += 1
    _build.ROUTES["featurize"][which] += 1


def kpm_feature_windows(kpms: torch.Tensor, center, scale,
                        window: int) -> torch.Tensor:
    """(N, L, K) raw KPM slab -> (N, L - window + 1, window, K) normalized
    rolling windows, on the slab's device.

    Drop-in for ``EpisodeBatch.kpm_windows(normalize=True)`` over any
    trace slab: the engine's chunked ``estimate_fleet`` feeds the slab
    covering one chunk of report periods. ``center``/``scale`` may be
    numpy arrays or tensors."""
    dev = kpms.device
    return featurize(kpms.to(F32).contiguous(),
                     torch.as_tensor(center, dtype=F32, device=dev),
                     torch.as_tensor(scale, dtype=F32, device=dev), window)
