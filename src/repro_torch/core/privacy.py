"""Privacy leakage metric: distance correlation (Székely dCor), as used by
the paper (via NoPeek [12]) between input images and intermediate
activations.

dCor in [0, 1]; lower means less information about the input leaks
through the transmitted features. Plain PyTorch here, on the tensors'
device; the O(n^2 d) pairwise-distance hot spot has a CUDA kernel in
``repro_torch.kernels.dcor`` (``dcor_kernel``). Double centring stays
plain PyTorch: it is O(n^2).
"""
from __future__ import annotations

import torch

F32 = torch.float32


def pairwise_dists(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix. x: (n, d) -> (n, n).

    Self-distances are pinned to exact 0: the ||a||^2+||b||^2-2ab
    expansion cancels catastrophically on the diagonal and sqrt amplifies
    the residue to ~1e-3."""
    x = x.to(F32)
    sq = (x * x).sum(dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    d2 = torch.where(eye, 0.0, d2)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _double_center(a: torch.Tensor) -> torch.Tensor:
    rm = a.mean(dim=0, keepdim=True)
    cm = a.mean(dim=1, keepdim=True)
    return a - rm - cm + a.mean()


def dcov2(a_centered: torch.Tensor, b_centered: torch.Tensor) -> torch.Tensor:
    return (a_centered * b_centered).mean()


def dcor(x: torch.Tensor, y: torch.Tensor, *,
         dist_fn=pairwise_dists) -> torch.Tensor:
    """Distance correlation between samples x: (n, ...) and y: (n, ...),
    a 0-d f32 tensor on their device."""
    a = _double_center(dist_fn(x.reshape(x.shape[0], -1)))
    b = _double_center(dist_fn(y.reshape(y.shape[0], -1)))
    dxy = dcov2(a, b)
    dxx = dcov2(a, a)
    dyy = dcov2(b, b)
    denom = torch.sqrt(torch.clamp_min(dxx * dyy, 1e-30))
    return torch.sqrt(torch.clamp_min(dxy, 0.0) / denom)


def layer_privacy_profile(inputs: torch.Tensor,
                          activations_by_layer) -> torch.Tensor:
    """P(l) for every candidate split: dCor(input, activation_l), through
    the plain distances (the reference's ``dcor_jit``)."""
    with torch.inference_mode():
        return torch.stack([dcor(inputs, act)
                            for act in activations_by_layer])
