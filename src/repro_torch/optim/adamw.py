"""AdamW with global-norm clipping and a cosine schedule, functional.

The reference's optimizer, not ``torch.optim.AdamW`` with
``clip_grad_norm_``, which compute something else:

  * the clip scale is ``min(1, clip / max(gnorm, 1e-9))``;
  * b2 defaults to 0.95;
  * the decay sits inside the update:
    ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``.

Parameters, gradients and moments are nested dicts (or tuples) of
tensors. The global norm sums its leaves in the order JAX flattens a tree
(sorted dict keys, ``tree_leaves``), and the bias corrections are f32
powers of an f32 step, as the reference computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

F32 = torch.float32


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and tuples, in JAX's flatten order
    (a dict's keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (tuple, list)):
        return type(head)(_map(fn, *vs) for vs in zip(*trees))
    return fn(*trees)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(total)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """Linear warmup to ``peak``, then a cosine down to ``floor_frac *
    peak`` at ``total``: ``lr(step)`` of an integer step tensor -> f32."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> dict:
        """Zero f32 moments shaped as ``params`` and an int32 step 0, on
        the parameters' device."""
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        zeros = lambda p: torch.zeros_like(p, dtype=F32)  # noqa: E731
        return {"m": _map(zeros, params), "v": _map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: ``(grads, state, params) -> (new params, new state,
        {"grad_norm", "lr"})``. Nothing is updated in place."""
        step = state["step"] + 1
        gnorm = global_norm(grads)
        if self.clip_norm is not None:
            # a true division: ``float / tensor`` would multiply by the
            # reciprocal
            clip = torch.full_like(gnorm, self.clip_norm)
            scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            grads = _map(lambda g: g.to(F32) * scale, grads)
        else:
            grads = _map(lambda g: g.to(F32), grads)
        b1, b2 = self.b1, self.b2
        m = _map(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
        v = _map(lambda vv, g: b2 * vv + (1 - b2) * g * g, state["v"], grads)
        tf = step.to(F32)
        bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)
        lr = self.lr(step) if callable(self.lr) else self.lr

        def upd(p, mm, vv):
            mhat = mm / bc1
            vhat = vv / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps) \
                + self.weight_decay * p
            return (p - lr * delta).to(p.dtype)

        new_params = _map(upd, params, m, v)
        return new_params, {"m": m, "v": v, "step": step}, {
            "grad_norm": gnorm,
            "lr": torch.as_tensor(lr, dtype=F32, device=gnorm.device)}
