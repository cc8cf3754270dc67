"""Parameter templates: one source of truth for shapes and init.

A template is a tree of dicts and tuples whose leaves are ``ParamSpec``;
``init_from_template`` turns it into the same tree of tensors. The logical
axis names ride along for the multi-GPU slice (ROADMAP.md module queue
item 12); nothing reads them yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis names (len == ndim)
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"  # fan_in | zeros | ones | neg_ones | normal | embed
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} needs one axis name a "
                             f"dimension, got {self.axes}")


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def stack_specs(tree, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layers dim of size n to every leaf."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n,) + tuple(s.shape), axes=(axis_name,) + tuple(s.axes)),
        tree)


_FILLS = {"zeros": 0, "ones": 1, "neg_ones": -1}


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               dtype: torch.dtype) -> torch.Tensor:
    dev = generator.device
    if spec.init in _FILLS:
        return torch.full(spec.shape, _FILLS[spec.init], dtype=dtype,
                          device=dev)
    if spec.init == "normal":
        std = spec.scale
    elif spec.init == "embed":
        std = 1.0
    elif spec.init == "fan_in":
        # The reference's formula as it is: the fan is the second-to-last
        # dim. For wq (D, H, dh) that is H, not D, so q and k come out
        # about sqrt(D / H) larger than a 1/sqrt(D) init would make them;
        # kept so that seeded activations have the reference's scale.
        fan = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / max(fan, 1) ** 0.5
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    t = torch.randn(spec.shape, generator=generator, dtype=dtype, device=dev)
    return t.mul_(std) if std != 1.0 else t


def init_from_template(tree, generator: torch.Generator, *, device,
                       dtype: torch.dtype | None = None):
    """The template's tree of tensors on ``device``, drawn from
    ``generator`` leaf by leaf in template order (on the generator's own
    device, then moved). ``dtype`` overrides every floating leaf's type:
    bf16 draws the normals in bf16 directly, so a full-width model never
    needs an f32 copy."""
    dev = resolve_device(device)

    def leaf(spec):
        want = dtype if dtype is not None and spec.dtype.is_floating_point \
            else spec.dtype
        return _init_leaf(spec, generator, want).to(dev)

    return tree_map(leaf, tree)


def fill_from_template(tree, *, device):
    """A template of constant leaves (zeros, ones, neg_ones) as tensors on
    ``device``, each in its spec's own dtype: a decode cache, whose f32
    state and int32 positions keep their types."""
    dev = resolve_device(device)

    def leaf(spec):
        if spec.init not in _FILLS:
            raise ValueError(f"{spec.init!r} is not a constant init")
        return torch.full(spec.shape, _FILLS[spec.init], dtype=spec.dtype,
                          device=dev)

    return tree_map(leaf, tree)
