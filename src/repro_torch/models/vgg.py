"""VGG16 with the paper's 43 split points (outputs after every layer or
sub-layer: conv, ReLU, pool, avgpool, flatten, fc, dropout, softmax).

The analytic half of the reference module: the layout, the activation
shapes and the FLOPs/data-size/privacy profile that Algorithm 1 consumes,
all float64 numpy. The VGG forward waits for the split-computing slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.profiles import SplitProfile

# (kind, arg): conv -> out_channels, pool -> window, fc -> out_features
_FEATURES = [
    ("conv", 64), ("relu", 0), ("conv", 64), ("relu", 0), ("pool", 2),
    ("conv", 128), ("relu", 0), ("conv", 128), ("relu", 0), ("pool", 2),
    ("conv", 256), ("relu", 0), ("conv", 256), ("relu", 0), ("conv", 256),
    ("relu", 0), ("pool", 2),
    ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
    ("relu", 0), ("pool", 2),
    ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
    ("relu", 0), ("pool", 2),
]


def layout(num_classes: int = 1000):
    ops = [("input", 0)] + list(_FEATURES)
    ops += [("avgpool", 7), ("flatten", 0)]
    ops += [("fc", 4096), ("relu", 0), ("dropout", 0),
            ("fc", 4096), ("relu", 0), ("dropout", 0),
            ("fc", num_classes), ("softmax", 0), ("output", 0)]
    assert len(ops) == 43, len(ops)
    return ops


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    image_size: int = 224
    width_mult: float = 1.0
    num_classes: int = 1000
    in_channels: int = 3

    def ch(self, c: int) -> int:
        return max(4, int(c * self.width_mult))

    def fc_width(self, w: int) -> int:
        return max(16, int(w * self.width_mult))


FULL = VGGConfig()


def _shapes(vcfg: VGGConfig):
    """Activation shape (H, W, C) or (F,) after every split point."""
    ops = layout(vcfg.num_classes)
    h = w = vcfg.image_size
    c = vcfg.in_channels
    flat = None
    out = []
    for kind, arg in ops:
        if kind == "conv":
            c = vcfg.ch(arg)
        elif kind == "pool":
            h //= arg
            w //= arg
        elif kind == "avgpool":
            h = w = min(h, arg)
        elif kind == "flatten":
            flat = h * w * c
        elif kind == "fc":
            flat = (vcfg.fc_width(arg) if arg != vcfg.num_classes
                    else vcfg.num_classes)
        out.append((flat,) if flat is not None else (h, w, c))
    return out


def vgg_split_profile(vcfg: VGGConfig, *, bytes_per_el: int = 4,
                      privacy: np.ndarray | None = None) -> SplitProfile:
    """Analytic per-split profile (FLOPs cumulative, bytes transmitted)."""
    ops = layout(vcfg.num_classes)
    shapes = _shapes(vcfg)
    flops = []
    c_in = vcfg.in_channels
    flat_in = None
    for i, (kind, arg) in enumerate(ops):
        sh = shapes[i]
        if kind == "conv":
            h, w, c = sh
            flops.append(2 * 9 * c_in * c * h * w)
            c_in = c
        elif kind in ("relu", "pool", "avgpool", "softmax"):
            flops.append(float(np.prod(sh)))
        elif kind == "fc":
            flops.append(2 * flat_in * sh[0])
            flat_in = sh[0]
        elif kind == "flatten":
            flat_in = int(np.prod(shapes[i - 1]))
            flops.append(0.0)
        else:
            flops.append(0.0)
    data = np.array([float(np.prod(s)) * bytes_per_el for s in shapes])
    if privacy is None:
        privacy = paper_privacy_profile()
    return SplitProfile(name=f"vgg16-{vcfg.image_size}px-w{vcfg.width_mult}",
                        flops_head=np.cumsum(flops).astype(float),
                        data_bytes=data, privacy=np.asarray(privacy, float),
                        layer_names=[f"{i+1}:{k}" for i, (k, _) in
                                     enumerate(ops)])


def paper_privacy_profile() -> np.ndarray:
    """dCor(input, act_l) for VGG16 calibrated to the paper's Fig. 5b:
    highest near the input, gradual decay, sharp decline around split 25,
    minima ~0.21-0.22 at splits 25, 38, 43 (1-indexed). Split 1 is the raw
    input (dCor exactly 1.0): a privacy-focused SC system never ships it, so
    any rho_max < 1 prefilters it in Algorithm 1."""
    l = np.arange(1, 44)
    base = 0.97 - 0.45 * (l / 43) ** 1.5
    drop = 0.30 / (1.0 + np.exp(-(l - 24.5) * 1.5))
    p = base - drop
    p = np.clip(p, 0.2, 1.0)
    p[0] = 1.0  # op 'input': untouched image
    p[24] = 0.215  # split 25
    p[37] = 0.220  # split 38
    p[42] = 0.210  # split 43
    return p
