"""VGG16 with the paper's 43 split points (outputs after every layer or
sub-layer: conv, ReLU, pool, avgpool, flatten, fc, dropout, softmax).

The analytic half (the layout, the activation shapes and the
FLOPs/data-size/privacy profile that Algorithm 1 consumes) is float64
numpy. The forward runs any range of the 43 ops in PyTorch, on the card
by default, for split inference and the measured dCor privacy profile.

Parameters keep the reference's names and layouts (``vgg_template``):
conv kernels HWIO, fc weights (in, out) with the rows of the first fc in
the (h, w, c) order of an NHWC flatten, so a reference parameter tree
carries over as it is (``repro_torch.weights.vgg_params_from_reference``).
Activations are NHWC, as the reference's: the forward convolves NCHW views
of NHWC memory (cuDNN's channels-last layout) with the kernels permuted to
OIHW, which is the same sum.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core.profiles import SplitProfile
from repro_torch.estimator.model import as_f32, full_f32

F32 = torch.float32

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
REDUCED = VGGConfig(image_size=32, width_mult=0.125, num_classes=10)


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


def vgg_template(vcfg: VGGConfig) -> dict:
    """{name: (shape, init)}: the reference's parameter leaves, conv
    kernels HWIO and fc weights (in, out), fan-in normal with zero
    biases."""
    ops = layout(vcfg.num_classes)
    shapes = _shapes(vcfg)
    t = {}
    c_in = vcfg.in_channels
    flat_in = None
    for i, (kind, arg) in enumerate(ops):
        if kind == "conv":
            c_out = vcfg.ch(arg)
            t[f"op{i}_w"] = ((3, 3, c_in, c_out), "fan_in")
            t[f"op{i}_b"] = ((c_out,), "zeros")
            c_in = c_out
        elif kind == "flatten":
            sh = shapes[i - 1]
            flat_in = sh[0] * sh[1] * sh[2]
        elif kind == "fc":
            f_out = shapes[i][0]
            t[f"op{i}_w"] = ((flat_in, f_out), "fan_in")
            t[f"op{i}_b"] = ((f_out,), "zeros")
            flat_in = f_out
    return t


def init_vgg(vcfg: VGGConfig, generator: torch.Generator, *,
             device="cuda") -> dict:
    """Random parameters: fan-in normal (std 1/sqrt(shape[-2]): c_in for
    an HWIO kernel, not 9 c_in, as the reference's template init, so
    activations grow through the convs) and zero biases. Drawn on the CPU
    from ``generator`` in template order, so a seed gives the same weights
    on every device, then moved to ``device``."""
    dev = resolve_device(device)
    params = {}
    for name, (shape, init) in vgg_template(vcfg).items():
        if init == "zeros":
            t = torch.zeros(shape, dtype=F32)
        else:
            t = torch.randn(shape, generator=generator, dtype=F32) \
                / max(shape[-2], 1) ** 0.5
        params[name] = t.to(dev)
    return params


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def forward(vcfg: VGGConfig, params: dict, x, *, start: int = 0,
            stop: int = 43, collect: bool = False, device="cuda"):
    """Run ops [start, stop) on ``device``. x: (N, H, W, C) images (or the
    split activation), a tensor or a numpy array; ``params`` must already
    be on ``device``. Returns the final activation, or the list of
    activations after every op if ``collect``. Inference only, in full
    f32 (no TF32)."""
    dev = resolve_device(device)
    for name, t in params.items():
        if t.device.type != dev.type:
            raise ValueError(f"parameter {name} is on {t.device}, the "
                             f"forward runs on {dev}")
    ops = layout(vcfg.num_classes)
    x = as_f32(x, dev)
    acts = []
    with torch.inference_mode(), full_f32(dev):
        for i in range(start, stop):
            kind, arg = ops[i]
            if kind in ("input", "output", "dropout"):  # inference identity
                pass
            elif kind == "conv":
                w = params[f"op{i}_w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
                x = _nhwc(F.conv2d(_nchw(x), w, params[f"op{i}_b"],
                                   padding=1))
            elif kind == "relu":
                x = F.relu(x)
            elif kind == "pool":
                x = _nhwc(F.max_pool2d(_nchw(x), arg))
            elif kind == "avgpool":
                # adaptive to (arg, arg): here shapes already match or
                # reduce
                h = x.shape[1]
                if h > arg:
                    k = h // arg
                    x = _nhwc(F.avg_pool2d(_nchw(x), k))
            elif kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif kind == "fc":
                x = x @ params[f"op{i}_w"] + params[f"op{i}_b"]
            elif kind == "softmax":
                x = torch.softmax(x, dim=-1)
            else:
                raise ValueError(kind)
            if collect:
                acts.append(x)
    return acts if collect else x


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
