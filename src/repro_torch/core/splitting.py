"""Head/tail model partitioning: the mechanism the PSO tables drive.

VGG16: split at any of the 43 op boundaries. The head runs ops [0, l) on
the UE, the boundary codec (``core.boundary``) shrinks the transmitted
activation, and the tail runs ops [l, 43) on the edge. The LM half of the
reference module waits for the LM slice (queue item 14).
"""
from __future__ import annotations

import torch

from repro_torch.core import boundary
from repro_torch.models import vgg as vggmod


def vgg_head(vcfg, params, images, l: int, *, device="cuda") -> torch.Tensor:
    """Ops [0, l) on the UE. Returns the intermediate activation."""
    return vggmod.forward(vcfg, params, images, start=0, stop=l,
                          device=device)


def vgg_tail(vcfg, params, act, l: int, *, device="cuda") -> torch.Tensor:
    return vggmod.forward(vcfg, params, act, start=l, stop=43, device=device)


def vgg_split_infer(vcfg, params, images, l: int,
                    codec: boundary.Codec = boundary.FP16, *,
                    device="cuda") -> torch.Tensor:
    """End-to-end split inference incl. boundary codec round-trip."""
    act = boundary.roundtrip(vgg_head(vcfg, params, images, l,
                                      device=device), codec)
    return vgg_tail(vcfg, params, act, l, device=device)
