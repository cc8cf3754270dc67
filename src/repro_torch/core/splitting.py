"""Head/tail model partitioning: the mechanism the PSO tables drive.

VGG16: split at any of the 43 op boundaries. The head runs ops [0, l) on
the UE, the boundary codec (``core.boundary``) shrinks the transmitted
activation, and the tail runs ops [l, 43) on the edge.

LM architectures: split at megablock boundaries (pattern repeats); the head
runs embed + groups [0, k), the tail groups [k, n_full) + remainder +
logits. The residual activation (B, S, d_model) crosses the boundary,
through the codec. ``use_kernel`` routes self-attention to the
flash_attention kernel, as in ``models.lm.forward``.
"""
from __future__ import annotations

import torch

from repro_torch.core import boundary
from repro_torch.models import lm
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


# ------------------------------------------------------------------ LM split
def lm_split_points(cfg) -> list[int]:
    """Valid split indices in megablock units (1..n_full)."""
    return list(range(1, cfg.n_full_patterns + 1))


def lm_head(cfg, params, batch, k: int, *, dtype=torch.bfloat16,
            use_kernel=True, device="cuda") -> torch.Tensor:
    """embed + pattern-groups [0, k) -> residual activation (B, S, D)."""
    dev = lm.checked_device(cfg, params, device)
    x = lm.embed_in(cfg, params, batch, dtype, dev)
    return lm.run_blocks(cfg, params, x, 0, k, remainder=False,
                         vision=lm.vision_in(batch, dev), dtype=dtype,
                         use_kernel=use_kernel)


def lm_tail(cfg, params, act, batch, k: int, *, dtype=torch.bfloat16,
            logits_mode="last", use_kernel=True,
            device="cuda") -> torch.Tensor:
    """pattern-groups [k, n_full) + remainder + logits. Only
    ``batch["vision"]`` is read, by the cross-attention blocks."""
    dev = lm.checked_device(cfg, params, device)
    x = lm.run_blocks(cfg, params, act.to(device=dev, dtype=dtype), k,
                      cfg.n_full_patterns, remainder=True,
                      vision=lm.vision_in(batch, dev), dtype=dtype,
                      use_kernel=use_kernel)
    if logits_mode == "last":
        x = x[:, -1:]
    return lm.logits_out(cfg, params, x, dtype)


def lm_split_infer(cfg, params, batch, k: int,
                   codec: boundary.Codec = boundary.FP16, *,
                   dtype=torch.bfloat16, logits_mode="last", use_kernel=True,
                   device="cuda") -> torch.Tensor:
    """Split inference in one process: the head, the codec's round trip of
    the activation, the tail. Inference only."""
    with torch.inference_mode():
        act = lm_head(cfg, params, batch, k, dtype=dtype,
                      use_kernel=use_kernel, device=device)
        act = boundary.roundtrip(act, codec)
        return lm_tail(cfg, params, act, batch, k, dtype=dtype,
                       logits_mode=logits_mode, use_kernel=use_kernel,
                       device=device)


def boundary_bytes(cfg, seq: int, batch: int, codec: boundary.Codec) -> int:
    return boundary.transmit_bytes((batch, seq, cfg.d_model), codec)
