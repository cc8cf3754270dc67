"""Pattern-grouped LM: repeated megablocks of ``cfg.pattern`` plus an
unrolled remainder, for the dense attention and the SSD configurations.

Parameters are the reference's tree (``model_template``): ``embed``,
``groups`` (one tree per pattern position, each leaf stacked over the
``n_full_patterns`` megablocks), ``rem`` (the remainder blocks),
``final_ln`` and, unless the embeddings are tied, ``head``. The forward is
full-sequence (train, or prefill without a cache) and walks the stacked
layers with a Python loop; ``decode_step``, caches, ``lm_loss`` and the
MoE, recurrent and cross-attention blocks are later slices, and
``check_ported`` names their ROADMAP.md queue items.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.template import ParamSpec, stack_specs, tree_map

F32 = torch.float32


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md module queue "
        f"item {item}")


def check_ported(cfg) -> None:
    """Raise for a configuration whose blocks are a later slice."""
    if cfg.is_moe:
        raise _not_ported(f"{cfg.name}: MoE blocks", "18")
    for spec in cfg.pattern:
        if spec.kind in ("rec", "cross"):
            raise _not_ported(f"{cfg.name}: {spec.kind!r} blocks", "19")
        if spec.kind not in ("attn", "local", "ssd"):
            raise ValueError(f"unknown block kind {spec.kind!r}")


# ------------------------------------------------------------------ templates
def block_template(cfg, spec):
    """An attention block ("attn" or "local"): attention then the dense
    MLP; an "ssd" block: the mixer alone. ``check_ported`` refuses the
    others."""
    if spec.kind == "ssd":
        return {"ssd": B.ssd_template(cfg)}
    return {"attn": B.attn_template(cfg), "ffn": B.mlp_template(cfg)}


def model_template(cfg):
    check_ported(cfg)
    D = cfg.d_model
    t = {}
    if cfg.frame_input_dim:
        t["embed"] = ParamSpec((cfg.frame_input_dim, D), ("fsdp", "embed"))
    else:
        t["embed"] = ParamSpec((cfg.vocab, D), ("vocab", "fsdp"), init="embed")
    t["groups"] = tuple(stack_specs(block_template(cfg, b),
                                    cfg.n_full_patterns)
                        for b in cfg.pattern)
    t["rem"] = tuple(block_template(cfg, b) for b in cfg.remainder)
    t["final_ln"] = ParamSpec((D,), ("embed",), init="zeros")
    if not cfg.tie_embeddings or cfg.frame_input_dim:
        t["head"] = ParamSpec((D, cfg.vocab), ("fsdp", "vocab"))
    return t


# ------------------------------------------------------------------ blocks
def _apply_ffn(cfg, p, x, dtype):
    return x + B.mlp_block(cfg, p["ffn"], x, dtype)


def apply_block(cfg, spec, p, x, *, positions, mode="train",
                dtype=B.DEFAULT_COMPUTE, use_kernel=True):
    """One block, full-sequence: attention then the MLP, each added to the
    residual stream; or the SSD mixer, added to it."""
    if mode not in ("train", "prefill"):
        raise _not_ported(f"mode={mode!r} (decode and its caches)", "20")
    if spec.kind == "ssd":
        delta, _ = B.ssd_block(cfg, p["ssd"], x, dtype, use_kernel)
        return x + delta
    x = x + B.attention_block(cfg, p["attn"], x, kind=spec.kind,
                              window=spec.window, positions=positions,
                              dtype=dtype, use_kernel=use_kernel)
    return _apply_ffn(cfg, p, x, dtype)


def run_blocks(cfg, params, x, lo: int, hi: int, *, remainder: bool,
               mode="train", dtype=B.DEFAULT_COMPUTE, use_kernel=True):
    """Megablocks [lo, hi) of ``params["groups"]``, then the remainder
    blocks if ``remainder``."""
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    kw = dict(positions=positions, mode=mode, dtype=dtype,
              use_kernel=use_kernel)
    for i in range(lo, hi):
        for spec, group in zip(cfg.pattern, params["groups"]):
            x = apply_block(cfg, spec, tree_map(lambda t: t[i], group), x,
                            **kw)
    if remainder:
        for spec, p in zip(cfg.remainder, params["rem"]):
            x = apply_block(cfg, spec, p, x, **kw)
    return x


# ------------------------------------------------------------------ embeddings
def _input(x, dev, dtype=None):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def embed_in(cfg, params, batch, dtype, device):
    """Token ids (B, S) -> embeddings, scaled by sqrt(d_model) in ``dtype``
    when tied; or frames (B, S, frame_input_dim) -> their projection."""
    dev = resolve_device(device)
    emb = params["embed"]
    if cfg.frame_input_dim:
        return B.cast(_input(batch["frames"], dev), dtype) @ B.cast(emb, dtype)
    x = emb[_input(batch["tokens"], dev, torch.long)].to(dtype)
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=dev)
    return x


def logits_out(cfg, params, x, dtype):
    h = B.rms_norm(x, params["final_ln"], cfg.norm_eps)
    if "head" in params:
        logits = h @ B.cast(params["head"], dtype)
    else:
        logits = h @ B.cast(params["embed"], dtype).T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(B.cast(logits, F32) / c)
    return logits


def checked_device(cfg, params, device) -> torch.device:
    """``device`` resolved, after refusing a configuration of a later slice
    and parameters that lie elsewhere."""
    check_ported(cfg)
    dev = resolve_device(device)

    def on_dev(t):
        if t.device.type != dev.type:
            raise ValueError(f"a parameter is on {t.device}, the forward "
                             f"runs on {dev}")

    tree_map(on_dev, params)
    return dev


# ------------------------------------------------------------------ forward
def forward(cfg, params, batch, *, mode="train", dtype=B.DEFAULT_COMPUTE,
            logits_mode="all", use_kernel=True, device="cuda"):
    """Full-sequence pass over ``batch`` ({"tokens": (B, S)} or
    {"frames": (B, S, F)}, numpy arrays or tensors); ``params`` must
    already be on ``device``. ``logits_mode``: "all" (B, S, V), "last"
    (B, 1, V) or "none" (returns None). ``use_kernel`` routes
    self-attention to the flash_attention kernel and the SSD mixer to the
    ssd kernel (see ``blocks``).
    Returns the logits, in ``dtype`` (f32 with a softcap)."""
    if logits_mode not in ("all", "last", "none"):
        raise ValueError(f"logits_mode must be all, last or none, got "
                         f"{logits_mode!r}")
    dev = checked_device(cfg, params, device)
    x = embed_in(cfg, params, batch, dtype, dev)
    x = run_blocks(cfg, params, x, 0, cfg.n_full_patterns, remainder=True,
                   mode=mode, dtype=dtype, use_kernel=use_kernel)
    if logits_mode == "none":
        return None
    if logits_mode == "last":
        x = x[:, -1:]
    return logits_out(cfg, params, x, dtype)
