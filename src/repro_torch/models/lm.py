"""Pattern-grouped LM: repeated megablocks of ``cfg.pattern`` plus an
unrolled remainder, for every configuration of the registry: dense, MoE,
sliding-window, local:global, cross-attention VLM, RG-LRU hybrid and SSD.

Parameters are the reference's tree (``model_template``): ``embed``,
``groups`` (one tree per pattern position, each leaf stacked over the
``n_full_patterns`` megablocks), ``rem`` (the remainder blocks),
``final_ln`` and, unless the embeddings are tied, ``head``. The forward is
full-sequence (train, or prefill without a cache) and walks the stacked
layers with a Python loop. It returns the logits; the MoE blocks' aux loss
is dropped, as only ``lm_loss`` (training, a later slice) consumes it.

Serving: ``prefill`` runs the prompt and returns the last logits and the
decode cache, ``decode_step`` one token a sequence at a given position.
The cache is the reference's tree (``cache_template``): ``groups`` (each
leaf stacked over the megablocks) and ``rem``; ``decode_step`` writes
layer i's slice in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.template import (ParamSpec, fill_from_template,
                                         stack_specs, tree_map)

F32 = torch.float32
MODES = ("train", "prefill", "decode")


KINDS = ("attn", "local", "cross", "rec", "ssd")


def check_ported(cfg) -> None:
    """Raise for a block kind the LM does not know."""
    for spec in cfg.pattern:
        if spec.kind not in KINDS:
            raise ValueError(f"unknown block kind {spec.kind!r}")


# ------------------------------------------------------------------ templates
def block_template(cfg, spec):
    """An attention block ("attn", "local" or "cross"): attention then
    the feed-forward (the MoE for a MoE config, else the dense MLP); a
    "rec" block: the RG-LRU then the dense MLP; an "ssd" block: the mixer
    alone."""
    if spec.kind == "ssd":
        return {"ssd": B.ssd_template(cfg)}
    if spec.kind == "rec":
        return {"rec": B.rec_template(cfg), "ffn": B.mlp_template(cfg)}
    ffn = B.moe_template(cfg) if cfg.is_moe else B.mlp_template(cfg)
    return {"attn": B.attn_template(cfg, spec.kind), "ffn": ffn}


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


def block_cache_template(cfg, spec, batch, max_seq):
    if spec.kind == "ssd":
        return {"ssd": B.ssd_cache_template(cfg, batch)}
    if spec.kind == "rec":
        return {"rec": B.rec_cache_template(cfg, batch)}
    return {"attn": B.attn_cache_template(cfg, batch, max_seq, spec.window,
                                          spec.kind)}


def cache_template(cfg, batch, max_seq):
    """The decode cache of ``batch`` sequences of up to ``max_seq``
    positions, grouped as the parameters."""
    check_ported(cfg)
    return {"groups": tuple(stack_specs(block_cache_template(
                cfg, b, batch, max_seq), cfg.n_full_patterns)
                for b in cfg.pattern),
            "rem": tuple(block_cache_template(cfg, b, batch, max_seq)
                         for b in cfg.remainder)}


# ------------------------------------------------------------------ blocks
def apply_ffn(cfg, p, x, dtype):
    """The feed-forward sublayer added to the residual stream: the MoE (its
    aux loss dropped) or the dense MLP."""
    if cfg.is_moe:
        delta, _ = B.moe_block(cfg, p["ffn"], x, dtype)
        return x + delta
    return x + B.mlp_block(cfg, p["ffn"], x, dtype)


_MIXER = {"attn": "attn", "local": "attn", "cross": "attn", "rec": "rec",
          "ssd": "ssd"}


def apply_mixer(cfg, spec, p, x, *, positions, vision=None,
                dtype=B.DEFAULT_COMPUTE, use_kernel=True, max_seq=None):
    """The block's first sublayer added to the residual stream: attention
    (a cross block's to ``vision``), the RG-LRU or the SSD mixer. With
    ``max_seq``, returns (x, the block's decode cache) instead."""
    if spec.kind == "ssd":
        delta, c = B.ssd_block(cfg, p["ssd"], x, dtype, use_kernel)
    elif spec.kind == "rec":
        delta, c = B.rec_block(cfg, p["rec"], x, dtype)
    else:
        delta = B.attention_block(
            cfg, p["attn"], x, kind=spec.kind, window=spec.window,
            positions=positions, cross_kv=vision, dtype=dtype,
            use_kernel=use_kernel, return_cache=max_seq is not None,
            max_seq=max_seq)
        if max_seq is not None:
            delta, c = delta
    if max_seq is None:
        return x + delta
    return x + delta, {_MIXER[spec.kind]: c}


def decode_mixer(cfg, spec, p, x, cache, pos: int, *,
                 dtype=B.DEFAULT_COMPUTE):
    """The block's first sublayer for one token x (B, 1, D) at position
    ``pos``, added to the residual stream; writes the block's ``cache``
    in place."""
    name = _MIXER[spec.kind]
    if name == "ssd":
        delta = B.ssd_decode(cfg, p["ssd"], x, cache["ssd"], dtype)
    elif name == "rec":
        delta = B.rec_decode(cfg, p["rec"], x, cache["rec"], dtype)
    else:
        delta = B.attention_decode(cfg, p["attn"], x, cache["attn"], pos,
                                   kind=spec.kind, window=spec.window,
                                   dtype=dtype)
    return x + delta


def apply_block(cfg, spec, p, x, *, positions=None, vision=None,
                mode="train", cache=None, pos=None, max_seq=None,
                dtype=B.DEFAULT_COMPUTE, use_kernel=True):
    """One block: the mixer, then the feed-forward but in an SSD block
    (the mixer alone), each added to the residual stream. "train" and
    "prefill" run the sequence at ``positions`` and return x; a "prefill"
    given ``max_seq`` returns (x, the block's decode cache). "decode" runs
    one token at ``pos`` against ``cache``, which it writes in place, and
    returns (x, cache)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    kw = dict(positions=positions, vision=vision, dtype=dtype,
              use_kernel=use_kernel)
    out = None
    if mode == "decode":
        x = decode_mixer(cfg, spec, p, x, cache, pos, dtype=dtype)
        out = cache
    elif mode == "prefill" and max_seq is not None:
        x, out = apply_mixer(cfg, spec, p, x, max_seq=max_seq, **kw)
    else:
        x = apply_mixer(cfg, spec, p, x, **kw)
    if spec.kind != "ssd":
        x = apply_ffn(cfg, p, x, dtype)
    return x if out is None else (x, out)


def run_blocks(cfg, params, x, lo: int, hi: int, *, remainder: bool,
               vision=None, mode="train", dtype=B.DEFAULT_COMPUTE,
               use_kernel=True):
    """Megablocks [lo, hi) of ``params["groups"]``, then the remainder
    blocks if ``remainder``; cross blocks attend to ``vision``."""
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    kw = dict(positions=positions, vision=vision, mode=mode, dtype=dtype,
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


def vision_in(batch, dev):
    """``batch["vision"]`` (B, vision_tokens, vision_dim) on ``dev``, or
    None."""
    v = batch.get("vision")
    return None if v is None else _input(v, dev)


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
    """``device`` resolved, after refusing an unknown block kind and
    parameters that lie elsewhere."""
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
    {"frames": (B, S, F)}, and {"vision": (B, vision_tokens, vision_dim)}
    for a cross-attention config; numpy arrays or tensors); ``params``
    must already be on ``device``. ``logits_mode``: "all" (B, S, V),
    "last" (B, 1, V) or "none" (returns None). ``use_kernel`` routes
    self-attention to the flash_attention kernel and the SSD mixer to the
    ssd kernel (see ``blocks``).
    Returns the logits, in ``dtype`` (f32 with a softcap); a MoE config's
    aux loss is not returned (only ``lm_loss``, a later slice, needs it)."""
    if logits_mode not in ("all", "last", "none"):
        raise ValueError(f"logits_mode must be all, last or none, got "
                         f"{logits_mode!r}")
    if mode == "decode":
        raise ValueError("forward runs a whole sequence; decode_step runs "
                         "one token against a prefill's cache")
    dev = checked_device(cfg, params, device)
    x = embed_in(cfg, params, batch, dtype, dev)
    x = run_blocks(cfg, params, x, 0, cfg.n_full_patterns, remainder=True,
                   vision=vision_in(batch, dev), mode=mode, dtype=dtype,
                   use_kernel=use_kernel)
    if logits_mode == "none":
        return None
    if logits_mode == "last":
        x = x[:, -1:]
    return logits_out(cfg, params, x, dtype)


# ------------------------------------------------------------------ serving
def _copy_into(dst: dict, src: dict) -> None:
    """Each leaf of ``src`` into the same-shaped leaf of ``dst``."""
    for k, d in dst.items():
        if isinstance(d, dict):
            _copy_into(d, src[k])
        elif d.shape != src[k].shape:
            raise ValueError(f"cache leaf {k!r}: {tuple(src[k].shape)} does "
                             f"not fit {tuple(d.shape)}")
        else:
            d.copy_(src[k])


def prefill(cfg, params, batch, *, max_seq, dtype=B.DEFAULT_COMPUTE,
            use_kernel=True, device="cuda"):
    """The prompt ``batch`` (as ``forward``'s; S tokens at positions 0..S-1)
    through every layer, each block keeping its decode cache sized for
    ``max_seq`` positions (a self-attention ring of min(window, max_seq)
    slots). Returns (the last position's logits (B, 1, V), the cache);
    the logits are ``forward(..., logits_mode="last")``'s. Inference
    only."""
    dev = checked_device(cfg, params, device)
    with torch.inference_mode():
        x = embed_in(cfg, params, batch, dtype, dev)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=dev)[None]
        kw = dict(positions=positions, vision=vision_in(batch, dev),
                  mode="prefill", max_seq=max_seq, dtype=dtype,
                  use_kernel=use_kernel)
        cache = init_cache(cfg, x.shape[0], max_seq, device=dev)
        for i in range(cfg.n_full_patterns):
            for spec, group, gcache in zip(cfg.pattern, params["groups"],
                                           cache["groups"]):
                x, c = apply_block(cfg, spec, tree_map(lambda t: t[i], group),
                                   x, **kw)
                _copy_into(tree_map(lambda t: t[i], gcache), c)
        for spec, p, rcache in zip(cfg.remainder, params["rem"],
                                   cache["rem"]):
            x, c = apply_block(cfg, spec, p, x, **kw)
            _copy_into(rcache, c)
        return logits_out(cfg, params, x[:, -1:], dtype), cache


def init_cache(cfg, batch: int, max_seq: int, *, device="cuda"):
    """An empty decode cache (``cache_template``'s zeros, and -1 for each
    ring's positions) on ``device``, every leaf in its template's dtype."""
    return fill_from_template(cache_template(cfg, batch, max_seq),
                              device=device)


def decode_step(cfg, params, cache, tokens, pos: int, *,
                dtype=B.DEFAULT_COMPUTE, device="cuda"):
    """One decode step: ``tokens`` (B, 1) at position ``pos`` (an int: the
    prompt's S for the first step) through every layer against ``cache``
    (``prefill``'s or ``init_cache``'s), each layer writing its slice in
    place. Returns (logits (B, 1, V), cache). Inference only."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is an encoder (causal=False): it has "
                         "no decode step")
    dev = checked_device(cfg, params, device)
    pos = int(pos)
    with torch.inference_mode():
        x = embed_in(cfg, params, {"tokens": tokens}, dtype, dev)
        for i in range(cfg.n_full_patterns):
            for spec, group, gcache in zip(cfg.pattern, params["groups"],
                                           cache["groups"]):
                x, _ = apply_block(cfg, spec, tree_map(lambda t: t[i], group),
                                   x, mode="decode", pos=pos, dtype=dtype,
                                   cache=tree_map(lambda t: t[i], gcache))
        for spec, p, c in zip(cfg.remainder, params["rem"], cache["rem"]):
            x, _ = apply_block(cfg, spec, p, x, mode="decode", cache=c,
                               pos=pos, dtype=dtype)
        return logits_out(cfg, params, x, dtype), cache
