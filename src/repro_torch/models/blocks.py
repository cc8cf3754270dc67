"""Building blocks of the LM: attention (self and cross), the MLP, the
MoE feed-forward, the RG-LRU recurrent block and the Mamba-2 SSD mixer
(template-driven).

Every block has a ``*_template(cfg)`` returning a ParamSpec tree and a
forward taking ``(cfg, params, x, ...)``. Compute runs in the given dtype
(bf16 by default) with f32 norms, rope, scores and softmax, as the
reference's ``models/blocks.py``. Weight layouts are the reference's:
``wq`` (D, H, dh), ``wk``/``wv`` (D, KV, dh), ``wo`` (H, dh, D); they are
reshaped to 2-D only inside, for ``torch.matmul``.

GQA is kv-major everywhere: q head h uses kv head h // (H / KV).

Self-attention routes as the reference's ``attention_block``:
``use_kernel=True`` (the reference's ``USE_PALLAS_ATTENTION``) sends every
full-sequence self-attention to the ``flash_attention`` kernel through
``kernels.flash_attention.mha``; ``use_kernel=False`` takes
``local_attention`` for a window shorter than the sequence,
``chunked_attention`` past ``ATTN_CHUNK`` tokens and ``direct_attention``
otherwise. Cross-attention (to the vision embeddings) always takes
``chunked_attention``, non-causal and without rope, as the reference's,
which never sends it to its kernel.

The SSD mixer routes as the reference's ``ssd_block``: ``use_kernel=True``
sends the chunked scan to the ``ssd`` kernel (``kernels.ssd``) with the
chunk ``min(ssm_chunk, S)``, which must divide S; ``use_kernel=False`` is
the reference's XLA route, its plain version in f32 with the whole
sequence as one chunk where the chunk does not divide S.

The MoE feed-forward (``moe_block``), the RG-LRU scan (``rec_block``) and
the cross-attention core are torch ops, as the reference leaves them to
XLA.

Decode: a prefill (``attention_block(return_cache=True)``, ``rec_block``,
``ssd_block``) returns each block's cache, whose layout the
``*_cache_template`` functions give; ``attention_decode``, ``rec_decode``
and ``ssd_decode`` take one token (B, 1, D) and a scalar position and
write the block's cache in place. A self-attention cache is a ring of
``W = min(window, max_seq)`` slots (``max_seq`` without a window): the
token at position ``pos`` sits in slot ``pos % W``, and ``pos`` (W,)
int32 holds each slot's position, -1 when empty. Its k and v are bf16,
or int8 codes with f32 scales (``cfg.kv_dtype == "int8"``) through
``core.boundary.rowwise_quant``, so the ``quantize`` kernel on a card. A
cross block's cache is the projected vision k and v in bf16, never
updated. The decode cores are torch ops, as the reference leaves them to
XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import mha
from repro_torch.kernels.ssd import ssd, ssd_ref
from repro_torch.models.template import ParamSpec, fill_from_template

F32 = torch.float32
DEFAULT_COMPUTE = torch.bfloat16
NEG_INF = -1e30
ATTN_CHUNK = 1024  # kv-chunk of chunked_attention
MOE_GROUP = 1024  # tokens per MoE dispatch group


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x


# ------------------------------------------------------------------ norms
def rms_norm(x, scale, eps):
    """f32 RMS norm scaled by (1 + scale): the scale is stored as an offset
    from 1 (initialised to zeros), so this is not ``nn.RMSNorm``."""
    xf = cast(x, F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + cast(scale, F32))
    return cast(out, x.dtype)


def _act(name):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# ------------------------------------------------------------------ rope
_FREQS: dict = {}


def _rope_freqs(theta, half: int, device) -> torch.Tensor:
    """exp(-log(theta) i / half) for i < half, f32, on ``device``: made
    once a (theta, half, device), since the upload of theta to a card
    waits for the card, once a rope call at every decode step."""
    key = (float(theta), half, device)
    if key not in _FREQS:
        with torch.inference_mode(False):
            log_theta = torch.log(torch.tensor(theta, dtype=F32,
                                               device=device))
            _FREQS[key] = torch.exp(
                -log_theta * torch.arange(half, dtype=F32, device=device)
                / half)
    return _FREQS[key]


def rope(x, positions, theta):
    """Half-split (not interleaved) rotary embedding in f32. x (..., S, H,
    dh), positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(theta, half, x.device)
    ang = positions[..., None].to(F32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(cast(x, F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return cast(out, x.dtype)


# ------------------------------------------------------------------ attention
def _gqa_scores(q, k, scale):
    """q (B, Sq, KV, G, dh), k (B, Sk, KV, dh) -> (B, KV, G, Sq, Sk) f32.
    bf16 products are exact in f32, so upcasting first is the reference's
    f32-accumulated product."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(F32), k.to(F32)) * scale


def _pv(p, v):
    """(B, KV, G, Sq, Sk) weights x (B, Sk, KV, dh) values, f32 sums, with
    P rounded to v's dtype first, as the reference's non-kernel paths."""
    return torch.einsum("bkgqs,bskd->bkgqd", cast(p, v.dtype).to(F32),
                        v.to(F32))


def direct_attention(q, k, v, mask, scale):
    """Full-materialisation attention. q (B, Sq, H, dh); k, v (B, Sk, KV,
    dh); mask broadcastable to (B, 1, 1, Sq, Sk)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    s = _gqa_scores(q.reshape(B, Sq, KV, H // KV, dh), k, scale)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o = _pv(p, v).permute(0, 3, 1, 2, 4)  # (B, Sq, KV, G, dh)
    return cast(o.reshape(B, Sq, H, dh), q.dtype)


def chunked_attention(q, k, v, *, causal, window, scale, chunk=ATTN_CHUNK):
    """Online-softmax attention over kv chunks; exact. q (B, Sq, H, dh),
    k and v (B, Sk, KV, dh). ``window`` > 0 restricts each query to the
    trailing ``window`` keys."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if Sk % chunk:
        chunk = Sk  # one chunk
    qg = q.reshape(B, Sq, KV, G, dh)
    q_pos = torch.arange(Sq, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, dh), dtype=F32, device=q.device)
    m = torch.full((B, KV, G, Sq), -math.inf, dtype=F32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=F32, device=q.device)
    for c0 in range(0, Sk, chunk):
        s = _gqa_scores(qg, k[:, c0:c0 + chunk], scale)
        k_pos = c0 + torch.arange(chunk, device=q.device)
        valid = torch.ones((Sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            valid &= q_pos[:, None] >= k_pos[None, :]
        if window:
            valid &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _pv(p, v[:, c0:c0 + chunk])
        m = m_new
    o = acc / torch.clamp_min(l[..., None], 1e-30)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh)
    return cast(o, q.dtype)


def local_attention(q, k, v, *, window, scale):
    """Exact sliding-window attention over (previous + own) blocks of
    ``window`` rows: O(S * 2 window) scores instead of O(S^2)."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    w = window
    pad = (-S) % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    nb = (S + pad) // w
    qb = q.reshape(B, nb, w, KV, G, dh)
    kb = k.reshape(B, nb, w, KV, dh)
    vb = v.reshape(B, nb, w, KV, dh)

    def shift(t):  # block i -> block i - 1, zeros before the first
        return F.pad(t, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]

    kctx = torch.cat([shift(kb), kb], dim=2)  # (B, nb, 2w, KV, dh)
    vctx = torch.cat([shift(vb), vb], dim=2)
    q_pos = torch.arange(w, device=q.device)[:, None]  # within-block
    k_pos = torch.arange(2 * w, device=q.device)[None, :] - w
    rel = q_pos - k_pos  # absolute distance q - k
    valid = (rel >= 0) & (rel < w)
    outs = []
    for i in range(nb):
        s = torch.einsum("bqkgd,bskd->bkgqs", qb[:, i].to(F32),
                         kctx[:, i].to(F32)) * scale
        v_ok = valid & ~(k_pos < 0) if i == 0 else valid
        p = torch.softmax(torch.where(v_ok, s, NEG_INF), dim=-1)
        o = _pv(p, vctx[:, i]).permute(0, 3, 1, 2, 4)  # (B, w, KV, G, dh)
        outs.append(cast(o, q.dtype))
    o = torch.stack(outs, dim=1).reshape(B, S + pad, H, dh)
    return o[:, :S]


def attn_template(cfg, kind: str = "attn"):
    """Self-attention ("attn", "local"), or cross-attention ("cross"):
    ``wk``/``wv`` then take ``vision_dim`` inputs and a scalar ``gate``
    (zeros) scales the output by tanh(gate)."""
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    kv_in = cfg.vision_dim if kind == "cross" else D
    t = {
        "ln": ParamSpec((D,), ("embed",), init="zeros"),
        "wq": ParamSpec((D, H, dh), ("fsdp", "heads", None)),
        "wk": ParamSpec((kv_in, KV, dh), ("fsdp", "kv", None)),
        "wv": ParamSpec((kv_in, KV, dh), ("fsdp", "kv", None)),
        "wo": ParamSpec((H, dh, D), ("heads", None, "fsdp")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((H, dh), ("heads", None), init="zeros")
        t["bk"] = ParamSpec((KV, dh), ("kv", None), init="zeros")
        t["bv"] = ParamSpec((KV, dh), ("kv", None), init="zeros")
    if kind == "cross":
        t["gate"] = ParamSpec((), (), init="zeros")
    return t


def _proj(x, w, dtype):
    """x (B, S, D) @ w (D, *out) -> (B, S, *out), in ``dtype``."""
    B, S, D = x.shape
    w = cast(w, dtype)
    return torch.matmul(x.reshape(B * S, D), w.reshape(D, -1)).reshape(
        B, S, *w.shape[1:])


def qkv_proj(cfg, p, x, cross_kv=None, dtype=DEFAULT_COMPUTE):
    """q (B, S, H, dh) from x; k, v (B, Sk, KV, dh) from ``cross_kv`` (B,
    Sk, vision_dim), cast to ``dtype``, or else from x (one GPU: no kv
    repeat)."""
    kv_src = x if cross_kv is None else cast(cross_kv, dtype)
    q = _proj(x, p["wq"], dtype)
    k, v = (_proj(kv_src, p[n], dtype) for n in ("wk", "wv"))
    if cfg.qkv_bias:
        q = q + cast(p["bq"], dtype)
        k = k + cast(p["bk"], dtype)
        v = v + cast(p["bv"], dtype)
    return q, k, v


def _self_attention(cfg, q, k, v, *, window, scale, use_kernel):
    """The core ``use_kernel`` and the shape choose, on rope'd q and k."""
    S = q.shape[1]
    if use_kernel:
        return mha(q, k, v, causal=cfg.causal, window=window)
    if window and S > window:
        return local_attention(q, k, v, window=window, scale=scale)
    if S > ATTN_CHUNK:
        return chunked_attention(q, k, v, causal=cfg.causal, window=window,
                                 scale=scale)
    q_pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if cfg.causal:
        mask &= q_pos[:, None] >= q_pos[None, :]
    if window:
        mask &= q_pos[:, None] - q_pos[None, :] < window
    return direct_attention(q, k, v, mask, scale)


def _out_proj(p, o, dtype):
    """o (B, S, H, dh) @ wo (H, dh, D) -> (B, S, D)."""
    B, S = o.shape[:2]
    wo = cast(p["wo"], dtype)
    return torch.matmul(o.reshape(B * S, -1), wo.reshape(-1, wo.shape[-1])
                        ).reshape(B, S, -1)


def _gated(p, out, dtype):
    """A cross block's output scaled by tanh(gate)."""
    return torch.tanh(cast(p["gate"], F32)).to(dtype) * out


def attention_block(cfg, p, x, *, kind, window, positions, cross_kv=None,
                    dtype=DEFAULT_COMPUTE, use_kernel=True,
                    return_cache=False, max_seq=None):
    """Full-sequence (train / prefill) attention sublayer: self-attention
    ("attn" or "local"), or cross-attention ("cross") to ``cross_kv`` (B,
    Sk, vision_dim), non-causal, without rope, through
    ``chunked_attention`` whatever ``use_kernel`` says, its output scaled
    by tanh(gate). Returns the residual delta (B, S, D); with
    ``return_cache``, (delta, the decode cache of this prefill, its ring
    sized for ``max_seq`` positions, S if None)."""
    cross = kind == "cross"
    if cross and cross_kv is None:
        raise ValueError("a cross-attention block needs the vision "
                         "embeddings (batch['vision'])")
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = qkv_proj(cfg, p, h, cross_kv if cross else None, dtype)
    scale = cfg.head_dim ** -0.5
    if cross:
        o = chunked_attention(q, k, v, causal=False, window=0, scale=scale)
    else:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        o = _self_attention(cfg, q, k, v, window=window, scale=scale,
                            use_kernel=use_kernel)
    out = _out_proj(p, o, dtype)
    if cross:
        out = _gated(p, out, dtype)
    if not return_cache:
        return out
    if cross:
        return out, {"k": cast(k, torch.bfloat16),
                     "v": cast(v, torch.bfloat16)}
    return out, _prefill_cache(cfg, k, v, window, max_seq or x.shape[1])


def _ring(window, max_seq) -> int:
    """A self-attention cache's slots: the window, at most ``max_seq``."""
    return min(window, max_seq) if window else max_seq


def _prefill_cache(cfg, k, v, window, max_seq):
    """The ring of ``_ring(window, max_seq)`` slots (``attn_cache_template``)
    filled from the prompt's rope'd k, v (B, S, KV, dh): its last ``keep =
    min(W, S)`` tokens, the token at position t in slot t % W."""
    Bsz, S = k.shape[:2]
    cache = fill_from_template(attn_cache_template(cfg, Bsz, max_seq, window,
                                                   "attn"), device=k.device)
    W = cache["pos"].shape[0]
    keep = min(W, S)
    pos = torch.arange(S - keep, S, dtype=torch.int32, device=k.device)
    slots = (pos % W).long()
    cache["pos"][slots] = pos
    for name, t in (("k", k[:, S - keep:]), ("v", v[:, S - keep:])):
        if cfg.kv_dtype == "int8":
            t, sc = _kv_quant(t)
            cache[name + "_scale"][:, slots] = sc
        cache[name][:, slots] = cast(t, cache[name].dtype)
    return cache


def _kv_quant(x):
    """Symmetric int8 over head_dim, one scale a (token, head): the
    boundary codec's formula (the quantize kernel on a card)."""
    from repro_torch.core.boundary import rowwise_quant  # an import cycle
    return rowwise_quant(x, 127)


def _kv_deq(q, s, dtype):
    return (q.to(F32) * s).to(dtype)


def decode_attention(q, ck, cv, cpos, pos: int, *, window, scale):
    """One query over a (ring) cache. q (B, 1, H, dh); ck, cv (B, W, KV,
    dh); cpos (W,) int32, the position in each slot (-1 empty); a slot
    counts where 0 <= cpos <= pos (and pos - cpos < window). f32 scores
    and softmax; P rounded to the cache's dtype before P.V, as the
    reference's."""
    B, _, H, dh = q.shape
    KV = ck.shape[2]
    s = _gqa_scores(q.reshape(B, 1, KV, H // KV, dh), ck, scale)[..., 0, :]
    valid = (cpos >= 0) & (cpos <= pos)
    if window:
        valid &= pos - cpos < window
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)  # (B,KV,G,W)
    o = torch.einsum("bkgw,bwkd->bkgd", cast(p, cv.dtype).to(F32),
                     cv.to(F32))
    return cast(o.reshape(B, 1, H, dh), q.dtype)


def attention_decode(cfg, p, x, cache, pos: int, *, kind, window,
                     dtype=DEFAULT_COMPUTE):
    """One-token attention sublayer. x (B, 1, D). A self-attention block
    ropes q and k at ``pos`` and writes k, v (or their int8 codes and
    scales) and ``pos`` into slot ``pos % W`` of ``cache`` in place; an
    int8 cache is dequantized whole to ``dtype`` for the core. A cross
    block reads its cache (every slot valid) and scales by tanh(gate).
    Returns the residual delta (B, 1, D)."""
    pos = int(pos)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    scale = cfg.head_dim ** -0.5
    if kind == "cross":  # q without its bias, as the reference's
        q = _proj(h, p["wq"], dtype)
        zeros = torch.zeros(cache["k"].shape[1], dtype=torch.int32,
                            device=x.device)
        o = decode_attention(q, cache["k"], cache["v"], zeros, pos,
                             window=0, scale=scale)
        return _gated(p, _out_proj(p, o, dtype), dtype)
    q, k, v = qkv_proj(cfg, p, h, None, dtype)
    at = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, at, cfg.rope_theta)
    k = rope(k, at, cfg.rope_theta)
    slot = pos % cache["k"].shape[1]
    ck, cv = cache["k"], cache["v"]
    if cfg.kv_dtype == "int8":
        for name, t in (("k", k), ("v", v)):
            codes, sc = _kv_quant(t)
            cache[name][:, slot] = codes[:, 0]
            cache[name + "_scale"][:, slot] = sc[:, 0]
        ck = _kv_deq(ck, cache["k_scale"], dtype)
        cv = _kv_deq(cv, cache["v_scale"], dtype)
    else:
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
    cache["pos"][slot] = pos
    o = decode_attention(q, ck, cv, cache["pos"], pos, window=window,
                         scale=scale)
    return _out_proj(p, o, dtype)


def attn_cache_template(cfg, batch, max_seq, window, kind):
    """A self-attention block's ring (see ``_prefill_cache``) or a cross
    block's vision k, v (``vision_tokens`` rows, bf16). One card: no kv
    repeat."""
    KV, dh = cfg.kv_heads, cfg.head_dim
    if kind == "cross":
        W = cfg.vision_tokens
        return {n: ParamSpec((batch, W, KV, dh), ("batch", None, "kv", None),
                             torch.bfloat16, "zeros") for n in ("k", "v")}
    W = _ring(window, max_seq)
    int8 = cfg.kv_dtype == "int8"
    kv_dt = torch.int8 if int8 else torch.bfloat16
    axes = ("batch", "cache_seq", "kv", None)
    t = {"k": ParamSpec((batch, W, KV, dh), axes, kv_dt, "zeros"),
         "v": ParamSpec((batch, W, KV, dh), axes, kv_dt, "zeros"),
         "pos": ParamSpec((W,), ("cache_seq",), torch.int32, "neg_ones")}
    if int8:
        for n in ("k_scale", "v_scale"):
            t[n] = ParamSpec((batch, W, KV, 1), axes, F32, "zeros")
    return t


# ------------------------------------------------------------------ MLP
def mlp_template(cfg):
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "ln": ParamSpec((D,), ("embed",), init="zeros"),
        "wg": ParamSpec((D, Fd), ("fsdp", "ff")),
        "wu": ParamSpec((D, Fd), ("fsdp", "ff")),
        "wd": ParamSpec((Fd, D), ("ff", "fsdp")),
    }


def mlp_block(cfg, p, x, dtype=DEFAULT_COMPUTE):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    g = _act(cfg.act)(_proj(h, p["wg"], dtype))
    u = _proj(h, p["wu"], dtype)
    return _proj(g * u, p["wd"], dtype)


# ------------------------------------------------------------------ MoE
def moe_template(cfg):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "ln": ParamSpec((D,), ("embed",), init="zeros"),
        "router": ParamSpec((D, E), (None, None), init="fan_in"),
        "wg": ParamSpec((E, D, Fd), ("experts", "fsdp", "ff")),
        "wu": ParamSpec((E, D, Fd), ("experts", "fsdp", "ff")),
        "wd": ParamSpec((E, Fd, D), ("experts", "ff", "fsdp")),
    }


def moe_group(T: int) -> int:
    """Tokens per dispatch group: MOE_GROUP, or all T where it does not
    divide T."""
    g = min(MOE_GROUP, T)
    return T if T % g else g


def _one_hot(i, n: int):
    return (i[..., None] == torch.arange(n, device=i.device)).to(torch.long)


def moe_route(cfg, p, h) -> dict:
    """Top-k routing of the normed tokens ``h`` (B, S, D), in groups of
    ``moe_group(B * S)`` tokens: f32 router logits and softmax, the top k
    (the lower expert first on ties, as ``lax.top_k``), their weights
    renormalised by max(sum, 1e-9), and each (token, k)'s place in its
    expert's queue, by k and then by token; a place at or past the
    capacity max(1, int(capacity_factor * g * K / E)) drops it. Returns
    {"probs" (nG, g, E) f32, "top_p" (nG, g, K) f32, "top_i", "slot"
    (nG, g, K) int64, "keep" (nG, g, K) bool, "cap"}. The router's
    product is f32: TF32 must be off (``torch.backends.cuda.matmul.
    allow_tf32``, off by default)."""
    B, S, D = h.shape
    E, K = cfg.num_experts, cfg.top_k
    g = moe_group(B * S)
    nG = B * S // g
    logits = torch.matmul(cast(h, F32).reshape(nG, g, D),
                          cast(p["router"], F32))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :K], top_i[..., :K]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    cap = max(1, int(cfg.capacity_factor * g * K / E))
    flat = _one_hot(top_i.transpose(1, 2).reshape(nG, K * g), E)
    pos = torch.cumsum(flat, dim=1) - flat  # exclusive, by k then token
    slot = (pos * flat).sum(-1).reshape(nG, K, g).transpose(1, 2)
    return {"probs": probs, "top_p": top_p, "top_i": top_i, "slot": slot,
            "keep": slot < cap, "cap": cap}


def moe_block(cfg, p, x, dtype=DEFAULT_COMPUTE):
    """The MoE feed-forward, full-sequence: ``moe_route``, then each kept
    (token, k) gathered into its (expert, slot) row (empty slots are zero
    rows), the experts' gated MLP as batched products over the experts in
    ``dtype``, and each token's kept rows summed in f32 with weights
    top_p rounded to ``dtype`` first, rounded once: the sums of the
    reference's one-hot dispatch and combine, without its products by
    zero. Returns (the residual delta (B, S, D), the aux loss)."""
    B, S, D = x.shape
    E, K, T = cfg.num_experts, cfg.top_k, B * S
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    r = moe_route(cfg, p, h)
    nG, g, _ = r["top_i"].shape
    n_rows = E * nG * r["cap"]
    # rows in (expert, group, slot) order; a dropped (token, k) goes to a
    # discard row past them
    grp = torch.arange(nG, device=x.device)[:, None, None]
    row = (r["top_i"] * nG + grp) * r["cap"] + r["slot"]
    row = torch.where(r["keep"], row, n_rows)
    tok = torch.arange(T, device=x.device).reshape(nG, g, 1).expand(-1, -1, K)
    src = torch.full((n_rows + 1,), T, dtype=torch.long, device=x.device)
    src.scatter_(0, row.reshape(-1), tok.reshape(-1))
    xt = cast(h, dtype).reshape(T, D)
    xe = torch.cat([xt, xt.new_zeros(1, D)]).index_select(0, src[:-1])
    xe = xe.reshape(E, nG * r["cap"], D)
    hid = _act(cfg.act)(torch.matmul(xe, cast(p["wg"], dtype)))
    hid = hid * torch.matmul(xe, cast(p["wu"], dtype))
    ye = torch.matmul(hid, cast(p["wd"], dtype)).reshape(n_rows, D)
    del xe, hid
    keep = r["keep"].reshape(T, K, 1)
    yk = ye.index_select(0, torch.where(r["keep"], row, 0).reshape(-1))
    w = cast(r["top_p"], dtype).to(F32).reshape(T, K, 1)
    y = torch.where(keep, yk.reshape(T, K, D).to(F32) * w, 0.0).sum(1)
    # the Switch load-balancing loss: E * sum_e(mean prob_e * share_e) / K
    me = r["probs"].mean(dim=(0, 1))
    fe = _one_hot(r["top_i"], E).sum(2).to(F32).mean(dim=(0, 1))
    return cast(y, dtype).reshape(B, S, D), E * torch.sum(me * fe) / K


# ------------------------------------------------------------------ RG-LRU
def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B, S, W), w (cw, W); ``state`` (B, cw - 1,
    W), the previous inputs, or None for zeros on the left. Returns (y,
    new state: the last cw - 1 rows of the padded input, None when cw is
    1)."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([cast(state, x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw))
    new_state = xp[:, -(cw - 1):] if cw > 1 else None
    return y + b, new_state


_LRU_C = 8.0


def rec_template(cfg):
    D, W = cfg.d_model, cfg.lru_width
    cw = cfg.conv1d_width
    return {
        "ln": ParamSpec((D,), ("embed",), init="zeros"),
        "wx": ParamSpec((D, W), ("fsdp", "ff")),
        "wy": ParamSpec((D, W), ("fsdp", "ff")),
        "conv_w": ParamSpec((cw, W), (None, "ff"), init="fan_in"),
        "conv_b": ParamSpec((W,), ("ff",), init="zeros"),
        "wi": ParamSpec((W, W), ("fsdp", "ff")),
        "wa": ParamSpec((W, W), ("fsdp", "ff")),
        "lam": ParamSpec((W,), ("ff",), init="normal", scale=0.5),
        "wo": ParamSpec((W, D), ("ff", "fsdp")),
    }


def _softplus(u):
    return torch.logaddexp(u, torch.zeros_like(u))  # jax.nn.softplus


def _rglru_gates(p, xc, dtype):
    """The decay a = exp(-8 softplus(lam) r) and the gated input
    sqrt(max(1 - a^2, 1e-9)) i xc, both f32, from the input and recurrence
    gates i, r (sigmoids in ``dtype``)."""
    i = torch.sigmoid(_proj(xc, p["wi"], dtype))
    r = torch.sigmoid(_proj(xc, p["wa"], dtype))
    log_a = -_LRU_C * _softplus(cast(p["lam"], F32)) * cast(r, F32)
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9))
             * cast(i, F32) * cast(xc, F32))
    return a, gated


def rglru_scan(a, b):
    """h_t = a_t h_(t-1) + b_t along dim 1 from h_(-1) = 0, for every t:
    the odd/even recursion of the reference's ``lax.associative_scan``
    (pairs combined, the half-length scan, then the even positions), so
    the sums group as the reference's, in log2(S) levels of torch ops."""
    n = a.shape[1]
    if n < 2:
        return b
    a2 = a[:, 1::2]
    odd = rglru_scan(a[:, 0:-1:2] * a2, b[:, 0:-1:2] * a2 + b[:, 1::2])
    ae = a[:, 2::2]
    out = torch.empty_like(b)
    out[:, :1] = b[:, :1]
    out[:, 1::2] = odd
    out[:, 2::2] = odd[:, :ae.shape[1]] * ae + b[:, 2::2]
    return out


def rec_block(cfg, p, x, dtype=DEFAULT_COMPUTE):
    """The RG-LRU temporal-mixing sublayer, full-sequence. Returns (the
    residual delta (B, S, D), the decode state {"h": the last step's
    state (B, W) f32, "conv": the conv state in bf16})."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xb = _proj(h, p["wx"], dtype)
    yb = _act(cfg.act)(_proj(h, p["wy"], dtype))
    xc, conv_state = _causal_conv(xb, cast(p["conv_w"], dtype),
                                  cast(p["conv_b"], dtype))
    a, gated = _rglru_gates(p, xc, dtype)
    hseq = rglru_scan(a, gated)
    out = _proj(cast(hseq, dtype) * yb, p["wo"], dtype)
    return out, {"h": hseq[:, -1], "conv": cast(conv_state, torch.bfloat16)}


def rec_decode(cfg, p, x, cache, dtype=DEFAULT_COMPUTE):
    """The RG-LRU sublayer for one token x (B, 1, D): the conv over the
    carried inputs, then h = a h_prev + gated in f32. Writes {"h",
    "conv"} of ``cache`` in place; returns the residual delta."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xb = _proj(h, p["wx"], dtype)
    yb = _act(cfg.act)(_proj(h, p["wy"], dtype))
    xc, conv_state = _causal_conv(xb, cast(p["conv_w"], dtype),
                                  cast(p["conv_b"], dtype), cache["conv"])
    a, gated = _rglru_gates(p, xc, dtype)
    hnew = a * cache["h"][:, None] + gated  # (B, 1, W) f32
    out = _proj(cast(hnew, dtype) * yb, p["wo"], dtype)
    cache["h"].copy_(hnew[:, 0])
    cache["conv"].copy_(conv_state)
    return out


def rec_cache_template(cfg, batch):
    W, cw = cfg.lru_width, cfg.conv1d_width
    return {"h": ParamSpec((batch, W), ("batch", "ff"), F32, "zeros"),
            "conv": ParamSpec((batch, cw - 1, W), ("batch", None, "ff"),
                              torch.bfloat16, "zeros")}


# ------------------------------------------------------------------ Mamba2 SSD
def ssd_template(cfg):
    D, Din, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, G, cw = cfg.d_inner // cfg.ssm_headdim, cfg.ssm_ngroups, \
        cfg.conv1d_width
    return {
        "ln": ParamSpec((D,), ("embed",), init="zeros"),
        "wz": ParamSpec((D, Din), ("fsdp", "ff")),
        "wx": ParamSpec((D, Din), ("fsdp", "ff")),
        "wB": ParamSpec((D, G * N), ("fsdp", None)),
        "wC": ParamSpec((D, G * N), ("fsdp", None)),
        "wdt": ParamSpec((D, nh), ("fsdp", "heads")),
        "dt_bias": ParamSpec((nh,), ("heads",), init="zeros"),
        "A_log": ParamSpec((nh,), ("heads",), init="normal", scale=0.5),
        "Dskip": ParamSpec((nh,), ("heads",), init="ones"),
        "conv_x": ParamSpec((cw, Din), (None, "ff"), init="fan_in"),
        "conv_B": ParamSpec((cw, G * N), (None, None), init="fan_in"),
        "conv_C": ParamSpec((cw, G * N), (None, None), init="fan_in"),
        "norm": ParamSpec((Din,), ("ff",), init="zeros"),
        "wo": ParamSpec((Din, D), ("ff", "fsdp")),
    }


def _ssd_inputs(cfg, p, x, dtype, conv_state=None):
    """The mixer's inputs over a sequence: z (B, S, Din), x (B, S, nh,
    hd), B and C (B, S, G, N) in ``dtype`` after the conv and silu; dt (B,
    S, nh) = softplus(h wdt + dt_bias) and A = -exp(A_log) (nh,) in f32;
    and the conv states {"x", "B", "C"}, each conv starting from
    ``conv_state`` (a decode cache's) or from zeros."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z = _proj(h, p["wz"], dtype)
    u = _proj(h, p["wdt"], dtype).to(F32) + cast(p["dt_bias"], F32)
    dt = _softplus(u)
    conv, states = {}, {}
    for name in ("x", "B", "C"):
        t, states[name] = _causal_conv(
            _proj(h, p["w" + name], dtype), cast(p["conv_" + name], dtype),
            0.0, None if conv_state is None else conv_state[name])
        conv[name] = F.silu(t)
    Bsz, S = x.shape[:2]
    nh, G, N = cfg.d_inner // cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    xh = conv["x"].reshape(Bsz, S, nh, cfg.ssm_headdim)
    Bg = conv["B"].reshape(Bsz, S, G, N)
    Cg = conv["C"].reshape(Bsz, S, G, N)
    A = -torch.exp(cast(p["A_log"], F32))
    return z, xh, Bg, Cg, dt, A, states


def ssd_block(cfg, p, x, dtype=DEFAULT_COMPUTE, use_kernel=True):
    """The Mamba-2 mixer, full-sequence: quadratic within chunks, the state
    recurrence across them. Returns (the residual delta (B, S, D), the
    cache {"s": final state (B, G, hpg, hd, N) f32, "conv": the conv
    states in bf16})."""
    z, xh, Bg, Cg, dt, A, conv_states = _ssd_inputs(cfg, p, x, dtype)
    Bsz, S = x.shape[:2]
    L = min(cfg.ssm_chunk, S)
    if use_kernel:  # y in the compute dtype; S % L raises
        y, s_last = ssd(xh, dt, A, Bg, Cg, chunk=L)
    else:  # y in f32 until the gate, one chunk where L does not divide S
        y, s_last = ssd_ref(cast(xh, F32), dt, A, Bg, Cg, S if S % L else L)
    y = cast(y, F32) + cast(p["Dskip"], F32)[:, None] * cast(xh, F32)
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = rms_norm(cast(y, dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    cache = {"s": s_last, "conv": {k: cast(v, torch.bfloat16)
                                   for k, v in conv_states.items()}}
    return _proj(y, p["wo"], dtype), cache


def ssd_decode(cfg, p, x, cache, dtype=DEFAULT_COMPUTE):
    """The Mamba-2 mixer for one token x (B, 1, D): the convs over the
    carried inputs, then s = exp(dt A) s + B (dt x) and y = C.s + Dskip x
    in f32, the gated norm and ``wo``. Writes {"s", "conv"} of ``cache``
    in place; returns the residual delta."""
    z, xh, Bg, Cg, dt, A, new_conv = _ssd_inputs(cfg, p, x, dtype,
                                                  cache["conv"])
    Bsz, _, nh, hd = xh.shape
    G = Bg.shape[2]
    hpg = nh // G
    dA = torch.exp(dt[:, 0] * A)  # (B, nh)
    xf = cast(xh[:, 0], F32).reshape(Bsz, G, hpg, hd)
    duh = dt[:, 0].reshape(Bsz, G, hpg, 1) * xf
    s = cache["s"] * dA.reshape(Bsz, G, hpg, 1, 1) + torch.einsum(
        "bgn,bghd->bghdn", cast(Bg[:, 0], F32), duh)
    y = torch.einsum("bgn,bghdn->bghd", cast(Cg[:, 0], F32), s)
    y = y + cast(p["Dskip"], F32).reshape(1, G, hpg, 1) * xf
    y = rms_norm(cast(y.reshape(Bsz, 1, nh * hd), dtype) * F.silu(z),
                 p["norm"], cfg.norm_eps)
    cache["s"].copy_(s)
    for name, st in new_conv.items():
        cache["conv"][name].copy_(st)
    return _proj(y, p["wo"], dtype)


def ssd_cache_template(cfg, batch):
    nh = cfg.d_inner // cfg.ssm_headdim
    G, N, hd = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    cw = cfg.conv1d_width
    return {
        "s": ParamSpec((batch, G, nh // G, hd, N),
                       ("batch", None, "heads", None, None), F32, "zeros"),
        "conv": {n: ParamSpec((batch, cw - 1, w), ("batch", None, ax),
                              torch.bfloat16, "zeros")
                 for n, w, ax in (("x", cfg.d_inner, "ff"),
                                  ("B", G * N, None), ("C", G * N, None))},
    }
