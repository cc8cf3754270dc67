"""Building blocks of the LM: attention, the MLP and the Mamba-2 SSD mixer
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
otherwise.

The SSD mixer routes as the reference's ``ssd_block``: ``use_kernel=True``
sends the chunked scan to the ``ssd`` kernel (``kernels.ssd``) with the
chunk ``min(ssm_chunk, S)``, which must divide S; ``use_kernel=False`` is
the reference's XLA route, its plain version in f32 with the whole
sequence as one chunk where the chunk does not divide S. The MoE,
recurrent and cross-attention blocks, ``ssd_decode`` and the decode caches
are later slices (``lm.check_ported``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import mha
from repro_torch.kernels.ssd import ssd, ssd_ref
from repro_torch.models.template import ParamSpec

F32 = torch.float32
DEFAULT_COMPUTE = torch.bfloat16
NEG_INF = -1e30
ATTN_CHUNK = 1024  # kv-chunk of chunked_attention


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
def rope(x, positions, theta):
    """Half-split (not interleaved) rotary embedding in f32. x (..., S, H,
    dh), positions (..., S)."""
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=F32, device=x.device))
    freqs = torch.exp(-log_theta
                      * torch.arange(half, dtype=F32, device=x.device)
                      / half)
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


def attn_template(cfg):
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    t = {
        "ln": ParamSpec((D,), ("embed",), init="zeros"),
        "wq": ParamSpec((D, H, dh), ("fsdp", "heads", None)),
        "wk": ParamSpec((D, KV, dh), ("fsdp", "kv", None)),
        "wv": ParamSpec((D, KV, dh), ("fsdp", "kv", None)),
        "wo": ParamSpec((H, dh, D), ("heads", None, "fsdp")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((H, dh), ("heads", None), init="zeros")
        t["bk"] = ParamSpec((KV, dh), ("kv", None), init="zeros")
        t["bv"] = ParamSpec((KV, dh), ("kv", None), init="zeros")
    return t


def _proj(x, w, dtype):
    """x (B, S, D) @ w (D, *out) -> (B, S, *out), in ``dtype``."""
    B, S, D = x.shape
    w = cast(w, dtype)
    return torch.matmul(x.reshape(B * S, D), w.reshape(D, -1)).reshape(
        B, S, *w.shape[1:])


def qkv_proj(cfg, p, x, dtype=DEFAULT_COMPUTE):
    """q (B, S, H, dh); k, v (B, S, KV, dh) (one GPU: no kv repeat)."""
    q, k, v = (_proj(x, p[n], dtype) for n in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + cast(p["bq"], dtype)
        k = k + cast(p["bk"], dtype)
        v = v + cast(p["bv"], dtype)
    return q, k, v


def attention_block(cfg, p, x, *, kind, window, positions,
                    dtype=DEFAULT_COMPUTE, use_kernel=True):
    """Full-sequence (train / prefill) self-attention sublayer ("attn" or
    "local"). Returns the residual delta (B, S, D)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = qkv_proj(cfg, p, h, dtype)
    scale = cfg.head_dim ** -0.5
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    if use_kernel:
        o = mha(q, k, v, causal=cfg.causal, window=window)
    elif window and S > window:
        o = local_attention(q, k, v, window=window, scale=scale)
    elif S > ATTN_CHUNK:
        o = chunked_attention(q, k, v, causal=cfg.causal, window=window,
                              scale=scale)
    else:
        q_pos = torch.arange(S, device=x.device)
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
        if cfg.causal:
            mask &= q_pos[:, None] >= q_pos[None, :]
        if window:
            mask &= q_pos[:, None] - q_pos[None, :] < window
        o = direct_attention(q, k, v, mask, scale)
    wo = cast(p["wo"], dtype)
    return torch.matmul(o.reshape(B * S, -1), wo.reshape(-1, wo.shape[-1])
                        ).reshape(B, S, -1)


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


# ------------------------------------------------------------------ Mamba2 SSD
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


def _ssd_inputs(cfg, p, x, dtype):
    """The mixer's inputs over a full sequence: z (B, S, Din), x (B, S, nh,
    hd), B and C (B, S, G, N) in ``dtype`` after the conv and silu; dt (B,
    S, nh) = softplus(h wdt + dt_bias) and A = -exp(A_log) (nh,) in f32;
    and the conv states {"x", "B", "C"}."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z = _proj(h, p["wz"], dtype)
    u = _proj(h, p["wdt"], dtype).to(F32) + cast(p["dt_bias"], F32)
    dt = torch.logaddexp(u, torch.zeros_like(u))  # jax.nn.softplus
    conv, states = {}, {}
    for name in ("x", "B", "C"):
        t, states[name] = _causal_conv(_proj(h, p["w" + name], dtype),
                                       cast(p["conv_" + name], dtype), 0.0)
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
