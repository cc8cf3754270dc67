"""Online-softmax attention over (BH, S, dh): the LM's self-attention core.

Inputs are q (BH, Sq, dh) and k, v (BH, Sk, dh), the kv heads already
broadcast to the q heads. Query i sees key j where ``causal`` allows it
(i >= j) and, for ``window`` > 0, where i - j < window, on absolute
positions; the output is (BH, Sq, dh) in q's dtype. Scores, the softmax and
both products are f32, and P stays f32 before P.V (the reference kernel
casts v to f32 first): only the output is rounded to q's dtype.

``flash_attention`` is the wrapper of the CUDA kernels in
``csrc/flash_attention.cu``, chosen by q's dtype: bf16 runs the Hopper
kernel (both products on ``wgmma``, K and V tiles through a TMA ring, P
carried as three bf16 pieces whose sum is P exactly, so P.V stays the
reference's f32 product), f32 the FMA kernel. ``split_bf16x3`` (from
``kernels.pieces``) is the plain version of that split, for the tests.
``attention_ref`` is the kernels' plain PyTorch version (the reference's
``ref.py``), which the wrapper runs for tensors on the CPU and the tests
hold the kernels to. ``mha`` is the
GQA entry point of the LM blocks, in the reference's ``ops.py`` layout, and
differentiable: the forward runs the wrapper, the backward recomputes
through ``attention_ref`` (there is no backward kernel in the reference
either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pieces import split_bf16x3  # noqa: F401

F32 = torch.float32
NEG_INF = -1e30  # the reference's mask value
HEAD_DIMS = (64, 80, 128, 256)  # stablelm, hubert, granite/qwen2/gemma3,
# recurrentgemma: every attention config of the repo


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """q (BH, Sq, dh), k and v (BH, Sk, dh) -> (BH, Sq, dh) in q's dtype:
    f32 scores, the masks, a softmax and an f32 P.V."""
    _, Sq, dh = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else dh ** -0.5
    s = torch.matmul(q.to(F32), k.to(F32).transpose(1, 2)) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(F32)).to(q.dtype)


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be (BH, S, dh), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in (F32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    BH, Sq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != dh:
        raise ValueError(f"k and v must be (BH, Sk, dh) = ({BH}, Sk, {dh}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    Sk = k.shape[1]
    if Sq < 1 or Sk < 1:
        raise ValueError("empty sequence")
    # the reference's blocks are min(128, S) and must tile S
    for name, n in (("Sq", Sq), ("Sk", Sk)):
        if n % min(128, n):
            raise ValueError(f"{name} = {n} is not a multiple of "
                             f"min(128, {name}) = 128")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """The attention kernel: contiguous f32 or bf16 q (BH, Sq, dh), k and v
    (BH, Sk, dh), each S a multiple of min(128, S) -> (BH, Sq, dh) in q's
    dtype.

    Tensors on the CPU run ``attention_ref``; on a card the CUDA kernel
    runs (head dims 64, 80, 128 and 256), or this raises."""
    window = int(window)
    _check(q, k, v, window)
    BH, Sq, dh = q.shape
    scale = float(scale) if scale is not None else dh ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head dims {HEAD_DIMS},"
                         f" got {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    o = torch.empty_like(q)
    lib = _build.library()
    entry = (lib.repro_flash_attention_bf16 if q.dtype == torch.bfloat16
             else lib.repro_flash_attention_f32)
    with torch.cuda.device(q.device):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   BH, Sq, k.shape[1], dh, int(causal), window, scale,
                   torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return o


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` forward; the backward differentiates
    ``attention_ref`` (the same function) at the saved inputs, as the
    reference's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)

    @staticmethod
    def backward(ctx, grad):
        causal, window, scale = ctx.args
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_()
                       for t in ctx.saved_tensors)
            out = attention_ref(q, k, v, causal=causal, window=window,
                                scale=scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None, None


def flatten_gqa(q, k, v):
    """(B, S, H, dh) q and (B, S, KV, dh) k, v -> (B*H, S, dh) each, kv
    head h // (H / KV) repeated for q head h (kv-major)."""
    B, Sq, H, dh = q.shape

    def flat(t):  # (B, S, n, dh) -> (B * H, S, dh), contiguous
        t = t.transpose(1, 2)
        if t.shape[1] != H:
            t = t.repeat_interleave(H // t.shape[1], dim=1)
        return t.contiguous().view(B * H, t.shape[2], dh)

    return flat(q), flat(k), flat(v)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        use_kernel: bool = True) -> torch.Tensor:
    """Multi-head attention. q (B, S, H, dh); k, v (B, S, KV, dh) (GQA).
    ``use_kernel`` runs the kernel (its plain version for CPU tensors),
    else ``attention_ref``. Returns (B, S, H, dh)."""
    B, Sq, H, dh = q.shape
    qf, kf, vf = flatten_gqa(q, k, v)
    if use_kernel:
        of = FlashAttention.apply(qf, kf, vf, causal, window, None)
    else:
        of = attention_ref(qf, kf, vf, causal=causal, window=window)
    return of.reshape(B, H, Sq, dh).transpose(1, 2)
