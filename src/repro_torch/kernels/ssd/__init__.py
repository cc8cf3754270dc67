"""Mamba-2 SSD (state-space dual) scan: the recurrent estimator's mixer.

Inputs are the post-projection tensors of one sequence:
  x  (B, S, nh, hd)   value-like stream
  dt (B, S, nh)       softplus-discretised step sizes
  A  (nh,)            negative per-head decay rates
  Bm (B, S, G, N)     input-expansion vectors (G groups)
  Cm (B, S, G, N)     output-contraction vectors
Output: y (B, S, nh, hd) and the final state (B, G, nh // G, hd, N).

``ssd`` is the wrapper of the CUDA kernel ``csrc/ssd.cu``; ``ssd_ref`` is
its plain PyTorch version (the reference's ``ref.py``), which the wrapper
runs for tensors on the CPU and the tests hold the kernel to.
``ssd_mixer`` is the dispatch the estimator calls. ``ssd_step`` is the
same recurrence for one step with an explicit carried state, in plain
torch ops as the reference keeps it (a single step has no tile structure
worth a kernel): scanning it over S steps from a zero state reproduces
the sequence pass.

The kernel takes f32 only; bf16 inputs and the LM stack's widths wait for
ROADMAP.md module queue item 14.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

F32 = torch.float32
MAX_CHUNK = 256  # longest chunk the kernel takes
SMEM_BYTES = 232448  # shared memory a block may have on the H100


def ssd_step(x_t, dt_t, A, B_t, C_t, state):
    """One SSD recurrence step: S' = exp(dt*A) * S + dt * (B (x) x).

    ``x_t`` (B, nh, hd); ``dt_t`` (B, nh); ``A`` (nh,); ``B_t``/``C_t``
    (B, G, N); ``state`` (B, G, nh//G, hd, N), the sequence pass's
    carried-state layout. Returns (y_t (B, nh, hd), new state)."""
    b, nh, hd = x_t.shape
    G = B_t.shape[1]
    hpg = nh // G
    dA = (dt_t.to(F32) * A.to(F32)).reshape(b, G, hpg)
    du = (dt_t.to(F32)[..., None] * x_t.to(F32)).reshape(b, G, hpg, hd)
    state = (state.to(F32) * torch.exp(dA)[..., None, None]
             + torch.einsum("bgn,bghd->bghdn", B_t.to(F32), du))
    y = torch.einsum("bgn,bghdn->bghd", C_t.to(F32), state)
    return y.reshape(b, nh, hd).to(x_t.dtype), state


def ssd_ref(x, dt, A, Bm, Cm, chunk: int):
    """The chunked sequence pass in plain torch ops: (y, final state)."""
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = nh // G
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {L}")
    nc = S // L
    xc = x.to(F32).reshape(B, nc, L, G, hpg, hd)
    dtc = dt.to(F32).reshape(B, nc, L, nh)
    Bc = Bm.to(F32).reshape(B, nc, L, G, N)
    Cc = Cm.to(F32).reshape(B, nc, L, G, N)
    dA = dtc * A.to(F32)
    lcum = torch.cumsum(dA, dim=2)  # (B, nc, L, nh)
    CB = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc)
    decay = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (.., t, s, nh)
    decay = decay.permute(0, 1, 4, 2, 3)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # mask BEFORE the exp: the upper triangle holds lcum[s] - lcum[t] > 0,
    # which overflows exp once dt grows
    M = torch.exp(torch.where(tri, decay, float("-inf"))
                  ).reshape(B, nc, G, hpg, L, L)
    M = M * CB[:, :, :, None]
    du = dtc.reshape(B, nc, L, G, hpg)[..., None] * xc
    y_intra = torch.einsum("bcghts,bcsghd->bctghd", M, du)
    lend = lcum[:, :, -1:, :]
    sdecay = torch.exp(lend - lcum).reshape(B, nc, L, G, hpg)
    S_c = torch.einsum("bcsgn,bcsghd->bcghdn", Bc, du * sdecay[..., None])
    cd = torch.exp(lend[:, :, 0]).reshape(B, nc, G, hpg)
    states = [torch.zeros((B, G, hpg, hd, N), dtype=F32, device=x.device)]
    for c in range(nc):
        states.append(states[-1] * cd[:, c][..., None, None] + S_c[:, c])
    s_prev = torch.stack(states[:-1], dim=1)  # (B, nc, G, hpg, hd, N)
    qdecay = torch.exp(lcum).reshape(B, nc, L, G, hpg)
    y_inter = (torch.einsum("bctgn,bcghdn->bctghd", Cc, s_prev)
               * qdecay[..., None])
    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    return y.to(x.dtype), states[-1]


def smem_bytes(hpg: int, hd: int, n: int, chunk: int) -> int:
    """Shared memory one block of the kernel needs (``csrc/ssd.cu``)."""
    return 4 * (3 * chunk * hpg + 2 * chunk * n + chunk * hpg * hd
                + chunk * (chunk + 1) // 2 + hpg * hd * n)


def _check(x, dt, A, Bm, Cm):
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x and Bm must be 4-D, got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if G < 1 or nh % G:
        raise ValueError(f"{nh} heads do not split into {G} groups")
    want = {"dt": (B, S, nh), "A": (nh,), "Bm": (B, S, G, N),
            "Cm": (B, S, G, N)}
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != F32:
            raise TypeError(
                f"the ssd kernel takes float32 only, {name} is {t.dtype}: "
                "bf16 waits for ROADMAP.md module queue item 14")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 256):
    """The SSD kernel: contiguous f32 inputs as above, S a multiple of
    ``min(chunk, S)`` -> (y (B, S, nh, hd), state (B, G, hpg, hd, N)).

    Tensors on the CPU run ``ssd_ref``; on a card the CUDA kernel runs, or
    this raises. The kernel takes chunks of at most ``MAX_CHUNK`` steps
    whose working set fits a block's shared memory (``smem_bytes``)."""
    _check(x, dt, A, Bm, Cm)
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {L}")
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd kernel for device {x.device}")
    hpg = nh // G
    need = smem_bytes(hpg, hd, N, L)
    if L > MAX_CHUNK or need > SMEM_BYTES:
        raise ValueError(
            f"the ssd kernel takes chunks of at most {MAX_CHUNK} steps whose "
            f"working set fits {SMEM_BYTES} B of shared memory; chunk {L} "
            f"with hpg {hpg}, hd {hd}, N {N} needs {need} B")
    y = torch.empty_like(x)
    state = torch.empty((B, G, hpg, hd, N), dtype=F32, device=x.device)
    if B == 0:
        return y, state
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, nh, hd, G, N,
            L, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "ssd")
    _build.LAUNCHES["ssd"] += 1
    return y, state


def ssd_mixer(x, dt, A, Bm, Cm, *, chunk: int = 256,
              use_kernel: bool = True):
    """The sequence pass: ``ssd`` (the kernel on a card) with
    ``use_kernel``, else the plain version."""
    if use_kernel:
        return ssd(x, dt, A, Bm, Cm, chunk=chunk)
    return ssd_ref(x, dt, A, Bm, Cm, chunk)
