"""Mamba-2 SSD (state-space dual) scan: the recurrent estimator's mixer.

Inputs are the post-projection tensors of one sequence:
  x  (B, S, nh, hd)   value-like stream
  dt (B, S, nh)       softplus-discretised step sizes
  A  (nh,)            negative per-head decay rates
  Bm (B, S, G, N)     input-expansion vectors (G groups)
  Cm (B, S, G, N)     output-contraction vectors
Output: y (B, S, nh, hd) and the final state (B, G, nh // G, hd, N).

``ssd`` is the wrapper of the CUDA kernels, which takes x, Bm and Cm in
f32 or bf16 and any chunk: by ``route``, ``csrc/ssd.cu`` (fused: f32
chunks whose working set fits one block, the recurrent estimator's) or
``csrc/ssd_chunked.cu``, chunk-parallel: on the tensor cores for bf16
shapes that tile into 16s (the SSD LM's), on the CUDA cores for every
other shape.
``ssd_ref`` is their plain PyTorch version (the reference's ``ref.py``),
which the wrapper runs for tensors on the CPU and the tests hold the
kernels to.
``ssd_mixer`` is the dispatch the estimator calls. ``ssd_step`` is the
same recurrence for one step with an explicit carried state, in plain
torch ops as the reference keeps it (a single step has no tile structure
worth a kernel): scanning it over S steps from a zero state reproduces
the sequence pass.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

F32 = torch.float32
DTYPES = (F32, torch.bfloat16)
FUSED_MAX_CHUNK = 256  # longest chunk the fused route takes
SMEM_BYTES = 232448  # shared memory a block may have on the H100
WGMMA_MAX_HD, WGMMA_MAX_N = 64, 256  # widest x and B/C rows of the
# tensor-core route (one 64-column tile of x; N padded to 64, 128 or 256)
DEVICE_LAUNCHES = {"fused": 1, "chunked": 5, "chunked_wgmma": 4}  # a call


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
    """Shared memory one block of the fused route needs (``csrc/ssd.cu``)."""
    return 4 * (3 * chunk * hpg + 2 * chunk * n + chunk * hpg * hd
                + chunk * (chunk + 1) // 2 + hpg * hd * n)


# (hpg, hd, N) of the fused route's compile-time instances
# (``csrc/ssd.cu`` namespace ``fz``): the recurrent estimator's first
FUSED_INSTANCES = ((4, 8, 8), (4, 16, 8), (4, 32, 16))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def fused_instance(hpg: int, hd: int, n: int, chunk: int,
                   aligned: bool = True) -> str:
    """Which kernel of the fused route runs (``csrc/ssd.cu``'s C entry
    picks it): ``"{hpg}x{hd}x{n}"``, a compile-time instance, where the
    shape is one of ``FUSED_INSTANCES``, x, Bm, Cm, y and the state start
    on 16 bytes (``aligned``) and the instance's working set fits a block
    (dt, B, C and x, lcum and the end decays, four warps' C.B rows of a
    slot, two states); else ``"generic"``. Only for shapes ``route`` sends
    to the fused route."""
    if aligned and (hpg, hd, n) in FUSED_INSTANCES:
        floats = (3 * _round_up(chunk * hpg, 4) + 2 * chunk * n
                  + chunk * hpg * hd + 4 * chunk * (32 // hpg)
                  + 2 * hpg * hd * n)
        if 4 * floats <= SMEM_BYTES:
            return f"{hpg}x{hd}x{n}"
    return "generic"


def padded_n(n: int) -> int:
    """N as the tensor-core kernels tile it: whole 128-byte rows of 64, 128
    or 256 bf16 values (``csrc/ssd_chunked.cu::tc::padded_n``)."""
    return 64 if n <= 64 else 128 if n <= 128 else 256


def wgmma_fits(n: int, chunk: int) -> bool:
    """Whether the tensor-core kernels' blocks fit a block's shared memory,
    as ``csrc/ssd_chunked.cu`` plans them: chunk_scan_tc's (``scan_plan``)
    with one consumer warpgroup (it takes two where they fit), and
    chunk_state_tc's (``SlabPlan``)."""
    np_, n_tt = padded_n(n), -(-chunk // 64)
    scal = (64 + 2 * 64 * n_tt) * 4
    cons = 3 * np_ * 128 + 2 * 64 * 128 + _round_up(2 * scal, 1024)
    scan = (1024 + np_ * 128 + n_tt * max(16384, np_ * 128) + cons
            + 8 * (1 + 10))
    slab_b = np_ // 64 * 32 * 128
    state = (1024 + 4 * (32 * 128 + slab_b)
             + _round_up(-(-chunk // 32) * 32 * 4, 16) + 8 * 4)
    return max(scan, state) <= SMEM_BYTES


def route(dtype: torch.dtype, hpg: int, hd: int, n: int, chunk: int,
          aligned: bool = True) -> str:
    """The kernel a card runs for these inputs:

    - "fused" (``csrc/ssd.cu``, one block a (batch, group) row with the
      carried state in shared memory; a compile-time instance where
      ``fused_instance`` names one) for f32 chunks of at most
      ``FUSED_MAX_CHUNK`` steps whose working set fits a block;
    - "chunked_wgmma" (``csrc/ssd_chunked.cu``, namespace ``tc``: chunk
      states, state passing and an attention-shaped chunk scan on bf16
      ``wgmma``, four launches) for bf16 inputs whose hd, N and chunk are
      multiples of 16, hd at most ``WGMMA_MAX_HD`` and N at most
      ``WGMMA_MAX_N``, whose blocks fit shared memory and whose x, Bm and
      Cm start on 16 bytes (``aligned``: TMA's rule);
    - "chunked" (the same file's CUDA-core kernels, five launches) for
      everything else."""
    if (dtype == F32 and chunk <= FUSED_MAX_CHUNK
            and smem_bytes(hpg, hd, n, chunk) <= SMEM_BYTES):
        return "fused"
    if (dtype == torch.bfloat16 and aligned and hd % 16 == 0
            and n % 16 == 0 and chunk % 16 == 0 and hd <= WGMMA_MAX_HD
            and n <= WGMMA_MAX_N
            and wgmma_fits(n, chunk)):
        return "chunked_wgmma"
    return "chunked"


def _check(x, dt, A, Bm, Cm):
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x and Bm must be 4-D, got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if G < 1 or nh % G:
        raise ValueError(f"{nh} heads do not split into {G} groups")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"the ssd kernel takes x, Bm and Cm all float32 or "
                        f"all bfloat16, got {x.dtype}, {Bm.dtype} and "
                        f"{Cm.dtype}")
    want = {"dt": (B, S, nh), "A": (nh,), "Bm": (B, S, G, N),
            "Cm": (B, S, G, N)}
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype not in DTYPES:
            raise TypeError(f"the ssd kernel takes float32 or bfloat16, "
                            f"{name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 256):
    """The SSD kernel: contiguous inputs as above, x, Bm and Cm all f32 or
    all bf16, S a multiple of ``L = min(chunk, S)`` -> (y (B, S, nh, hd)
    in x's dtype, state (B, G, hpg, hd, N) f32).

    Tensors on the CPU run ``ssd_ref``; on a card the kernel ``route``
    picks runs, or this raises. dt and A are taken in f32 (a bf16 one is
    cast, exactly). The chunked routes allocate f32 workspaces of
    B * S * nh * (1 + hd * N / L) values, and C.B's B * S * G * L f32
    values (CUDA cores) or dt transposed (B * S * nh f32) and the entry
    states' 3 * 64 * padded_n(N) bf16 pieces a (batch, chunk, head)
    (tensor cores)."""
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
    dt, A = dt.to(F32), A.to(F32)
    hpg = nh // G
    y = torch.empty_like(x)
    state = torch.empty((B, G, hpg, hd, N), dtype=F32, device=x.device)
    if B == 0:
        return y, state
    lib = _build.library()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm))
    which = route(x.dtype, hpg, hd, N, L, aligned)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "fused":
            rc = lib.repro_ssd_f32(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, nh, hd,
                G, N, L, stream)
        else:
            # f32 workspaces: the cumulative decays (and, for the tensor
            # cores, dt transposed beside them) and each chunk's state (2
            # and 67 MB at the SSD LM's call); then each chunk's C.B in f32
            # (CUDA cores) or each chunk's entry state as three bf16 pieces
            # (tensor cores: 101 MB there)
            tc = which == "chunked_wgmma"
            lcum = torch.empty((1 + tc, B, nh, S), dtype=F32,
                               device=x.device)
            states = torch.empty((B, S // L, nh, hd, N), dtype=F32,
                                 device=x.device)
            if tc:  # repro_ssd_chunked's kind 2
                kind = 2
                work = torch.empty((B, S // L, nh, 3 * 64 * padded_n(N)),
                                   dtype=torch.bfloat16, device=x.device)
            else:  # kind 0 (f32) or 1 (bf16) on the CUDA cores
                kind = int(x.dtype == torch.bfloat16)
                work = torch.empty((B, S // L, G, L, L), dtype=F32,
                                   device=x.device)
            rc = lib.repro_ssd_chunked(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                lcum.data_ptr(), states.data_ptr(), work.data_ptr(), B, S,
                nh, hd, G, N, L, kind, stream)
    _build.check_launch(rc, f"ssd ({which})")
    _build.LAUNCHES["ssd"] += 1
    _build.ROUTES["ssd"][which] += 1
    return y, state


def ssd_mixer(x, dt, A, Bm, Cm, *, chunk: int = 256,
              use_kernel: bool = True):
    """The sequence pass: ``ssd`` (the kernel on a card) with
    ``use_kernel``, else the plain version."""
    if use_kernel:
        return ssd(x, dt, A, Bm, Cm, chunk=chunk)
    return ssd_ref(x, dt, A, Bm, Cm, chunk)
