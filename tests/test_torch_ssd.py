"""Port parity for the ssd stage: the plain PyTorch chunked SSD against the
JAX ``ssd`` (its Pallas kernel in interpret mode) and ``ssd_ref`` at the
reference's test shapes, a chunk above 256 steps and the SSD LM's 32
heads a group, in f32 (y within 1e-4, the state within 1e-3, as the
reference's own kernel test) and in bf16 (y within one bf16 ulp of each
element over a floor of 1e-5 of its largest magnitude, the state as in
f32); chunk-size invariance; the O(1) step scanned over a sequence equals
the sequence pass; large steps stay finite; the wrapper refuses what the
kernels do not take."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd as ref_ssd
from repro.kernels.ssd import ssd_ref as ref_ssd_ref
from repro.kernels.ssd import ssd_step as ref_ssd_step
from repro_torch.kernels.pieces import split_bf16x3
from repro_torch.kernels.ssd import (fused_instance, route, ssd, ssd_mixer,
                                     ssd_ref, ssd_step)
from test_torch_kernels_cuda import FUSED_SHAPES, bf16_close

# (S, L, nh, hd, G, N): the reference's test shapes, a chunk above 256
# steps, and the SSD LM's 32 heads in one group at small widths
SHAPES = [(64, 16, 4, 16, 1, 8), (128, 32, 8, 32, 2, 16),
          (96, 96, 2, 8, 1, 4), (512, 512, 2, 8, 1, 4),
          (64, 32, 32, 4, 1, 8)]


def _inputs(seed, B, S, nh, hd, G, N, dt_scale=0.5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    dt = (np.logaddexp(rng.normal(size=(B, S, nh)), 0.0)
          * dt_scale).astype(np.float32)
    A = (-np.exp(rng.normal(size=nh) * 0.3)).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S,L,nh,hd,G,N", SHAPES)
def test_ssd_matches_reference(S, L, nh, hd, G, N):
    arrs = _inputs(S + L, 2, S, nh, hd, G, N)
    jx = [jnp.asarray(a) for a in arrs]
    for want_y, want_s in (ref_ssd(*jx, chunk=L), ref_ssd_ref(*jx, L)):
        for got_y, got_s in (ssd(*_t(arrs), chunk=L), ssd_ref(*_t(arrs), L)):
            assert got_y.dtype == torch.float32
            assert got_s.shape == (2, G, nh // G, hd, N)
            np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                       rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("S,L,nh,hd,G,N", SHAPES)
def test_ssd_bf16_matches_reference(S, L, nh, hd, G, N):
    """bf16 x, B and C (dt and A f32, as the LM gives them): y in bf16,
    rounded once from the f32 sum, the state in f32."""
    x, dt, A, Bm, Cm = _inputs(S + L + 1, 2, S, nh, hd, G, N)
    jx = [jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dt),
          jnp.asarray(A), jnp.asarray(Bm).astype(jnp.bfloat16),
          jnp.asarray(Cm).astype(jnp.bfloat16)]
    tx = [torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dt),
          torch.from_numpy(A), torch.from_numpy(Bm).to(torch.bfloat16),
          torch.from_numpy(Cm).to(torch.bfloat16)]
    for want_y, want_s in (ref_ssd(*jx, chunk=L), ref_ssd_ref(*jx, L)):
        want_y = np.asarray(want_y.astype(jnp.float32))
        for got_y, got_s in (ssd(*tx, chunk=L), ssd_ref(*tx, L)):
            assert got_y.dtype == torch.bfloat16
            assert got_s.dtype == torch.float32
            assert bf16_close(got_y, torch.from_numpy(want_y))
            np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                       rtol=1e-3, atol=1e-3)


def _pieces_product(eq, factor, operand):
    """einsum(eq) of an f32 factor and an exact bf16 operand as the tensor
    cores take it: the factor as its three bf16 pieces, each product with
    f32 sums, the smallest piece first, added in f32."""
    hi, mid, lo = split_bf16x3(factor)
    out = torch.einsum(eq, lo.float(), operand)
    out = out + torch.einsum(eq, mid.float(), operand)
    return out + torch.einsum(eq, hi.float(), operand)


def ssd_wgmma_plain(x, dt, A, Bm, Cm, L):
    """The arithmetic of ``csrc/ssd_chunked.cu``'s tensor-core route in
    plain torch: C.B of exact bf16 values with f32 sums; dt folded into
    M'[t, s] = exp(lcum[t] - lcum[s]) C.B[t, s] dt[s] (masked before the
    exp) and into B'[t, n] = B[t, n] dt[t] exp(lcum[L-1] - lcum[t]); each
    f32 factor (M', B', the entry states) split by ``split_bf16x3`` into
    pieces whose products with x or C are summed in f32; y = intra +
    exp(lcum[t]) C s^T rounded once."""
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg, nc = nh // G, S // L
    xc = x.float().reshape(B, nc, L, G, hpg, hd)
    dtc = dt.float().reshape(B, nc, L, G, hpg)
    Bc = Bm.float().reshape(B, nc, L, G, N)
    Cc = Cm.float().reshape(B, nc, L, G, N)
    lcum = torch.cumsum(dtc * A.float().reshape(G, hpg), dim=2)
    CB = torch.einsum("bctgn,bcsgn->bcgts", Cc, Bc)
    lg = lcum.permute(0, 1, 3, 4, 2)  # (B, nc, G, hpg, L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    arg = torch.where(tri, lg[..., :, None] - lg[..., None, :], -torch.inf)
    M = (torch.exp(arg) * CB[:, :, :, None]
         * dtc.permute(0, 1, 3, 4, 2)[..., None, :])  # (.., t, s)
    y_intra = _pieces_product("bcghts,bcsghd->bctghd", M, xc)
    w = dtc * torch.exp(lcum[:, :, -1:] - lcum)  # (B, nc, L, G, hpg)
    S_c = _pieces_product("bctghn,bctghd->bcghdn",
                          Bc[:, :, :, :, None] * w[..., None], xc)
    cd = torch.exp(lcum[:, :, -1])  # (B, nc, G, hpg)
    states = [torch.zeros((B, G, hpg, hd, N))]
    for c in range(nc):
        states.append(states[-1] * cd[:, c][..., None, None] + S_c[:, c])
    s_prev = torch.stack(states[:-1], dim=1)  # (B, nc, G, hpg, hd, N)
    y_inter = (_pieces_product("bcghdn,bctgn->bctghd", s_prev, Cc)
               * torch.exp(lcum)[..., None])
    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    return y.to(x.dtype), states[-1]


# (S, L, nh, hd, G, N, dt_scale): the reduced SSD LM's widths, two groups
# over chunks of 64, a chunk of 128 at the LM's head width, and steps of
# ~40 whose decays fall far below 2^-100, where the pieces stop being exact
WGMMA_SHAPES = [(64, 16, 4, 32, 1, 16, 0.5), (256, 64, 4, 16, 2, 32, 0.5),
                (256, 128, 8, 64, 1, 16, 0.5),
                (128, 64, 4, 32, 1, 16, 40.0)]


@pytest.mark.parametrize("S,L,nh,hd,G,N,dt_scale", WGMMA_SHAPES)
def test_wgmma_arithmetic_matches_plain(S, L, nh, hd, G, N, dt_scale):
    """The tensor-core formulation, in bf16, against ``ssd_ref``: y within
    one bf16 ulp of each element (over a floor of 1e-5 of max|y|), the
    state within 1e-4 of its largest magnitude, everything finite. These
    shapes are the ones the wrapper sends to the tensor cores."""
    x, dt, A, Bm, Cm = _inputs(S + L + nh, 2, S, nh, hd, G, N, dt_scale)
    tx = [torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dt),
          torch.from_numpy(A), torch.from_numpy(Bm).to(torch.bfloat16),
          torch.from_numpy(Cm).to(torch.bfloat16)]
    assert route(torch.bfloat16, nh // G, hd, N, L) == "chunked_wgmma"
    y, st = ssd_wgmma_plain(*tx, L)
    yr, sr = ssd_ref(*tx, L)
    assert y.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    assert bf16_close(y, yr)
    assert (st - sr).abs().max() <= 1e-4 * sr.abs().max()


@pytest.mark.parametrize("dtype,hd,N,L,aligned,want", [
    (torch.bfloat16, 64, 128, 256, True, "chunked_wgmma"),  # mamba2-370m
    (torch.bfloat16, 32, 16, 16, True, "chunked_wgmma"),    # its reduced()
    (torch.bfloat16, 64, 128, 512, True, "chunked_wgmma"),
    (torch.bfloat16, 24, 20, 40, True, "chunked"),  # not in 16s
    (torch.bfloat16, 8, 8, 256, True, "chunked"),
    (torch.bfloat16, 80, 64, 64, True, "chunked"),  # hd above 64
    (torch.bfloat16, 64, 128, 1024, True, "chunked"),  # C.B past smem
    (torch.bfloat16, 64, 128, 256, False, "chunked"),  # TMA's alignment
    (torch.float32, 64, 128, 256, True, "chunked"),
    (torch.float32, 8, 8, 64, True, "fused")])
def test_route_follows_dtype_and_shape(dtype, hd, N, L, aligned, want):
    assert route(dtype, 32 if hd == 64 else 4, hd, N, L, aligned) == want


@pytest.mark.parametrize("shape,instance", FUSED_SHAPES + [
    ((2, 96, 96, 2, 8, 1, 4), "generic"), ((3, 256, 256, 2, 8, 1, 8),
                                           "generic")])
def test_fused_route_and_instance(shape, instance):
    """Every f32 shape of the card tests meant for the fused route takes it,
    on the instance the C entry picks; an unaligned base takes the generic
    kernel."""
    B, S, L, nh, hd, G, N = shape
    assert route(torch.float32, nh // G, hd, N, L) == "fused"
    assert fused_instance(nh // G, hd, N, L) == instance
    assert fused_instance(nh // G, hd, N, L, aligned=False) == "generic"


def test_chunk_size_invariance():
    arrs = _t(_inputs(11, 2, 256, 4, 16, 2, 8))
    y0, s0 = ssd_mixer(*arrs, chunk=64, use_kernel=False)
    for chunk in (128, 256):
        for use_kernel in (False, True):
            y, s = ssd_mixer(*arrs, chunk=chunk, use_kernel=use_kernel)
            torch.testing.assert_close(y, y0, rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(s, s0, rtol=2e-5, atol=2e-5)


def test_step_scan_matches_sequence_pass():
    x, dt, A, Bm, Cm = _inputs(12, 2, 48, 4, 8, 2, 4)
    y_seq, s_seq = ssd_mixer(*_t((x, dt, A, Bm, Cm)), chunk=16)
    state = torch.zeros(tuple(s_seq.shape))
    ys = []
    for i in range(x.shape[1]):
        y, state = ssd_step(*_t((x[:, i], dt[:, i], A, Bm[:, i], Cm[:, i])),
                            state)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_seq, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(state, s_seq, rtol=1e-4, atol=1e-4)


def test_ssd_step_matches_reference():
    x, dt, A, Bm, Cm = _inputs(13, 3, 1, 4, 8, 2, 4)
    st = np.random.default_rng(1).normal(size=(3, 2, 2, 8, 4)).astype(
        np.float32)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], st)
    want_y, want_s = ref_ssd_step(*[jnp.asarray(a) for a in args])
    got_y, got_s = ssd_step(*_t(args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_large_dt_stays_finite(use_kernel):
    """Steps of ~40 drive the decay to exp(-40 * ...) underflow: masking
    before the exp keeps every output finite."""
    arrs = _t(_inputs(14, 2, 128, 4, 8, 1, 8, dt_scale=40.0))
    y, s = ssd_mixer(*arrs, chunk=64, use_kernel=use_kernel)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def test_zero_dt_rows_leave_the_state():
    """The padding the estimator adds (dt = 0 rows) changes no state."""
    x, dt, A, Bm, Cm = _inputs(15, 2, 40, 4, 8, 1, 8)
    pad = [np.concatenate([a, np.zeros_like(a[:, :24])], 1)
           for a in (x, dt, Bm, Cm)]
    _, s = ssd(*_t((x, dt, A, Bm, Cm)), chunk=40)
    _, s_pad = ssd(*_t((pad[0], pad[1], A, pad[2], pad[3])), chunk=64)
    torch.testing.assert_close(s_pad, s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["bf16", "f16", "shape", "chunk", "groups",
                                 "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """bf16: x in bf16 beside f32 B and C (x, B and C share one type); f16
    is neither f32 nor bf16."""
    x, dt, A, Bm, Cm = _t(_inputs(16, 1, 32, 4, 8, 1, 8))
    chunk = 16
    if bad == "bf16":
        x = x.to(torch.bfloat16)
    elif bad == "f16":
        x, Bm, Cm = (t.to(torch.float16) for t in (x, Bm, Cm))
    elif bad == "shape":
        dt = dt[:, :, :3].contiguous()
    elif bad == "chunk":
        chunk = 12  # 32 is not a multiple of 12
    elif bad == "groups":
        Bm = torch.zeros((1, 32, 3, 8))
        Cm = Bm.clone()
    else:
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        ssd(x, dt, A, Bm, Cm, chunk=chunk)
