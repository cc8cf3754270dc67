"""Port parity for the ssd stage: the plain PyTorch chunked SSD against the
JAX ``ssd`` (its Pallas kernel in interpret mode) and ``ssd_ref`` at the
reference's test shapes in f32 (y within 1e-4, the state within 1e-3, as
the reference's own kernel test); chunk-size invariance; the O(1) step
scanned over a sequence equals the sequence pass; large steps stay
finite; the wrapper refuses what the kernel does not take."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd as ref_ssd
from repro.kernels.ssd import ssd_ref as ref_ssd_ref
from repro.kernels.ssd import ssd_step as ref_ssd_step
from repro_torch.kernels.ssd import ssd, ssd_mixer, ssd_ref, ssd_step

SHAPES = [(64, 16, 4, 16, 1, 8), (128, 32, 8, 32, 2, 16),
          (96, 96, 2, 8, 1, 4)]


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


@pytest.mark.parametrize("bad", ["bf16", "shape", "chunk", "groups",
                                 "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, dt, A, Bm, Cm = _t(_inputs(16, 1, 32, 4, 8, 1, 8))
    chunk = 16
    if bad == "bf16":
        x = x.to(torch.bfloat16)
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
