"""Port parity for the attention kernel's plain version and the GQA entry
point: ``attention_ref`` (what the wrapper runs for CPU tensors) against the
JAX package's ``attention_ref`` and its Pallas ``flash_attention`` in
interpret mode at S = 256 (two 128-row kv blocks), head dims 64 and 128,
causal and not, windows 0, 8 and 100, in f32 (1e-5 absolute) and bf16 (two
bf16 ulps of the largest output magnitude: the f32 sums run in other
orders, and the output is rounded to bf16 once); ``mha`` with GQA (4 q
heads over 2 kv heads) against the JAX ``mha``; the wrapper's errors; the
autograd backward (recomputed through ``attention_ref``) against
``jax.vjp`` of the JAX ``mha``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as ref_attention
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import mha as ref_mha
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention, mha,
                                                 split_bf16x3)

F32_ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _bf16_bound(ref: np.ndarray) -> float:
    """Two bf16 ulps of the largest magnitude."""
    return 2.0 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    tol = F32_ATOL if dtype == "float32" else _bf16_bound(want)
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [0, 8, 100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128])
def test_plain_matches_reference(dh, causal, window, dtype):
    jdt, tdt = DTYPES[dtype]
    arrs = _arrays(dh + window + causal, *[(4, 256, dh)] * 3)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrs)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (4, 256, dh)
    _close(got, ref_attention(jq, jk, jv, causal=causal, window=window),
           dtype)
    _close(got, ref_flash(jq, jk, jv, causal=causal, window=window,
                          interpret=True), dtype)


def test_explicit_scale_and_short_sequence():
    """A sequence shorter than a block (one block of S rows) and a given
    scale, as the reference's ``block = min(128, S)``."""
    q, k, v = _arrays(3, (2, 48, 64), (2, 48, 64), (2, 48, 64))
    want = ref_flash(*map(jnp.asarray, (q, k, v)), causal=True, scale=0.3,
                     interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          scale=0.3)
    _close(got, want, "float32")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mha_gqa_matches_reference(use_kernel):
    q, k, v = _arrays(7, (2, 256, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64))
    want = ref_mha(*map(jnp.asarray, (q, k, v)), causal=True, window=0,
                   use_kernel=use_kernel, interpret=True)
    before = LAUNCHES["flash_attention"]
    got = mha(*map(torch.from_numpy, (q, k, v)), causal=True,
              use_kernel=use_kernel)
    assert got.shape == (2, 256, 4, 64)
    _close(got, want, "float32")
    assert LAUNCHES["flash_attention"] == before  # the CPU runs no kernel


def test_backward_matches_jax_vjp():
    """Gradients of the kernel path (GQA, causal, window 100) through the
    autograd Function equal ``jax.vjp`` of the reference's custom_vjp."""
    q, k, v, g = _arrays(11, (2, 256, 4, 64), (2, 256, 2, 64),
                         (2, 256, 2, 64), (2, 256, 4, 64))
    out, vjp = jax.vjp(lambda a, b, c: ref_mha(
        a, b, c, causal=True, window=100, use_kernel=True, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_out = mha(tq, tk, tv, causal=True, window=100)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(g))
    _close(got_out.detach(), out, "float32")
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-5 * max(1.0, np.abs(b).max()), (name, err)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,error,match", [
    ((_t(4, 64), _t(4, 64), _t(4, 64)), ValueError, "must be"),
    ((_t(2, 16, 8, dtype=torch.float16),) * 3, TypeError, "float32 or"),
    ((_t(2, 16, 8), _t(2, 16, 8, dtype=torch.bfloat16), _t(2, 16, 8)),
     ValueError, "q is"),
    ((_t(2, 8, 16).transpose(1, 2), _t(2, 16, 8), _t(2, 16, 8)), ValueError,
     "contiguous"),
    ((_t(2, 16, 8), _t(2, 16, 4), _t(2, 16, 4)), ValueError, "k and v"),
    ((_t(2, 200, 8),) * 3, ValueError, "multiple of"),
    ((_t(2, 128, 8), _t(2, 192, 8), _t(2, 192, 8)), ValueError, "Sk"),
], ids=["ndim", "dtype", "mixed", "strided", "kv-shape", "ragged-q",
        "ragged-k"])
def test_wrapper_errors(args, error, match):
    with pytest.raises(error, match=match):
        flash_attention(*args)


def test_wrapper_refuses_other_devices_and_windows():
    with pytest.raises(ValueError, match="window"):
        flash_attention(*(_t(1, 16, 8),) * 3, window=-1)
    meta = torch.zeros((1, 16, 8), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        flash_attention(meta, meta, meta)


def test_plain_is_the_reference_formula_on_unequal_lengths():
    """Sq != Sk (a block each) with a window: the masks act on absolute
    positions, as the reference's."""
    q, k, v = _arrays(5, (2, 64, 64), (2, 128, 64), (2, 128, 64))
    want = ref_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                         window=16)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=16)
    _close(got, want, "float32")


def _split_inputs(family: str, n: int = 200_000) -> np.ndarray:
    rng = np.random.default_rng(19)
    if family == "log-uniform":  # p over [2^-100, 1]
        p = np.exp2(rng.uniform(-100.0, 0.0, n))
    elif family == "signed":  # the ssd kernel's M', B' and states
        p = rng.normal(size=n) * np.exp2(rng.uniform(-90.0, 20.0, n))
    else:  # the softmax's own values: exp(-x), x up to 69
        p = np.exp(-rng.uniform(0.0, 69.0, n))
    return np.concatenate([p, [1.0, 2.0 ** -100]]).astype(np.float32)


@pytest.mark.parametrize("family", ["log-uniform", "exp", "signed"])
def test_split_bf16x3_sums_to_p_exactly(family):
    """The bf16 kernels carry an f32 factor as three bf16 pieces: their sum
    is it bit for bit wherever |p| >= 2^-100 (P's scores within 69 of the
    row's max; the ssd kernel's signed M', B' and states)."""
    p = torch.from_numpy(_split_inputs(family))
    pieces = split_bf16x3(p)
    assert all(t.dtype == torch.bfloat16 for t in pieces)
    total = sum(t.double() for t in pieces)
    assert torch.equal(total, p.double())


def test_split_bf16x3_loses_nothing_of_weight_below_2_pow_100():
    """exp(-x) for x from 69 to 104: the residue falls into f32's
    subnormals, and what is lost stays under 1e-40 (against l >= 1)."""
    x = np.random.default_rng(20).uniform(69.0, 104.0, 100_000)
    p = torch.from_numpy(np.exp(-x).astype(np.float32))
    total = sum(t.double() for t in split_bf16x3(p))
    assert float((total - p.double()).abs().max()) < 1e-40


@pytest.mark.parametrize("family", ["log-uniform", "exp", "signed"])
def test_split_bf16x3_products_sum_to_p_v(family):
    """Each piece times a bf16 v is exact in f32 (8 x 8 significant
    bits), so the three f32 products summed in f32 give p v up to the two
    f32 roundings of the sums."""
    p = torch.from_numpy(_split_inputs(family))
    v = torch.from_numpy(np.random.default_rng(21).normal(
        size=p.shape).astype(np.float32)).to(torch.bfloat16).float()
    lo, mid, hi = (t.float() * v for t in reversed(split_bf16x3(p)))
    got = (lo + mid) + hi  # f32, the smallest first as the kernel's order
    want = p.double() * v.double()
    assert bool(((got.double() - want).abs()
                 <= 2.0 ** -22 * want.abs()).all())
