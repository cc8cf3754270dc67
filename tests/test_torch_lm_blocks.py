"""Port parity for the LM's parts: the norm, rope and the three
non-kernel attention cores in f32 within 1e-5 of the output's largest
magnitude; the SSD mixer of mamba2-370m (both routes, f32 and bf16) and
its causal conv; and every block of gemma3-27b (local windows, gelu, tied
embeddings, softcap), qwen2-72b (qkv bias), mixtral-8x22b and
llama4-scout-17b-a16e (MoE, top-2 and top-1), recurrentgemma-2b (RG-LRU
and local attention) and llama-3.2-vision-90b (cross-attention to seeded
vision embeddings) on the reference's own input, through both attention
routes, in f32 within 1e-5 and in bf16 within two bf16 ulps of the block
output's largest magnitude (the end-to-end forwards of gemma3-27b, scout
and the VLM in bf16 amplify any 1-ulp difference; see
``test_torch_lm.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import blocks as ref_blocks
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.models import blocks, init_params, lm
from repro_torch.models.template import tree_map
from repro_torch.weights import lm_params_from_reference
from test_torch_kernels_cuda import bf16_close
from test_torch_lm import numpy_params

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _reference(name, seed):
    """Both packages' reduced config and one set of weights made from a
    seed, as the reference's tree of arrays and of JAX arrays."""
    cfg = get_config(name).reduced()
    tree = numpy_params(cfg, seed)
    return (ref_get_config(name).reduced(), cfg,
            jax.tree.map(jnp.asarray, tree), tree)


def test_norm_rope_and_attention_cores_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 4, 16)).astype(np.float32) * 3
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32) * 3
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    sc = rng.normal(size=16).astype(np.float32) * 0.1
    pos = np.arange(64, dtype=np.int32)[None]
    J, T = jnp.asarray, torch.from_numpy

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()

    close(blocks.rms_norm(T(x), T(sc), 1e-6), ref_blocks.rms_norm(
        J(x), J(sc), 1e-6))
    close(blocks.rope(T(x), T(pos), 1e7), ref_blocks.rope(J(x), J(pos), 1e7))
    scale = 16 ** -0.5
    qp = np.arange(64)
    mask = (qp[:, None] >= qp[None, :]) & (qp[:, None] - qp[None, :] < 24)
    close(blocks.direct_attention(T(x), T(k), T(v), T(mask), scale),
          ref_blocks.direct_attention(J(x), J(k), J(v), J(mask), scale))
    for causal, window in ((True, 0), (True, 24), (False, 0)):
        close(blocks.chunked_attention(T(x), T(k), T(v), causal=causal,
                                       window=window, scale=scale, chunk=16),
              ref_blocks.chunked_attention(J(x), J(k), J(v), causal=causal,
                                           window=window, scale=scale,
                                           chunk=16))
    for w in (8, 24):  # 64 rows in 8 blocks, and padded to 72
        close(blocks.local_attention(T(x), T(k), T(v), window=w,
                                     scale=scale),
              ref_blocks.local_attention(J(x), J(k), J(v), window=w,
                                         scale=scale))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["gemma3-27b", "qwen2-72b", "mixtral-8x22b",
                                  "llama4-scout-17b-a16e",
                                  "recurrentgemma-2b",
                                  "llama-3.2-vision-90b"])
def test_blocks_match_reference(name, dtype):
    """Each block (and the logits) on the reference's own input: f32
    within 1e-5, bf16 within two bf16 ulps, of the output's largest
    magnitude."""
    jdt, tdt = DTYPES[dtype]
    ref_cfg, cfg, rp, tree = _reference(name, 3)
    params = lm_params_from_reference(tree, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)}
    vision = tvision = None
    if cfg.vision_dim:
        v = rng.normal(size=(2, cfg.vision_tokens, cfg.vision_dim)).astype(
            np.float32)
        vision, tvision = jnp.asarray(v), torch.from_numpy(v)
    x = ref_lm.embed_in(ref_cfg, rp, batch, jdt)
    got = lm.embed_in(cfg, params, batch, tdt, "cpu")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    layers = [(s, jax.tree.map(lambda t: t[i], rp["groups"][j]),
               tree_map(lambda t: t[i], params["groups"][j]))
              for i in range(cfg.n_full_patterns)
              for j, s in enumerate(cfg.pattern)]
    layers += list(zip(cfg.remainder, rp["rem"], params["rem"]))
    for spec, rpb, pb in layers:
        xin = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
        x, _, _ = ref_lm.apply_block(ref_cfg, spec, rpb, x, mode="train",
                                     positions=jnp.arange(32)[None],
                                     vision=vision, dtype=jdt)
        want = np.asarray(x.astype(jnp.float32))
        for use_kernel in (True, False):
            out = lm.apply_block(cfg, spec, pb, xin, dtype=tdt,
                                 positions=torch.arange(32)[None],
                                 vision=tvision, use_kernel=use_kernel)
            top = np.abs(want).max()
            tol = (1e-5 * top if dtype == "float32"
                   else 2 * 2.0 ** (np.floor(np.log2(top)) - 7))
            err = np.abs(out.float().numpy() - want).max()
            assert err <= tol, (spec, use_kernel, err, tol)
    xin = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    want = np.asarray(ref_lm.logits_out(ref_cfg, rp, x, jdt)
                      .astype(jnp.float32))
    got = lm.logits_out(cfg, params, xin, tdt).float().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _ssd_block_pair(dtype, use_kernel, S, seed=5):
    """mamba2-370m reduced, its first block's weights and an input of S
    tokens' embeddings: the reference's ssd_block (its Pallas ssd in
    interpret mode with ``use_kernel``) and the port's."""
    jdt, tdt = DTYPES[dtype]
    ref_cfg, cfg, rp, tree = _reference("mamba2-370m", seed)
    params = lm_params_from_reference(tree, device="cpu")
    rpb = jax.tree.map(lambda t: t[0], rp["groups"][0])["ssd"]
    pb = tree_map(lambda t: t[0], params["groups"][0])["ssd"]
    batch = {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)}
    x = ref_lm.embed_in(ref_cfg, rp, batch, jdt)
    xin = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    ref_blocks.USE_PALLAS_ATTENTION = use_kernel
    try:
        want = ref_blocks.ssd_block(ref_cfg, rpb, x, jdt)
    finally:
        ref_blocks.USE_PALLAS_ATTENTION = False
    return want, lambda: blocks.ssd_block(cfg, pb, xin, tdt, use_kernel)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_block_matches_reference(dtype, use_kernel):
    """The SSD mixer over two chunks, through the kernel route (the
    reference's USE_PALLAS_ATTENTION) and the XLA route, against the
    reference's, relative to the largest magnitude: f32 delta and final
    state within 1e-5. bf16 delta and state within four bf16 ulps (2.0^-6):
    XLA on the CPU lowers silu's sigmoid to 1 / (1 + exp(-x)) rounded to
    bf16 at every step, torch's silu rounds once, so 39% of the silu
    outputs of x, B, C and the gate differ by an ulp (3.1 and 1.8 ulps
    here; with torch's rounding in the reference, see the next test). The
    conv states (before the silu) within one bf16 ulp of each element."""
    (want, cache), run = _ssd_block_pair(dtype, use_kernel, 32)
    got, got_cache = run()
    want = np.asarray(want.astype(jnp.float32))
    ws = np.asarray(cache["s"])
    assert got_cache["s"].dtype == torch.float32
    assert got_cache["s"].shape == ws.shape
    for a, b in ((got.float().numpy(), want), (got_cache["s"].numpy(), ws)):
        top = np.abs(b).max()
        tol = (1e-5 * top if dtype == "float32"
               else 4 * 2.0 ** (np.floor(np.log2(top)) - 7))
        assert np.abs(a - b).max() <= tol
    for name, v in cache["conv"].items():
        w = np.asarray(v.astype(jnp.float32))
        g = got_cache["conv"][name]
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(g.float().numpy() - w) <= ulp).all(), name


def _silu_rounded_once(t):
    """silu in f32, rounded once to the input's dtype, as torch's."""
    f = t.astype(jnp.float32)
    return (f * jax.nn.sigmoid(f)).astype(t.dtype)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ssd_block_bf16_with_silu_rounded_once(monkeypatch, use_kernel):
    """The bf16 SSD block with the reference's silu rounded once, as the
    port's: the one difference the test above allows for is gone, so the
    delta is held to one bf16 ulp of each element over a floor of 1e-5 of
    its largest magnitude, and the f32 state to 1e-5 of its largest
    magnitude, through both routes."""
    monkeypatch.setattr(jax.nn, "silu", _silu_rounded_once)
    (want, cache), run = _ssd_block_pair("bfloat16", use_kernel, 32)
    monkeypatch.undo()
    got, got_cache = run()
    assert bf16_close(got, torch.from_numpy(
        np.array(want.astype(jnp.float32))).to(torch.bfloat16))
    ws = np.asarray(cache["s"])
    assert (np.abs(got_cache["s"].numpy() - ws).max()
            <= 1e-5 * np.abs(ws).max())


def test_ssd_block_chunk_not_dividing_sequence():
    """24 tokens and a chunk of 16: the XLA route takes the whole sequence
    as one chunk and agrees with the reference's within 1e-5 of its largest
    magnitude; the kernel route raises, as the reference's assert."""
    (want, _), run = _ssd_block_pair("float32", False, 24)
    got, _ = run()
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    cfg = get_config("mamba2-370m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pb = tree_map(lambda t: t[0], params["groups"][0])["ssd"]
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        blocks.ssd_block(cfg, pb, torch.zeros((2, 24, cfg.d_model)),
                         torch.float32, use_kernel=True)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    """The depthwise causal conv, from zeros on the left or from a carried
    state, and its new state: within 1e-6 of the output's magnitude."""
    rng = np.random.default_rng(int(with_state))
    x = rng.normal(size=(2, 12, 8)).astype(np.float32)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    st = rng.normal(size=(2, 3, 8)).astype(np.float32) if with_state else None
    J, T = jnp.asarray, torch.from_numpy
    want, want_st = ref_blocks._causal_conv(
        J(x), J(w), J(b), None if st is None else J(st))
    got, got_st = blocks._causal_conv(T(x), T(w), T(b),
                                      None if st is None else T(st))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
