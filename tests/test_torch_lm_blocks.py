"""Port parity for the dense LM's parts: the norm, rope and the three
non-kernel attention cores in f32 within 1e-5 of the output's largest
magnitude; and every block of gemma3-27b (local windows, gelu, tied
embeddings, softcap) and qwen2-72b (qkv bias) on the reference's own input,
through both attention routes, in f32 within 1e-5 and in bf16 within two
bf16 ulps of the block output's largest magnitude (the end-to-end forward
of gemma3-27b in bf16 amplifies any 1-ulp difference; see
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

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _reference(name, seed):
    """Both packages' reduced config and one set of weights made from a
    seed, as the reference's tree of arrays and of JAX arrays."""
    cfg = get_config(name).reduced()
    tree = tree_map(lambda t: t.numpy(), init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))
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
@pytest.mark.parametrize("name", ["gemma3-27b", "qwen2-72b"])
def test_blocks_match_reference(name, dtype):
    """Each block (and the logits) on the reference's own input: f32
    within 1e-5, bf16 within two bf16 ulps, of the output's largest
    magnitude."""
    jdt, tdt = DTYPES[dtype]
    ref_cfg, cfg, rp, tree = _reference(name, 3)
    params = lm_params_from_reference(tree, device="cpu")
    batch = {"tokens": np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32)}
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
                                     dtype=jdt)
        want = np.asarray(x.astype(jnp.float32))
        for use_kernel in (True, False):
            out = lm.apply_block(cfg, spec, pb, xin, dtype=tdt,
                                 positions=torch.arange(32)[None],
                                 use_kernel=use_kernel)
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
