"""Port parity for the RG-LRU block (recurrentgemma-2b) and the
cross-attention block (llama-3.2-vision-90b) against the JAX package, with
the same weights and input, at ``reduced()``.

- The scan (``blocks.rglru_scan``) against the reference's
  ``lax.associative_scan`` on the same decays and inputs, within 1e-6 of
  the state's largest magnitude (bit-equal here, on the CPU, up to 4096
  steps). The port runs the reference's odd/even recursion, so the sums
  group as the reference's; but each combine is a multiply and an add,
  which a compiler may fuse into one rounding where the other rounds
  twice, so the bound allows the last bits of a step to differ; the
  decays (under 1) carry such a difference forward without growing it.
- ``rec_block``: the delta and the final state (f32) in f32 within 1e-5,
  in bf16 within two bf16 ulps, of their largest magnitudes (one and 1.3
  ulps measured: the gates are bf16 products and sigmoids, which XLA on
  the CPU rounds at each step, as the bf16 silu of
  ``test_torch_lm_blocks.py``); the conv state (before any activation)
  within one bf16 ulp of each element.
- The cross-attention sublayer with nonzero gates (the init is zeros,
  and tanh(0) = 0 would hide the block) at the same bounds as the delta.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as ref_get_config
from repro.models import blocks as ref_blocks
from repro_torch.configs import get_config
from repro_torch.models import blocks, init_params
from repro_torch.models.template import tree_map

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bound(want, dtype, ulps=2):
    top = np.abs(want).max()
    return (1e-5 * top if dtype == "float32"
            else ulps * 2.0 ** (np.floor(np.log2(top)) - 7))


@functools.lru_cache(maxsize=None)
def _block(name, kind, seed):
    """Both packages' reduced config and the weights of the first block
    of ``kind`` (pattern position, megablock 0) as numpy arrays."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    j = [s.kind for s in cfg.pattern].index(kind)
    key = "rec" if kind == "rec" else "attn"
    p = tree_map(lambda t: t[0].numpy(), params["groups"][j])[key]
    return ref_get_config(name).reduced(), cfg, p


@pytest.mark.parametrize("S", [1, 2, 7, 64, 4096])
def test_rglru_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = np.exp(-8.0 * rng.uniform(0.0, 1.0, (2, S, 16))).astype(np.float32)
    b = rng.normal(size=(2, S, 16)).astype(np.float32)

    def comb(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

    _, want = lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                   axis=1)
    want = np.asarray(want)
    got = blocks.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # and the recurrence it computes, step by step in float64
    h, seq = np.zeros((2, 16)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    assert np.abs(got.numpy() - np.stack(seq, 1)).max() <= 1e-5 * np.abs(
        want).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rec_block_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    ref_cfg, cfg, p = _block("recurrentgemma-2b", "rec", 4)
    p = dict(p, ln=np.random.default_rng(4).normal(
        size=p["ln"].shape).astype(np.float32) * 0.1)
    x = np.random.default_rng(5).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    want, st = ref_blocks.rec_block(
        ref_cfg, {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(jdt), jdt)
    got, got_st = blocks.rec_block(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x).to(tdt), tdt)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= _bound(want, dtype)
    wh = np.asarray(st["h"])
    assert got_st["h"].dtype == torch.float32 and got_st["h"].shape == \
        wh.shape
    assert np.abs(got_st["h"].numpy() - wh).max() <= _bound(wh, dtype)
    wc = np.asarray(st["conv"].astype(jnp.float32))
    gc = got_st["conv"]
    assert gc.dtype == torch.bfloat16 and gc.shape == wc.shape
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wc), 1e-30))) - 7)
    assert (np.abs(gc.float().numpy() - wc) <= ulp).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_block_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    ref_cfg, cfg, p = _block("llama-3.2-vision-90b", "cross", 6)
    rng = np.random.default_rng(6)
    p = dict(p, gate=np.float32(0.7),
             ln=rng.normal(size=p["ln"].shape).astype(np.float32) * 0.1)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    vis = rng.normal(size=(2, cfg.vision_tokens, cfg.vision_dim)).astype(
        np.float32)
    pos = np.arange(32, dtype=np.int32)[None]
    want = ref_blocks.attention_block(
        ref_cfg, {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(jdt), kind="cross", window=0,
        positions=jnp.asarray(pos), cross_kv=jnp.asarray(vis), dtype=jdt)
    want = np.asarray(want.astype(jnp.float32))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    for use_kernel in (True, False):  # cross never takes the kernel
        got = blocks.attention_block(
            cfg, tp, torch.from_numpy(x).to(tdt), kind="cross", window=0,
            positions=torch.from_numpy(pos), cross_kv=torch.from_numpy(vis),
            dtype=tdt, use_kernel=use_kernel)
        assert got.dtype == tdt and got.shape == want.shape
        assert np.abs(got.float().numpy() - want).max() <= _bound(want,
                                                                  dtype)
    assert np.abs(want).max() > 0
    with pytest.raises(ValueError, match="vision"):
        blocks.attention_block(cfg, tp, torch.from_numpy(x), kind="cross",
                               window=0, positions=torch.from_numpy(pos))
