"""Port parity for ``decode_step`` (see ``test_torch_decode.py``, which
holds the caches, the prefill, the rings, the int8 cache and the MoE's
decode routing): 4 teacher-forced steps of the nine decoder
configurations at ``reduced()`` from the very same cache as the JAX
package's (the reference's prefill cache, carried by
``lm_cache_from_reference``), the logits at the forward's tolerances and
the caches after the steps as the prefill's (``_decode_held``,
``_hold_cache``); and every configuration in bf16 block by block, each
block's prefill and each decode step from the reference's own input and
cache, the output and the cache within two bf16 ulps of their largest
magnitude (gemma3-27b, llama4-scout-17b-a16e and llama-3.2-vision-90b are
held only so in bf16, as their forwards are)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro_torch.models import lm
from repro_torch.weights import lm_cache_from_reference, \
    lm_params_from_reference
from test_torch_decode import (DECODERS, MAX_SEQ, S, STEPS, _at, _batch,
                               _bf16_ulp, _configs, _decode_held, _flat,
                               _hold_cache, _layers, _leaf_err, _ref_flat,
                               _tokens, _weights)
from test_torch_lm import BF16_BY_BLOCK, DTYPES


@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in DECODERS for d in DTYPES
    if not (n in BF16_BY_BLOCK and d == "bfloat16")])
def test_decode_matches_reference(name, dtype):
    _hold_cache(*_decode_held(name, dtype))


@pytest.mark.parametrize("name", DECODERS)
def test_decode_by_block_bf16(name):
    """bf16, block by block: each block's prefill on the reference's own
    input (through both attention routes), then each of 4 decode steps on
    the reference's own input and cache; outputs and caches within two
    bf16 ulps of their largest magnitude, positions exactly."""
    ref_cfg, cfg = _configs(name)
    tree, rp = _weights(name)
    params = lm_params_from_reference(tree, device="cpu")
    batch = _batch(cfg, S=S)
    vision = tvision = None
    if cfg.vision_dim:
        vision = jnp.asarray(batch["vision"])
        tvision = torch.from_numpy(batch["vision"])
    jdt, tdt = DTYPES["bfloat16"]

    def close(got, want):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        return err <= 2 * _bf16_ulp(np.abs(want).max()), err

    def as_t(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)

    x = ref_lm.embed_in(ref_cfg, rp, batch, jdt)
    ref_caches = []
    for spec, j, i in _layers(cfg):
        xin = as_t(x)
        x, _, c = ref_lm.apply_block(
            ref_cfg, spec, _at(rp, j, i), x, mode="prefill",
            positions=jnp.arange(S)[None], vision=vision, dtype=jdt,
            max_seq=MAX_SEQ)
        ref_caches.append(c)
        for use_kernel in (True, False):
            out, pc = lm.apply_block(
                cfg, spec, _at(params, j, i), xin, mode="prefill",
                positions=torch.arange(S)[None], vision=tvision,
                max_seq=MAX_SEQ, dtype=tdt, use_kernel=use_kernel)
            ok, err = close(out, x)
            assert ok, (spec, use_kernel, err)
            for path, w in _ref_flat(c).items():
                assert _leaf_err(_flat(pc)[path], w, "bfloat16",
                                 by_block=True) <= 1.0, \
                    (spec, path)
    toks = _tokens(cfg)
    for t in range(STEPS):
        x = ref_lm.embed_in(ref_cfg, rp, {"tokens": toks[:, t:t + 1]}, jdt)
        for n, (spec, j, i) in enumerate(_layers(cfg)):
            xin = as_t(x)
            carried = lm_cache_from_reference(
                jax.tree.map(np.asarray, ref_caches[n]), device="cpu")
            x, _, ref_caches[n] = ref_lm.apply_block(
                ref_cfg, spec, _at(rp, j, i), x, mode="decode",
                cache=ref_caches[n], pos=jnp.int32(S + t), dtype=jdt)
            out, pc = lm.apply_block(cfg, spec, _at(params, j, i), xin,
                                     mode="decode", cache=carried,
                                     pos=S + t, dtype=tdt)
            ok, err = close(out, x)
            assert ok, (t, spec, err)
            for path, w in _ref_flat(ref_caches[n]).items():
                assert _leaf_err(_flat(pc)[path], w, "bfloat16",
                                 by_block=True) <= 1.0, \
                    (t, spec, path)
