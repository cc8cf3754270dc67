"""Port parity for LM split serving: the boundary codec on the head's bf16
activation bit-equal to the reference's (bf16 rows straight into the
quantize kernel's plain version), the head and the tail against the JAX
package with the same weights, ``lm_split_infer`` through FP16, INT8 and
INT4 against the reference's, head plus tail equal to the forward, and
``lm_split_profile`` and the boundary bytes equal to the reference's, for
the dense LMs, the MoE LMs (mixtral-8x22b, llama4-scout-17b-a16e), the
RG-LRU hybrid (recurrentgemma-2b), the cross-attention VLM
(llama-3.2-vision-90b, whose tail reads ``batch["vision"]``) and the SSD
LM (mamba2-370m).

Tolerances: f32 activations and logits within 1e-5 of their largest
magnitude; bf16 split inference within 0.05 of the logit scale, the JAX
package's own bound between its attention routes (llama-3.2-vision-90b's
bf16 forward amplifies a 1-ulp difference past it, as the JAX package's
own two routes do: it is held block by block, ``test_torch_lm_blocks.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import boundary as ref_boundary
from repro.core import splitting as ref_splitting
from repro.core.profiles import lm_split_profile as ref_lm_split_profile
from repro_torch.configs import get_config, list_archs
from repro_torch.core import boundary
from repro_torch.core.profiles import lm_split_profile
from repro_torch.core.splitting import (boundary_bytes, lm_head,
                                        lm_split_infer, lm_split_points,
                                        lm_tail)
from repro_torch.models import init_params, lm
from repro_torch.models.template import tree_map
from repro_torch.weights import lm_params_from_reference
from test_torch_lm import numpy_params

CODECS = ["FP16", "INT8", "INT4"]


@functools.lru_cache(maxsize=None)
def _setup(name, seed=0, S=16):
    """Both packages' reduced config, one set of weights made from a seed
    (the reference's tree, as JAX arrays and as the port's params in
    ``dtype``) and a token batch."""
    cfg = get_config(name).reduced()
    tree = numpy_params(cfg, seed)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)}
    if cfg.vision_dim:
        batch["vision"] = rng.normal(
            size=(2, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)

    def params(dtype=None):
        return lm_params_from_reference(tree, device="cpu", dtype=dtype)

    return (ref_get_config(name).reduced(), cfg,
            jax.tree.map(jnp.asarray, tree), params, batch)


def _jnp(batch):
    return jax.tree.map(jnp.asarray, batch)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("codec", CODECS)
def test_codec_on_bf16_activation_bit_equal(codec):
    """bf16 rows quantize as their exact f32 values: codes, scales and the
    dequantized bf16 round trip equal the reference's."""
    rng = np.random.default_rng(len(codec))
    x = (rng.normal(size=(2, 16, 64)) * rng.uniform(0.1, 50.0, (2, 16, 1))
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    c, rc = getattr(boundary, codec), getattr(ref_boundary, codec)
    np.testing.assert_array_equal(
        boundary.roundtrip(tx, c).float().numpy(),
        _f32(ref_boundary.roundtrip(jx, rc)))
    if c.bits < 16:
        q, s = boundary.quantize(tx, c.bits)
        rq, rs = ref_boundary.quantize(jx, c.bits)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


@pytest.mark.parametrize("codec", CODECS)
def test_head_codec_tail_match_reference(codec):
    """f32: the head's activation, the codec on the reference's activation
    (bit-equal), and the tail on the coded activation."""
    ref_cfg, cfg, rp, params, batch = _setup("granite-8b")
    k = 1
    want = ref_splitting.lm_head(ref_cfg, rp, batch, k, dtype=jnp.float32)
    params = params()
    got = lm_head(cfg, params, batch, k, dtype=torch.float32, device="cpu")
    want = np.array(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    sent = ref_boundary.roundtrip(jnp.asarray(want),
                                  getattr(ref_boundary, codec))
    got_sent = boundary.roundtrip(torch.from_numpy(want),
                                  getattr(boundary, codec))
    np.testing.assert_array_equal(got_sent.numpy(), np.asarray(sent))
    want_out = np.asarray(ref_splitting.lm_tail(ref_cfg, rp, sent, batch, k,
                                                dtype=jnp.float32))
    out = lm_tail(cfg, params, got_sent, batch, k, dtype=torch.float32,
                  device="cpu")
    assert out.shape == want_out.shape == (2, 1, cfg.vocab)
    assert (np.abs(out.numpy() - want_out).max()
            <= 1e-5 * np.abs(want_out).max())


# a code of the boundary that moves by one step: see the test's docstring
SPLIT_RTOL = {("mamba2-370m", "INT8"): 2e-4, ("mixtral-8x22b", "FP16"): 2e-4,
              ("llama-3.2-vision-90b", "FP16"): 2e-4}


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", ["granite-8b", "qwen2-72b", "mamba2-370m",
                                  "mixtral-8x22b", "llama4-scout-17b-a16e",
                                  "recurrentgemma-2b",
                                  "llama-3.2-vision-90b"])
def test_lm_split_infer_matches_reference(name, codec, use_kernel):
    """End to end in f32, against the reference's lm_split_infer (its
    default XLA attention) within 1e-5 of the logit scale. A code can
    differ only where the two heads' activations straddle a rounding
    boundary of the codec, which none does here but three cases, held at
    2e-4: mamba2-370m's heads agree to 5.7e-8, yet one INT8 code of its
    2048 sits on a boundary and moves by one step, which moves the logits
    by 8.0e-5 of their scale; through FP16 (the bf16 round trip), one bf16
    value of mixtral-8x22b's 2048 (heads 1.4e-6 apart; logits 1.9e-4) and
    eight of llama-3.2-vision-90b's (2.2e-5; 1.5e-5) round to the
    neighbouring bf16. Each tail on the same coded activation agrees to
    4.4e-7."""
    ref_cfg, cfg, rp, params, batch = _setup(name)
    want = np.asarray(ref_splitting.lm_split_infer(
        ref_cfg, rp, _jnp(batch), 1, getattr(ref_boundary, codec),
        dtype=jnp.float32))
    got = lm_split_infer(cfg, params(), batch, 1, getattr(boundary, codec),
                         dtype=torch.float32, use_kernel=use_kernel,
                         device="cpu")
    assert got.shape == want.shape == (2, 1, cfg.vocab)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= SPLIT_RTOL.get((name, codec), 1e-5), err


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", ["granite-8b", "qwen2-72b", "mamba2-370m",
                                  "mixtral-8x22b", "llama4-scout-17b-a16e",
                                  "recurrentgemma-2b"])
def test_lm_split_infer_bf16_matches_reference(name, use_kernel):
    """As served: bf16 weights and compute, the FP16 codec (the integer
    codecs' bf16 path is held bit for bit above, on the same activation)."""
    ref_cfg, cfg, rp, params, batch = _setup(name)
    want = _f32(ref_splitting.lm_split_infer(ref_cfg, rp, _jnp(batch), 1))
    got = lm_split_infer(cfg, params(torch.bfloat16), batch, 1,
                         use_kernel=use_kernel, device="cpu")
    assert got.dtype == (torch.float32 if cfg.logit_softcap
                         else torch.bfloat16)
    assert got.shape == (2, 1, cfg.vocab)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 0.05, err


@pytest.mark.parametrize("name", ["granite-8b", "gemma3-27b", "mamba2-370m",
                                  "mixtral-8x22b", "llama4-scout-17b-a16e",
                                  "recurrentgemma-2b",
                                  "llama-3.2-vision-90b"])
def test_head_plus_tail_equals_forward(name):
    """In bf16 the FP16 codec is the identity, so split inference at every
    split point is the forward, bit for bit."""
    _, cfg, _, params, batch = _setup(name)
    bf = params(torch.bfloat16)
    full = lm.forward(cfg, bf, batch, logits_mode="last", device="cpu")
    assert lm_split_points(cfg) == list(range(1, cfg.n_full_patterns + 1))
    for k in lm_split_points(cfg):
        out = lm_split_infer(cfg, bf, batch, k, device="cpu")
        assert torch.equal(out, full), k


@pytest.mark.parametrize("name", list_archs())
def test_lm_split_profile_and_bytes_match_reference(name):
    cfg, ref = get_config(name), ref_get_config(name)
    for seq, batch in ((4096, 4), (512, 8)):
        got = lm_split_profile(cfg, seq, batch)
        want = ref_lm_split_profile(ref, seq, batch)
        assert got.name == want.name and got.layer_names == want.layer_names
        for field in ("flops_head", "data_bytes", "privacy"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        for codec in CODECS:
            assert boundary_bytes(cfg, seq, batch, getattr(boundary, codec)) \
                == ref_splitting.boundary_bytes(ref, seq, batch,
                                                getattr(ref_boundary, codec))
