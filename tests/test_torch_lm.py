"""Port parity for the LM: configurations, the parameter tree, the norm,
rope and the three non-kernel attention cores, and the full forward of
every configuration of the registry (the five dense attention configs,
the MoE configs mixtral-8x22b and llama4-scout-17b-a16e, the RG-LRU
hybrid recurrentgemma-2b, the cross-attention VLM llama-3.2-vision-90b
with seeded vision embeddings, and the SSD LM mamba2-370m) at
``reduced()`` against the JAX package, with the same weights, with the
attention and ssd kernels routed in (``use_kernel=True``, the reference's
``USE_PALLAS_ATTENTION`` on, its Pallas kernels in interpret mode) and
out.

Tolerances, relative to the largest |logit|:
- f32: 2e-5, and each block's own output to 1e-5
  (``test_torch_lm_blocks.py``). The forward amplifies a block's 1e-6
  difference: the random weights' scores are large, so the softmax is
  peaked and steep. gemma3-27b gets 1e-4: its 7 reduced layers of local
  attention amplify the most, and there the JAX package's own two
  attention routes differ by more than 2e-5. mamba2-370m is held at the
  same 2e-5 (2.1e-7 measured): its two SSD layers have no softmax to
  amplify a difference. llama-3.2-vision-90b gets 1e-4 too: its 6 reduced
  layers amplify each block's 1.3e-6 (``test_torch_lm_blocks.py``) to
  4.0e-5, and the JAX package's own two attention routes differ there by
  1.9e-5.
- bf16: 0.05, the JAX package's own bound between its two attention
  routes (``test_kernel_integration.py``), at that test's shape (2 x 16
  tokens). gemma3-27b, llama4-scout-17b-a16e and llama-3.2-vision-90b are
  held block by block instead, each block's output within two bf16 ulps
  of its largest magnitude (``test_torch_lm_blocks.py``): their bf16
  forwards lose any 1-ulp difference within a few layers (scout's top-1
  router sends a token to another expert), and the JAX package's own two
  routes differ there by more than 0.05 (0.23 for scout, 0.21 for the
  VLM).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import blocks as ref_blocks
from repro.models import abstract_params as ref_abstract_params
from repro.models import init_params as ref_init_params
from repro.models import lm as ref_lm
from repro_torch.configs import get_config, list_archs
from repro_torch.models import init_params, lm
from repro_torch.models.template import tree_map
from repro_torch.weights import lm_params_from_reference

PORTED = ["granite-8b", "stablelm-1.6b", "qwen2-72b", "gemma3-27b",
          "hubert-xlarge", "mamba2-370m", "mixtral-8x22b",
          "llama4-scout-17b-a16e", "recurrentgemma-2b",
          "llama-3.2-vision-90b"]
# a MoE, RG-LRU or cross-attention block in each
NEW_BLOCKS = ["mixtral-8x22b", "llama4-scout-17b-a16e", "recurrentgemma-2b",
              "llama-3.2-vision-90b"]
F32_RTOL = {"gemma3-27b": 1e-4, "llama-3.2-vision-90b": 1e-4}  # else 2e-5
BF16_RTOL = 0.05
# held block by block in bf16 (test_torch_lm_blocks.py)
BF16_BY_BLOCK = ("gemma3-27b", "llama4-scout-17b-a16e",
                 "llama-3.2-vision-90b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["pattern"] = [dataclasses.asdict(b) for b in cfg.pattern]
    return d


@pytest.mark.parametrize("name", ref_list_archs())
def test_configs_match_reference(name):
    assert list_archs() == ref_list_archs()
    cfg, ref = get_config(name), ref_get_config(name)
    assert _as_dict(cfg) == _as_dict(ref)
    assert _as_dict(cfg.reduced()) == _as_dict(ref.reduced())
    assert cfg.param_count() == ref.param_count()
    assert (cfg.n_full_patterns, len(cfg.remainder)) == (
        ref.n_full_patterns, len(ref.remainder))


def numpy_params(cfg, seed):
    """The port's init made from a seed, as numpy arrays (the reference's
    tree), with every cross-attention gate drawn in [0.5, 1.5]: the init
    is zeros, and tanh(0) = 0 would hide the cross blocks."""
    tree = tree_map(lambda t: t.numpy(), init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))
    rng = np.random.default_rng(seed)

    def gates(node):
        if isinstance(node, dict):
            if "gate" in node:
                g = node["gate"]
                node["gate"] = rng.uniform(0.5, 1.5, g.shape).astype(g.dtype)
            for v in node.values():
                gates(v)
        elif isinstance(node, tuple):
            for v in node:
                gates(v)

    gates(tree)
    return tree


@functools.lru_cache(maxsize=None)
def _reference(name, seed=0):
    """The reduced config in both packages and one set of weights made from
    a seed (``numpy_params``), which is the reference's tree (the JAX
    forward takes it as it is)."""
    cfg = get_config(name).reduced()
    tree = numpy_params(cfg, seed)
    return (ref_get_config(name).reduced(), cfg,
            jax.tree.map(jnp.asarray, tree), tree)


def _batch(cfg, seed=0, S=16):
    rng = np.random.default_rng(seed)
    if cfg.frame_input_dim:
        return {"frames": rng.normal(size=(2, S, cfg.frame_input_dim))
                .astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)}
    if cfg.vision_dim:
        batch["vision"] = rng.normal(
            size=(2, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("name", ["granite-8b", "gemma3-27b",
                                  "hubert-xlarge", "mamba2-370m",
                                  "mixtral-8x22b", "recurrentgemma-2b",
                                  "llama-3.2-vision-90b"])
def test_params_from_reference_keep_the_tree(name):
    """The reference's tree (its abstract params: keys, tuples, shapes) is
    the port's, and ``lm_params_from_reference`` carries a reference init
    over leaf for leaf."""
    ref_cfg = ref_get_config(name).reduced()
    cfg = get_config(name).reduced()
    want = jax.tree.map(lambda s: tuple(s.shape),
                        ref_abstract_params(ref_cfg))
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tree_map(lambda x: tuple(x.shape), own) == want
    if name in ("gemma3-27b", "hubert-xlarge"):
        return
    tree = jax.tree.map(np.asarray,
                        ref_init_params(ref_cfg, jax.random.PRNGKey(0)))
    got = lm_params_from_reference(tree, device="cpu")
    assert isinstance(got["groups"], tuple) and isinstance(got["rem"], tuple)
    flat_got, flat_want = [], []
    tree_map(flat_got.append, got)
    jax.tree.map(flat_want.append, tree)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    bf = lm_params_from_reference(tree, device="cpu", dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16
    if name == "llama-3.2-vision-90b":  # the cross blocks' scalar gates
        j = [b.kind for b in cfg.pattern].index("cross")
        gate = got["groups"][j]["attn"]["gate"]
        assert gate.shape == (cfg.n_full_patterns,)
        rem = lm_params_from_reference(
            {"gate": np.asarray(np.float32(0.5))}, device="cpu")["gate"]
        assert rem.shape == () and float(rem) == 0.5


def test_init_formulas_match_reference():
    """Zero norms and biases, unit-variance embeddings, fan-in normals
    with the fan at shape[-2] (H for wq): the reference's init."""
    cfg = get_config("stablelm-1.6b").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    a = p["groups"][0]["attn"]
    assert not a["ln"].any() and not a["bq"].any()
    assert abs(float(p["embed"].std()) - 1.0) < 0.05
    for w, fan in ((a["wq"], cfg.n_heads), (a["wo"], cfg.head_dim),
                   (p["groups"][0]["ffn"]["wd"], cfg.d_ff)):
        assert abs(float(w.std()) * fan ** 0.5 - 1.0) < 0.1


def _ref_forward(ref_cfg, rp, batch, dtype, pallas):
    ref_blocks.USE_PALLAS_ATTENTION = pallas
    try:
        out, _, _ = ref_lm.forward(ref_cfg, rp, jax.tree.map(jnp.asarray,
                                                             batch),
                                   dtype=dtype, remat="none")
    finally:
        ref_blocks.USE_PALLAS_ATTENTION = False
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in PORTED for d in DTYPES
    if not (n in BF16_BY_BLOCK and d == "bfloat16")])
def test_forward_matches_reference(name, dtype, use_kernel):
    jdt, tdt = DTYPES[dtype]
    ref_cfg, cfg, rp, tree = _reference(name)
    batch = _batch(cfg)
    want = _ref_forward(ref_cfg, rp, batch, jdt, use_kernel)
    params = lm_params_from_reference(tree, device="cpu")
    got = lm.forward(cfg, params, batch, dtype=tdt, use_kernel=use_kernel,
                     device="cpu")
    assert got.shape == want.shape == (2, 16, cfg.vocab)
    assert got.dtype == (torch.float32 if cfg.logit_softcap else tdt)
    rtol = F32_RTOL.get(name, 2e-5) if dtype == "float32" else BF16_RTOL
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= rtol, err
    last = lm.forward(cfg, params, batch, dtype=tdt, use_kernel=use_kernel,
                      logits_mode="last", device="cpu")
    # the logits product of one row may round otherwise than of sixteen
    assert ((last - got[:, -1:]).abs().max()
            <= 1e-6 * got.abs().max()), name


def _prefill_and_decode(cfg, params, batch):
    """A prefill of ``batch`` with room for two more tokens, then two
    decode steps: prefill's last logits equal the forward's, and each
    step's logits are finite."""
    S = batch["tokens"].shape[1]
    last, cache = lm.prefill(cfg, params, batch, max_seq=S + 2,
                             device="cpu")
    assert torch.equal(last, lm.forward(cfg, params, batch,
                                        logits_mode="last", device="cpu"))
    for t in range(2):
        out, again = lm.decode_step(cfg, params, cache,
                                    batch["tokens"][:, t:t + 1], S + t,
                                    device="cpu")
        assert again is cache
        assert out.shape == (2, 1, cfg.vocab) and torch.isfinite(out).all()


@pytest.mark.parametrize("name", NEW_BLOCKS)
def test_new_blocks_run_and_decode_still_raises(name):
    """The MoE, RG-LRU and cross-attention configs run the forward, a
    prefill and decode steps (their parity: test_torch_decode.py); the
    full-sequence forward still refuses mode="decode", which
    ``decode_step`` runs."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lm.check_ported(cfg)
    batch = _batch(cfg)
    with pytest.raises(ValueError, match="decode_step"):
        lm.forward(cfg, params, batch, mode="decode", device="cpu")
    out = lm.forward(cfg, params, batch, mode="prefill", logits_mode="last",
                     device="cpu")
    assert out.shape == (2, 1, cfg.vocab) and torch.isfinite(out).all()
    _prefill_and_decode(cfg, params, batch)


def test_decode_mode_raises():
    """forward's mode="decode" and an unknown logits_mode raise; decode
    itself runs through ``lm.decode_step``."""
    cfg = get_config("granite-8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="decode_step"):
        lm.forward(cfg, params, _batch(cfg), mode="decode", device="cpu")
    with pytest.raises(ValueError, match="logits_mode"):
        lm.forward(cfg, params, _batch(cfg), logits_mode="first",
                   device="cpu")
    _prefill_and_decode(cfg, params, _batch(cfg))
