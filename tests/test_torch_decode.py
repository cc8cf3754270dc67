"""Port parity for LM serving: the decode caches a prefill produces and the
one-token ``decode_step``, for the nine decoder configurations of the
registry (all but the encoder hubert-xlarge) at ``reduced()``, against
the JAX package with the same weights (``lm_params_from_reference``).

- The cache templates and ``init_cache`` equal the reference's leaf for
  leaf: shape, dtype and init (bf16 or int8 k/v, int32 positions of -1,
  f32 scales and states, bf16 conv states, the cross cache sized by
  ``vision_tokens``).
- The prefill (16 tokens, ``max_seq`` 20) against the reference's
  ``forward(mode="prefill")`` with ``USE_PALLAS_ATTENTION`` on (its Pallas
  kernels in interpret mode) and off: the last logits at the forward's
  tolerances (``test_torch_lm.py``) and equal to the port's own
  ``forward(logits_mode="last")``; every cache leaf: positions exactly,
  in an f32 run f32 leaves within 1e-5 of their largest magnitude and
  bf16 leaves (k, v and conv states, bf16 in every run) within two bf16
  ulps of it; in a bf16 run every float leaf within 0.05 of it, the bound
  of the bf16 logits (a deep layer's input drifts by bf16 roundings as
  the forward's does).
- ``decode_step`` from the very same cache (the reference's, carried by
  ``lm_cache_from_reference``) over 4 teacher-forced steps against the
  reference's ``decode_step``: the logits at the forward's tolerances, the
  caches after the steps as above. Every config is also held block by
  block in bf16 (gemma3-27b, llama4-scout-17b-a16e and
  llama-3.2-vision-90b only so, as their forwards are): each block's
  prefill and each decode step from the reference's own input and cache,
  the output and the cache within two bf16 ulps of their largest
  magnitude.
- Rings: a prompt longer than the local window (recurrentgemma-2b at two
  megablocks, window 8), full attention with ``max_seq`` under the prompt,
  and decode steps that cross the wrap; every ring's positions are held
  exactly against the positions the ring must hold.
- ``kv_dtype="int8"`` on granite-8b and recurrentgemma-2b: in f32 the
  codes and scales equal the reference's exactly, prefill and decode; in
  bf16 the port's projections round a k or v to another bf16 value than
  XLA's in some elements, so the codes are held exactly against the
  reference's ``rowwise_quant`` of the port's own bf16 k and v, and
  within one code of the reference's codes.
- The MoE at decode routes T = B tokens: its decisions (top_i, keep and
  the queue slots) equal the reference's exactly at every step and layer,
  read off the reference's own ``lax.top_k`` and ``jax.nn.one_hot`` calls
  as ``test_torch_moe.py`` reads them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.boundary import rowwise_quant as ref_rowwise_quant
from repro.models import blocks as ref_blocks
from repro.models import init_cache as ref_init_cache
from repro.models import lm as ref_lm
from repro.models.template import is_spec
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import blocks, init_cache, lm
from repro_torch.weights import lm_cache_from_reference, \
    lm_params_from_reference
from test_torch_lm import (BF16_BY_BLOCK, BF16_RTOL, DTYPES, F32_RTOL,
                           PORTED, _batch, numpy_params)

DECODERS = [n for n in PORTED if n != "hubert-xlarge"]
S, MAX_SEQ, STEPS = 16, 20, 4


def _flat(tree, prefix=""):
    """{keystr path: leaf} of a tree of dicts and tuples, with the paths
    ``jax.tree_util.keystr`` gives."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _ref_flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(name, **over):
    return (ref_get_config(name).reduced(**over),
            get_config(name).reduced(**over))


@functools.lru_cache(maxsize=None)
def _weights(name, n_layers=None):
    """One set of weights made from a seed for the reduced config (cross
    gates drawn nonzero), as numpy arrays and as JAX arrays."""
    over = {} if n_layers is None else {"n_layers": n_layers}
    tree = numpy_params(get_config(name).reduced(**over), 0)
    return tree, jax.tree.map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_prefill(name, dtype, pallas, kv="bf16", max_seq=MAX_SEQ,
                 n_layers=None):
    """The reference's prefill of ``_batch``: (last logits f32, cache)."""
    over = {"kv_dtype": kv}
    if n_layers is not None:
        over["n_layers"] = n_layers
    ref_cfg, _ = _configs(name, **over)
    _, rp = _weights(name, n_layers)
    batch = jax.tree.map(jnp.asarray, _batch(ref_cfg, S=S))
    ref_blocks.USE_PALLAS_ATTENTION = pallas
    try:
        logits, _, cache = ref_lm.forward(
            ref_cfg, rp, batch, mode="prefill", dtype=DTYPES[dtype][0],
            remat="none", logits_mode="last", max_seq=max_seq)
    finally:
        ref_blocks.USE_PALLAS_ATTENTION = False
    return np.asarray(logits.astype(jnp.float32)), cache


def _bf16_ulp(top):
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def _leaf_err(got, want, dtype, by_block=False):
    """The largest difference of a cache leaf over its bound (<= 1 holds):
    integer leaves exactly; in an f32 run f32 leaves within 1e-5 of their
    largest magnitude and bf16 leaves within two bf16 ulps of it; in a
    bf16 run every float leaf within BF16_RTOL of it end to end, within
    two bf16 ulps block by block."""
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    w = np.asarray(want).astype(np.float32) if want.dtype.kind == "f" or \
        want.dtype.name == "bfloat16" else np.asarray(want)
    assert tuple(got.shape) == w.shape
    if want.dtype.kind in "iu":
        return float((g != w).sum())
    err = np.abs(g.astype(np.float32) - w).max() if w.size else 0.0
    top = np.abs(w).max() if w.size else 0.0
    if dtype == "float32" and want.dtype.name == "float32":
        return err / max(1e-5 * top, 1e-30)
    if dtype == "bfloat16" and not by_block:
        return err / max(BF16_RTOL * top, 1e-30)
    return err / max(2 * _bf16_ulp(top), 1e-30)


def _hold_cache(got, want_tree, dtype, skip=()):
    want = _ref_flat(want_tree)
    got = _flat(got)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if any(s in path for s in skip):
            continue
        err = _leaf_err(got[path], w, dtype)
        assert err <= 1.0, (path, err)


def _rtol(name, dtype):
    return F32_RTOL.get(name, 2e-5) if dtype == "float32" else BF16_RTOL


def _rel(got, want):
    return np.abs(got.float().numpy() - want).max() / np.abs(want).max()


def _tokens(cfg):
    """The decode steps' tokens, one a sequence a step."""
    return np.random.default_rng(1).integers(
        0, cfg.vocab, (2, STEPS)).astype(np.int32)


@pytest.mark.parametrize("name,kv", [(n, "bf16") for n in DECODERS] + [
    ("granite-8b", "int8"), ("recurrentgemma-2b", "int8")])
def test_cache_template_matches_reference(name, kv):
    ref_cfg, cfg = _configs(name, kv_dtype=kv)
    want = {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                ref_lm.cache_template(ref_cfg, 2, MAX_SEQ),
                is_leaf=is_spec)[0]}
    got = _flat(lm.cache_template(cfg, 2, MAX_SEQ))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert (g.shape, str(g.dtype).split(".")[-1], g.init) == (
            w.shape, jnp.dtype(w.dtype).name, w.init), path
    ref_c = _ref_flat(ref_init_cache(ref_cfg, 2, MAX_SEQ))
    own = _flat(init_cache(cfg, 2, MAX_SEQ, device="cpu"))
    for path, w in ref_c.items():
        assert str(own[path].dtype).split(".")[-1] == w.dtype.name, path
        assert _leaf_err(own[path], w, "float32") == 0.0, path
    if cfg.vision_tokens:
        j = [b.kind for b in cfg.pattern].index("cross")
        assert got[f"['groups'][{j}]['attn']['k']"].shape[2] == \
            cfg.vision_tokens


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in DECODERS for d in DTYPES
    if not (n in BF16_BY_BLOCK and d == "bfloat16")])
def test_prefill_matches_reference(name, dtype, use_kernel):
    want, want_cache = _ref_prefill(name, dtype, use_kernel)
    _, cfg = _configs(name)
    params = lm_params_from_reference(_weights(name)[0], device="cpu")
    batch = _batch(cfg, S=S)
    tdt = DTYPES[dtype][1]
    step = make_prefill_step(cfg, MAX_SEQ, dtype=tdt, use_kernel=use_kernel,
                             device="cpu")
    got, cache = step(params, batch)
    assert got.shape == want.shape == (2, 1, cfg.vocab)
    assert _rel(got, want) <= _rtol(name, dtype)
    assert torch.equal(got, lm.forward(cfg, params, batch, dtype=tdt,
                                       use_kernel=use_kernel,
                                       logits_mode="last", device="cpu"))
    _hold_cache(cache, want_cache, dtype)


def _carried(name, dtype, **kw):
    """The reference's prefill cache (XLA route) and the same cache
    carried into the port."""
    _, rc = _ref_prefill(name, dtype, False, **kw)
    return rc, lm_cache_from_reference(jax.tree.map(np.asarray, rc),
                                       device="cpu")


def _bf16_flips(own, ref) -> int:
    """How many elements of the bf16 cache leaves the two packages hold
    as different bf16 values."""
    return sum(int((own[p].float().numpy() != w.astype(np.float32)).sum())
               for p, w in _ref_flat(ref).items()
               if w.dtype.name == "bfloat16")


def _decode_held(name, dtype, **kw):
    """STEPS teacher-forced decode steps of both packages from the
    same cache, each step's logits held at the forward's tolerance.
    Returns (the port's cache, the reference's, the dtype whose bounds
    they are held to) after the steps.

    In an f32 run the cache's k, v and conv states are bf16, rounded from
    f32 values that differ between the packages in their last bits: where
    such a rounding goes the other way (``_bf16_flips``) the layers after
    it see a one-ulp change of a bf16 value, which the model amplifies as
    any bf16 rounding (1.1e-3 of the logit scale seen, on a ring-wrap
    step of recurrentgemma-2b). That step is held at the bf16 bound, and
    the next starts from the reference's cache again."""
    over = {k: v for k, v in (("kv_dtype", kw.get("kv")),
                              ("n_layers", kw.get("n_layers"))) if v}
    ref_cfg, cfg = _configs(name, **over)
    tree, rp = _weights(name, kw.get("n_layers"))
    params = lm_params_from_reference(tree, device="cpu")
    rc, cache = _carried(name, dtype, **kw)
    jdt, tdt = DTYPES[dtype]
    step = make_decode_step(cfg, dtype=tdt, device="cpu")
    toks = _tokens(cfg)
    for t in range(STEPS):
        rl, rc = ref_lm.decode_step(ref_cfg, rp, rc,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(S + t), dtype=jdt)
        got, again = step(params, cache, toks[:, t:t + 1], S + t)
        assert again is cache and got.shape == (2, 1, cfg.vocab)
        flips = dtype == "float32" and _bf16_flips(_flat(cache), rc)
        rtol = BF16_RTOL if flips else _rtol(name, dtype)
        assert _rel(got, np.asarray(rl.astype(jnp.float32))) <= rtol, (
            t, flips)
        if flips and t + 1 < STEPS:
            cache = lm_cache_from_reference(jax.tree.map(np.asarray, rc),
                                            device="cpu")
    return cache, rc, "bfloat16" if flips else dtype


def _layers(cfg):
    """(spec, group index or None, megablock or remainder index) of every
    layer in order."""
    out = [(s, j, i) for i in range(cfg.n_full_patterns)
           for j, s in enumerate(cfg.pattern)]
    return out + [(s, None, j) for j, s in enumerate(cfg.remainder)]


def _at(tree, j, i):
    """A layer's slice of a parameter or cache tree (either package's)."""
    if j is None:
        return tree["rem"][i]
    return jax.tree.map(lambda t: t[i], tree["groups"][j])


def _ring_positions(W, last):
    """The positions a ring of W slots holds once positions 0..last are
    written, each at slot pos % W (-1 where none was)."""
    want = np.full(W, -1, np.int32)
    for p in range(max(0, last - W + 1), last + 1):
        want[p % W] = p
    return want


@pytest.mark.parametrize("name,max_seq,n_layers", [
    ("recurrentgemma-2b", MAX_SEQ, 7),  # window 8 < the 16-token prompt
    ("mixtral-8x22b", MAX_SEQ, None),  # window 8, full-attention pattern
    ("granite-8b", 12, None),  # max_seq under the prompt: W = 12
    ("granite-8b", 18, None)])  # the decode steps cross the wrap at 18
def test_ring_wraps(name, max_seq, n_layers):
    """Prefill and decode where the ring wraps, in f32: the logits as the
    reference's, the caches as ``test_decode_matches_reference`` holds
    them, and every ring's positions exactly what the ring must hold after
    the prompt and after each step."""
    kw = {"max_seq": max_seq, "n_layers": n_layers}
    want, want_cache = _ref_prefill(name, "float32", False, **kw)
    over = {} if n_layers is None else {"n_layers": n_layers}
    _, cfg = _configs(name, **over)
    params = lm_params_from_reference(_weights(name, n_layers)[0],
                                      device="cpu")
    got, cache = lm.prefill(cfg, params, _batch(cfg, S=S), max_seq=max_seq,
                            dtype=torch.float32, device="cpu")
    assert _rel(got, want) <= _rtol(name, "float32")
    _hold_cache(cache, want_cache, "float32")
    rings = {p: t for p, t in _flat(cache).items() if p.endswith("['pos']")}
    assert rings
    wrapped = False
    for t in rings.values():
        W = t.shape[-1]
        wrapped |= W < S
        for row in t.reshape(-1, W):
            np.testing.assert_array_equal(row.numpy(),
                                          _ring_positions(W, S - 1))
    assert wrapped == (name != "granite-8b" or max_seq < S)
    cache, rc, held = _decode_held(name, "float32", **kw)
    _hold_cache(cache, rc, held)
    for path, t in _flat(cache).items():
        if path.endswith("['pos']"):
            W = t.shape[-1]
            for row in t.reshape(-1, W):
                np.testing.assert_array_equal(
                    row.numpy(), _ring_positions(W, S + STEPS - 1))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["granite-8b", "recurrentgemma-2b"])
def test_int8_kv_matches_reference(name, dtype):
    want, want_cache = _ref_prefill(name, dtype, False, kv="int8")
    _, cfg = _configs(name, kv_dtype="int8")
    params = lm_params_from_reference(_weights(name)[0], device="cpu")
    tdt = DTYPES[dtype][1]
    got, cache = lm.prefill(cfg, params, _batch(cfg, S=S), max_seq=MAX_SEQ,
                            dtype=tdt, use_kernel=False, device="cpu")
    assert _rel(got, want) <= _rtol(name, dtype)
    codes = ("['k']", "['v']")
    own, ref = _flat(cache), _ref_flat(want_cache)
    if dtype == "float32":  # the codes exactly, the scales within 1e-5
        for path, w in ref.items():
            if path.endswith(codes):
                np.testing.assert_array_equal(own[path].numpy(), w)
        _hold_cache(cache, want_cache, dtype)
    else:
        # the port's own bf16 k and v through the reference's formula give
        # the port's codes and scales exactly; its codes are within one of
        # the reference's
        _, kv16 = lm.prefill(get_config(name).reduced(), params,
                             _batch(cfg, S=S), max_seq=MAX_SEQ, dtype=tdt,
                             use_kernel=False, device="cpu")
        kv16 = _flat(kv16)
        for path, w in ref.items():
            if not path.endswith(codes):
                continue
            n = min(w.shape[-3], S)  # the prompt's slots
            x = jnp.asarray(kv16[path][..., :n, :, :].float().numpy())
            q, sc = ref_rowwise_quant(x.astype(jnp.bfloat16), 127)
            np.testing.assert_array_equal(
                own[path][..., :n, :, :].numpy(), np.asarray(q))
            np.testing.assert_array_equal(
                own[path[:-2] + "_scale']"][..., :n, :, :].numpy(),
                np.asarray(sc))
            assert np.abs(own[path].numpy().astype(int)
                          - w.astype(int)).max() <= 1, path
        _hold_cache(cache, want_cache, dtype, skip=codes)
    cache, rc, held = _decode_held(name, dtype, kv="int8")
    if held == "float32":  # the codes exactly
        _hold_cache(cache, rc, held)
    else:
        own, ref = _flat(cache), _ref_flat(rc)
        for path in ref:
            if path.endswith(codes):
                assert np.abs(own[path].numpy().astype(int)
                              - ref[path].astype(int)).max() <= 1, path
        _hold_cache(cache, rc, held, skip=codes)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_decode_routes_as_reference(name, dtype, monkeypatch):
    """The MoE at decode routes the B = 2 tokens of a step as one group:
    top_i, keep and the queue slots of every layer and step equal the
    reference's (its decode unrolled, so that its own ``lax.top_k`` and
    ``jax.nn.one_hot`` calls can be read)."""
    ref_cfg, cfg = _configs(name)
    tree, rp = _weights(name)
    params = lm_params_from_reference(tree, device="cpu")
    rc, cache = _carried(name, dtype)
    jdt, tdt = DTYPES[dtype]
    seen = {"top_i": [], "one_hot": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def rec_top_k(v, k):
        out = top_k(v, k)
        seen["top_i"].append(np.asarray(out[1]))
        return out

    def rec_one_hot(v, n, **kw):
        seen["one_hot"].append((np.asarray(v), n))
        return one_hot(v, n, **kw)

    routes = []
    moe_route = blocks.moe_route

    def rec_route(*a, **k):
        routes.append(moe_route(*a, **k))
        return routes[-1]

    toks = _tokens(cfg)
    monkeypatch.setattr(blocks, "moe_route", rec_route)
    for t in range(STEPS):
        monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
        monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
        _, rc = ref_lm.decode_step(ref_cfg, rp, rc,
                                   jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(S + t), dtype=jdt, unroll=True)
        monkeypatch.setattr(jax.lax, "top_k", top_k)
        monkeypatch.setattr(jax.nn, "one_hot", one_hot)
        lm.decode_step(cfg, params, cache, toks[:, t:t + 1], S + t,
                       dtype=tdt, device="cpu")
    assert len(routes) == len(seen["top_i"]) == STEPS * cfg.n_layers
    slots = seen["one_hot"][1::2]
    for r, ref_i, (ref_slot, cap) in zip(routes, seen["top_i"], slots):
        assert r["top_i"].shape == (1, 2, cfg.top_k) and r["cap"] == cap
        np.testing.assert_array_equal(r["top_i"].numpy(), ref_i)
        np.testing.assert_array_equal(r["slot"].numpy(), ref_slot)
        np.testing.assert_array_equal(r["keep"].numpy(), ref_slot < cap)
