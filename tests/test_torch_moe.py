"""Port parity for the MoE feed-forward (``blocks.moe_block``) against the
JAX package's ``moe_block``, with the same weights and input, for top-2
(mixtral-8x22b) and top-1 (llama4-scout-17b-a16e) at ``reduced()``: one
group of 64 tokens; two groups (T = 2048); one group of all 1536 tokens
(the 1024-token group does not divide 1536); the capacity overflowing
(both packages' ``reduced(capacity_factor=0.25)``, so tokens are
dropped); and tied router probabilities (a router whose columns are zero
but one), where the lower expert must come first, as ``lax.top_k`` puts
it.

The routing decisions are held exactly: top_i, keep and every (token,
k)'s queue slot. They are read off the reference's own run: its
``lax.top_k`` gives top_i, and its second ``jax.nn.one_hot`` call takes
the slots and the capacity; a (token, k) is kept where its slot is under
the capacity. The block output is held in f32 within 1e-5 of its largest
magnitude, in bf16 within two bf16 ulps of it; the Switch aux loss within
1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import blocks as ref_blocks
from repro_torch.configs import get_config
from repro_torch.models import blocks
from repro_torch.models.template import init_from_template

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (batch, seq, capacity_factor or None for the config's 1.25, tied router)
CASES = {"one_group": (2, 32, None, False),
         "two_groups": (2, 1024, None, False),
         "one_group_of_T": (2, 768, None, False),
         "overflow": (2, 32, 0.25, False),
         "tie": (2, 32, None, True)}


def _configs(name, cf):
    kw = {} if cf is None else {"capacity_factor": cf}
    return (ref_get_config(name).reduced(**kw),
            get_config(name).reduced(**kw))


def _weights(cfg, tie, seed=0):
    """The MoE template's weights made from a seed, as numpy arrays; with
    ``tie``, a router whose columns are zero but the last, so that every
    token's probabilities tie on the other experts."""
    p = {k: v.numpy() for k, v in init_from_template(
        blocks.moe_template(cfg), torch.Generator().manual_seed(seed),
        device="cpu").items()}
    p["ln"] = np.random.default_rng(seed).normal(
        size=p["ln"].shape).astype(np.float32) * 0.1
    if tie:
        p["router"][:, :-1] = 0.0
    return p


def _ref_moe(ref_cfg, p, x, jdt, monkeypatch):
    """The reference's moe_block on (p, x) and its decisions: top_i (nG,
    g, K), the queue slots (nG, g, K) and the capacity."""
    seen = {"one_hot": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def rec_top_k(v, k):
        out = top_k(v, k)
        seen["top_i"] = np.asarray(out[1])
        return out

    def rec_one_hot(v, n, **kw):
        seen["one_hot"].append((np.asarray(v), n))
        return one_hot(v, n, **kw)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    try:
        y, aux = ref_blocks.moe_block(
            ref_cfg, {k: jnp.asarray(v) for k, v in p.items()},
            jnp.asarray(x).astype(jdt), jdt)
    finally:
        monkeypatch.undo()
    slot, cap = seen["one_hot"][1]
    return (np.asarray(y.astype(jnp.float32)), float(aux), seen["top_i"],
            slot, cap)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_block_matches_reference(name, dtype, case, monkeypatch):
    B, S, cf, tie = CASES[case]
    jdt, tdt = DTYPES[dtype]
    ref_cfg, cfg = _configs(name, cf)
    p = _weights(cfg, tie)
    x = np.random.default_rng(S).normal(size=(B, S, cfg.d_model)).astype(
        np.float32) * 2.0
    want, want_aux, ref_i, ref_slot, ref_cap = _ref_moe(ref_cfg, p, x, jdt,
                                                        monkeypatch)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x).to(tdt)
    route = blocks.moe_route(cfg, tp, blocks.rms_norm(xt, tp["ln"],
                                                      cfg.norm_eps))
    g = blocks.moe_group(B * S)
    assert route["top_i"].shape == (B * S // g, g, cfg.top_k)
    assert route["cap"] == ref_cap
    np.testing.assert_array_equal(route["top_i"].numpy(), ref_i)
    np.testing.assert_array_equal(route["slot"].numpy(), ref_slot)
    np.testing.assert_array_equal(route["keep"].numpy(), ref_slot < ref_cap)
    if case == "overflow":
        assert not route["keep"].all()
    if tie:  # the tied experts, lower index first
        tied = route["top_i"][..., :1] != cfg.num_experts - 1
        assert (route["top_i"][..., 0][tied[..., 0]] == 0).all()
        if cfg.top_k > 1:
            top = route["top_i"]
            assert ((top[..., 1] == 0) | (top[..., 1] == 1)).all()
    got, aux = blocks.moe_block(cfg, tp, xt, tdt)
    assert got.dtype == tdt and got.shape == (B, S, cfg.d_model)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - want_aux) <= 1e-6 * abs(want_aux)
    top = np.abs(want).max()
    tol = (1e-5 * top if dtype == "float32"
           else 2 * 2.0 ** (np.floor(np.log2(top)) - 7))
    assert np.abs(got.float().numpy() - want).max() <= tol
