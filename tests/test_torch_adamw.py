"""Port parity for the hand-written AdamW (``repro_torch.optim``): the
global norm, the cosine schedule and several ``update`` steps against
``repro.optim`` on the same numpy trees, with clipping active and not, a
constant and a scheduled lr, and weight decay. Both run in f32 with the
same operations; the leaves' sums of squares reduce in another order, so
the norm holds rtol 1e-6 and the parameters 1e-6 of their magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import global_norm as ref_global_norm
from repro_torch.optim import AdamW, cosine_schedule, global_norm, tree_leaves

SHAPES = {"b": {"w": (5, 3), "a": (7,)}, "a": {"z": (2, 2, 3), "b": (1,)},
          "c": ((4,), (3, 2))}


def _tree(rng, scale=1.0):
    def leaf(shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {g: (tuple(leaf(s) for s in d) if isinstance(d, tuple)
                else {k: leaf(s) for k, s in d.items()})
            for g, d in SHAPES.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _assert_tree_close(ref, got, rtol):
    want = [np.asarray(x) for x in jax.tree.leaves(ref)]
    have = [x.numpy() for x in tree_leaves(got)]
    assert len(want) == len(have)
    for a, b in zip(want, have):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=rtol * max(np.abs(a).max(), 1e-30))


def test_tree_leaves_follow_jax_order():
    tree = _tree(np.random.default_rng(0))
    want = [np.asarray(x) for x in jax.tree.leaves(_jax(tree))]
    got = [x.numpy() for x in tree_leaves(_torch(tree))]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_global_norm_matches_reference(scale):
    tree = _tree(np.random.default_rng(1), scale)
    want = float(ref_global_norm(_jax(tree)))
    got = global_norm(_torch(tree))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("peak,warmup,total,floor", [
    (1e-3, 10, 100, 0.1), (3e-4, 0, 50, 0.0), (1.0, 5, 5, 0.5)])
def test_cosine_schedule_matches_reference(peak, warmup, total, floor):
    ref, port = ref_cosine(peak, warmup, total, floor), cosine_schedule(
        peak, warmup, total, floor)
    for step in range(0, total + 20):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("clip", [None, 1.0, 1e6], ids=["none", "active",
                                                         "inactive"])
@pytest.mark.parametrize("sched", [False, True], ids=["const", "cosine"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_update_matches_reference(clip, sched, wd):
    """Six steps from the same parameters and per-step gradients: the
    parameters, moments, step and reported norm and lr agree."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    lr_ref = ref_cosine(1e-2, 2, 6) if sched else 1e-2
    lr_port = cosine_schedule(1e-2, 2, 6) if sched else 1e-2
    ref = RefAdamW(lr=lr_ref, weight_decay=wd, clip_norm=clip)
    port = AdamW(lr=lr_port, weight_decay=wd, clip_norm=clip)
    rp, pp = _jax(params), _torch(params)
    rs, ps = ref.init(rp), port.init(pp)
    assert int(ps["step"]) == 0 and ps["step"].dtype == torch.int32
    for i in range(6):
        grads = _tree(rng, scale=10.0 ** (i - 2))
        rp, rs, rinfo = ref.update(_jax(grads), rs, rp)
        pp, ps, pinfo = port.update(_torch(grads), ps, pp)
        _assert_tree_close(rp, pp, 1e-6)
        _assert_tree_close(rs["m"], ps["m"], 1e-6)
        _assert_tree_close(rs["v"], ps["v"], 1e-6)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        np.testing.assert_allclose(float(pinfo["grad_norm"]),
                                   float(rinfo["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pinfo["lr"]), float(rinfo["lr"]),
                                   rtol=1e-6)


def test_update_tracks_no_gradient_and_keeps_inputs():
    rng = np.random.default_rng(3)
    params = {k: v.requires_grad_() for k, v in
              _torch(_tree(rng))["b"].items()}
    before = {k: v.detach().clone() for k, v in params.items()}
    opt = AdamW(lr=0.1)
    state = opt.init(params)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    new, state, _ = opt.update(grads, state, params)
    for k in params:
        assert not new[k].requires_grad
        assert torch.equal(params[k].detach(), before[k])
        assert not torch.equal(new[k], before[k])
