"""Port parity for the VGG16 split-computing stack at REDUCED width: the
parameter template, the seeded init, the forward at all 43 split points
with the reference's weights carried over, head/tail split inference, and
the slice as a whole (fig5's measured dCor trend, and the measured
43-split privacy profile through Algorithm 1). The same numpy images,
weights and projection go to both packages; the JAX Pallas dCor kernel
runs in interpret mode."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as privacy_ref
from repro.core import pso as pso_ref
from repro.core.energy import EDGE_A40X2 as REF_EDGE
from repro.core.energy import UE_VM_2CORE as REF_UE
from repro.core.objective import Constraints as RefConstraints
from repro.core.objective import Weights as RefWeights
from repro.core.splitting import vgg_head as ref_head
from repro.core.splitting import vgg_tail as ref_tail
from repro.kernels.dcor import dcor_kernel as ref_dcor_kernel
from repro.models import vgg as vgg_ref
from repro_torch.core import privacy, pso
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE
from repro_torch.core.objective import Constraints, Weights
from repro_torch.core.splitting import vgg_head, vgg_tail
from repro_torch.kernels.dcor import dcor_kernel
from repro_torch.models import vgg
from repro_torch.weights import vgg_params_from_reference

ROOT = Path(__file__).resolve().parents[1]
N_IMG = 24  # fig5's fast-run image count
SPLITS = [1, 5, 17, 31, 34, 40]  # the reference's split-equivalence cases
# PyTorch's CPU convolutions and XLA's may sum in other orders;
# activations grow by orders of magnitude through the 13 convs (fan-in
# init over c_in only), so each activation is held to 1e-5 of its own
# largest magnitude
ACT_RTOL = 1e-5


def textured(n, size, seed=0):
    """fig5's inputs: normal noise summed over H, then over W, x 0.05."""
    rng = np.random.default_rng(seed)
    xs = np.cumsum(np.cumsum(rng.normal(size=(n, size, size, 3)), 1), 2)
    return (xs * 0.05).astype(np.float32)


def assert_act_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=ACT_RTOL,
                               atol=ACT_RTOL * scale, err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """(numpy images, reference tree, port params, reference activations,
    port activations) at REDUCED width."""
    tree = vgg_ref.init_vgg(vgg_ref.REDUCED, jax.random.PRNGKey(0))
    tree = {k: np.array(v) for k, v in tree.items()}
    xs = textured(N_IMG, vgg_ref.REDUCED.image_size)
    fwd = jax.jit(lambda p, x: vgg_ref.forward(vgg_ref.REDUCED, p, x,
                                               collect=True))
    ref_acts = [np.array(a) for a in fwd(tree, jnp.asarray(xs))]
    params = vgg_params_from_reference(tree, device="cpu")
    acts = vgg.forward(vgg.REDUCED, params, xs, collect=True, device="cpu")
    return xs, tree, params, ref_acts, [a.numpy() for a in acts]


@pytest.mark.parametrize("cfg", ["FULL", "REDUCED"])
def test_template_matches_reference(cfg):
    want = vgg_ref.vgg_template(getattr(vgg_ref, cfg))
    got = vgg.vgg_template(getattr(vgg, cfg))
    assert list(got) == list(want)
    for name, spec in want.items():
        assert got[name] == (tuple(spec.shape), spec.init), name
    assert vgg_ref._shapes(getattr(vgg_ref, cfg)) == vgg._shapes(
        getattr(vgg, cfg))


def test_init_per_leaf_std_and_seed():
    a = vgg.init_vgg(vgg.REDUCED, torch.Generator().manual_seed(0),
                     device="cpu")
    b = vgg.init_vgg(vgg.REDUCED, torch.Generator().manual_seed(0),
                     device="cpu")
    c = vgg.init_vgg(vgg.REDUCED, torch.Generator().manual_seed(1),
                     device="cpu")
    for name, (shape, init) in vgg.vgg_template(vgg.REDUCED).items():
        t = a[name]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert torch.equal(t, b[name])
        if init == "zeros":
            assert not t.any()
            continue
        assert not torch.equal(t, c[name])
        # fan-in over shape[-2] (c_in of an HWIO kernel, not 9 c_in); the
        # sample std of N normals has a relative spread of 1/sqrt(2N)
        std = 1.0 / shape[-2] ** 0.5
        assert abs(float(t.std()) / std - 1.0) < 4.0 / (2 * t.numel()) ** 0.5
        assert abs(float(t.mean())) < 4.0 * std / t.numel() ** 0.5


def test_forward_matches_reference_at_every_split(pair):
    _, _, _, ref_acts, acts = pair
    assert len(acts) == 43
    for i, (got, want) in enumerate(zip(acts, ref_acts)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert_act_close(got, want, f"split {i + 1}")
    np.testing.assert_array_equal(acts[0], pair[0])  # the input op
    np.testing.assert_allclose(acts[-1].sum(-1), 1.0, rtol=1e-5)


def test_forward_range_continues_the_reference(pair):
    """Ops [17, 43) from the reference's split-17 activation."""
    _, _, params, ref_acts, _ = pair
    got = vgg.forward(vgg.REDUCED, params, ref_acts[16], start=17,
                      device="cpu").numpy()
    assert_act_close(got, ref_acts[-1], "tail from split 17")


@pytest.mark.parametrize("l", SPLITS)
def test_head_tail_equals_full(pair, l):
    xs, tree, params, ref_acts, acts = pair
    act = vgg_head(vgg.REDUCED, params, xs, l, device="cpu")
    assert_act_close(act.numpy(), ref_acts[l - 1], f"head {l}")
    ref_act = ref_head(vgg_ref.REDUCED, tree, jnp.asarray(xs), l)
    np.testing.assert_array_equal(act.numpy(), acts[l - 1])
    out = vgg_tail(vgg.REDUCED, params, act, l, device="cpu").numpy()
    np.testing.assert_allclose(out, acts[-1], rtol=1e-4, atol=1e-5)
    want = np.asarray(ref_tail(vgg_ref.REDUCED, tree, ref_act, l))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def test_params_from_reference_checks_leaves():
    with pytest.raises(ValueError, match="not a VGG parameter name"):
        vgg_params_from_reference({"fc": np.zeros(2, np.float32)},
                                  device="cpu")
    with pytest.raises(TypeError, match="float32"):
        vgg_params_from_reference({"op1_w": np.zeros(2)}, device="cpu")


def test_forward_checks_param_device(pair):
    params = {k: v.to("meta") for k, v in pair[2].items()}
    with pytest.raises(ValueError, match="is on meta"):
        vgg.forward(vgg.REDUCED, params, pair[0], device="cpu")


# fig5's measured-dCor trend (benchmarks/fig5_objective.py:50-77): ten
# splits, activations wider than 4096 through one random projection (the
# same numpy matrix for both packages)
FIG5_SPLITS = [0, 4, 10, 16, 24, 30, 33, 36, 40, 42]


def test_fig5_measured_dcor_matches_reference(pair):
    xs, _, _, ref_acts, acts = pair
    n = xs.shape[0]
    xf = xs.reshape(n, -1)
    for i in FIG5_SPLITS:
        a, ra = acts[i].reshape(n, -1), ref_acts[i].reshape(n, -1)
        if a.shape[1] > 4096:
            pm = (np.random.default_rng(7).normal(size=(a.shape[1], 4096))
                  / a.shape[1] ** 0.5).astype(np.float32)
            a, ra = a @ pm, np.asarray(jnp.asarray(ra) @ jnp.asarray(pm))
        want = float(ref_dcor_kernel(jnp.asarray(xf), jnp.asarray(ra),
                                     interpret=True))
        got = float(dcor_kernel(torch.from_numpy(xf), torch.from_numpy(a)))
        assert abs(got - want) < 1e-4, (i + 1, got, want)


def test_measured_profile_gives_the_reference_tables(pair):
    """The measured 43-split profile (the port's forward and dCor against
    the reference's) into ``vgg_split_profile`` + ``pso_vectorized``:
    the privacy values within 1e-4 and the lookup tables equal."""
    xs, _, _, ref_acts, acts = pair
    want = np.asarray(privacy_ref.layer_privacy_profile(
        jnp.asarray(xs), [jnp.asarray(a) for a in ref_acts]), np.float64)
    got = np.asarray([float(dcor_kernel(torch.from_numpy(xs),
                                        torch.from_numpy(a)))
                      for a in acts])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for cfg in ("FULL", "REDUCED"):
        prof_r = vgg_ref.vgg_split_profile(getattr(vgg_ref, cfg),
                                           privacy=want)
        prof_t = vgg.vgg_split_profile(getattr(vgg, cfg), privacy=got)
        a = pso_ref.pso_vectorized(prof_r, REF_UE, REF_EDGE,
                                   RefWeights(1.0, 0.15, 0.1),
                                   RefConstraints(rho_max=0.92, tau_max_s=6.0,
                                                  e_max_j=40.0), 130)
        b = pso.pso_vectorized(prof_t, UE_VM_2CORE, EDGE_A40X2,
                               Weights(1.0, 0.15, 0.1),
                               Constraints(rho_max=0.92, tau_max_s=6.0,
                                           e_max_j=40.0), 130)
        np.testing.assert_array_equal(a.table, b.table, err_msg=cfg)
        np.testing.assert_array_equal(a.feasible_prefilter,
                                      b.feasible_prefilter, err_msg=cfg)
        assert (b.table >= 0).any(), cfg  # the table is not all NO_SPLIT


def test_layer_privacy_profile_on_port_activations(pair):
    xs, _, _, _, acts = pair
    plain = privacy.layer_privacy_profile(
        torch.from_numpy(xs), [torch.from_numpy(a) for a in acts])
    kern = torch.stack([dcor_kernel(torch.from_numpy(xs),
                                    torch.from_numpy(a)) for a in acts])
    assert torch.equal(plain, kern)  # on the CPU the kernel is the oracle


def test_quickstart_torch_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--smoke", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "measured privacy" in out.stdout
    assert out.stdout.rstrip().endswith("done.")
