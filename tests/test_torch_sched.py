"""Port parity for the PRB scheduler: ``scheduler_step`` over several
periods, every policy, masked and unmasked, ``fused`` both ways, against
the JAX step on the same numpy inputs. rr and maxsinr shares and PF
averages are bit-equal (their sums are of small integers); pf shares are
within the reference's fused-vs-unfused bar (rtol 1e-5, atol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import sched as sched_ref
from repro_torch.sim import sched

N, C, T = 40, 3, 6


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    # whole-Mbps rates, so maxsinr sees exact ties
    rate = np.round(rng.uniform(1.0, 40.0, (T, N))).astype(np.float32)
    cells = rng.integers(0, C, (T, N)).astype(np.int32)
    cells[:, :C] = np.arange(C)  # no cell empty in the unmasked form
    active = rng.random((T, N)) < 0.75 if masked else None
    return rate, cells, active


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("policy", sched.POLICIES)
def test_scheduler_step_matches_reference(policy, masked, fused):
    rate, cells, active = _inputs(len(policy) + 2 * masked, masked)
    rcfg = sched_ref.SchedulerConfig(policy, pf_beta=0.3, fused=fused)
    cfg = sched.SchedulerConfig(policy, pf_beta=0.3, fused=fused)
    rs = sched_ref.scheduler_init(N)
    ps = sched.scheduler_init(N, device="cpu")
    for t in range(T):
        act = None if active is None else active[t]
        rs, rshare = sched_ref.scheduler_step(
            rcfg, C, rs, jnp.asarray(cells[t]), jnp.asarray(rate[t]),
            None if act is None else jnp.asarray(act))
        ps, share = sched.scheduler_step(
            cfg, C, ps, torch.from_numpy(cells[t]), torch.from_numpy(rate[t]),
            None if act is None else torch.from_numpy(act))
        assert share.dtype == torch.float32 and int(ps.step) == t + 1
        if policy == "pf":
            np.testing.assert_allclose(share.numpy(), np.asarray(rshare),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(ps.avg_tp.numpy(),
                                       np.asarray(rs.avg_tp), rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(share.numpy(), np.asarray(rshare))
            np.testing.assert_array_equal(ps.avg_tp.numpy(),
                                          np.asarray(rs.avg_tp))
        if act is not None:
            assert not share.numpy()[~act].any()


@pytest.mark.parametrize("fused", [False, True])
def test_cell_shares_conserve_the_budget(fused):
    rng = np.random.default_rng(1)
    w = rng.uniform(0.1, 2.0, N).astype(np.float32)
    g = rng.integers(0, C, N).astype(np.int32)
    got = sched.cell_shares(torch.from_numpy(w), torch.from_numpy(g), C,
                            fused=fused).numpy()
    want = np.asarray(sched_ref.cell_shares(jnp.asarray(w), jnp.asarray(g),
                                            C, fused=fused))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    sums = np.bincount(g, weights=got, minlength=C)
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)


def test_out_of_range_cell_reads_as_the_reference_gathers():
    """An id outside [0, C) takes no part in a normalizer; its own share
    reads the normalizer the reference's clamping gather reads."""
    rate = np.linspace(1.0, 9.0, 8).astype(np.float32)
    cells = np.array([0, 1, 2, 5, -1, 0, 1, -7], np.int32)
    for policy in sched.POLICIES:
        _, want = sched_ref.scheduler_step(
            sched_ref.SchedulerConfig(policy), 3, sched_ref.scheduler_init(8),
            jnp.asarray(cells), jnp.asarray(rate))
        _, got = sched.scheduler_step(
            sched.SchedulerConfig(policy), 3,
            sched.scheduler_init(8, device="cpu"), torch.from_numpy(cells),
            torch.from_numpy(rate))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_config_validation_matches_reference():
    for kw in ({"policy": "edf"}, {"n_prb": 0}, {"pf_beta": 0.0},
               {"pf_beta": 1.5}):
        with pytest.raises(ValueError):
            sched_ref.SchedulerConfig(**kw)
        with pytest.raises(ValueError):
            sched.SchedulerConfig(**kw)
    assert sched.POLICIES == sched_ref.POLICIES
