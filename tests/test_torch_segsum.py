"""Port parity for the segsum stage: the plain PyTorch segment reduction
against the JAX ``segment_reduce`` (its Pallas kernel in interpret mode,
and its XLA scatter form), and the cells layer's kernel aggregation
against its numpy form. Max is bit-equal; a sum in another order is within
the reference's own bar (rtol 1e-5, atol 1e-5)."""
import numpy as np
import pytest
import torch

from repro.kernels.segsum import segment_reduce as ref_segment_reduce
from repro.sim import cells as cells_ref
from repro_torch.kernels.segsum import (VEC4_MAX_N, VEC4_MAX_SEGMENTS,
                                        segment_reduce,
                                        segment_reduce_batched,
                                        segment_reduce_ref, segsum_route)
from repro_torch.sim import cells as cells_t


def _case(t, n, c, seed, with_mask, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(t, n)).astype(np.float32)
    g = rng.integers(lo, c if hi is None else hi, (t, n)).astype(np.int32)
    m = rng.random((t, n)) < 0.7 if with_mask else None
    return v, g, m


def _port(v, g, c, op, m, use_kernel=True):
    return segment_reduce(torch.from_numpy(v), torch.from_numpy(g), c, op=op,
                          mask=None if m is None else torch.from_numpy(m),
                          use_kernel=use_kernel).numpy()


def _assert_matches(got, want, op):
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ref_kernel", [True, False])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("t,n,c,with_mask",
                         [(1, 16, 3, False), (5, 200, 7, True),
                          (12, 1000, 5, True), (3, 33, 1, False)])
def test_segment_reduce_matches_reference(ref_kernel, op, t, n, c,
                                          with_mask):
    v, g, m = _case(t, n, c, 0, with_mask)
    want = np.asarray(ref_segment_reduce(v, g, c, op=op, mask=m,
                                         use_kernel=ref_kernel))
    for use_kernel in (True, False):
        got = _port(v, g, c, op, m, use_kernel)
        assert got.shape == (t, c) and got.dtype == np.float32
        _assert_matches(got, want, op)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_out_of_range_ids_contribute_nothing(op):
    """Negative ids and ids >= C are dropped, in both reference forms."""
    v, g, _ = _case(4, 300, 5, 1, False, lo=-3, hi=9)
    for ref_kernel in (True, False):
        want = np.asarray(ref_segment_reduce(v, g, 5, op=op,
                                             use_kernel=ref_kernel))
        _assert_matches(_port(v, g, 5, op, None), want, op)


def test_segment_reduce_1d_and_broadcast_ids():
    v1 = np.arange(6, dtype=np.float32)
    g1 = np.array([0, 1, 0, 2, 1, 0], np.int32)
    got = segment_reduce(torch.from_numpy(v1), torch.from_numpy(g1), 3)
    assert got.shape == (3,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_segment_reduce(v1, g1, 3)))
    v2 = np.stack([v1, v1 * 2])
    got2 = segment_reduce(torch.from_numpy(v2), torch.from_numpy(g1), 3)
    np.testing.assert_array_equal(
        got2.numpy(), np.asarray(ref_segment_reduce(v2, g1, 3)))
    np.testing.assert_array_equal(got2.numpy()[1], got2.numpy()[0] * 2)


@pytest.mark.parametrize("op,identity", [("sum", 0.0), ("max", -np.inf)])
def test_empty_segments_take_the_identity(op, identity):
    v = np.ones((2, 4), np.float32)
    g = np.zeros((2, 4), np.int32)
    out = _port(v, g, 3, op, None)
    assert (out[:, 1:] == identity).all()
    np.testing.assert_array_equal(
        out, np.asarray(ref_segment_reduce(v, g, 3, op=op)))


def test_masked_slots_redirect_to_the_dummy_segment():
    v, g, m = _case(3, 50, 4, 2, True)
    got = _port(v, g, 4, "sum", m)
    want = _port(v, np.where(m, g, 4).astype(np.int32), 4, "sum", None)
    np.testing.assert_array_equal(got, want)


def test_wrapper_runs_plain_version_on_cpu():
    v, g, _ = _case(5, 64, 4, 3, False, lo=-1, hi=6)
    tv, tg = torch.from_numpy(v), torch.from_numpy(g)
    for op in ("sum", "max"):
        assert torch.equal(segment_reduce_batched(tv, tg, 4, op=op),
                           segment_reduce_ref(tv, tg, 4, op=op))


@pytest.mark.parametrize("bad", ["dtype", "ids_dtype", "shape", "rank",
                                 "contiguous", "op"])
def test_wrapper_rejects_malformed_input(bad):
    v = torch.zeros((3, 8))
    g = torch.zeros((3, 8), dtype=torch.int32)
    kw = {"op": "sum"}
    if bad == "dtype":
        v = v.double()
    elif bad == "ids_dtype":
        g = g.long()
    elif bad == "shape":
        g = g[:, :4]
    elif bad == "rank":
        v, g = v[0], g[0]
    elif bad == "contiguous":
        v = torch.zeros((8, 3)).T
    else:
        kw["op"] = "mean"
    with pytest.raises((TypeError, ValueError)):
        segment_reduce_batched(v, g, 4, **kw)


@pytest.mark.parametrize("c", range(1, VEC4_MAX_SEGMENTS + 1))
def test_route_takes_vec4_instances(c):
    """Every C of 1-8 has an instance for rows of a multiple of 4 values
    up to 4096: the paths' C 4 and 5 at N 1024 among them."""
    for n in (4, 32, 1024, 1028, 4092, VEC4_MAX_N):
        assert segsum_route(n, c) == "vec4"


@pytest.mark.parametrize("n,c,aligned", [
    (1024, VEC4_MAX_SEGMENTS + 1, True), (VEC4_MAX_N + 4, 4, True),
    (1025, 4, True), (33, 1, True), (1022, 8, True), (0, 4, True),
    (1024, 4, False), (4096, 1, False)])
def test_route_generic_past_each_edge(n, c, aligned):
    """Past 8 segments, past 4096 values, off a multiple of 4, with no
    values or off the 16-byte grid: the first version."""
    assert segsum_route(n, c, aligned) == "generic"


@pytest.mark.parametrize("t,n,c", [(1, 1024, 4), (130, 1024, 4),
                                   (2, 4100, 9), (3, 33, 1)])
def test_wrapper_runs_plain_version_on_cpu_at_route_shapes(t, n, c):
    """On CPU tensors the wrapper is the plain version on either side of
    the route's edges, ids outside [0, C) included."""
    v, g, _ = _case(t, n, c, 4, False, lo=-2, hi=c + 2)
    tv, tg = torch.from_numpy(v), torch.from_numpy(g)
    for op in ("sum", "max"):
        assert torch.equal(segment_reduce_batched(tv, tg, c, op=op),
                           segment_reduce_ref(tv, tg, c, op=op))


@pytest.mark.parametrize("bad,match", [
    ("segments", "n_segments"), ("device", "no segsum kernel"),
    ("ids_device", "seg_ids are on")])
def test_wrapper_raises_on_segments_and_devices(bad, match):
    v = torch.zeros((3, 8))
    g = torch.zeros((3, 8), dtype=torch.int32)
    c = 4
    if bad == "segments":
        c = 0
    elif bad == "device":
        v, g = v.to("meta"), g.to("meta")
    else:
        g = g.to("meta")
    with pytest.raises(ValueError, match=match):
        segment_reduce_batched(v, g, c)


@pytest.mark.parametrize("n,steps,c", [(24, 36, 3), (64, 130, 4)])
def test_cell_load_and_coupling_kernel_match(n, steps, c):
    """``cell_load``/``coupled_interference_mw`` with ``use_kernel=True``
    (segsum, run here as its plain version) against the reference's kernel
    form and the port's numpy form."""
    rng = np.random.default_rng(n)
    grid = cells_t.handover_grid(cells_t.attach_ring(n, c), steps, 0.25,
                                 rng, n_cells=c)
    demand = rng.uniform(0.05, 1.0, n)
    got = cells_t.cell_load(grid, demand, c, use_kernel=True, device="cpu")
    want = np.asarray(cells_ref.cell_load(grid, demand, c, use_kernel=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, cells_t.cell_load(grid, demand, c),
                               rtol=1e-5, atol=1e-6)
    coup = cells_t.ring_coupling(c)
    got_i = cells_t.coupled_interference_mw(grid, demand, coup,
                                            use_kernel=True, device="cpu")
    np.testing.assert_allclose(got_i, cells_ref.coupled_interference_mw(
        grid, demand, coup, use_kernel=True), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(
        got_i, cells_t.coupled_interference_mw(grid, demand, coup),
        rtol=1e-5, atol=1e-9)
    # the numpy form is the reference's, bit for bit
    np.testing.assert_array_equal(cells_t.cell_load(grid, demand, c),
                                  cells_ref.cell_load(grid, demand, c))
