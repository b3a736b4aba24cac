"""K5's plain version (ops/select_cuda.py::ball_select_plain) against the
TPU kernel ``lidardetection_tpu/ops/select_tpu.py::ball_select`` run in
interpret mode on the CPU, on the same runs, built as
tests/test_select_tpu.py builds them: disjoint runs of a sorted table,
each at most (nw - 1) * cap rows. The scores must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.ops import pointnet2 as jp2
from lidardetection_tpu.ops.select_tpu import ball_select as pallas_select
from lidardetection_tpu_torch.ops.select_cuda import (
    ball_select, ball_select_plain, select_launch_plan, squared_radii,
)

NW = 4


def _runs(rng, n, m, n_row, cap, empty_share):
    """Disjoint runs per center, some empty: each starts in its own block of
    every third cap-block and is shorter than two blocks."""
    third = np.arange(0, n // cap - 2, 3)
    blocks = np.stack([rng.permutation(third)[:n_row] for _ in range(m)])
    start = blocks * cap + rng.randint(0, cap, (m, n_row))
    end = start + rng.randint(0, 2 * cap, (m, n_row))
    end = np.where(rng.rand(m, n_row) < empty_share, start, end)
    return start.astype(np.int32), np.minimum(end, n).astype(np.int32)


def _case(seed, b, n, m, n_row, cap, empty_share=0.2):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    orig = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32)
    centers = rng.uniform(-3, 3, (b, m, 3)).astype(np.float32)
    runs = [_runs(rng, n, m, n_row, cap, empty_share) for _ in range(b)]
    start = np.stack([r[0] for r in runs])
    end = np.stack([r[1] for r in runs])
    return xyz, orig, start, end, centers


def _pallas(xyz, orig, start, end, centers, radii, nsamples, cap):
    """The TPU kernel per sample, over its packed candidate windows."""
    outs = []
    for i in range(xyz.shape[0]):
        cand, _ = jp2._candidate_windows(jnp.asarray(xyz[i]),
                                         jnp.asarray(orig[i]),
                                         jnp.asarray(start[i]), cap, nw=NW)
        nb = -(-xyz.shape[1] // cap) + 2
        outs.append(pallas_select(cand, jnp.asarray(start[i]),
                                  jnp.asarray(end[i]), jnp.asarray(centers[i]),
                                  radii, nsamples, cap, nb, nw=NW,
                                  interpret=True))
    return [np.stack([np.asarray(o[r]) for o in outs]) for r in range(len(radii))]


@pytest.mark.parametrize('radii,nsamples,n_row,b', [
    ((0.8, 1.6), (4, 6), 9, 1),
    ((0.8, 1.2), (16, 32), 6, 2),
    ((2.4,), (16,), 3, 2),
])
def test_plain_matches_pallas_interpret(radii, nsamples, n_row, b):
    cap = 8
    args = _case(len(radii) + n_row, b, 240, 37, n_row, cap)
    want = _pallas(*args, radii, nsamples, cap)
    got = ball_select_plain(*(torch.from_numpy(a) for a in args), radii,
                            nsamples, (NW - 1) * cap)
    for g, w, ns in zip(got, want, nsamples):
        assert tuple(g.shape) == (b, 37, ns)
        np.testing.assert_array_equal(g.numpy(), w)
    assert np.isfinite(want[-1]).any() and np.isinf(want[0]).any()


def test_empty_runs_give_no_hits():
    args = _case(7, 1, 240, 12, 9, 8, empty_share=1.0)
    got = ball_select_plain(*(torch.from_numpy(a) for a in args), (5.0,), (8,),
                            24)
    assert bool(torch.isinf(got[0]).all())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = [torch.from_numpy(a) for a in _case(8, 2, 240, 10, 6, 8)]
    before = ball_select.launches
    got = ball_select(*args, (0.8, 1.6), (4, 8), 24)
    want = ball_select_plain(*args, (0.8, 1.6), (4, 8), 24)
    assert ball_select.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_squared_radii_are_squared_in_float32():
    """float32(r) * float32(r) rounded to float32, as the TPU kernel squares
    the radius: for 0.4 it differs from rounding 0.4 * 0.4 taken in double."""
    r2 = squared_radii((0.4, 0.8))
    assert r2[0] == float(np.float32(0.4) * np.float32(0.4))
    assert r2[0] != float(np.float32(0.4 * 0.4))


@pytest.mark.parametrize('n_row,nsamples', [(9, (16, 16)), (9, (16, 32)),
                                            (6, (16, 32)), (3, (16, 32))])
def test_launch_plan_at_the_pvrcnn_shapes(n_row, nsamples):
    """A request's five sources: up to 1024 hits a center (576 where three
    runs of 192 rows hold fewer), inside the 48 KB a block gets without
    opting in."""
    plan = select_launch_plan(n_row, 192, nsamples)
    cap = min(n_row * 192, 1024)
    assert (plan.cap, plan.list_cap) == (cap, max(nsamples))
    assert plan.smem_bytes == 4 * (cap + 256 + max(nsamples)
                                   + 2 * n_row + 1) < 48 * 1024


def test_launch_plan_sizes_from_the_shape():
    assert select_launch_plan(1, 10, (4,)).cap == 10  # runs hold fewer
    big = select_launch_plan(9, 192, (40000,))  # the taken list sets it
    assert big.list_cap == 40000 and big.smem_bytes <= 227 * 1024
    with pytest.raises(ValueError):
        select_launch_plan(9, 192, (60000,))
