"""The port's point ops against the JAX package's, on the CPU
(lidardetection_tpu/ops/pointnet2.py).

The same seed-made numpy inputs go through both. Indices, empty masks and
candidate sets must be equal: random clouds put no pair within float32
rounding of a radius. The grid ball query is held against the JAX
package's row-run path run through the Pallas kernel in interpret mode
(``_FORCE_KERNEL_INTERPRET``, as tests/test_grid_ball_query.py does):
the port's selection there is K5's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.ops import pointnet2 as jp2
from lidardetection_tpu_torch.ops import pointnet2 as tp2
from lidardetection_tpu_torch.ops.select_cuda import ball_select

BOUNDS = (0.0, -8.0, -2.0, 16.0, 8.0, 2.0)


def _cloud(rng, b, n, lo=(0, -8, -2), hi=(16, 8, 2)):
    return np.stack([rng.uniform(lo[i], hi[i], (b, n)) for i in range(3)],
                    axis=-1).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _equal(got, want, what=''):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def test_farthest_point_sample_matches_jax():
    rng = np.random.RandomState(0)
    xyz = _cloud(rng, 2, 700)
    num = np.array([700, 410], np.int32)
    want = jp2.farthest_point_sample(jnp.asarray(xyz), jnp.asarray(num), 96)
    got = tp2.farthest_point_sample(*_t(xyz, num), 96)
    _equal(got, want)
    assert int(got[1].max()) < 410  # padding is never chosen


@pytest.mark.parametrize('n,npoint,sectors', [(1024, 64, 8), (1000, 48, 16)])
def test_sector_fps_matches_jax(n, npoint, sectors):
    """(1000, 48, 16) degrades to fewer sectors, as the JAX function does."""
    rng = np.random.RandomState(1)
    xyz = _cloud(rng, 2, n, lo=(-30, -30, -2), hi=(30, 30, 2))
    num = np.array([n, n - 300], np.int32)
    want = jp2.sector_fps(jnp.asarray(xyz), jnp.asarray(num), npoint, sectors)
    got = tp2.sector_fps(*_t(xyz, num), npoint, sectors)
    _equal(got, want)


def test_fps_knobs_engage_only_on_the_card():
    rng = np.random.RandomState(2)
    xyz, num = _t(_cloud(rng, 1, 512), np.array([512], np.int32))
    knobs = tp2.PointOpKnobs(fps_sectors=8)
    _equal(tp2.fps(xyz, num, 32, knobs), tp2.farthest_point_sample(xyz, num, 32))


@pytest.mark.parametrize('radius,nsample', [(0.8, 16), (1.6, 8), (3.0, 32)])
def test_ball_query_matches_jax(radius, nsample):
    rng = np.random.RandomState(3)
    src, centers = _cloud(rng, 2, 512), _cloud(rng, 2, 300)
    num = np.array([512, 400], np.int32)
    cvalid = rng.rand(2, 300) > 0.2
    for valid in (None, cvalid):
        want = jp2.ball_query(radius, nsample, jnp.asarray(src),
                              jnp.asarray(num), jnp.asarray(centers),
                              None if valid is None else jnp.asarray(valid))
        got = tp2.ball_query(radius, nsample, *_t(src, num, centers),
                             None if valid is None else torch.from_numpy(valid))
        _equal(got[0], want[0], 'idx')
        _equal(got[1], want[1], 'empty')
    assert not bool(got[1].all()) and bool(got[1].any())


def test_ball_query_multi_matches_jax():
    rng = np.random.RandomState(4)
    src, centers = _cloud(rng, 2, 400), _cloud(rng, 2, 64)
    num = np.array([400, 123], np.int32)
    args = (jnp.asarray(src), jnp.asarray(num), jnp.asarray(centers))
    want = jp2.ball_query_multi((0.8, 1.6), (8, 16), *args)
    got = tp2.ball_query_multi((0.8, 1.6), (8, 16), *_t(src, num, centers))
    for (gi, ge), (wi, we) in zip(got, want):
        _equal(gi, wi, 'idx')
        _equal(ge, we, 'empty')


def _dense_cloud(rng, b, n):
    """Half the points in a 1 m clump, so a few cells hold more than a
    small cap."""
    pts = _cloud(rng, b, n)
    pts[:, : n // 2] = rng.uniform(0, 1, (b, n // 2, 3)) + np.float32([4, 1, 0])
    return pts


@pytest.mark.parametrize('case', ['caps_hold', 'caps_bind', 'invalid_centres',
                                  'out_of_bounds_centres'])
def test_grid_ball_query_multi_matches_jax_kernel_path(monkeypatch, case):
    monkeypatch.setattr(jp2, '_FORCE_KERNEL_INTERPRET', True)
    rng = np.random.RandomState(5)
    b, n, m = 2, 600, 64
    src = _dense_cloud(rng, b, n) if case == 'caps_bind' else _cloud(rng, b, n)
    centers = _cloud(rng, b, m)
    if case == 'caps_bind':
        centers[:, :16] = src[:, :16]  # centres inside the clump
    if case == 'out_of_bounds_centres':
        centers[:, :6, 0] += 20.0
        centers[:, 6:9, 2] -= 9.0
    num = np.array([n, n - 150], np.int32)
    cvalid = None
    if case == 'invalid_centres':
        cvalid = rng.rand(b, m) > 0.33
    cap = 8 if case == 'caps_bind' else 32  # 32: no run of 96 rows is cut
    for radii, nsamples in (((0.8,), (16,)), ((0.8, 1.6), (8, 32))):
        want = jp2.grid_ball_query_multi(
            radii, nsamples, jnp.asarray(src), jnp.asarray(num),
            jnp.asarray(centers), None if cvalid is None else jnp.asarray(cvalid),
            bounds=BOUNDS, cell_cap=cap)
        got = tp2.grid_ball_query_multi(
            radii, nsamples, *_t(src, num, centers),
            None if cvalid is None else torch.from_numpy(cvalid),
            bounds=BOUNDS, cell_cap=cap)
        for (gi, ge), (wi, we) in zip(got, want):
            _equal(gi, wi, f'{case} {radii} idx')
            _equal(ge, we, f'{case} {radii} empty')
    exact = tp2.ball_query(radii[-1], nsamples[-1], *_t(src, num, centers),
                           None if cvalid is None else torch.from_numpy(cvalid))
    # the cap cut candidates only where it binds
    assert torch.equal(got[-1][0], exact[0]) == (case != 'caps_bind')
    if case == 'invalid_centres':
        assert bool(got[0][1][~torch.from_numpy(cvalid)].all())


def test_grid_ball_query_multi_runs_the_plain_select_on_the_cpu():
    rng = np.random.RandomState(6)
    src, centers = _cloud(rng, 1, 300), _cloud(rng, 1, 20)
    before = ball_select.launches
    (idx, empty), = tp2.grid_ball_query_multi(
        (1.0,), (8,), *_t(src, np.array([300], np.int32), centers),
        bounds=BOUNDS, cell_cap=300)
    assert ball_select.launches == before
    want = tp2.ball_query(1.0, 8, *_t(src, np.array([300], np.int32), centers))
    _equal(idx, want[0])
    _equal(empty, want[1])


def _rois(rng, b, r):
    ctr = _cloud(rng, b, r, lo=(2, -6, -1), hi=(14, 6, 1))
    size = rng.uniform(0.5, 4.0, (b, r, 3)).astype(np.float32)
    return ctr, size


def test_roi_candidates_matches_jax():
    rng = np.random.RandomState(7)
    kp = _cloud(rng, 2, 512)
    num = np.array([512, 300], np.int32)
    ctr, size = _rois(rng, 2, 24)
    r_cand = (0.5 * np.linalg.norm(size, axis=-1) + 1.6).astype(np.float32)
    r_cand[1, :5] = 0.0  # padded RoIs
    want = jp2.roi_candidates(jnp.asarray(kp), jnp.asarray(num),
                              jnp.asarray(ctr), jnp.asarray(r_cand), 64)
    got = tp2.roi_candidates(*_t(kp, num, ctr, r_cand), 64)
    _equal(got[1], want[1], 'live')
    _equal(got[0], want[0], 'idx')
    assert bool(got[1].any()) and not bool(got[1][1, :5].any())


@pytest.mark.parametrize('nsample', [4, 16])
def test_candidate_rank_select_is_the_one_hot_selection(nsample):
    """The port's rank-th-hit lanes, one-hot, are the JAX package's
    selection tensor wherever the group is not empty."""
    rng = np.random.RandomState(8)
    b, r, g, k = 2, 6, 27, 32
    cand = _cloud(rng, b, r * k, lo=(0, 0, 0), hi=(2, 2, 2)).reshape(b, r, k, 3)
    live = rng.rand(b, r, k) > 0.25
    live[0, 0] = False  # a RoI without candidates
    grid = _cloud(rng, b, r * g, lo=(0, 0, 0), hi=(2, 2, 2)).reshape(b, r, g, 3)
    sel, empty = jp2.candidate_rank_select(jnp.asarray(cand), jnp.asarray(live),
                                           jnp.asarray(grid), 0.6, nsample)
    idx, got_empty = tp2.candidate_rank_select(*_t(cand, live, grid), 0.6,
                                               nsample)
    _equal(got_empty, empty)
    one_hot = torch.nn.functional.one_hot(idx, k).bool().numpy()
    keep = ~np.asarray(empty)
    _equal(one_hot[keep], np.asarray(sel)[keep])
    assert keep.any() and (~keep).any()


def test_group_points_matches_jax():
    rng = np.random.RandomState(9)
    feats = rng.randn(2, 50, 7).astype(np.float32)
    idx = rng.randint(0, 50, (2, 11, 5)).astype(np.int32)
    _equal(tp2.group_points(*_t(feats, idx)),
           jp2.group_points(jnp.asarray(feats), jnp.asarray(idx)))
