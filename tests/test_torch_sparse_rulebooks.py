"""The port's rulebook construction against lidardetection_tpu.ops.sparse on the
CPU: the same voxel tables, made from a numpy seed, go through both, and
every integer result (sorted coords, rulebooks, output coords and counts)
must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.ops import sparse as jsparse
from lidardetection_tpu_torch.ops import sparse as tsparse

GRIDS = [(6, 14, 12), (9, 20, 16), (41, 24, 20)]
# kernel, stride, padding of the backbone's four strided convolutions
STRIDED = {
    'pad111': ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    'pad011': ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    'zcompress': ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
}


def make_table(seed, shape, b=2, v=96, fill=(70, 41), sort=True):
    """Unique random voxels per sample: coords (B, V, 3) -1 padded,
    features (B, V, 4), counts (B,)."""
    rng = np.random.RandomState(seed)
    d, h, w = shape
    coords = np.full((b, v, 3), -1, np.int32)
    feats = np.zeros((b, v, 4), np.float32)
    for i in range(b):
        n = fill[i % len(fill)]
        keys = rng.choice(d * h * w, n, replace=False)
        if sort:
            keys = np.sort(keys)
        coords[i, :n] = np.stack([keys // (h * w), (keys // w) % h, keys % w], -1)
        feats[i, :n] = rng.randn(n, 4)
    num = np.asarray([fill[i % len(fill)] for i in range(b)], np.int32)
    return feats, coords, num


def both(feats, coords, num, shape):
    jst = jsparse.SparseTensor(jnp.asarray(feats), jnp.asarray(coords),
                               jnp.asarray(num), shape)
    tst = tsparse.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                               torch.from_numpy(num), shape)
    return jst, tst


def equal(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape', GRIDS)
def test_from_unsorted_matches_jax(shape):
    feats, coords, num = make_table(1, shape, sort=False)
    want = jsparse.from_unsorted(jnp.asarray(feats), jnp.asarray(coords),
                                 jnp.asarray(num), shape)
    got = tsparse.from_unsorted(torch.from_numpy(feats), torch.from_numpy(coords),
                                torch.from_numpy(num), shape)
    equal(got.coords, want.coords)
    equal(got.features, want.features)
    equal(got.valid_mask, want.valid_mask)
    keys = tsparse.linear_key(got.coords, shape)
    assert (keys[:, 1:] >= keys[:, :-1]).all()
    np.testing.assert_array_equal(
        keys.numpy(), np.asarray(jsparse.linear_key(want.coords, shape)))


@pytest.mark.parametrize('shape', GRIDS)
@pytest.mark.parametrize('kernel', [(3, 3, 3), (3, 1, 1)])
def test_subm_rulebook_matches_jax(shape, kernel):
    jst, tst = both(*make_table(2, shape), shape)
    got = tsparse.build_subm_rulebook(tst, kernel)
    equal(got, jsparse.build_subm_rulebook(jst, kernel))
    v = tst.coords.shape[1]
    center = got.shape[-1] // 2
    rows = torch.arange(v).expand(2, v)
    # a live row finds itself at the centre offset, a padding row nothing
    assert torch.equal(got[..., center][tst.valid_mask], rows[tst.valid_mask].int())
    assert (got[~tst.valid_mask] == v).all()


@pytest.mark.parametrize('shape', GRIDS)
@pytest.mark.parametrize('conv', sorted(STRIDED))
def test_strided_tables_match_jax(shape, conv):
    kernel, stride, padding = STRIDED[conv]
    jst, tst = both(*make_table(3, shape), shape)
    want = jsparse.build_strided_out_coords(jst, kernel, stride, padding, 400)
    got = tsparse.build_strided_out_coords(tst, kernel, stride, padding, 400)
    equal(got[0], want[0])
    equal(got[1], want[1])
    assert got[2] == tuple(int(x) for x in want[2])
    assert 0 < int(got[1].min()) and int(got[1].max()) < 400  # no overflow
    equal(tsparse.build_strided_rulebook(tst, got[0], got[2], kernel, stride,
                                         padding),
          jsparse.build_strided_rulebook(jst, want[0], want[2], kernel, stride,
                                         padding))


@pytest.mark.parametrize('shape', GRIDS)
def test_strided_table_overflow_keeps_lowest_keys(shape):
    kernel, stride, padding = STRIDED['pad111']
    jst, tst = both(*make_table(4, shape), shape)
    full = tsparse.build_strided_out_coords(tst, kernel, stride, padding, 400)
    cap = int(full[1].min()) // 2
    want = jsparse.build_strided_out_coords(jst, kernel, stride, padding, cap)
    got = tsparse.build_strided_out_coords(tst, kernel, stride, padding, cap)
    equal(got[0], want[0])
    equal(got[1], want[1])
    assert (got[1] == cap).all()
    assert torch.equal(got[0], full[0][:, :cap])
    equal(tsparse.build_strided_rulebook(tst, got[0], got[2], kernel, stride,
                                         padding),
          jsparse.build_strided_rulebook(jst, want[0], want[2], kernel, stride,
                                         padding))


@pytest.mark.parametrize('shape', GRIDS[:2])
def test_empty_table_matches_jax(shape):
    jst, tst = both(*make_table(5, shape, fill=(0, 9)), shape)
    got = tsparse.build_subm_rulebook(tst)
    equal(got, jsparse.build_subm_rulebook(jst))
    assert (got[0] == tst.coords.shape[1]).all()
    for kernel, stride, padding in STRIDED.values():
        want = jsparse.build_strided_out_coords(jst, kernel, stride, padding, 64)
        out = tsparse.build_strided_out_coords(tst, kernel, stride, padding, 64)
        equal(out[0], want[0])
        equal(out[1], want[1])
        assert int(out[1][0]) == 0 and (out[0][0] == -1).all()
        equal(tsparse.build_strided_rulebook(tst, out[0], out[2], kernel,
                                             stride, padding),
              jsparse.build_strided_rulebook(jst, want[0], want[2], kernel,
                                             stride, padding))


def test_sparse_to_dense_matches_jax():
    shape = GRIDS[0]
    feats, coords, num = make_table(6, shape)
    jst, tst = both(feats, coords, num, shape)
    got = tsparse.sparse_to_dense(tst)
    assert tuple(got.shape) == (2, *shape, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsparse.sparse_to_dense(jst)))
