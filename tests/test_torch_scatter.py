"""K2 scatter_rows (port) against the JAX package's scatter, on the CPU.

``scatter_rows_plain`` must equal, bit for bit, the Pallas kernel run in
interpret mode (as tests/test_scatter_bucketing.py runs it) and the
``scatter_rows_sorted`` path, with padding rows and an empty sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.models.backbones_2d.map_to_bev import (
    PointPillarScatter as JaxPointPillarScatter,
)
from lidardetection_tpu.ops.scatter_tpu import (
    _scatter_pallas, host_tile_starts, scatter_rows_sorted,
)
from lidardetection_tpu_torch.models.backbones_2d.map_to_bev import PointPillarScatter
from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows, scatter_rows_plain


def _tables(seed, capacity, n_valid, n_slots, c=8):
    """Key-sorted tables, one per entry of n_valid (0 = empty sample);
    padding rows carry the n_slots key and junk features."""
    rng = np.random.RandomState(seed)
    keys, feats = [], []
    for n in n_valid:
        k = np.sort(rng.choice(n_slots, size=n, replace=False))
        keys.append(np.concatenate([k, np.full(capacity - n, n_slots)]))
        feats.append(rng.randn(capacity, c))
    return (np.stack(keys).astype(np.int32),
            np.stack(feats).astype(np.float32))


@pytest.mark.parametrize('n_slots', [4500, 2048])
def test_plain_matches_pallas_interpret(n_slots):
    keys, feats = _tables(0, 1024, (700, 0), n_slots)
    starts = np.stack([host_tile_starts(k, n_slots) for k in keys])
    want = _scatter_pallas(jnp.asarray(feats), jnp.asarray(keys), n_slots,
                           jnp.asarray(starts), interpret=True)
    got = scatter_rows_plain(torch.from_numpy(feats), torch.from_numpy(keys),
                             n_slots)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1].any()  # the empty sample


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_wrapper_matches_scatter_rows_sorted(dtype):
    n_slots = 3000
    keys, feats = _tables(1, 900, (650, 0, 899), n_slots, c=16)
    want = scatter_rows_sorted(jnp.asarray(feats, jnp.dtype(str(dtype)[6:])),
                               jnp.asarray(keys), n_slots)
    before = scatter_rows.launches
    got = scatter_rows(torch.from_numpy(feats).to(dtype),
                       torch.from_numpy(keys), n_slots)
    assert scatter_rows.launches == before  # no kernel launch for CPU tensors
    assert got.dtype == dtype and got.shape == (3, n_slots, 16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_point_pillar_scatter_module_matches_jax():
    rng = np.random.RandomState(2)
    nx, ny, c, cap = 40, 30, 8, 500
    coords = np.full((2, cap, 3), -1, np.int32)
    for b, n in enumerate((420, 37)):
        cells = np.sort(rng.choice(nx * ny, size=n, replace=False))
        coords[b, :n] = np.stack([np.zeros(n), cells // nx, cells % nx], -1)
    feats = rng.randn(2, cap, c).astype(np.float32)
    batch = {'pillar_features': feats, 'voxel_coords': coords}

    want = JaxPointPillarScatter(grid_size=(nx, ny, 1), num_bev_features=c) \
        .apply({}, {k: jnp.asarray(v) for k, v in batch.items()})
    got = PointPillarScatter((nx, ny, 1), c)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got['spatial_features'].shape == (2, ny, nx, c)
    np.testing.assert_array_equal(got['spatial_features'].numpy(),
                                  np.asarray(want['spatial_features']))
