"""``ops/voxelize.py::voxelize_device``, the port's counterpart of the JAX
package's on-device voxelizer ``voxelize_jax``, on the CPU.

At tests/test_voxelize.py's cases (its range and voxel of 0.5 x 0.5 x 4
m, ``num_valid`` cut included) every output equals ``voxelize_jax``'s bit
for bit. Wherever the occupancy is below ``max_voxels`` it equals the
port's host voxelizer ``voxelize_np`` (its rows sorted by key), at a
KITTI-sized scan with second.yaml's voxel too; above the cap it keeps the
lowest keys, the host table's first ``max_voxels`` rows. At a voxel that
is not a power of two XLA:CPU rounds ``voxelize_jax``'s cell as a product
with the reciprocal, so a point on a cell border can land one cell over
from the division that ``voxelize_np`` and the port compute; those
voxels are held against ``voxelize_np`` only. The card's run is in
chip_smoke.py (``voxelize_device_phase``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.ops import voxelize as jax_voxelize
from lidardetection_tpu_torch.datasets.synthetic import make_scene
from lidardetection_tpu_torch.ops.voxelize import voxelize_device, voxelize_np

PC_RANGE = (0.0, -4.0, -3.0, 8.0, 4.0, 1.0)  # tests/test_voxelize.py's
VSZ = (0.5, 0.5, 4.0)
KITTI_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)  # second.yaml's
KITTI_VOXEL = (0.05, 0.05, 0.1)


def _rand_points(n=500, seed=0):
    """tests/test_voxelize.py's points: some out of range."""
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.rand(n, 1) * 10 - 1, rng.rand(n, 1) * 10 - 5,
         rng.rand(n, 1) * 5 - 3.5, rng.rand(n, 1)], axis=1).astype(np.float32)


def _tail_far_out(points, n_valid):
    out = points.copy()
    out[n_valid:] = 99999.0
    return out


# (points, num_valid, max_points_per_voxel, max_voxels): the cases of
# tests/test_voxelize.py:43-80
CASES = {
    'matches np': (_rand_points(400), 400, 8, 256),
    'all valid': (_rand_points(100), 100, 4, 64),
    'num_valid cut': (_rand_points(100), 50, 4, 64),
    'num_valid cut, tail far out': (_tail_far_out(_rand_points(100), 50), 50,
                                    4, 64),
    'max_voxels cap': (_rand_points(500, seed=1), 500, 4, 8),
}


def _port(points, n_valid, per, cap, pcr=PC_RANGE, vsz=VSZ):
    return [t.numpy() for t in voxelize_device(
        torch.from_numpy(points), n_valid, pcr, vsz, per, cap)]


@pytest.mark.parametrize('name', sorted(CASES))
def test_equals_voxelize_jax_bit_for_bit(name):
    points, n_valid, per, cap = CASES[name]
    got = _port(points, n_valid, per, cap)
    want = [np.asarray(a) for a in jax_voxelize.voxelize_jax(
        jnp.asarray(points), jnp.int32(n_valid), PC_RANGE, VSZ, per, cap)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert int(got[3]) > 0


@pytest.mark.parametrize('name', sorted(CASES))
def test_equals_the_host_voxelizers_sorted_table(name):
    """Below the cap the host table (sorted rows) itself; at it, the host
    table's first `max_voxels` rows (the lowest keys)."""
    points, n_valid, per, cap = CASES[name]
    got = _port(points, n_valid, per, cap)
    room = max(len(points), cap)
    host = voxelize_np(points[:n_valid], PC_RANGE, VSZ, per, room)
    assert int(got[3]) == min(host[3], cap)
    assert (host[3] > cap) == (name == 'max_voxels cap')
    for g, h in zip(got[:3], host[:3]):
        assert np.array_equal(g, h[:cap])


def test_equals_the_host_voxelizer_at_a_kitti_scan():
    """A synthetic KITTI scan (18960 points in range) at second.yaml's
    voxel, 5 points a voxel, the test cap of 40000 and a cap of 1000 (the
    lowest keys), the cloud padded past its valid count."""
    points = make_scene(np.random.RandomState(0),
                        np.float32(KITTI_RANGE))[0]
    padded = np.concatenate([points, np.full((100, 4), 1e4, np.float32)])
    for cap in (40000, 1000):
        got = _port(padded, len(points), 5, cap, KITTI_RANGE, KITTI_VOXEL)
        host = voxelize_np(points, KITTI_RANGE, KITTI_VOXEL, 5,
                           max(len(points), cap))
        assert host[3] > 1000
        assert int(got[3]) == min(host[3], cap)
        for g, h in zip(got[:3], host[:3]):
            assert np.array_equal(g, h[:cap])
