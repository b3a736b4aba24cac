"""Port voxelizer against the JAX package's ``voxelize_np``: identical
tables (first-come slots and points, key-sorted rows, -1 padded coords),
including a saturated ``max_voxels`` cap and a saturated point cap."""

import numpy as np
import pytest

from lidardetection_tpu.core.np_geometry import mask_points_by_range as jax_mask
from lidardetection_tpu.ops.voxelize import voxelize_np as jax_voxelize_np
from lidardetection_tpu_torch.config import dataset_info
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.datasets.synthetic import make_scene
from lidardetection_tpu_torch.ops.voxelize import (
    build_batch, mask_points_by_range, voxelize_np,
)

PC_RANGE = np.array([0, -39.68, -3, 69.12, 39.68, 1], np.float32)


def _cloud(seed):
    points, _, _ = make_scene(np.random.RandomState(seed), PC_RANGE,
                              num_ground=6000)
    # some points outside the range and the grid, to be dropped
    extra = np.random.RandomState(seed + 1).uniform(
        -80, 80, (300, 4)).astype(np.float32)
    return np.concatenate([points, extra])


@pytest.mark.parametrize('voxel_size,max_points,max_voxels', [
    ((0.16, 0.16, 4.0), 32, 20000),   # PointPillar, cap not reached
    ((0.16, 0.16, 4.0), 32, 1500),    # max_voxels overflow
    ((0.4, 0.4, 0.5), 5, 6000),       # 3D grid, per-voxel point overflow
])
def test_voxelize_matches_jax(voxel_size, max_points, max_voxels):
    points = _cloud(0)
    got = voxelize_np(points, PC_RANGE, voxel_size, max_points, max_voxels)
    want = jax_voxelize_np(points, PC_RANGE, voxel_size, max_points,
                           max_voxels)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if max_voxels == 1500:
        assert got[3] == max_voxels
    if max_points == 5:
        assert got[2].max() == max_points


def test_empty_cloud():
    voxels, coords, counts, n = voxelize_np(
        np.zeros((0, 4), np.float32), PC_RANGE, (0.16, 0.16, 4.0), 32, 100)
    assert n == 0 and not voxels.any() and (coords == -1).all() \
        and not counts.any()


def test_build_batch_filters_and_stacks():
    clouds = [_cloud(3), _cloud(4)]
    batch = build_batch(clouds, PC_RANGE, (0.16, 0.16, 4.0), 32, 4000)
    assert batch['voxels'].shape == (2, 4000, 32, 4)
    assert batch['voxel_coords'].shape == (2, 4000, 3)
    for i, points in enumerate(clouds):
        np.testing.assert_array_equal(mask_points_by_range(points, PC_RANGE),
                                      jax_mask(points, PC_RANGE))
        kept = points[jax_mask(points, PC_RANGE)]
        want = jax_voxelize_np(kept, PC_RANGE, (0.16, 0.16, 4.0), 32, 4000)
        np.testing.assert_array_equal(batch['voxels'][i], want[0])
        np.testing.assert_array_equal(batch['voxel_num_points'][i], want[2])
        assert batch['num_voxels'][i] == want[3]


def test_dataset_info_matches_jax_dataset():
    from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg
    from lidardetection_tpu.datasets import build_dataloader

    path = 'tools/cfgs/kitti_models/pointpillar.yaml'
    cfg = jax_cfg(path)
    cfg.DATA_CONFIG.DATASET = 'SyntheticDataset'
    dataset, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                  batch_size=1, training=False, num_scenes=1)
    assert dataset_info(cfg_from_yaml_file(path).DATA_CONFIG) \
        == dataset.dataset_info


@pytest.mark.parametrize('max_points', [20000, 3000], ids=['padded', 'cut'])
def test_build_batch_pads_raw_points_as_the_data_processor(max_points):
    """With max_points (detectors that read raw points) the batch carries
    the in-range cloud in its order, zero-padded or cut, as the JAX
    package's eval DataProcessor leaves it."""
    from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg
    from lidardetection_tpu.datasets.processor.data_processor import DataProcessor

    data_cfg = jax_cfg('tools/cfgs/kitti_models/pv_rcnn.yaml').DATA_CONFIG
    vox = data_cfg.DATA_PROCESSOR[-1]
    processor = DataProcessor(data_cfg.DATA_PROCESSOR, PC_RANGE, training=False,
                              max_points=max_points)
    clouds = [_cloud(5), _cloud(6)]
    batch = build_batch(clouds, PC_RANGE, vox.VOXEL_SIZE,
                        vox.MAX_POINTS_PER_VOXEL, 4000, max_points=max_points)
    assert batch['points'].shape == (2, max_points, 4)
    for i, points in enumerate(clouds):
        want = processor.forward({'points': points.copy()})
        np.testing.assert_array_equal(batch['points'][i], want['points'])
        assert batch['num_points'][i] == want['num_points']
    assert 'points' not in build_batch(clouds, PC_RANGE, vox.VOXEL_SIZE,
                                       vox.MAX_POINTS_PER_VOXEL, 4000)


@pytest.mark.parametrize('case', ['voxel overflow', 'point overflow',
                                  'out of range', 'empty cloud'])
def test_native_voxelizer_equals_plain_and_jax(case):
    """The host library's voxelizer (the default), the numpy plain version
    and the JAX package's voxelize_np: equal tables, coords, counts and
    voxel counts."""
    from lidardetection_tpu_torch import native
    from lidardetection_tpu_torch.ops.voxelize import voxelize_plain

    points = _cloud(7)
    voxel_size, max_points, max_voxels = (0.2, 0.2, 0.25), 5, 8000
    if case == 'voxel overflow':
        max_voxels = 700
    elif case == 'point overflow':
        voxel_size, max_points = (0.8, 0.8, 1.0), 3
    elif case == 'out of range':  # every point beyond the grid, one inside
        points = points[~mask_points_by_range(points, PC_RANGE)]
        points = np.concatenate([points, [[1.0, 0.5, -2.0, 0.3]]]).astype(
            np.float32)
    else:
        points = np.zeros((0, 4), np.float32)
    got = voxelize_np(points, PC_RANGE, voxel_size, max_points, max_voxels)
    with native.plain_host():
        plain = voxelize_np(points, PC_RANGE, voxel_size, max_points,
                            max_voxels)
    want = jax_voxelize_np(points, PC_RANGE, voxel_size, max_points,
                           max_voxels)
    for other in (plain, want, voxelize_plain(points, PC_RANGE, voxel_size,
                                              max_points, max_voxels)):
        assert got[3] == other[3]
        for g, w in zip(got[:3], other[:3]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    n = got[3]
    assert {'voxel overflow': n == max_voxels,
            'point overflow': got[2].max() == max_points and n < max_voxels,
            'out of range': n == 1,
            'empty cloud': n == 0 and (got[1] == -1).all()}[case]
