"""The augmentor, port against the JAX package, bit for bit: the port's
functions given ``RandomState(s)``, the JAX package's run after
``np.random.seed(s)``.

* The world flips along x and y, the rotation and the scaling, on boxes of
  7 columns, of 9 (NuScenes' velocities) and with the multiframe side
  arrays (``locations`` (G, T, 3), ``rotations_y`` (G, T)).
* ``DataAugmentor.forward`` with the world ops on a multiframe sample with
  a gt validity mask.
* ``DataBaseSampler`` on a database the test writes (the PREPARE filters,
  LIMIT_WHOLE_SCENE, SAMPLE_ROT_ANGLE, the sample-box extra width, the
  road-plane lift, the multiframe side arrays, and
  DATABASE_WITH_FAKELIDAR), four scenes in a row so that the pointers run
  out and the permutations are drawn again.
"""

import copy
import pickle

import numpy as np
import pytest

from lidardetection_tpu.datasets.augmentor import augmentor_utils as jax_utils
from lidardetection_tpu.datasets.augmentor import data_augmentor as jax_aug
from lidardetection_tpu.datasets.augmentor import database_sampler as jax_db
from lidardetection_tpu.utils.calibration_kitti import Calibration as JaxCalib
from lidardetection_tpu_torch.datasets.augmentor import (
    augmentor_utils, data_augmentor, database_sampler,
)
from lidardetection_tpu_torch.utils.calibration_kitti import Calibration

T = 3  # multiframe poses a box


def _sample(rng, columns, frames):
    n = 6
    boxes = np.concatenate([rng.uniform(-30, 30, (n, 3)),
                            rng.uniform(0.5, 4, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1)),
                            rng.randn(n, columns - 7)], 1).astype(np.float32)
    out = {'gt_boxes': boxes,
           'points': rng.uniform(-40, 40, (500, 5)).astype(np.float32)}
    if frames:
        out['locations'] = (boxes[:, None, :3]
                            + rng.randn(n, T, 3)).astype(np.float32)
        out['rotations_y'] = (boxes[:, None, 6]
                              + rng.randn(n, T) * 0.1).astype(np.float32)
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('layout', ['7', '9', 'multiframe'])
@pytest.mark.parametrize('op', ['flip_x', 'flip_y', 'rotation', 'scaling'])
def test_world_op_equals_jax(op, layout):
    columns = 9 if layout == '9' else 7
    args = {'flip_x': (), 'flip_y': (), 'rotation': ([-0.78, 0.78],),
            'scaling': ([0.95, 1.05],)}[op]
    name = {'flip_x': 'random_flip_along_x', 'flip_y': 'random_flip_along_y',
            'rotation': 'global_rotation', 'scaling': 'global_scaling'}[op]
    for seed in range(6):  # both sides of each coin
        sample = _sample(np.random.RandomState(100 + seed), columns,
                         layout == 'multiframe')
        mine, theirs = copy.deepcopy(sample), copy.deepcopy(sample)
        side = ({'locations': mine.pop('locations'),
                 'rotations_y': mine.pop('rotations_y')}
                if layout == 'multiframe' else {})
        jside = ({'locations': theirs.pop('locations'),
                  'rotations_y': theirs.pop('rotations_y')}
                 if layout == 'multiframe' else {})
        rng = np.random.RandomState(seed)
        np.random.seed(seed)
        want = getattr(jax_utils, name)(theirs['gt_boxes'], theirs['points'],
                                        *args, **jside)
        got = getattr(augmentor_utils, name)(mine['gt_boxes'], mine['points'],
                                             *args, rng, **side)
        _equal(got, want)
        assert rng.randint(1 << 30) == np.random.randint(1 << 30)


def test_augmentor_forward_equals_jax():
    cfg = {'DISABLE_AUG_LIST': ['random_world_scaling'], 'AUG_CONFIG_LIST': [
        {'NAME': 'random_world_flip', 'ALONG_AXIS_LIST': ['x', 'y']},
        {'NAME': 'random_world_rotation', 'WORLD_ROT_ANGLE': 0.3925},
        {'NAME': 'random_world_scaling', 'WORLD_SCALE_RANGE': [0.9, 1.1]}]}
    want_aug = jax_aug.DataAugmentor('.', cfg, ['Car', 'Pedestrian'])
    got_aug = data_augmentor.DataAugmentor('.', cfg, ['Car', 'Pedestrian'])
    assert len(got_aug.data_augmentor_queue) == 2
    for seed in range(4):
        sample = _sample(np.random.RandomState(seed), 9, True)
        sample['gt_names'] = np.array(['Car', 'Pedestrian', 'Tram'] * 2)
        sample['gt_boxes_mask'] = sample['gt_names'] != 'Tram'
        sample['road_plane'] = np.array([0, -1.0, 0, 1.7])
        rng = np.random.RandomState(seed)
        np.random.seed(seed)
        want = want_aug.forward(copy.deepcopy(sample))
        got = got_aug.forward(copy.deepcopy(sample), rng)
        assert sorted(got) == sorted(want) and 'road_plane' not in got
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert len(got['gt_boxes']) == 4
        assert np.all(np.abs(got['gt_boxes'][:, 6]) <= np.pi)


CALIB = {'P2': np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                         [0, 0, 1, 0.003]], np.float32),
         'P3': np.eye(3, 4, dtype=np.float32),
         'R0': np.eye(3, dtype=np.float32),
         'Tr_velo2cam': np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]],
                                 np.float32)}


def _write_database(root, rng):
    """gt_database/ and dbinfos.pkl: per class 5 objects of points in box
    coordinates, with difficulty, point counts and multiframe poses."""
    (root / 'gt_database').mkdir()
    infos = {}
    for name, size in (('Car', (3.9, 1.6, 1.56)), ('Pedestrian', (0.8, 0.6, 1.73))):
        infos[name] = []
        for i in range(5):
            pts = (rng.rand(40 + 10 * i, 4) - 0.5).astype(np.float32)
            pts[:, :3] *= size
            path = f'gt_database/{name}_{i}.bin'
            pts.tofile(root / path)
            box = np.array([*rng.uniform(5, 60, 1), *rng.uniform(-30, 30, 1),
                            -0.9, *size, rng.uniform(-3, 3)], np.float32)
            infos[name].append({
                'name': name, 'path': path, 'box3d_lidar': box,
                'num_points_in_gt': len(pts), 'difficulty': -1 if i == 4 else i % 3,
                'locations': (box[None, :3] + rng.randn(T, 3)).astype(np.float32),
                'rotations_y': (box[6] + rng.randn(T) * 0.1).astype(np.float32)})
    with open(root / 'dbinfos.pkl', 'wb') as f:
        pickle.dump(infos, f)


@pytest.mark.parametrize('fakelidar', [False, True], ids=['lidar', 'fakelidar'])
def test_database_sampler_equals_jax(tmp_path, fakelidar):
    _write_database(tmp_path, np.random.RandomState(0))
    cfg = {'DB_INFO_PATH': ['dbinfos.pkl'], 'USE_ROAD_PLANE': True,
           'PREPARE': {'filter_by_min_points': ['Car:45', 'Pedestrian:5'],
                       'filter_by_difficulty': [-1]},
           'SAMPLE_GROUPS': ['Car:4', 'Pedestrian:3', 'Cyclist:2'],
           'NUM_POINT_FEATURES': 4, 'DATABASE_WITH_FAKELIDAR': fakelidar,
           'REMOVE_EXTRA_WIDTH': [0.1, 0.1, 0.0], 'LIMIT_WHOLE_SCENE': True,
           'SAMPLE_ROT_ANGLE': [-0.3, 0.3],
           'REMOVE_SAMPLE_BOXES_EXTRA_WIDTH': [0.2, 0.2, 0.0]}
    classes = ['Car', 'Pedestrian']
    want_db = jax_db.DataBaseSampler(tmp_path, cfg, classes)
    got_db = database_sampler.DataBaseSampler(tmp_path, cfg, classes)
    assert [len(got_db.db_infos[c]) for c in classes] == \
        [len(want_db.db_infos[c]) for c in classes] == [3, 4]
    rng = np.random.RandomState(7)
    np.random.seed(7)
    pasted = 0
    for scene in range(4):
        sample = _sample(np.random.RandomState(50 + scene), 7, True)
        sample['points'] = sample['points'][:, :4]
        sample['gt_names'] = np.array(['Car', 'Pedestrian', 'Cyclist'] * 2)
        sample['gt_boxes_mask'] = sample['gt_names'] != 'Cyclist'
        sample['road_plane'] = np.array([0, -1.0, 0, 1.7])
        want = want_db(dict(sample, calib=JaxCalib(CALIB)))
        got = got_db(dict(sample, calib=Calibration(CALIB)), rng)
        assert sorted(got) == sorted(want)
        for key in want:
            if key == 'calib':
                continue
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        pasted += len(got['gt_boxes']) - 4
        # the side arrays keep the masked-out boxes' rows, as in JAX
        assert len(got['locations']) == 6 + len(got['gt_boxes']) - 4
    assert pasted > 0
    assert rng.randint(1 << 30) == np.random.randint(1 << 30)
