"""The NuScenes data layer, port against the JAX package, on a tree the
test writes (``datasets/synthetic_trees.py::write_nuscenes_tree``: 3 train
and 2 val key frames, each with 9 sweeps of a 32-beam scan of ~6k returns,
5 columns; infos with 9-column gt (one NaN velocity) and
``num_lidar_pts``), in two copies, one for each package's writes. The
DATA_CONFIG is cbgs_second_multihead.yaml's (10 sweeps, CBGS, the full
augmentor, FILTER_MIN_POINTS_IN_GT, SET_NAN_VELOCITY_TO_ZEROS,
PRED_VELOCITY, the VoxelResBackBone8x host plan at the 60000 cap). The
port gets ``RandomState(s)`` (CBGS: the dataset's seed s) where the JAX
package runs after ``np.random.seed(s)``; everything is compared bit for
bit but the raw points' MAX_POINTS padding (``points`` against the JAX
package's first ``num_points`` rows).

* ``get_lidar_with_sweeps`` and the CBGS-resampled infos;
* the gt database (``create_groundtruth_database``): the dbinfos pickle and
  every ``.bin`` file;
* ``__getitem__`` in train mode (three items in a row) and in test mode;
* ``generate_prediction_dicts`` on a multi-class output with gaps, and
  ``_kitti_style_eval``: the same result dict as the JAX package's given
  the KITTI protocol's names of the classes (it raises on NuScenes'
  lower-case names, which the port maps to the protocol's class ids).
"""

import pickle

import numpy as np
import pytest

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets.nuscenes import nuscenes_dataset as jax_nusc
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.datasets import synthetic_trees
from lidardetection_tpu_torch.datasets.nuscenes import nuscenes_dataset
from test_torch_kitti_dataset import assert_sample_equal, assert_tree_equal

CFG = 'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml'
SENSOR = {'elevation_deg': (-30.67, 10.67), 'beams': 32, 'azimuth_steps': 200}
NUM_TRAIN, NUM_VAL = 3, 2


def _cfgs():
    jcfg, pcfg = jax_cfg_from_yaml(CFG), cfg_from_yaml_file(CFG)
    return jcfg, pcfg


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """{package: root}, each with that package's gt database."""
    roots = {}
    jcfg, pcfg = _cfgs()
    for name in ('jax', 'port'):
        root = tmp_path_factory.mktemp(f'nuscenes_{name}')
        synthetic_trees.write_nuscenes_tree(root, NUM_TRAIN, NUM_VAL, seed=4,
                                            sensor=SENSOR)
        if name == 'jax':
            ds = jax_nusc.NuScenesDataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                                          training=False, root_path=root)
            np.random.seed(21)
            ds.include_nuscenes_data('train')  # the db from the train infos
            ds.infos = ds.infos[NUM_VAL:]
            ds.create_groundtruth_database(max_sweeps=10)
        else:
            ds = nuscenes_dataset.NuScenesDataset(
                pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, training=False,
                root_path=root)
            ds.include_nuscenes_data('train')
            ds.infos = ds.infos[NUM_VAL:]
            ds.create_groundtruth_database(np.random.RandomState(21),
                                           max_sweeps=10)
        roots[name] = root
    return roots


def test_gt_database_equals_jax(trees):
    version = 'v1.0-trainval'
    name = 'nuscenes_dbinfos_10sweeps_withvelo.pkl'
    with open(trees['jax'] / version / name, 'rb') as f:
        want = pickle.load(f)
    with open(trees['port'] / version / name, 'rb') as f:
        got = pickle.load(f)
    assert_tree_equal(got, want, name)
    assert sum(len(v) for v in got.values()) == NUM_TRAIN * 9
    jax_db = sorted((trees['jax'] / version / 'gt_database_10sweeps_withvelo').iterdir())
    port_db = sorted((trees['port'] / version / 'gt_database_10sweeps_withvelo').iterdir())
    assert [p.name for p in port_db] == [p.name for p in jax_db]
    assert len(port_db) == NUM_TRAIN * 9
    for g, w in zip(port_db, jax_db):
        assert g.read_bytes() == w.read_bytes(), g.name


def _datasets(trees, training, seed):
    jcfg, pcfg = _cfgs()
    np.random.seed(seed)
    want = jax_nusc.NuScenesDataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                                    training=training, root_path=trees['jax'])
    got = nuscenes_dataset.NuScenesDataset(
        pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, training=training,
        root_path=trees['port'], seed=seed)
    want.set_sparse_plan(jcfg.MODEL)
    got.set_model(pcfg.MODEL)
    return got, want


def test_sweeps_and_cbgs_equal_jax(trees):
    got_ds, want_ds = _datasets(trees, True, seed=5)
    # CBGS: every class's frames, resampled toward equal class shares
    assert len(got_ds.infos) == len(want_ds.infos) > NUM_TRAIN
    assert [i['token'] for i in got_ds.infos] == \
        [i['token'] for i in want_ds.infos]
    rng = np.random.RandomState(8)
    np.random.seed(8)
    for index in range(3):
        want = want_ds.get_lidar_with_sweeps(index, max_sweeps=10)
        got = got_ds.get_lidar_with_sweeps(index, rng, max_sweeps=10)
        assert got.dtype == want.dtype and got.shape[1] == 5
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got[:, 4])) == 10  # the key frame and 9 sweeps


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_getitem_equals_jax(trees, training):
    got_ds, want_ds = _datasets(trees, training, seed=6)
    rng = np.random.RandomState(12)
    np.random.seed(12)
    for index in range(3 if training else NUM_VAL):
        want = want_ds[index]
        got = got_ds.get_item(index, rng)
        assert_sample_equal(got, want)
        gt = got['gt_boxes']
        assert gt.shape == (256, 10) and np.isfinite(gt).all()
        assert (gt[:, -1] > 0).sum() >= (9 if training else 1)
        assert got['points'].shape[1] == 5
    assert rng.randint(1 << 30) == np.random.randint(1 << 30)


def _predictions(dataset, rng):
    """Each val frame's gt, jittered, as a multi-class output: the kept rows
    3 slots apart, the rest masked out."""
    out = {k: [] for k in ('pred_boxes', 'pred_scores', 'pred_labels',
                           'pred_mask', 'num_preds')}
    for info in dataset.infos:
        boxes = info['gt_boxes'].astype(np.float32).copy()
        boxes[:, 0:2] += rng.randn(len(boxes), 2).astype(np.float32) * 0.2
        labels = np.array([dataset.class_names.index(n) + 1
                           for n in info['gt_names']])
        rows = np.arange(len(boxes)) * 3
        slots = 40
        padded = np.zeros((slots, 9), np.float32)
        padded[rows] = boxes
        scores = np.zeros(slots, np.float32)
        scores[rows] = rng.uniform(0.2, 1.0, len(boxes))
        lab = np.zeros(slots, np.int64)
        lab[rows] = labels
        mask = np.zeros(slots, bool)
        mask[rows] = True
        for key, value in zip(out, (padded, scores, lab, mask, len(boxes))):
            out[key].append(value)
    return {k: np.stack(v) for k, v in out.items()}


def test_prediction_dicts_and_kitti_style_eval_equal_jax(trees):
    got_ds, want_ds = _datasets(trees, False, seed=0)
    preds = _predictions(want_ds, np.random.RandomState(3))
    batch = {'batch_size': NUM_VAL, 'frame_id': np.array(['a', 'b']),
             'metadata': np.array([{'token': 'a'}, {'token': 'b'}])}
    classes = list(got_ds.class_names)
    want = want_ds.generate_prediction_dicts(batch, preds, classes)
    got = got_ds.generate_prediction_dicts(batch, preds, classes)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert len(got[0]['name']) == 9
    with pytest.raises(KeyError):  # the JAX package's lower-case names
        want_ds.evaluation(want, classes, eval_metric='kitti')
    known = ['Car', 'Truck', 'Pedestrian']  # the protocol's names of them
    want_str, want_dict = want_ds._kitti_style_eval(want, known)
    got_str, got_dict = got_ds.evaluation(got, classes, eval_metric='kitti')
    assert got_str == want_str and list(got_dict) == list(want_dict)
    for key, value in want_dict.items():
        assert float(got_dict[key]) == float(value), key
    assert got_dict['Car_bev/moderate_R40'] > 0
    # a padded last batch: the annos past the infos' count are left out
    again = got_ds.evaluation(got + got[:1], classes, eval_metric='kitti')[1]
    assert again == got_dict
    message, empty = got_ds.evaluation(got, classes)
    assert 'nuscenes-devkit not installed' in message and empty == {}
