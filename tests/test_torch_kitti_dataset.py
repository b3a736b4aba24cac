"""The KITTI data layer, port against the JAX package, on a tree the test
writes (``datasets/synthetic_trees.py::write_kitti_tree``: 3 train frames
and 1 val frame of a 32-beam scan, ~16k returns each, in two copies, one
for each package's writes).

* ``create_kitti_infos``: the info pickles equal, array for array, and the
  gt-database ``.bin`` files equal byte for byte.
* ``__getitem__`` in train mode with the full augmentor of pointpillar.yaml
  and second.yaml (gt sampling with the road plane, flip, rotation,
  scaling; SECOND's host plan), the port given ``RandomState(s)`` and the
  JAX package run after ``np.random.seed(s)``, each train frame twice in
  a row (the sampler's pointers move): every key equal bit for bit but
  two, each named: ``bev_tile_starts`` (the TPU scatter's histogram, not
  ported) and
  the raw points' MAX_POINTS padding (``points`` is compared with the JAX
  package's first ``num_points`` rows). The same in test mode.
* ``generate_prediction_dicts`` and ``evaluation`` on single-class output:
  equal annos and result dicts; on a multi-class output with gaps the
  port reads the rows ``pred_mask`` marks.
* ``png_size`` against PIL's reading of the tree's PNGs.
"""

import pickle

import numpy as np
import pytest
from PIL import Image

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets.kitti import kitti_dataset as jax_kitti
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.datasets import synthetic_trees
from lidardetection_tpu_torch.datasets.kitti import kitti_dataset

CLASSES = ['Car', 'Pedestrian', 'Cyclist']
SENSOR = {'elevation_deg': (-24.9, 2.0), 'beams': 32, 'azimuth_steps': 500}
NUM_TRAIN, NUM_VAL = 3, 1


def write_tree(root):
    return synthetic_trees.write_kitti_tree(root, NUM_TRAIN, NUM_VAL, seed=3,
                                            sensor=SENSOR)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """{package: root}, each tree with that package's infos and database."""
    roots = {}
    for name, module, load in (('jax', jax_kitti, jax_cfg_from_yaml),
                               ('port', kitti_dataset, cfg_from_yaml_file)):
        root = tmp_path_factory.mktemp(f'kitti_{name}')
        write_tree(root)
        cfg = load('tools/cfgs/dataset_configs/kitti_dataset.yaml')
        module.create_kitti_infos(cfg, CLASSES, root, root, workers=1)
        roots[name] = root
    return roots


def assert_tree_equal(got, want, where=''):
    """Nested dicts, lists and arrays equal, dtypes and shapes included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for key in want:
            assert_tree_equal(got[key], want[key], f'{where}/{key}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype \
            and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def test_png_size_equals_pil(trees):
    pngs = sorted((trees['port'] / 'training' / 'image_2').glob('*.png'))
    assert len(pngs) == NUM_TRAIN + NUM_VAL
    for path in pngs:
        with Image.open(path) as im:
            width, height = im.size
        assert kitti_dataset.png_size(path) == (height, width) == \
            synthetic_trees.KITTI_IMAGE
    other = trees['port'] / 'ImageSets' / 'train.txt'
    with pytest.raises(ValueError, match='not a PNG'):
        kitti_dataset.png_size(other)


def test_infos_and_gt_database_equal_jax(trees):
    names = ('kitti_infos_train.pkl', 'kitti_infos_val.pkl',
             'kitti_infos_trainval.pkl', 'kitti_infos_test.pkl',
             'kitti_dbinfos_train.pkl')
    for name in names:
        with open(trees['jax'] / name, 'rb') as f:
            want = pickle.load(f)
        with open(trees['port'] / name, 'rb') as f:
            got = pickle.load(f)
        assert_tree_equal(got, want, name)
    with open(trees['port'] / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    assert len(infos) == NUM_TRAIN
    annos = infos[0]['annos']
    assert list(annos['name'][-1:]) == ['DontCare'] and annos['index'][-1] == -1
    assert (annos['num_points_in_gt'][:-1] > 5).all()
    jax_db = sorted((trees['jax'] / 'gt_database').iterdir())
    port_db = sorted((trees['port'] / 'gt_database').iterdir())
    assert [p.name for p in port_db] == [p.name for p in jax_db]
    assert len(port_db) == NUM_TRAIN * 7  # a file an object, no DontCare
    for got, want in zip(port_db, jax_db):
        assert got.read_bytes() == want.read_bytes(), got.name


def _cfgs(name, root):
    jcfg = jax_cfg_from_yaml(f'tools/cfgs/kitti_models/{name}.yaml')
    pcfg = cfg_from_yaml_file(f'tools/cfgs/kitti_models/{name}.yaml')
    for cfg in (jcfg, pcfg):
        cfg.DATA_CONFIG.DATA_PATH = str(root)
    return jcfg, pcfg


def _datasets(name, trees, training):
    jcfg, pcfg = _cfgs(name, trees['jax'])
    want = jax_kitti.KittiDataset(jcfg.DATA_CONFIG, CLASSES, training=training,
                                  root_path=trees['jax'])
    got = kitti_dataset.KittiDataset(pcfg.DATA_CONFIG, CLASSES,
                                     training=training, root_path=trees['port'])
    want.set_sparse_plan(jcfg.MODEL)
    got.set_model(pcfg.MODEL)
    return got, want


# the keys the port leaves out of a sample, each for its reason
NOT_PORTED = ('bev_tile_starts',  # the TPU scatter's tile histogram
              'num_points')       # the MAX_POINTS padding's count


def assert_sample_equal(got, want):
    assert set(got) == set(want) - set(NOT_PORTED), \
        sorted(set(got) ^ set(want))
    for key, value in want.items():
        if key in NOT_PORTED:
            continue
        if key == 'points':  # the port keeps them unpadded
            value = value[:int(want['num_points'])]
        if key == 'calib':
            for attr in ('P2', 'R0', 'V2C'):
                np.testing.assert_array_equal(getattr(got[key], attr),
                                              getattr(value, attr))
            continue
        if isinstance(value, np.ndarray) or np.isscalar(value):
            assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
@pytest.mark.parametrize('name', ['pointpillar', 'second'])
def test_getitem_equals_jax(trees, name, training):
    got_ds, want_ds = _datasets(name, trees, training)
    assert len(got_ds) == len(want_ds) == (NUM_TRAIN if training else NUM_VAL)
    rng = np.random.RandomState(11)
    np.random.seed(11)
    n_sampled = 0
    for index in list(range(len(want_ds))) * (2 if training else 1):
        want = want_ds[index]
        got = got_ds.get_item(index, rng)
        assert_sample_equal(got, want)
        n_gt = int((want['gt_boxes'][:, -1] > 0).sum())
        n_sampled += n_gt
        if name == 'second':
            assert any(k.startswith('rb_') for k in got)
    # the next draw of each generator is the same: the same calls were made
    assert rng.randint(1 << 30) == np.random.randint(1 << 30)
    if training:  # gt sampling pasted boxes beside each frame's own
        assert n_sampled > 2 * NUM_TRAIN * 7


def _predictions(dataset, rng, classes_per_row):
    """Padded predictions of every val frame: its gt boxes jittered, with
    labels, scores and a pred_mask, the kept rows at `classes_per_row`'s
    slots."""
    preds = {'pred_boxes': [], 'pred_scores': [], 'pred_labels': [],
             'pred_mask': [], 'num_preds': []}
    for info in dataset.kitti_infos:
        annos = info['annos']
        keep = annos['name'] != 'DontCare'
        boxes = annos['gt_boxes_lidar'].astype(np.float32)
        boxes[:, 0:2] += rng.randn(len(boxes), 2).astype(np.float32) * 0.1
        labels = np.array([CLASSES.index(n) + 1 for n in annos['name'][keep]])
        n, slots = len(boxes), 12
        rows = np.arange(n) * classes_per_row
        out_boxes = np.zeros((slots * classes_per_row, 7), np.float32)
        out_boxes[rows] = boxes
        scores = np.zeros(len(out_boxes), np.float32)
        scores[rows] = rng.uniform(0.2, 1.0, n)
        out_labels = np.zeros(len(out_boxes), np.int64)
        out_labels[rows] = labels
        mask = np.zeros(len(out_boxes), bool)
        mask[rows] = True
        for key, value in zip(preds, (out_boxes, scores, out_labels, mask, n)):
            preds[key].append(value)
    return {k: np.stack(v) for k, v in preds.items()}


def test_prediction_dicts_and_evaluation_equal_jax(trees, tmp_path):
    got_ds, want_ds = _datasets('pointpillar', trees, training=False)
    want_sample = want_ds[0]
    batch = {'batch_size': 1, 'frame_id': np.array([want_sample['frame_id']]),
             'calib': [want_sample['calib']],
             'image_shape': np.array([want_sample['image_shape']])}
    preds = _predictions(want_ds, np.random.RandomState(5), 1)
    want = want_ds.generate_prediction_dicts(batch, preds, CLASSES,
                                             output_path=tmp_path / 'jax')
    got = got_ds.generate_prediction_dicts(batch, preds, CLASSES,
                                           output_path=tmp_path / 'port')
    assert len(got) == len(want) == 1 and len(got[0]['name']) == 7
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], want[0][key], err_msg=key)
    name = f"{want_sample['frame_id']}.txt"
    assert (tmp_path / 'port' / name).read_text() == \
        (tmp_path / 'jax' / name).read_text()
    want_str, want_dict = want_ds.evaluation(want, CLASSES)
    got_str, got_dict = got_ds.evaluation(got, CLASSES)
    assert got_str == want_str and list(got_dict) == list(want_dict)
    for key, value in want_dict.items():
        assert float(got_dict[key]) == float(value), key
    assert got_dict['Car_3d/moderate_R40'] > 0
    # a multi-class output: the kept rows lie apart; the port reads them
    gapped = _predictions(want_ds, np.random.RandomState(5), 3)
    annos = got_ds.generate_prediction_dicts(batch, gapped, CLASSES)
    for key in got[0]:
        np.testing.assert_array_equal(annos[0][key], got[0][key], err_msg=key)


def test_create_kitti_infos_entry_point(tmp_path):
    write_tree(tmp_path)
    kitti_dataset.main(['create_kitti_infos',
                        'tools/cfgs/dataset_configs/kitti_dataset.yaml',
                        str(tmp_path)])
    for name in ('kitti_infos_train.pkl', 'kitti_infos_val.pkl',
                 'kitti_dbinfos_train.pkl'):
        assert (tmp_path / name).exists(), name
    with pytest.raises(SystemExit, match='usage'):
        kitti_dataset.main(['create_infos'])
