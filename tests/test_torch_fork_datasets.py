"""The fork's datasets, port against the JAX package, on trees the tests
write: ``tests/test_fork_datasets.py::make_mini_plusai`` (a PlusAI
multiframe scene, two frames of ~3300 stacked points), a Livox tree and a
Mix tree of ``datasets/synthetic_trees.py`` (a 32-beam sector, ~16k
returns a frame), each in two copies, one for each package's writes.

* ``create_plusai_infos``: the info pickles equal array for array, the gt
  database's ``.bin`` files byte for byte. The Livox tree's infos and gt
  database (the JAX package has no creation function: its ``get_infos``
  and ``create_groundtruth_database``, pickled as ``create_livox_infos``
  pickles them) likewise.
* ``get_item`` in train mode with the augmentor (gt sampling with the
  multiframe poses, flip, rotation, scaling; the host plan of PV-RCNN's
  sparse backbone) under ``RandomState(s)`` against ``__getitem__`` after
  ``np.random.seed(s)``, every frame twice (the sampler's pointers move),
  and in test mode: every key bit for bit but the TPU scatter's
  ``bev_tile_starts``, the raw points compared up to ``num_points``.
* Mix: the port's MixDataset on a generated Mix tree (x, y, z a point)
  against the JAX package's on the same tree with a zero intensity
  column, the layout the JAX reader takes.
* ``generate_prediction_dicts`` and ``evaluation`` (the round trip of
  test_fork_datasets.py:90): equal annos and result dicts.
* ``stack_frames_to_base`` and ``DemoDataset``, ``load_lidar_calib``
  (YAML against the JAX package's OpenCV reading), the ROS readers'
  refusal, and a loader of each of the five Livox / Mix configs on the
  writers' trees.
"""

import pickle
import shutil

import numpy as np
import pytest
from test_fork_datasets import make_mini_plusai
from test_torch_kitti_dataset import assert_tree_equal

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets.livox import livox_dataset as jax_livox
from lidardetection_tpu.datasets.mix_data import mix_dataset as jax_mix
from lidardetection_tpu.datasets.plusai import plusai_bag_dataset as jax_bag
from lidardetection_tpu.datasets.plusai import plusai_dataset as jax_plusai
from lidardetection_tpu.utils import calibration_plusai as jax_calib
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.datasets import (
    build_dataloader, dataset_class, synthetic_trees,
)
from lidardetection_tpu_torch.datasets.livox import livox_dataset
from lidardetection_tpu_torch.datasets.mix_data import mix_dataset
from lidardetection_tpu_torch.datasets.plusai import (
    plusai_bag_dataset, plusai_dataset,
)
from lidardetection_tpu_torch.utils import calibration_plusai

CLASSES = ['Car', 'Truck']
SMALL = {**synthetic_trees.LIVOX, 'beams': 32, 'azimuth_steps': 500}
MULTIFRAME = 'tools/cfgs/livox_models/pv_rcnn_multiframe.yaml'
LIVOX_PP = 'tools/cfgs/livox_models/pointpillar.yaml'
MIX_PP = 'tools/cfgs/mix_data_models/pointpillars_xy.yaml'


def _sampling(cfg, groups):
    """gt sampling of `groups` per frame (the configs sample none), on no
    road plane, with a width for each of the three box sizes (livox_dataset.
    yaml lists two, which both packages' samplers refuse once a box is
    pasted)."""
    for aug in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST:
        if aug.NAME == 'gt_sampling':
            aug.SAMPLE_GROUPS = groups
            aug.USE_ROAD_PLANE = False
            aug.REMOVE_EXTRA_WIDTH = [0.0, 0.0, 0.0]
            aug.PREPARE.filter_by_min_points = ['Car:1', 'Truck:1']
    return cfg


def _cfgs(path, groups, root, cap=8000):
    """The config in both packages, gt sampling of `groups`, the voxel and
    point caps cut to `cap`, reading the tree at `root`."""
    out = []
    for load in (jax_cfg_from_yaml, cfg_from_yaml_file):
        cfg = _sampling(load(path), groups)
        data = cfg.DATA_CONFIG
        data.DATA_PATH = str(root)
        for p in data.DATA_PROCESSOR:
            if p.NAME == 'transform_points_to_voxels':
                p.MAX_NUMBER_OF_VOXELS = {'train': cap, 'test': cap}
            if p.NAME == 'sample_points':
                p.NUM_POINTS = {'train': cap, 'test': cap}
        if 'MAX_POINTS' in data:
            data.MAX_POINTS = cap
        out.append(cfg)
    return out


@pytest.fixture(scope='module')
def plusai(tmp_path_factory):
    """{package: root} of the mini PlusAI tree, each with that package's
    infos and gt database."""
    def write(root):
        make_mini_plusai(root)
        return root

    return _plusai_trees(tmp_path_factory, 'mini', write)


@pytest.fixture(scope='module')
def plusai_written(tmp_path_factory):
    """The same of a tree that ``write_plusai_tree`` writes through the
    MOT generator (three scenes of four frames, two stacked samples each,
    nine moving obstacles; the last scene in val)."""
    sensor = {**synthetic_trees.PLUSAI, 'beams': 16, 'azimuth_steps': 400}
    return _plusai_trees(tmp_path_factory, 'written', lambda root: (
        synthetic_trees.write_plusai_tree(root, 3, 4, seed=5, sensor=sensor)))


def _plusai_trees(tmp_path_factory, kind, write):
    """`write(dir)` -> a tree's root, in a directory of each package's,
    with that package's infos and gt database."""
    roots = {}
    for name, module, load in (('jax', jax_plusai, jax_cfg_from_yaml),
                               ('port', plusai_dataset, cfg_from_yaml_file)):
        root = write(tmp_path_factory.mktemp(f'plusai_{kind}_{name}'))
        cfg = load('tools/cfgs/dataset_configs/plusai_multiframe_dataset.yaml')
        module.create_plusai_infos(cfg, CLASSES, root, root, workers=1)
        roots[name] = root
    return roots


def jax_infos(cls, cfg, root, db_name):
    """The JAX package's infos of a Livox-layout tree under the config's
    INFO_PATH names and its gt database as `db_name` (it has no function
    that writes them)."""
    dataset = cls(cfg, CLASSES, training=False, root_path=root)
    for mode in ('train', 'test'):
        split = (root / 'ImageSets' / f'{cfg.DATA_SPLIT[mode]}.txt')
        infos = dataset.get_infos(num_workers=1, has_label=True,
                                  sample_id_list=split.read_text().splitlines())
        with open(root / cfg.INFO_PATH[mode][0], 'wb') as f:
            pickle.dump(infos, f)
    dataset.create_groundtruth_database(root / cfg.INFO_PATH['train'][0])
    shutil.move(root / 'plusai_dbinfos_train.pkl', root / db_name)


@pytest.fixture(scope='module')
def livox(tmp_path_factory):
    """{package: root} of a Livox tree (8 train and 2 val frames), each with
    that package's infos and gt database under the config's names."""
    roots = {}
    for name in ('jax', 'port'):
        root = tmp_path_factory.mktemp(f'livox_{name}')
        synthetic_trees.write_livox_tree(root, 10, 2, seed=4, sensor=SMALL)
        roots[name] = root
    jax_infos(jax_livox.LivoxDataset,
              jax_cfg_from_yaml('tools/cfgs/dataset_configs/livox_dataset.yaml'),
              roots['jax'], 'livox_dbinfos_train.pkl')
    livox_dataset.create_livox_infos(
        cfg_from_yaml_file('tools/cfgs/dataset_configs/livox_dataset.yaml'),
        CLASSES, roots['port'], workers=1)
    return roots


def _compare_trees(want_root, got_root, names):
    for name in names:
        with open(want_root / name, 'rb') as f:
            want = pickle.load(f)
        with open(got_root / name, 'rb') as f:
            got = pickle.load(f)
        assert_tree_equal(got, want, name)
    want_db = sorted((want_root / 'gt_database').iterdir())
    got_db = sorted((got_root / 'gt_database').iterdir())
    assert [p.name for p in got_db] == [p.name for p in want_db]
    assert len(got_db) > 0
    for got, want in zip(got_db, want_db):
        assert got.read_bytes() == want.read_bytes(), got.name


def test_plusai_infos_and_gt_database_equal_jax(plusai):
    _compare_trees(plusai['jax'], plusai['port'],
                   ('plusai_infos_train.pkl', 'plusai_infos_val.pkl',
                    'plusai_dbinfos_train.pkl'))
    with open(plusai['port'] / 'plusai_dbinfos_train.pkl', 'rb') as f:
        db = pickle.load(f)
    assert db['Car'][0]['locations'].shape == (3, 3)


def test_livox_infos_and_gt_database_equal_jax(livox):
    _compare_trees(livox['jax'], livox['port'],
                   ('livox_infos_train.pkl', 'livox_infos_val.pkl',
                    'livox_dbinfos_train.pkl'))
    with open(livox['port'] / 'livox_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    assert len(infos) == 8
    assert set(infos[0]['annos']['name']) == {'Car', 'Truck'}  # fused


def assert_sample_equal(got, want):
    """Every key of the JAX sample but the TPU scatter's histogram, padded
    raw points up to their count."""
    assert set(got) == set(want) - {'bev_tile_starts'}, \
        sorted(set(got) ^ set(want))
    for key, value in want.items():
        if key == 'bev_tile_starts':
            continue
        if key == 'points' and 'num_points' in want:
            n = int(want['num_points'])
            assert int(got['num_points']) == n
            np.testing.assert_array_equal(got[key][:n], value[:n])
            continue
        if key == 'points':  # unpadded (the model reads none): the port's
            # processor hands them on in float32, the JAX one as they come
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], value.astype(np.float32))
            continue
        if isinstance(value, np.ndarray) or np.isscalar(value):
            assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _hold_items(want_ds, got_ds, training, seed):
    rng = np.random.RandomState(seed)
    np.random.seed(seed)
    n_gt = 0
    for index in list(range(len(want_ds))) * (2 if training else 1):
        want = want_ds[index]
        got = got_ds.get_item(index, rng)
        assert_sample_equal(got, want)
        n_gt += int((want['gt_boxes'][:, -1] > 0).sum())
    assert rng.randint(1 << 30) == np.random.randint(1 << 30)
    return n_gt


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
@pytest.mark.parametrize('tree', ['mini', 'written'])
def test_plusai_multiframe_items_equal_jax(plusai, plusai_written, tree,
                                           training):
    roots = plusai if tree == 'mini' else plusai_written
    jcfg, pcfg = _cfgs(MULTIFRAME, ['Car:2', 'Truck:1'], roots['jax'])
    want = jax_plusai.PlusAIMultiframeDataset(
        jcfg.DATA_CONFIG, CLASSES, training=training, root_path=roots['jax'])
    got = plusai_dataset.PlusAIMultiframeDataset(
        pcfg.DATA_CONFIG, CLASSES, training=training, root_path=roots['port'])
    want.set_sparse_plan(jcfg.MODEL)
    got.set_model(pcfg.MODEL)
    assert len(got) == len(want) == (1 if tree == 'mini' else
                                     4 if training else 2)
    n_gt = _hold_items(want, got, training, seed=5)
    sample = got.get_item(0, np.random.RandomState(0))
    assert sample['locations'].shape == (64, 3, 3)
    assert any(k.startswith('rb_') for k in sample)
    if tree == 'mini':
        # its two obstacles a frame; gt sampling pastes none there (the
        # database holds the frame's own boxes, which collide)
        assert n_gt == (4 if training else 2)
    elif training:  # gt sampling pasted boxes, with their poses
        assert n_gt > 2 * 4 * 9


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_livox_items_equal_jax(livox, training):
    jcfg, pcfg = _cfgs(LIVOX_PP, ['Car:4', 'Truck:2'], livox['jax'], cap=48000)
    want = jax_livox.LivoxDataset(jcfg.DATA_CONFIG, CLASSES, training=training,
                                  root_path=livox['jax'])
    got = livox_dataset.LivoxDataset(pcfg.DATA_CONFIG, CLASSES,
                                     training=training, root_path=livox['port'])
    want.set_sparse_plan(jcfg.MODEL)
    got.set_model(pcfg.MODEL)
    n_gt = _hold_items(want, got, training, seed=6)
    if training:  # gt sampling pasted boxes beside each frame's own
        assert n_gt > 2 * 8 * 8


def test_mix_items_equal_jax_on_four_columns(tmp_path):
    """The port's MixDataset on a generated Mix tree (float64 x, y, z)
    against the JAX package's on the same tree with a zero intensity
    column appended (its reader takes four a point)."""
    mix = synthetic_trees.write_mix_tree(tmp_path / 'port', 6, 2, seed=3)
    four = tmp_path / 'jax' / 'training'
    shutil.copytree(mix, four)
    for path in sorted((four / 'pointcloud').iterdir()):
        xyz = np.fromfile(path).reshape(-1, 3)
        np.c_[xyz, np.zeros(len(xyz))].tofile(path)
    livox_dataset.create_livox_infos(cfg_from_yaml_file(MIX_PP).DATA_CONFIG,
                                     CLASSES, mix, workers=1)
    jax_infos(jax_mix.MixDataset, jax_cfg_from_yaml(MIX_PP).DATA_CONFIG, four,
              'mix_dbinfos_train.pkl')
    _compare_trees(four, mix, ('mix_data_infos_train.pkl',
                               'mix_data_infos_val.pkl',
                               'mix_dbinfos_train.pkl'))
    for training in (True, False):
        jcfg, pcfg = _cfgs(MIX_PP, ['Car:3', 'Truck:2'], four, cap=32000)
        want = jax_mix.MixDataset(jcfg.DATA_CONFIG, CLASSES, training=training,
                                  root_path=four)
        got = mix_dataset.MixDataset(pcfg.DATA_CONFIG, CLASSES,
                                     training=training, root_path=mix)
        want.set_sparse_plan(jcfg.MODEL)
        got.set_model(pcfg.MODEL)
        assert len(got) == len(want) == (4 if training else 2)
        _hold_items(want, got, training, seed=8)
    points = got.get_lidar('000000')
    assert points.shape[1] == 4 and not points[:, 3].any()


def test_prediction_dicts_and_evaluation_equal_jax(plusai):
    """test_fork_datasets.py:90's round trip in both packages: the val
    frame's gt as predictions, then the protocol."""
    jcfg = jax_cfg_from_yaml(MULTIFRAME)
    pcfg = cfg_from_yaml_file(MULTIFRAME)
    want_ds = jax_plusai.PlusAIMultiframeDataset(
        jcfg.DATA_CONFIG, CLASSES, training=False, root_path=plusai['jax'])
    got_ds = plusai_dataset.PlusAIMultiframeDataset(
        pcfg.DATA_CONFIG, CLASSES, training=False, root_path=plusai['port'])
    info = got_ds.plusai_infos[0]
    gt = info['annos']['gt_boxes_lidar']
    n, slots = len(gt), 5
    boxes = np.zeros((1, slots, 7), np.float32)
    boxes[0, :n] = gt
    preds = {'pred_boxes': boxes,
             'pred_scores': np.array([[0.9, 0.8, 0, 0, 0]], np.float32),
             'pred_labels': np.array([[1, 2, 0, 0, 0]]),
             'pred_mask': np.arange(slots)[None] < n,
             'num_preds': np.array([n])}
    batch = {'batch_size': 1, 'frame_id': [info['point_cloud']['lidar_idx']]}
    want = want_ds.generate_prediction_dicts(batch, preds, CLASSES)
    got = got_ds.generate_prediction_dicts(batch, preds, CLASSES)
    assert_tree_equal(got, want, 'annos')
    want_str, want_dict = want_ds.evaluation(want, CLASSES)
    got_str, got_dict = got_ds.evaluation(got, CLASSES)
    assert got_str == want_str and list(got_dict) == list(want_dict)
    for key, value in want_dict.items():
        assert float(got_dict[key]) == float(value), key
    # one gt box a class: the protocol's 11 recall points give 1/11 of it
    assert got_dict['Car_3d/moderate'] == pytest.approx(100 / 11)


def test_stack_frames_and_demo_dataset_equal_jax(tmp_path):
    rng = np.random.RandomState(9)
    frames = [(0.1 * i, (rng.randn(3) * 5, (lambda q: q / np.linalg.norm(q))(
        rng.randn(4))), rng.rand(50, 4).astype(np.float32)) for i in range(3)]
    want = jax_bag.stack_frames_to_base(frames, 1)
    got = plusai_bag_dataset.stack_frames_to_base(frames, 1)
    assert got.dtype == want.dtype and got.shape == (150, 5)
    np.testing.assert_array_equal(got, want)
    for k in range(2):
        rng.rand(300, 4).astype(np.float32).tofile(tmp_path / f'f{k}.bin')
    jcfg = jax_cfg_from_yaml('tools/cfgs/kitti_models/pointpillar.yaml')
    pcfg = cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml')
    want_ds = jax_bag.DemoDataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                                  root_path=tmp_path)
    got_ds = plusai_bag_dataset.DemoDataset(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES,
                                            root_path=tmp_path)
    assert len(got_ds) == len(want_ds) == 2
    for k in range(2):
        want_item = want_ds[k]
        got_item = got_ds[k]
        for key in ('voxels', 'voxel_coords', 'voxel_num_points',
                    'num_voxels'):
            np.testing.assert_array_equal(got_item[key], want_item[key],
                                          err_msg=key)


def test_ros_readers_raise_naming_rosbag():
    for cls in (plusai_bag_dataset.UnifyLidar,
                plusai_bag_dataset.BagMultiframeDatasetUnifyLidar,
                plusai_bag_dataset.BagMultiframeDataset):
        with pytest.raises(ImportError, match='rosbag and sensor_msgs'):
            cls({}, 'drive.bag', CLASSES)


def test_lidar_calib_reads_the_opencv_yaml(tmp_path):
    matrix = np.arange(16, dtype=np.float32).reshape(4, 4) / 7
    data = ', '.join(f'{v:.9g}' for v in matrix.ravel())
    (tmp_path / 'truck1_20200101_lidar0.yml').write_text(
        '%YAML:1.0\n---\nTr_lidar_to_imu: !!opencv-matrix\n   rows: 4\n'
        f'   cols: 4\n   dt: d\n   data: [ {data} ]\n')
    args = ('truck1', 'lidar0', '20200101', str(tmp_path))
    want = jax_calib.load_lidar_calib(*args)
    got = calibration_plusai.load_lidar_calib(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, matrix, rtol=1e-7)
    (tmp_path / 'truck1_20200101_lidar1.yml').write_text(
        '%YAML:1.0\n---\nTr_lidar_to_imu: !!opencv-matrix\n   rows: 4\n')
    with pytest.raises(ValueError, match='cv2'):
        calibration_plusai.load_lidar_calib('truck1', 'lidar1', '20200101',
                                            str(tmp_path))
    with pytest.raises(FileNotFoundError):
        calibration_plusai.load_lidar_calib('truck2', 'lidar0', '20200101',
                                            str(tmp_path))


@pytest.mark.parametrize('path', [
    'livox_models/pointpillar.yaml', 'livox_models/pv_rcnn.yaml',
    'livox_models/pv_rcnn_multiframe.yaml',
    'mix_data_models/pointpillars_xy.yaml', 'mix_data_models/pv_rcnn_xy.yaml'])
def test_fork_configs_build_a_loader_from_a_written_tree(path, tmp_path):
    """Each Livox / Mix config's dataset from a tree the writers write, its
    infos created, a training batch and a test batch through
    ``build_dataloader`` with the model's host plan and raw points."""
    cfg = cfg_from_yaml_file(f'tools/cfgs/{path}')
    data = cfg.DATA_CONFIG
    name = data.DATASET
    if name == 'PlusAIMultiframeDataset':
        sensor = {**synthetic_trees.PLUSAI, 'beams': 16, 'azimuth_steps': 400}
        root = synthetic_trees.write_plusai_tree(tmp_path, 2, 4, sensor=sensor)
        plusai_dataset.create_plusai_infos(data, CLASSES, root, root,
                                           workers=1)
    elif name == 'MixDataset':
        root = synthetic_trees.write_mix_tree(tmp_path, 4, 2)
        livox_dataset.create_livox_infos(data, CLASSES, root, workers=1)
    else:
        root = tmp_path
        synthetic_trees.write_livox_tree(root, 4, 2, sensor=SMALL)
        livox_dataset.create_livox_infos(data, CLASSES, root, workers=1)
    assert dataset_class(name).__name__ == name
    for training in (True, False):
        dataset, loader = build_dataloader(
            data, list(cfg.CLASS_NAMES), 2, training=training, root_path=root,
            workers=0, model_cfg=cfg.MODEL)
        assert type(dataset).__name__ == name and len(dataset) == 2
        batch = next(iter(loader))
        assert batch['voxels'].shape[0] == 2 and (batch['num_voxels'] > 0).all()
        assert (batch['gt_boxes'][..., -1] > 0).any()
        if cfg.MODEL.get('PFE'):  # the raw points the VSA reads
            assert batch['points'].shape[0] == 2 and \
                (batch['num_points'] > 0).all()
        if name == 'PlusAIMultiframeDataset':
            assert batch['locations'].shape[2] == 3


def test_info_entry_points(tmp_path):
    """``create_plusai_infos`` and ``create_livox_infos`` from the command
    line, each on a tree the writers write."""
    sensor = {**synthetic_trees.PLUSAI, 'beams': 8, 'azimuth_steps': 200}
    plusai = synthetic_trees.write_plusai_tree(tmp_path / 'plusai', 2, 4,
                                               sensor=sensor)
    plusai_dataset.main([
        'create_plusai_infos',
        'tools/cfgs/dataset_configs/plusai_multiframe_dataset.yaml',
        str(plusai)])
    root = tmp_path / 'livox'
    synthetic_trees.write_livox_tree(root, 4, 2, sensor=SMALL)
    livox_dataset.main(['create_livox_infos', LIVOX_PP, str(root)])
    for path in (plusai / 'plusai_infos_train.pkl',
                 plusai / 'plusai_dbinfos_train.pkl',
                 root / 'livox_infos_val.pkl', root / 'livox_dbinfos_train.pkl'):
        assert path.exists(), path
    with open(plusai / 'plusai_infos_train.pkl', 'rb') as f:
        assert 'locations' in pickle.load(f)[0]['annos']  # the multiframe layout
    for main in (plusai_dataset.main, livox_dataset.main):
        with pytest.raises(SystemExit, match='usage'):
            main(['create_infos'])
