"""The fork's offline generators, port against the JAX package, on the trees
of tests/test_data_gen.py's writers (``fake_tree``: two blank scenes and a
three-object database; its MOT and Mix source trees) and on the MOT tree
of ``datasets/synthetic_trees.py::write_plusai_tree``:

* the seeded RANSAC ``find_plane``, the pitch rectification and
  ``estimate_ground_plane_batch``: equal floats and pickles;
* ``generate_fake_lidar`` and ``create_groundtruth_database`` (the object
  database of a Livox-layout tree): the clouds byte for byte, the labels
  and db infos array for array;
* ``process_obstacles`` (the gap filling) and
  ``prepare_multiframe_dataset``: the stacked clouds byte for byte, the
  labels array for array; ``gen_single_frame_dataset``, which raises in
  the JAX package, against the single frames;
* ``generate_mix_dataset``: the mixed tree byte for byte.
"""

import pickle
import shutil

import numpy as np
import pytest
from test_data_gen import fake_tree  # noqa: F401
from test_torch_kitti_dataset import assert_tree_equal

from lidardetection_tpu.datasets.mix_data import gen_mix_dataset as jax_mix
from lidardetection_tpu.datasets.plusai import fake_lidar_dataset as jax_fake
from lidardetection_tpu.datasets.plusai.fake_lidar_dataset import (
    plane_estimation as jax_plane,
)
from lidardetection_tpu.datasets.plusai.mot_dataset import (
    gen_mot_dataset as jax_mot,
)
from lidardetection_tpu_torch.datasets import synthetic_trees
from lidardetection_tpu_torch.datasets.mix_data import gen_mix_dataset
from lidardetection_tpu_torch.datasets.plusai import fake_lidar_dataset as fake
from lidardetection_tpu_torch.datasets.plusai.fake_lidar_dataset import (
    plane_estimation,
)
from lidardetection_tpu_torch.datasets.plusai.mot_dataset import (
    gen_mot_dataset,
)


def assert_dirs_equal(got, want):
    """Two trees: the same files; ``.pkl`` files equal as loaded, the
    others byte for byte."""
    got_files = sorted(p.relative_to(got) for p in got.rglob('*') if p.is_file())
    want_files = sorted(p.relative_to(want) for p in want.rglob('*')
                        if p.is_file())
    assert got_files == want_files and got_files
    for rel in got_files:
        if rel.suffix == '.pkl':
            with open(got / rel, 'rb') as f:
                g = pickle.load(f)
            with open(want / rel, 'rb') as f:
                w = pickle.load(f)
            assert_tree_equal(g, w, str(rel))
        else:
            assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel


def test_plane_estimation_equals_jax():
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 50, (500, 2))
    z = 0.02 * xy[:, 0] - 0.01 * xy[:, 1] + 0.3 + rng.randn(500) * 0.005
    pts = np.c_[xy, z]
    pts[::5, 2] += rng.uniform(1, 3, 100)
    for seed in (0, 3):
        want = jax_plane.find_plane(pts, seed=seed)
        assert plane_estimation.find_plane(pts, seed=seed) == want
    a, b, d = want
    assert plane_estimation.get_angle_pitch(a, b, d) == \
        jax_plane.get_angle_pitch(a, b, d)
    assert plane_estimation.angle_rotate(a, b, d) == \
        jax_plane.angle_rotate(a, b, d)
    got = plane_estimation.gen_rectified_plane(pts)
    np.testing.assert_array_equal(got, jax_plane.gen_rectified_plane(pts))
    # the levelled scene's ground has no pitch left
    assert abs(plane_estimation.find_plane(got)[0]) < 2e-3


def test_fake_lidar_and_gt_database_equal_jax(fake_tree):  # noqa: F811
    scene_dir, gt_root, out = fake_tree
    want_params = jax_fake.estimate_ground_plane_batch(scene_dir)
    with open(scene_dir / 'ground_plane_params.pkl', 'rb') as f:
        want_pickle = pickle.load(f)
    got_params = fake.estimate_ground_plane_batch(scene_dir)
    with open(scene_dir / 'ground_plane_params.pkl', 'rb') as f:
        assert pickle.load(f) == want_pickle == got_params == want_params
    trees = {}
    for name, module in (('jax', jax_fake), ('port', fake)):
        trees[name] = out.parent / f'fake_{name}'
        ids = module.generate_fake_lidar(
            num_frames=3, num_objects_per_frame=6,
            object_range=(0, -20, -3, 150, 20, 3), gt_data_path=gt_root,
            blank_scene_path=scene_dir, output_path=trees[name], seed=4)
        assert ids == ['000000', '000001', '000002']
        db = module.create_groundtruth_database(
            trees[name], used_classes=('Car', 'Truck'))
        assert sum(len(v) for v in db.values()) > 0
    assert_dirs_equal(trees['port'], trees['jax'])


def test_process_obstacles_equals_jax():
    def obs(x, vx=10.0):
        return {'class': 'Car', 'size': [4.5, 1.9, 1.6], 'is_front_car': False,
                'location': np.array([x, 0.0, 0.8]), 'heading': 0.1 * x,
                'velocity': np.array([vx, 0.0, 0.0])}

    cases = [{'a': [obs(10.0), obs(11.0), {}]},     # extrapolated forward
             {'b': [{}, obs(5.0), obs(7.0)]},       # extrapolated backward
             {'c': [obs(1.0), {}, {}]},             # unseen at the base
             {'d': [{}, obs(3.0, vx=-50.0), {}]},   # no usable velocity
             {'e': [obs(2.0), obs(3.0), obs(4.0)],  # several tracks
              'f': [obs(8.0), obs(9.0), {}]}]
    for case in cases:
        want = jax_mot.process_obstacles(pickle.loads(pickle.dumps(case)))
        got = gen_mot_dataset.process_obstacles(pickle.loads(pickle.dumps(case)))
        assert_tree_equal(got, want, str(list(case)))


def _mot_tree(root):
    """tests/test_data_gen.py's MOT scene (four frames of 200 points, the
    ego 2 m a frame, one obstacle) beside the writer's two scenes."""
    rng = np.random.RandomState(2)
    scene = root / 'mot_dataset' / 's0'
    (scene / 'pointcloud').mkdir(parents=True)
    (scene / 'label').mkdir()
    for i in range(4):
        rng.rand(200, 4).astype(np.float32).tofile(
            scene / 'pointcloud' / f'{i:06d}.bin')
        annos = {'timestamp': 1000.0 + 0.1 * i,
                 'trans': np.array([2.0 * i, 0.0, 0.0]),
                 'quat': np.array([0, 0, 0, 1.0]),
                 'bag_name': 'bag0', 'frame_index': i,
                 'obstacle_list': [{
                     'uuid': 'u0',
                     'position': {'x': 30.0 + i, 'y': 0.0, 'z': 0.8},
                     'direction': {'x': 1.0, 'y': 0.0},
                     'velocity': {'x': 10.0, 'y': 0.0, 'z': 0.0},
                     'size': [4.5, 1.9, 1.6], 'is_front_car': False}]}
        with open(scene / 'label' / f'{i:06d}.pkl', 'wb') as f:
            pickle.dump(annos, f)


def _mot_trees(tmp_path):
    sensor = {**synthetic_trees.PLUSAI, 'beams': 8, 'azimuth_steps': 200}
    base = tmp_path / 'jax'
    synthetic_trees.write_plusai_tree(base, 2, 4, seed=1, sensor=sensor)
    shutil.rmtree(base / 'multiframe')  # the writer's own stacking
    _mot_tree(base)
    shutil.copytree(base, tmp_path / 'port')
    return base, tmp_path / 'port'


def test_mot_dataset_equals_jax(tmp_path):
    trees = _mot_trees(tmp_path)
    for root, module in zip(trees, (jax_mot, gen_mot_dataset)):
        assert module.prepare_multiframe_dataset(root) == \
            ['s0', 'scene_000', 'scene_001']
    assert_dirs_equal(trees[1] / 'multiframe', trees[0] / 'multiframe')
    labels = sorted((trees[1] / 'multiframe' / 'scene_000' / 'label')
                    .iterdir())
    assert len(labels) == 2
    with open(labels[0], 'rb') as f:
        final = pickle.load(f)
    assert len(final['obstacles']) == 9
    assert all(len(track) == 3 for track in final['obstacles'])


def test_single_frame_dataset(tmp_path):
    """A stack of one: the JAX package's raises (its obstacles are read at
    frame 1 whatever the stack); the port's keeps every frame, its cloud
    with a zero frame index, each obstacle at that frame, as the three-frame
    stack holds the same frame's obstacles at its base."""
    jax_root, root = _mot_trees(tmp_path)
    with pytest.raises(IndexError):
        jax_mot.gen_single_frame_dataset(jax_root)
    assert gen_mot_dataset.gen_single_frame_dataset(root) == \
        ['s0', 'scene_000', 'scene_001']
    single = root / 'multiframe' / 'scene_000'
    assert len(list((single / 'label').iterdir())) == 4
    frame = np.fromfile(root / 'mot_dataset' / 'scene_000' / 'pointcloud' /
                        '000001.bin', np.float32).reshape(-1, 4)
    cloud = np.fromfile(single / 'pointcloud' / '000001.bin',
                        np.float32).reshape(-1, 5)
    np.testing.assert_array_equal(cloud[:, :4], frame)
    assert not cloud[:, 4].any()
    with open(single / 'label' / '000001.pkl', 'rb') as f:
        got = pickle.load(f)
    gen_mot_dataset.prepare_multiframe_dataset(jax_root)
    with open(jax_root / 'multiframe' / 'scene_000' / 'label' / '000000.pkl',
              'rb') as f:
        stacked = pickle.load(f)  # frames 0-2, base frame 1
    assert [t[0]['location'].tolist() for t in got['obstacles']] == \
        [t[1]['location'].tolist() for t in stacked['obstacles']]


def test_generate_mix_dataset_equals_jax(tmp_path):
    """tests/test_data_gen.py's two source trees (three frames each, fine
    and fused names), then the writer's larger ones."""
    rng = np.random.RandomState(3)
    for k, (name, nfeat) in enumerate((('livox', 4), ('fake', 3))):
        root = tmp_path / 'small' / name / 'training'
        (root / 'pointcloud').mkdir(parents=True)
        (root / 'label').mkdir()
        for i in range(3):
            rng.rand(50, nfeat).astype(np.float64).tofile(
                root / 'pointcloud' / f'{i:06d}.bin')
            labels = [{'name': 'car' if k == 0 else 'Car',
                       'box3d_lidar': np.array([20, 0, 1.0, 4.5, 1.9, 1.6, 0.0])}]
            with open(root / 'label' / f'{i:06d}.pkl', 'wb') as f:
                pickle.dump(labels, f)
    for seed in (0, 1):
        for name, module in (('jax', jax_mix), ('port', gen_mix_dataset)):
            ids = module.generate_mix_dataset(
                tmp_path / 'small' / 'livox', tmp_path / 'small' / 'fake',
                tmp_path / f'mix_{name}_{seed}', num_frames=5, seed=seed)
            assert len(ids) == 5
        assert_dirs_equal(tmp_path / f'mix_port_{seed}',
                          tmp_path / f'mix_jax_{seed}')
    # the writer's Mix tree: a Livox tree and a fake-lidar tree from blank
    # scenes, the database and the generator, mixed by the port
    mix = synthetic_trees.write_mix_tree(tmp_path / 'written', 6, 2, seed=2)
    jax_mix.generate_mix_dataset(tmp_path / 'written' / 'livox',
                                 tmp_path / 'written' / 'fake',
                                 tmp_path / 'written_jax', 6, seed=2)
    shutil.rmtree(mix / 'ImageSets')  # written by the tree writer after
    assert_dirs_equal(mix, tmp_path / 'written_jax' / 'training')
