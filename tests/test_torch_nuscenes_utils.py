"""The NuScenes devkit bridge (``datasets/nuscenes/nuscenes_utils.py`` and
``NuScenesDataset._nuscenes_official_eval``), port against the JAX
package, both driven through one stand-in devkit that the test builds as
modules of its own and puts in ``sys.modules``: ``nuscenes`` (a
``NuScenes`` of 2 scenes x 2 key frames, each key frame 2 sweeps after
the previous one, over .bin files in ``tmp_path``; ``Box``,
``transform_matrix``, ``config_factory`` and a ``NuScenesEval`` that
records the results JSON it reads and writes fixed metrics) and
``pyquaternion.Quaternion``.

* ``get_available_scenes`` and ``fill_trainval_infos``: the infos, their
  sweeps and transforms, equal;
* ``transform_det_annos_to_nusc_annos`` and ``format_nuscene_results``:
  equal;
* ``NuScenesDataset.evaluation(eval_metric='nuscenes')``: the same
  results JSON handed to the devkit, the same result string and dict;
  without the devkit both return the JAX package's message and ``{}``.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets.nuscenes import nuscenes_dataset as jax_nusc
from lidardetection_tpu.datasets.nuscenes import nuscenes_utils as jax_utils
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.datasets.nuscenes import nuscenes_dataset
from lidardetection_tpu_torch.datasets.nuscenes import nuscenes_utils

CFG = 'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml'
VERSION = 'v1.0-trainval'
CATEGORIES = ('vehicle.car', 'human.pedestrian.adult', 'vehicle.truck',
              'movable_object.barrier', 'vehicle.bicycle')


class Quaternion:
    """pyquaternion's Quaternion, the parts the bridge uses."""

    def __init__(self, q=None, axis=None, radians=None):
        if axis is not None:
            axis = np.asarray(axis, float) / np.linalg.norm(axis)
            half = radians / 2.0
            q = [np.cos(half), *(np.sin(half) * axis)]
        self.q = np.asarray(q, float)

    @property
    def elements(self):
        return self.q.copy()

    @property
    def inverse(self):
        w, x, y, z = self.q
        return Quaternion(np.array([w, -x, -y, -z]) / np.dot(self.q, self.q))

    def __mul__(self, other):
        a1, b1, c1, d1 = self.q
        a2, b2, c2, d2 = other.q
        return Quaternion([a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
                           a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
                           a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
                           a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2])

    @property
    def rotation_matrix(self):
        w, x, y, z = self.q / np.linalg.norm(self.q)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


class Box:
    """nuscenes.utils.data_classes.Box, the parts the bridge uses."""

    def __init__(self, center, size, orientation, label=np.nan, score=np.nan,
                 velocity=(np.nan, np.nan, np.nan), name=None, token=None):
        self.center = np.asarray(center, float)
        self.wlh = np.asarray(size, float)
        self.orientation = orientation
        # the devkit's casts: a numpy score would not serialize
        self.label = int(label) if not np.isnan(label) else label
        self.score = float(score) if not np.isnan(score) else score
        self.velocity = np.asarray(velocity, float)
        self.name, self.token = name, token

    def translate(self, x):
        self.center = self.center + x

    def rotate(self, quaternion):
        self.center = quaternion.rotation_matrix @ self.center
        self.orientation = quaternion * self.orientation
        self.velocity = quaternion.rotation_matrix @ self.velocity


def transform_matrix(translation=np.zeros(3), rotation=Quaternion([1, 0, 0, 0]),
                     inverse=False):
    tm = np.eye(4)
    if inverse:
        rot_inv = rotation.rotation_matrix.T
        tm[:3, :3] = rot_inv
        tm[:3, 3] = rot_inv.dot(-np.array(translation))
    else:
        tm[:3, :3] = rotation.rotation_matrix
        tm[:3, 3] = np.array(translation)
    return tm


class World:
    """2 scenes x 2 key frames of LIDAR_TOP, 2 sweeps before each key
    frame, the whole sample_data chain linked by `prev`; 3 annotations a
    key frame (one with no lidar or radar return)."""

    def __init__(self, dataroot, seed=3):
        rng = np.random.RandomState(seed)
        self.dataroot = Path(dataroot)
        self.tables = {k: {} for k in ('scene', 'sample', 'sample_data',
                                       'calibrated_sensor', 'ego_pose',
                                       'sample_annotation')}
        self.scene, self.sample = [], []
        prev, t = '', 1_500_000_000_000_000
        for s in range(2):
            samples = []
            for k in range(2):
                for j in range(3):  # two sweeps, then the key frame
                    t += 50_000
                    key = j == 2
                    token = f's{s}k{k}' + ('' if key else f'w{j}')
                    folder = 'samples' if key else 'sweeps'
                    filename = f'{folder}/LIDAR_TOP/{token}.bin'
                    path = self.dataroot / filename
                    path.parent.mkdir(parents=True, exist_ok=True)
                    rng.rand(20, 5).astype(np.float32).tofile(path)
                    self._add('calibrated_sensor', {
                        'token': f'cs_{token}',
                        'translation': list(rng.uniform(-1, 1, 3)),
                        'rotation': list(self._unit(rng))})
                    self._add('ego_pose', {
                        'token': f'ep_{token}',
                        'translation': list(rng.uniform(-50, 50, 3)),
                        'rotation': list(self._unit(rng))})
                    self._add('sample_data', {
                        'token': token, 'prev': prev, 'timestamp': t,
                        'filename': filename,
                        'calibrated_sensor_token': f'cs_{token}',
                        'ego_pose_token': f'ep_{token}'})
                    prev = token
                anns = []
                for a in range(3):
                    ann = f'{token}a{a}'
                    self._add('sample_annotation', {
                        'token': ann, 'num_lidar_pts': int(a != 1) * (3 + a),
                        'num_radar_pts': 0,
                        'category_name': CATEGORIES[rng.randint(len(CATEGORIES))],
                        'translation': list(rng.uniform(-40, 40, 3)),
                        'size': list(rng.uniform(0.5, 4, 3)),
                        'rotation': list(self._unit(rng)),
                        'velocity': [np.nan] * 3 if a == 2
                        else list(rng.uniform(-3, 3, 3))})
                    anns.append(ann)
                sample = {'token': f'sample_{token}', 'scene_token': f'scene{s}',
                          'data': {'LIDAR_TOP': token}, 'anns': anns}
                self._add('sample', sample)
                self.sample.append(sample)
                samples.append(sample)
            scene = {'token': f'scene{s}', 'name': f'scene-{s:04d}',
                     'first_sample_token': samples[0]['token']}
            self._add('scene', scene)
            self.scene.append(scene)

    @staticmethod
    def _unit(rng):
        q = rng.normal(size=4)
        return q / np.linalg.norm(q)

    def _add(self, table, record):
        self.tables[table][record['token']] = record

    def get(self, table, token):
        return self.tables[table][token]

    def get_sample_data_path(self, token):
        return str(self.dataroot / self.get('sample_data', token)['filename'])

    def get_box(self, ann_token):
        a = self.get('sample_annotation', ann_token)
        return Box(a['translation'], a['size'], Quaternion(a['rotation']),
                   name=a['category_name'], token=a['token'])

    def sample_of(self, sd_token):
        return next(s for s in self.sample
                    if s['data']['LIDAR_TOP'] == sd_token)

    def get_boxes(self, sd_token):
        return [self.get_box(a) for a in self.sample_of(sd_token)['anns']]

    def box_velocity(self, ann_token):
        return np.asarray(self.get('sample_annotation', ann_token)['velocity'])

    def get_sample_data(self, sd_token):
        return self.get_sample_data_path(sd_token), self.get_boxes(sd_token), None


@pytest.fixture
def devkit(tmp_path, monkeypatch):
    """The stand-in devkit in sys.modules: (its world, the results JSONs
    its NuScenesEval read)."""
    import json

    world = World(tmp_path / VERSION)
    read = []

    def NuScenes(version, dataroot, verbose=True):
        assert version == VERSION and Path(dataroot) == world.dataroot
        return world

    class NuScenesEval:
        def __init__(self, nusc, config, result_path, eval_set, output_dir,
                     verbose=True):
            assert nusc is world and config == 'cfg:detection_cvpr_2019'
            assert eval_set == 'val'
            self.result_path, self.output_dir = result_path, Path(output_dir)

        def main(self, plot_examples=0, render_curves=False):
            with open(self.result_path) as f:
                read.append(json.load(f))
            names = ['car', 'truck', 'construction_vehicle', 'bus', 'trailer',
                     'barrier', 'motorcycle', 'bicycle', 'pedestrian',
                     'traffic_cone']
            metrics = {
                'label_aps': {n: {str(d): 0.1 * i + 0.01 * d
                                  for d in (0.5, 1.0, 2.0, 4.0)}
                              for i, n in enumerate(names)},
                'label_tp_errors': {n: {'trans_err': 0.3 + 0.01 * i,
                                        'scale_err': 0.25, 'orient_err': 0.5,
                                        'vel_err': 1.1, 'attr_err': 0.2}
                                    for i, n in enumerate(names)},
                'mean_dist_aps': {n: 0.05 * i for i, n in enumerate(names)},
                'tp_errors': {'trans_err': 0.31, 'scale_err': 0.26,
                              'orient_err': 0.41, 'vel_err': 1.02,
                              'attr_err': 0.19},
                'mean_ap': 0.4321, 'nd_score': 0.5123}
            with open(self.output_dir / 'metrics_summary.json', 'w') as f:
                json.dump(metrics, f)

    def module(name, **attrs):
        m = types.ModuleType(name)
        m.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, name, m)
        return m

    module('pyquaternion', Quaternion=Quaternion)
    module('nuscenes')
    module('nuscenes.nuscenes', NuScenes=NuScenes)
    module('nuscenes.utils')
    module('nuscenes.utils.data_classes', Box=Box)
    module('nuscenes.utils.geometry_utils', transform_matrix=transform_matrix)
    module('nuscenes.eval')
    module('nuscenes.eval.detection')
    module('nuscenes.eval.detection.config',
           config_factory=lambda name: f'cfg:{name}')
    module('nuscenes.eval.detection.evaluate', NuScenesEval=NuScenesEval)
    return world, read


def assert_equal_tree(got, want, path='root'):
    assert type(got) is type(want) or (np.isscalar(got) and np.isscalar(want)), \
        f'{path}: {type(got)} vs {type(want)}'
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_equal_tree(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_tree(g, w, f'{path}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), \
            f'{path}: {got!r} vs {want!r}'


def _infos(module, world):
    scenes = module.get_available_scenes(world)
    return scenes, module.fill_trainval_infos(
        world.dataroot, world, {'scene0'}, {'scene1'}, max_sweeps=10)


def test_available_scenes_and_infos_match_jax(devkit):
    world, _ = devkit
    got_scenes, got = _infos(nuscenes_utils, world)
    want_scenes, want = _infos(jax_utils, world)
    assert [s['token'] for s in got_scenes] == ['scene0', 'scene1']
    assert_equal_tree(got_scenes, want_scenes)
    assert [len(x) for x in got] == [2, 2]
    # sample 1 of a scene walks back through the other key frame: both
    # branches of the sweep chain (a transform, then the repeated last)
    sweeps = got[0][1]['sweeps']
    assert len(sweeps) == 9 and sweeps[0]['transform_matrix'] is not None
    assert sweeps[-1] is sweeps[-2]
    assert_equal_tree(got, want)


def _det_annos(infos, seed=5):
    rng = np.random.RandomState(seed)
    names = np.array(['car', 'pedestrian', 'bus', 'bicycle', 'barrier'])
    annos = []
    for info in infos:
        n = 4
        boxes = np.concatenate([rng.uniform(-30, 30, (n, 3)),
                                rng.uniform(0.5, 4, (n, 3)),
                                rng.uniform(-3, 3, (n, 1)),
                                rng.uniform(-1, 1, (n, 2)) * [[1], [0.1], [1], [0.05]]],
                               axis=1).astype(np.float32)
        labels = rng.randint(1, len(names) + 1, n)
        annos.append({'name': names[labels - 1], 'score': rng.rand(n).astype(np.float32),
                      'boxes_lidar': boxes, 'pred_labels': labels,
                      'metadata': {'token': info['token']}})
    return annos


def test_det_annos_and_results_format_match_jax(devkit, tmp_path):
    import json

    world, read = devkit
    _, (train, _) = _infos(nuscenes_utils, world)
    annos = _det_annos(train)
    got = nuscenes_utils.transform_det_annos_to_nusc_annos(annos, world)
    want = jax_utils.transform_det_annos_to_nusc_annos(annos, world)
    assert sum(len(v) for v in got['results'].values()) == 8
    assert_equal_tree(got, want)
    # the moving and the standing attributes both occur
    attrs = {a['attribute_name'] for v in got['results'].values() for a in v}
    assert len(attrs) > 2

    evaluator = sys.modules['nuscenes.eval.detection.evaluate'].NuScenesEval(
        world, 'cfg:detection_cvpr_2019', None, 'val', tmp_path)
    evaluator.result_path = tmp_path / 'r.json'
    evaluator.result_path.write_text(json.dumps(got))
    evaluator.main()
    metrics = json.loads((tmp_path / 'metrics_summary.json').read_text())
    classes = ['car', 'truck', 'bus', 'pedestrian', 'barrier']
    assert nuscenes_utils.format_nuscene_results(metrics, classes) == \
        jax_utils.format_nuscene_results(metrics, classes)


def _datasets(root):
    jcfg, pcfg = jax_cfg_from_yaml(CFG), cfg_from_yaml_file(CFG)
    port = nuscenes_dataset.NuScenesDataset(
        pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, training=False, root_path=root)
    jax_ds = jax_nusc.NuScenesDataset(
        jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=False, root_path=root)
    return port, jax_ds


def test_official_eval_matches_jax(devkit, tmp_path):
    world, read = devkit
    _, (_, val) = _infos(nuscenes_utils, world)
    port, jax_ds = _datasets(tmp_path)
    assert port.root_path == world.dataroot
    port.infos, jax_ds.infos = val, val
    annos = _det_annos(val, seed=9)
    got = port.evaluation(annos, port.class_names, eval_metric='nuscenes',
                          output_path=str(tmp_path / 'port'))
    want = jax_ds.evaluation(annos, jax_ds.class_names, eval_metric='nuscenes',
                             output_path=str(tmp_path / 'jax'))
    assert len(read) == 2 and read[0] == read[1]
    assert read[0]['meta']['use_lidar'] and len(read[0]['results']) == 2
    assert 'NDS:\t 0.5123' in got[0] and got[1]['mAP'] == 0.4321
    assert got == want


def test_eval_without_the_devkit_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'nuscenes', None)  # ImportError
    (tmp_path / VERSION).mkdir()
    port, jax_ds = _datasets(tmp_path)
    got = port.evaluation([], port.class_names)
    assert got == jax_ds.evaluation([], jax_ds.class_names)
    assert got[1] == {} and 'nuscenes-devkit not installed' in got[0]
