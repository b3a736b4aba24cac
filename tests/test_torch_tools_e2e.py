"""The port's tools end to end on the CPU, at tests/test_torch_pointpillar.py's
reduced PointPillar (a YAML written to a temporary directory).

* bag2json: the JAX tool's ``main()`` (tools/inference_bag2json.py, an
  orbax checkpoint of random weights from the JAX package's
  ``save_checkpoint``) and the port's (the same weights through
  ``convert.flax_to_state_dict``, saved as a ``.pth``) run over one folder
  of seeded ``.bin`` clouds, a scene drifting frame by frame: the kept
  detections agree within test_torch_pointpillar.py's tolerances (boxes
  1e-4, scores 1e-5, labels exactly) and the track ids of each frame are
  equal.
* The test tool: ``--eval_all`` over a directory of two checkpoints written
  by training steps (epochs 2 and 10, so that name order and epoch order
  differ, and an unfinished save beside them) evaluates them in epoch order
  and stops at ``--max_waiting_mins 0``, each result equal to
  ``eval_one_epoch`` on the restored weights; two gloo ranks under
  ``torchrun`` give the one process's merged annos and protocol result.
"""

import importlib.util
import json
import logging
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets.plusai.plusai_bag_dataset import (
    DemoDataset as JaxDemoDataset,
)
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.parallel.train_step import (
    TrainState, device_batch, jit_init,
)
from lidardetection_tpu.utils.checkpoint import save_checkpoint as jax_save
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict
from lidardetection_tpu_torch.datasets.synthetic import (
    build_test_loader, make_scene,
)
from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
from lidardetection_tpu_torch.tools import inference_bag2json
from lidardetection_tpu_torch.tools import test as test_tool
from lidardetection_tpu_torch.tools.common import build_detector
from lidardetection_tpu_torch.train import Trainer
from lidardetection_tpu_torch.utils.checkpoint import save_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_pointpillar import CFG, _randomize, _reduce  # noqa: E402
from torch_threads import two_torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 5
SCENES = 4  # the test tool's synthetic split


def plain_tree(value):
    if isinstance(value, dict):
        return {k: plain_tree(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain_tree(v) for v in value]
    return value


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    """The reduced YAML and a folder of FRAMES clouds: one seeded scene,
    moved 0.3 m along x a frame."""
    root = tmp_path_factory.mktemp('tools')
    cfg = _reduce(cfg_from_yaml_file(CFG))
    cfg_file = root / 'pointpillar_small.yaml'
    cfg_file.write_text(yaml.safe_dump(plain_tree(cfg)))
    clouds = root / 'clouds'
    clouds.mkdir()
    points, _, _ = make_scene(np.random.RandomState(4),
                              np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                         np.float32))
    for t in range(FRAMES):
        moved = points.copy()
        moved[:, 0] += 0.3 * t
        moved.astype(np.float32).tofile(clouds / f'{t:06d}.bin')
    return root, cfg_file, clouds


def test_bag2json_matches_the_jax_tool(small, monkeypatch):
    root, cfg_file, clouds = small
    jcfg = jax_cfg_from_yaml(str(cfg_file))
    dataset = JaxDemoDataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                             root_path=str(clouds))
    model = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES),
                              jcfg.CLASS_NAMES, dataset.dataset_info)
    variables = jax.device_get(jit_init(
        model, device_batch(dataset.collate_batch([dataset[0]]))))
    rng = np.random.RandomState(0)
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)
    orbax_ckpt = jax_save(TrainState.create(params, stats, optax.identity()),
                          root / 'jax_ckpt', 1)
    pth = root / 'port_ckpt' / 'checkpoint_epoch_1.pth'
    pth.parent.mkdir()
    torch.save({'model': flax_to_state_dict(params, stats),
                'meta': {'epoch': 1}}, pth)

    spec = importlib.util.spec_from_file_location(
        'jax_inference_bag2json', ROOT / 'tools' / 'inference_bag2json.py')
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    want_file = root / 'jax.json'
    monkeypatch.setattr(sys, 'argv', [
        'inference_bag2json.py', '--cfg_file', str(cfg_file), '--data_path',
        str(clouds), '--ckpt', orbax_ckpt, '--output', str(want_file),
        '--cpu'])
    jax_tool.main()
    got_file = root / 'port.json'
    inference_bag2json.main(['--cfg_file', str(cfg_file), '--data_path',
                             str(clouds), '--ckpt', str(pth.parent),
                             '--output', str(got_file), '--cpu'])
    want = json.loads(want_file.read_text())
    got = json.loads(got_file.read_text())

    assert len(got) == len(want) == FRAMES
    tracks = 0
    for g, w in zip(got, want):
        assert g['timestamp'] == w['timestamp']
        assert len(g['detections']) == len(w['detections']) > 0
        assert [d['label'] for d in g['detections']] == \
            [d['label'] for d in w['detections']]
        np.testing.assert_allclose([d['box'] for d in g['detections']],
                                   [d['box'] for d in w['detections']],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose([d['score'] for d in g['detections']],
                                   [d['score'] for d in w['detections']],
                                   rtol=0, atol=1e-5)
        assert [o['id'] for o in g['tracked_objects']] == \
            [o['id'] for o in w['tracked_objects']]
        assert [o['type'] for o in g['tracked_objects']] == \
            [o['type'] for o in w['tracked_objects']]
        if g['tracked_objects']:
            np.testing.assert_allclose(
                [o['box'] for o in g['tracked_objects']],
                [o['box'] for o in w['tracked_objects']], rtol=0, atol=1e-4)
        tracks += len(g['tracked_objects'])
    assert tracks > 0  # tracks were confirmed and reported


@pytest.fixture(scope='module')
def ckpt_dir(small):
    """checkpoint_epoch_2.pth and _10.pth of the reduced config after one
    and two training steps, and an unfinished save."""
    root, cfg_file, _ = small
    trainer = Trainer(cfg_from_yaml_file(str(cfg_file)), device='cpu',
                      total_steps=2)
    scenes = [trainer.dataset(2, seed=1)[i] for i in range(2)]
    out = root / 'ckpt'
    for epoch in (2, 10):
        trainer.step(trainer.make_batch(scenes))
        save_checkpoint(trainer.state, out, epoch)
    (out / 'checkpoint_epoch_11.pth.77.tmp').write_bytes(b'')
    return out


def _eval_args(cfg_file, ckpt_dir, out, batch_size):
    return ['--cfg_file', str(cfg_file), '--cpu', '--synthetic',
            '--num_scenes', str(SCENES), '--batch_size', str(batch_size),
            '--eval_all', '--ckpt_dir', str(ckpt_dir), '--max_waiting_mins',
            '0', '--output_dir', str(out)]


def test_eval_all_evaluates_each_checkpoint_in_epoch_order(small, ckpt_dir):
    root, cfg_file, _ = small
    results = test_tool.main(_eval_args(cfg_file, ckpt_dir, root / 'one', 2))
    assert [tag for _, tag, _ in results] == ['epoch_2', 'epoch_10']
    cfg = cfg_from_yaml_file(str(cfg_file))
    classes = list(cfg.CLASS_NAMES)
    for ckpt, tag, result in results:
        assert Path(ckpt).name == f'checkpoint_{tag}.pth'
        model = build_detector(cfg, torch.device('cpu'), ckpt)
        _, loader = build_test_loader(cfg, 2, SCENES)
        want, annos = eval_one_epoch(model, loader, cfg.MODEL.POST_PROCESSING,
                                     classes, logging.getLogger('eval'))
        recall = [k for k in result if k.startswith('recall/')]
        assert recall and all(np.isfinite(result[k]) for k in recall)
        for key, value in want.items():
            if key != 'sec_per_example':
                assert result[key] == value, key
        with open(root / 'one' / 'eval' / tag / 'result.pkl', 'rb') as f:
            written = pickle.load(f)
        assert [a['frame_id'] for a in written] == list(range(SCENES))
        assert sum(len(a['name']) for a in written) > 0
        for g, w in zip(written, annos):
            np.testing.assert_array_equal(g['boxes_lidar'], w['boxes_lidar'])


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def test_eval_all_on_two_gloo_ranks_gives_one_process(small, ckpt_dir):
    root, cfg_file, _ = small
    one = root / 'one_b1'
    test_tool.main(_eval_args(cfg_file, ckpt_dir, one, 1))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(OMP_NUM_THREADS='1', PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
         '2', '--master_port', str(_free_port()), '-m',
         'lidardetection_tpu_torch.tools.test',
         *_eval_args(cfg_file, ckpt_dir, root / 'two', 1)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    from lidardetection_tpu_torch.datasets.synthetic import SyntheticScenes

    cfg = cfg_from_yaml_file(str(cfg_file))
    dataset, _ = build_test_loader(cfg, 1, SCENES)
    assert isinstance(dataset, SyntheticScenes)
    for tag in ('epoch_2', 'epoch_10'):
        parts = []
        for run in (one, root / 'two'):
            with open(run / 'eval' / tag / 'result.pkl', 'rb') as f:
                parts.append(pickle.load(f))
        got, want = parts
        assert [a['frame_id'] for a in got] == [a['frame_id'] for a in want] \
            == list(range(SCENES))
        for g, w in zip(got, want):
            assert list(g['name']) == list(w['name'])
            for key in ('boxes_lidar', 'score'):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           atol=1e-5, err_msg=key)
        assert dataset.evaluation(got, list(cfg.CLASS_NAMES)) == \
            dataset.evaluation(want, list(cfg.CLASS_NAMES))
    assert not (root / 'two' / 'eval' / 'epoch_2' / 'tmpdir').exists()
