"""The data layer's slice as a whole, on a KITTI tree the test writes (4
train and 2 val frames of a 32-beam scan, ~16k returns each, with the
port's infos and gt database):

* evaluation from files: the reduced PointPillar of test_torch_eval.py
  with the same random weights through each package's
  ``build_dataloader(training=False, model_cfg=...)`` and
  ``eval_one_epoch`` over the val split: the same detections per frame,
  boxes within 1e-4 and scores within 1e-5 (test_torch_eval.py's
  tolerances), the same recall counters and every AP key within 0.01;
* training from files: ``train.main(['--data_path', root, '--device',
  'cpu', ...])`` on a reduced second.yaml (the full augmentor, two forked
  loader workers) takes 2 steps with finite losses, saves a checkpoint
  (its step count 2, finite parameters), evaluates the val split through
  the KITTI protocol, and a second run on the same directory resumes from
  the checkpoint and takes 2 more (step count 4).
"""

import logging
import math
import re

import jax
import numpy as np
import pytest
import torch
import yaml

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import build_dataloader as jax_build_dataloader
from lidardetection_tpu.engine.evaluator import eval_one_epoch as jax_eval_one_epoch
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.parallel.train_step import device_batch, jit_init
from lidardetection_tpu_torch import train
from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
from lidardetection_tpu_torch.convert import flax_to_state_dict
from lidardetection_tpu_torch.datasets import build_dataloader, synthetic_trees
from lidardetection_tpu_torch.datasets.kitti import kitti_dataset
from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
from lidardetection_tpu_torch.models import build_network
from test_torch_eval import _eval_cfg, _randomize
from test_torch_kitti_dataset import CLASSES, SENSOR
from test_torch_train_step import _reduce
from torch_threads import two_torch_threads  # noqa: F401

NUM_TRAIN, NUM_VAL = 4, 2


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti_slice')
    synthetic_trees.write_kitti_tree(root, NUM_TRAIN, NUM_VAL, seed=9,
                                     sensor=SENSOR)
    cfg = cfg_from_yaml_file('tools/cfgs/dataset_configs/kitti_dataset.yaml')
    kitti_dataset.create_kitti_infos(cfg, CLASSES, root, root, workers=1)
    return root


def _from_files(cfg, root):
    cfg = _eval_cfg(cfg)
    cfg.DATA_CONFIG.DATASET = 'KittiDataset'
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    return cfg


def test_eval_from_files_matches_jax(tree):
    logger = logging.getLogger('test_torch_data_slice')
    cfg = _from_files(jax_cfg_from_yaml('tools/cfgs/kitti_models/pointpillar.yaml'),
                      tree)
    dataset, loader = jax_build_dataloader(cfg.DATA_CONFIG, CLASSES, NUM_VAL,
                                           training=False, model_cfg=cfg.MODEL)
    model = jax_build_network(cfg.MODEL, len(CLASSES), CLASSES,
                              dataset.dataset_info)
    variables = jax.device_get(jit_init(model, device_batch(next(iter(loader)))))
    rng = np.random.RandomState(0)
    variables = {'params': _randomize(variables['params'], rng),
                 'batch_stats': _randomize(variables['batch_stats'], rng)}
    want, want_annos = jax_eval_one_epoch(
        model, variables, loader, cfg.MODEL.POST_PROCESSING, CLASSES, logger)

    pcfg = _from_files(cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml'),
                       tree)
    pmodel = build_network(pcfg.MODEL, 3, dataset_info(pcfg.DATA_CONFIG))
    pmodel.load_state_dict(flax_to_state_dict(variables['params'],
                                              variables['batch_stats']))
    _, ploader = build_dataloader(pcfg.DATA_CONFIG, CLASSES, NUM_VAL,
                                  training=False, model_cfg=pcfg.MODEL,
                                  workers=0)
    got, annos = eval_one_epoch(pmodel, ploader, pcfg.MODEL.POST_PROCESSING,
                                CLASSES, logger)

    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith('recall/'):
            assert got[key] == value, key
        elif key != 'sec_per_example':
            assert abs(float(got[key]) - float(value)) <= 0.01, key
    assert len(annos) == len(want_annos) == NUM_VAL
    n_dets = 0
    for a, w in zip(annos, want_annos):
        assert a['frame_id'] == w['frame_id']
        np.testing.assert_array_equal(a['name'], w['name'])
        np.testing.assert_allclose(a['score'], w['score'], rtol=0, atol=1e-5)
        np.testing.assert_allclose(a['boxes_lidar'], w['boxes_lidar'], rtol=0,
                                   atol=1e-4)
        n_dets += len(a['name'])
    assert n_dets > NUM_VAL


def _plain(tree):
    """A config as plain dicts and lists, for yaml."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def test_train_cli_from_files(tree, tmp_path):
    cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/second.yaml')
    augmentor = _plain(cfg.DATA_CONFIG.DATA_AUGMENTOR)
    cfg = _reduce(cfg, 'second')
    cfg.DATA_CONFIG.DATASET = 'KittiDataset'
    cfg.DATA_CONFIG.DATA_AUGMENTOR = augmentor
    cfg_file = tmp_path / 'second_reduced.yaml'
    cfg_file.write_text(yaml.safe_dump(_plain(cfg)))
    out = tmp_path / 'run'
    argv = ['--cfg_file', str(cfg_file), '--data_path', str(tree), '--device',
            'cpu', '--batch_size', '2', '--workers', '2', '--output_dir',
            str(out)]
    for epochs in (1, 2):
        result = train.main(argv + ['--epochs', str(epochs)])
        saved = torch.load(out / 'ckpt' / f'checkpoint_epoch_{epochs}.pth',
                           weights_only=True)
        assert saved['step'] == 2 * epochs
        assert all(torch.isfinite(v).all() for v in saved['model'].values())
        assert 'Car_3d/moderate_R40' in result and result['sec_per_example'] > 0
    assert (out / 'eval' / 'result.pkl').exists()
    log = ''.join(p.read_text() for p in sorted(out.glob('log_train_*.txt')))
    assert 'resumed from' in log and '2 loader workers' in log
    # the first step of each epoch is logged, and each epoch's mean
    losses = [float(x) for x in re.findall(r'loss (\S+) lr', log)
              + re.findall(r'mean logged loss (\S+)\)', log)]
    assert len(losses) == 4 and all(math.isfinite(v) for v in losses)
