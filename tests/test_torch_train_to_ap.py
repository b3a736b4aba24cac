"""The train-to-AP tool of the port (``python -m
lidardetection_tpu_torch.train_to_ap``), on the CPU at a reduced size.

* ``overfit_config`` makes the edits of the JAX package's harness
  (tools/train_to_ap.py:82-100): the voxel sizes and caps it gives for
  pointpillar.yaml and second.yaml.
* The whole loop at the reduced PointPillar of test_torch_train_step.py
  (2 scenes, 1 epoch, batch 2): it saves a checkpoint, restores it into a
  fresh model, runs precise-BN and eval, and prints a parseable gate line
  with every key; a second call on the same directory resumes (no epoch
  left to train) and gives the same AP.
"""

import json

import numpy as np
import pytest
import yaml

from lidardetection_tpu_torch import train_to_ap
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from test_torch_train_step import _reduce
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

GATE_KEYS = {'metric', 'value', 'unit', 'pass', 'scenes', 'epochs', 'device',
             'wall_s', 's_per_epoch', 'sec_per_example', 'num_candidates_p50',
             'num_candidates_max', 'recall_rcnn_0.7'}


@pytest.mark.parametrize('name,voxel_size,cap', [
    ('pointpillar', [0.32, 0.32, 4], 8000),
    ('second', [0.1, 0.1, 0.1], 24000),
])
def test_overfit_config_matches_the_jax_harness(name, voxel_size, cap):
    cfg = cfg_from_yaml_file(f'tools/cfgs/kitti_models/{name}.yaml')
    assert 'DATA_AUGMENTOR' in cfg.DATA_CONFIG
    out = train_to_ap.overfit_config(cfg)
    assert out is cfg
    data = cfg.DATA_CONFIG
    assert data.DATASET == 'SyntheticDataset' and 'DATA_AUGMENTOR' not in data
    vox = [p for p in data.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    np.testing.assert_allclose(vox.VOXEL_SIZE, voxel_size, rtol=1e-12)
    assert dict(vox.MAX_NUMBER_OF_VOXELS) == {'train': cap, 'test': cap}
    full = train_to_ap.overfit_config(
        cfg_from_yaml_file(f'tools/cfgs/kitti_models/{name}.yaml'),
        half_res=False)
    vox = [p for p in full.DATA_CONFIG.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    assert vox.VOXEL_SIZE[0] * 2 == voxel_size[0]


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _gate_line(text):
    lines = [ln for ln in text.splitlines() if ln.startswith('{')]
    assert len(lines) == 1, text
    return json.loads(lines[0])


def test_the_tool_trains_restores_recalibrates_and_evaluates(tmp_path, capsys):
    cfg = _reduce(cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml'),
                  'pointpillar')
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 40
    cfg_file = tmp_path / 'pointpillar_small.yaml'
    cfg_file.write_text(yaml.safe_dump(_plain(cfg)))
    out = tmp_path / 'run'
    argv = ['--cfg_file', str(cfg_file), '--scenes', '2', '--epochs', '1',
            '--batch_size', '2', '--device', 'cpu', '--output_dir', str(out),
            '--min_ap', '0']
    assert train_to_ap.main(argv) == 0
    gate = _gate_line(capsys.readouterr().out)
    assert set(gate) == GATE_KEYS
    assert gate['metric'] == 'train_to_ap_car_3d_moderate_R40'
    assert gate['unit'] == 'AP' and gate['pass'] is True
    assert (gate['scenes'], gate['epochs'], gate['device']) == (2, 1, 'cpu')
    assert 0.0 <= gate['value'] <= 100.0
    assert gate['s_per_epoch'] > 0 and gate['sec_per_example'] > 0
    assert 0 < gate['num_candidates_p50'] <= gate['num_candidates_max'] <= 256
    assert [p.name for p in (out / 'ckpt').iterdir()] == ['checkpoint_epoch_1.pth']
    assert (out / 'eval' / 'result.pkl').exists()

    # a second call resumes: nothing left to train, the same checkpoint
    assert train_to_ap.main(argv) == 0
    again = _gate_line(capsys.readouterr().out)
    assert again['s_per_epoch'] is None and again['value'] == gate['value']
    # the gate fails below --min_ap
    assert train_to_ap.main(argv[:-1] + ['101']) == 1
    assert _gate_line(capsys.readouterr().out)['pass'] is False
