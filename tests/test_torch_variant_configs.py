"""Every model config under tools/cfgs/*_models/ in the port alone, on the
CPU: it builds, serves one request through ``serve.Detector`` and takes
one finite training step through ``train.Trainer`` on its own synthetic
scenes (its point width, velocities and frame poses), cut to CPU size as
tests/test_variant_configs.py cuts the JAX package's: a 64 x 64 BEV grid
over the config's range (z kept), a 1000-voxel cap, 2048 raw points, 256
keypoints, 32 proposals and 16 sampled RoIs, f32. The parity with the
JAX package is held per module and per slice in the other
test_torch_*.py files.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.serve import Detector
from lidardetection_tpu_torch.train import Trainer
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in ROOT.glob('tools/cfgs/*_models/*.yaml'))


def shrink(cfg):
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    data = cfg.DATA_CONFIG
    if 'DATA_AUGMENTOR' in data:
        del data.DATA_AUGMENTOR
    data.MAX_POINTS = 2048
    pillar = cfg.MODEL.get('MAP_TO_BEV', {}).get('NAME') == 'PointPillarScatter'
    pcr = data.POINT_CLOUD_RANGE
    for p in data.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1000, 'test': 1000}
            # a grid the BEV backbone's strides divide; the z voxel kept,
            # so HeightCompression's width stays the config's
            p.VOXEL_SIZE = [(pcr[3] - pcr[0]) / 64.0, (pcr[4] - pcr[1]) / 64.0,
                            pcr[5] - pcr[2] if pillar else p.VOXEL_SIZE[2]]
        if p.NAME == 'sample_points':
            p.NUM_POINTS = {'train': 2048, 'test': 2048}
    m = cfg.MODEL
    if m.get('BACKBONE_3D', {}).get('NAME') == 'PointNet2MSG':
        m.BACKBONE_3D.SA_CONFIG.NPOINTS = [256, 64, 16, 8]
    if 'PFE' in m:
        m.PFE.NUM_KEYPOINTS = 256
    if 'ROI_HEAD' in m:
        rh = m.ROI_HEAD
        for phase in ('TRAIN', 'TEST'):
            rh.NMS_CONFIG[phase].NMS_PRE_MAXSIZE = 256
            rh.NMS_CONFIG[phase].NMS_POST_MAXSIZE = 32
        rh.TARGET_CONFIG.ROI_PER_IMAGE = 16
        if 'ROI_AWARE_POOL' in rh:
            rh.ROI_AWARE_POOL.POOL_SIZE = 6
        if 'ROI_POINT_POOL' in rh:
            rh.ROI_POINT_POOL.NUM_SAMPLED_POINTS = 64
        if 'SA_CONFIG' in rh:
            rh.SA_CONFIG.NPOINTS = [32, 16, -1]
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 128
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 16
    return cfg


def test_every_model_config_is_listed():
    assert len(CONFIGS) == 15
    assert 'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml' in CONFIGS


@pytest.mark.parametrize('cfg_file', CONFIGS)
def test_config_builds_serves_and_steps(cfg_file):
    det = Detector(shrink(cfg_from_yaml_file(cfg_file)), device='cpu')
    points = det.scene(np.random.RandomState(0))
    assert points.shape[1] == det.info['num_point_features']
    (result,) = det.predict([points])
    n = len(result['boxes'])
    assert result['scores'].shape == result['labels'].shape == (n,)
    assert np.isfinite(result['boxes']).all()
    assert set(result['labels'].tolist()) <= set(
        range(1, len(det.cfg['CLASS_NAMES']) + 1))

    trainer = Trainer(shrink(cfg_from_yaml_file(cfg_file)), device='cpu',
                      total_steps=2)
    dataset = trainer.dataset(2, seed=1)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    tb = trainer.step(trainer.make_batch([dataset[0], dataset[1]]))
    assert np.isfinite(float(tb['loss'])) and float(tb['loss']) > 0
    after = trainer.model.state_dict()
    assert all(torch.isfinite(v).all() for v in after.values())
    assert sum(not torch.equal(before[k], after[k]) for k in before) \
        > len(before) // 2
