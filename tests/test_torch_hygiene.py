"""The port stands alone: it imports nothing of JAX, flax or the JAX
package, and its entry point runs on the card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.datasets.synthetic import make_scene
    from lidardetection_tpu_torch.serve import Detector

    cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/%(name)s.yaml')
    vox = cfg.DATA_CONFIG.DATA_PROCESSOR[-1]
    vox.VOXEL_SIZE = %(voxel_size)s
    vox.MAX_NUMBER_OF_VOXELS = {'train': 2000, 'test': 2000}
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -40.96, -3, 71.68, 40.96, 1]
    cfg.MODEL.BACKBONE_2D.LAYER_NUMS = %(layer_nums)s
    det = Detector(cfg, device='cpu')
    points, _, _ = make_scene(np.random.RandomState(0),
                              det.info['point_cloud_range'], num_ground=2000)
    det.predict([points])
    leaked = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                           'lidardetection_tpu'))
    print('LEAKED', leaked)
''')


@pytest.mark.parametrize('name,voxel_size,layer_nums', [
    ('pointpillar', [0.64, 0.64, 4], [0, 0, 0]),
    ('second', [0.32, 0.32, 0.1], [0, 0]),
])
def test_port_imports_no_jax(name, voxel_size, layer_nums):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = str(ROOT)
    script = _SCRIPT % {'name': name, 'voxel_size': voxel_size,
                        'layer_nums': layer_nums}
    proc = subprocess.run([sys.executable, '-c', script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'LEAKED []' in proc.stdout, proc.stdout


@pytest.mark.parametrize('name', ['pointpillar', 'second'])
def test_default_device_is_cuda(name):
    from lidardetection_tpu_torch.serve import Detector

    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Detector(f'tools/cfgs/kitti_models/{name}.yaml')


def test_kernel_wrappers_reject_other_devices():
    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import rulebook_conv
    from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe

    meta = torch.device('meta')
    with pytest.raises(ValueError, match='cpu or cuda'):
        rulebook_conv(torch.zeros((1, 4, 8), device=meta),
                      torch.zeros((1, 4, 27), dtype=torch.int32, device=meta),
                      torch.zeros((27, 8, 16), device=meta))
    with pytest.raises(ValueError, match='cpu or cuda'):
        scatter_rows(torch.zeros((1, 4, 8), device=meta),
                     torch.zeros((1, 4), dtype=torch.int32, device=meta), 10)
    with pytest.raises(ValueError, match='cpu or cuda'):
        pillar_vfe(torch.zeros((1, 4, 8, 4), device=meta),
                   torch.zeros((1, 4, 4), device=meta),
                   torch.zeros((1, 4, 16), device=meta),
                   torch.zeros((1, 4), dtype=torch.int32, device=meta),
                   torch.zeros((4, 16), device=meta),
                   torch.zeros((16,), device=meta))
