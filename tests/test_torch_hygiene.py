"""The port stands alone: it imports nothing of JAX, flax, optax or the JAX
package, and its entry points run on the card unless asked for the CPU."""

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
    %(setup)s
    det = Detector(cfg, device='cpu')
    points, _, _ = make_scene(np.random.RandomState(0),
                              det.info['point_cloud_range'], num_ground=2000)
    det.predict([points])
    import tempfile
    from lidardetection_tpu_torch.datasets.synthetic import (
        SyntheticScenes, SyntheticLoader,
    )
    from lidardetection_tpu_torch.train import Trainer, main
    trainer = Trainer(cfg, device='cpu')
    dataset = SyntheticScenes(trainer.class_names, det.info['point_cloud_range'],
                               num_scenes=2)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer.fit(SyntheticLoader(dataset, 2, trainer.make_batch), ckpt_dir,
                    total_epochs=1)
    assert trainer.state.step == 1
    import pkgutil, importlib, lidardetection_tpu_torch
    for mod in pkgutil.walk_packages(lidardetection_tpu_torch.__path__,
                                     'lidardetection_tpu_torch.'):
        importlib.import_module(mod.name)
    leaked = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                           'orbax', 'lidardetection_tpu',
                                           'tools', 'cv2', 'matplotlib',
                                           'PIL', 'vispy'))
    print('LEAKED', leaked)
''')


# Part-A²'s RoI head at a small grid and few RoIs (at its 12^3 grids and
# 128 RoIs a CPU step takes minutes)
_SMALL_ROI_HEAD = ('roi = cfg.MODEL.ROI_HEAD; roi.ROI_AWARE_POOL.POOL_SIZE = 4; '
                   'roi.TARGET_CONFIG.ROI_PER_IMAGE = 16; '
                   'roi.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 64')
# PointRCNN at tests/test_pointrcnn_e2e.py's size (it has no voxelizer)
_SMALL_POINTRCNN = '\n'.join((
    "cfg.DATA_CONFIG.MAX_POINTS = 1024",
    "cfg.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {'train': 1024, 'test': 1024}",
    "m = cfg.MODEL",
    "m.BACKBONE_3D.SA_CONFIG.NPOINTS = [256, 64, 16, 8]",
    "m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 64",
    "m.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16",
    "m.ROI_HEAD.ROI_POINT_POOL.NUM_SAMPLED_POINTS = 64",
    "m.ROI_HEAD.SA_CONFIG.NPOINTS = [32, 16, -1]"))


def _voxel_setup(voxel_size, layer_nums, extra=''):
    return '\n'.join((
        'vox = cfg.DATA_CONFIG.DATA_PROCESSOR[-1]',
        f'vox.VOXEL_SIZE = {voxel_size}',
        "vox.MAX_NUMBER_OF_VOXELS = {'train': 2000, 'test': 2000}",
        'cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -40.96, -3, 71.68, 40.96, 1]',
        f'cfg.MODEL.BACKBONE_2D.LAYER_NUMS = {layer_nums}', extra))


@pytest.mark.parametrize('name,setup', [
    ('pointpillar', _voxel_setup([0.64, 0.64, 4], [0, 0, 0])),
    ('second', _voxel_setup([0.32, 0.32, 0.1], [0, 0])),
    ('PartA2', _voxel_setup([0.32, 0.32, 0.1], [0, 0], _SMALL_ROI_HEAD)),
    ('pointrcnn', _SMALL_POINTRCNN),
], ids=['pointpillar', 'second', 'PartA2', 'pointrcnn'])
def test_port_imports_no_jax(name, setup):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = str(ROOT)
    env['OMP_NUM_THREADS'] = '2'  # as torch_threads.py: six files at once
    script = _SCRIPT % {'name': name, 'setup': setup}
    proc = subprocess.run([sys.executable, '-c', script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'LEAKED []' in proc.stdout, proc.stdout


@pytest.mark.parametrize('name', ['pointpillar', 'second', 'pv_rcnn',
                                  'PartA2', 'pointrcnn'])
def test_default_device_is_cuda(name):
    from lidardetection_tpu_torch.serve import Detector

    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Detector(f'tools/cfgs/kitti_models/{name}.yaml')


def test_train_cli_refuses_to_start_without_cuda():
    from lidardetection_tpu_torch import train

    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train.main(['--num_steps', '1'])


def test_sources_name_no_jax_module():
    """No source file of the port imports jax, flax, optax, orbax, the JAX
    package or the repository's tools/, in any function either (the
    subprocess above only sees the imports that ran)."""
    import re

    pattern = re.compile(
        r'^\s*(?:from|import)\s+'
        r'(jax|jaxlib|flax|optax|orbax|lidardetection_tpu|tools)\b',
        re.MULTILINE)
    sources = sorted((ROOT / 'lidardetection_tpu_torch').rglob('*.py'))
    sources.append(ROOT / 'chip_smoke.py')
    assert len(sources) > 30
    for path in sources:
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize('name', ['TRAIN', 'PVRCNN', 'PARTA2'])
def test_unported_paths_raise_with_the_roadmap_item(name):
    """The three paths that raised naming the variants now run: the
    multiframe enlarged anchor targets (TRAIN), the tracking targets of
    the PV-RCNN RoI head (PVRCNN, whose training forward still refuses to
    run without a source of draws) and Part-A²'s RoI head without part
    features (PARTA2, the anchor-free PartA2_free.yaml)."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
    from lidardetection_tpu_torch.models import build_network
    from lidardetection_tpu_torch.models.dense_heads.anchor_head import (
        AnchorHeadSingle,
    )

    gt = torch.zeros(1, 4, 8)
    gt[0, :2] = torch.tensor([[8.0, 0.0, -1.0, 3.9, 1.6, 1.5, 0.3, 1],
                              [16.0, 4.0, -1.0, 0.8, 0.6, 1.7, -1.0, 2]])
    loc = gt[..., None, 0:3].repeat(1, 1, 3, 1)
    loc[..., 0, 0] -= 2.0  # moved 1 m a frame along x
    loc[..., 1, 0] -= 1.0
    roty = gt[..., 6, None].repeat(1, 1, 3)
    if name == 'PVRCNN':
        from lidardetection_tpu_torch.models.roi_heads import roi_head_utils
        cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/pv_rcnn.yaml')
        model = build_network(cfg.MODEL, 3, dataset_info(cfg.DATA_CONFIG))
        with pytest.raises(ValueError, match='draw'):  # no source of draws
            model.roi_head.train()({'batch_box_preds': torch.zeros(1, 4, 7),
                                    'batch_cls_preds': torch.zeros(1, 4, 3)})
        tracking = {**cfg.MODEL.ROI_HEAD.TARGET_CONFIG, 'ROI_PER_IMAGE': 4,
                    'REG_TRACKING_INFO': True}
        rois = gt[..., :7].clone()
        rois[..., 0] += 0.1
        draws = {n: torch.rand(1, 4) for n, _ in roi_head_utils.SAMPLE_DRAWS}
        t = roi_head_utils.assign_roi_targets(draws, {
            'rois': rois, 'roi_scores': torch.ones(1, 4),
            'roi_labels': gt[..., -1].int(), 'roi_valid': gt[..., -1] > 0,
            'gt_boxes': gt, 'locations': loc, 'rotations_y': roty}, tracking)
        # the box, its class, then the two displacements and two headings
        assert t['gt_of_rois'].shape == (1, 4, 16)
        kept = t['gt_of_rois'][0][t['reg_valid_mask'][0] > 0]
        assert len(kept) > 0
        assert torch.allclose(kept[:, 8:14], torch.tensor([1.0, 0, 0] * 2))
        return
    if name == 'PARTA2':  # the anchor-free variant's RoI head
        cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/PartA2_free.yaml')
        cfg.MODEL.ROI_HEAD.ROI_AWARE_POOL.POOL_SIZE = 4  # a small first FC
        model = build_network(cfg.MODEL, 3, dataset_info(cfg.DATA_CONFIG))
        assert model.roi_head.model_cfg.DISABLE_PART
        assert model.point_head.box_layers is not None
        coords = torch.rand(1, 500, 3) * torch.tensor([20.0, 10.0, 2.0])
        out = model.roi_head({
            'batch_box_preds': torch.cat([gt[..., :7], gt[..., :7]], 1),
            'batch_cls_preds': torch.randn(1, 8, 3), 'point_coords': coords,
            'point_valid': torch.ones(1, 500, dtype=torch.bool),
            'point_cls_scores': torch.rand(1, 500),
            'point_features': torch.randn(1, 500, 16)})
        assert torch.isfinite(out['batch_box_preds']).all()
        assert out['batch_box_preds'].shape[-1] == 7
        return
    cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml')
    head_cfg = cfg.MODEL.DENSE_HEAD
    head_cfg.USE_MULTIFRAME_ENLARGED_GT_BOXES = True
    head = AnchorHeadSingle(head_cfg, 8, 3, (32, 32, 1),
                            (0, -12.8, -3, 25.6, 12.8, 1)).train()
    out = head({'spatial_features_2d': torch.zeros(1, 16, 16, 8),
                'gt_boxes': gt, 'locations': loc, 'rotations_y': roty})
    enlarged = out['gt_boxes_enlarged']
    # the swept box is 2 m longer along its heading's x, as wide or wider
    assert enlarged[0, 0, 3] > gt[0, 0, 3] + 1.5
    assert (enlarged[0, :2, 4] >= gt[0, :2, 4] - 1e-6).all()
    assert (out['anchor_head_fwd']['box_cls_labels'] > 0).any()


def test_kernel_wrappers_reject_other_devices():
    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows
    from lidardetection_tpu_torch.ops.select_cuda import ball_select
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv, rulebook_conv_dw,
    )
    from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe

    meta = torch.device('meta')
    with pytest.raises(ValueError, match='cpu or cuda'):
        rulebook_conv(torch.zeros((1, 4, 8), device=meta),
                      torch.zeros((1, 4, 27), dtype=torch.int32, device=meta),
                      torch.zeros((27, 8, 16), device=meta))
    with pytest.raises(ValueError, match='cpu or cuda'):
        rulebook_conv_dw(torch.zeros((1, 4, 8), device=meta),
                         torch.zeros((1, 4, 27), dtype=torch.int32, device=meta),
                         torch.zeros((1, 4, 16), device=meta))
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
    runs = torch.zeros((1, 4, 9), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match='cpu or cuda'):
        ball_select(torch.zeros((1, 64, 3), device=meta),
                    torch.zeros((1, 64), dtype=torch.int32, device=meta),
                    runs, runs, torch.zeros((1, 4, 3), device=meta),
                    (0.4, 0.8), (16, 16), 192)


def test_new_modules_are_walked():
    """The fork's datasets, their generators, the process group, the tools,
    the tracker and the visualiser are among the sources the no-JAX checks
    read (the subprocess's walk imports each of them)."""
    modules = ('datasets/plusai/plusai_dataset.py',
               'datasets/plusai/plusai_bag_dataset.py',
               'datasets/plusai/fake_lidar_dataset/gen_fake_lidar.py',
               'datasets/plusai/mot_dataset/gen_mot_dataset.py',
               'datasets/livox/livox_dataset.py',
               'datasets/mix_data/mix_dataset.py',
               'datasets/mix_data/gen_mix_dataset.py',
               'utils/calibration_plusai.py', 'parallel/dist.py',
               'utils/tracker_for_inference.py', 'utils/data_viz.py',
               'tools/common.py', 'tools/test.py', 'tools/demo.py',
               'tools/inference.py', 'tools/inference_video.py',
               'tools/mot_benchmark.py', 'tools/inference_bag2json.py',
               'tools/demo_3d.py', 'tools/verify_cuda.py',
               'tools/visual_utils/visualize_utils.py',
               'tools/visual_utils/laserdetvis.py')
    sources = set((ROOT / 'lidardetection_tpu_torch').rglob('*.py'))
    for name in modules:
        assert ROOT / 'lidardetection_tpu_torch' / name in sources, name


def test_every_config_names_a_registered_dataset():
    """``dataset_class`` resolves the DATASET of every config under
    tools/cfgs/ to a class of that name."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.datasets import DATASETS, dataset_class

    paths = sorted((ROOT / 'tools' / 'cfgs').rglob('*.yaml'))
    names = set()
    cwd = os.getcwd()
    os.chdir(ROOT)  # the _BASE_CONFIG_ paths
    try:
        for path in paths:
            cfg = cfg_from_yaml_file(str(path))
            names.add((cfg.get('DATA_CONFIG') or cfg)['DATASET'])
    finally:
        os.chdir(cwd)
    assert len(paths) >= 17
    assert names == {'KittiDataset', 'NuScenesDataset', 'LivoxDataset',
                     'PlusAIMultiframeDataset', 'MixDataset'}
    for name in set(DATASETS) | names:
        assert dataset_class(name).__name__ == name
    with pytest.raises(NotImplementedError, match='no dataset'):
        dataset_class('WaymoDataset')
