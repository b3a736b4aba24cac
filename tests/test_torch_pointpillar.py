"""The PointPillar serving slice, port against the JAX package, on the CPU.

Both packages read the JAX package's own ``build_dataloader`` batch and the
same weights (flax variables converted with ``flax_to_state_dict``), at a
reduced size: 0.64 m pillars, LAYER_NUMS [1, 1, 1], narrow filters, f32
compute. The head output ``batch_fused_preds`` must agree within 1e-4 (the
same f32 math in another summation order), and the post-processed
detections of ``make_eval_step`` exactly in count and labels and within
1e-4 in boxes and scores.
"""

import jax
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.parallel.train_step import (
    device_batch, jit_init, make_eval_step,
)
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict
from lidardetection_tpu_torch.core.box_coders import ResidualCoder
from lidardetection_tpu_torch.models.dense_heads.anchor_generator import (
    generate_anchors,
)
from lidardetection_tpu_torch.serve import Detector

CFG = 'tools/cfgs/kitti_models/pointpillar.yaml'


def _reduce(cfg):
    """Cut to CPU size; the range is widened so the grid divides by 8."""
    data = cfg.DATA_CONFIG
    data.DATASET = 'SyntheticDataset'
    data.POINT_CLOUD_RANGE = [0, -40.96, -3, 71.68, 40.96, 1]
    data.MAX_POINTS = 24000
    if 'DATA_AUGMENTOR' in data:
        del data.DATA_AUGMENTOR
    vox = [p for p in data.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    vox.VOXEL_SIZE = [0.64, 0.64, 4]
    vox.MAX_NUMBER_OF_VOXELS = {'train': 6000, 'test': 6000}
    m = cfg.MODEL
    m.COMPUTE_DTYPE = 'float32'
    m.VFE.NUM_FILTERS = [32]
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.LAYER_NUMS = [1, 1, 1]
    m.BACKBONE_2D.NUM_FILTERS = [32, 32, 64]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [32, 32, 32]
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 1024
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 100
    return cfg


def _randomize(tree, rng):
    """Random BN affines and statistics; class bias 0 so NMS sees live
    candidates (the focal init puts every score under SCORE_THRESH)."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, 'items'):
            out[key] = _randomize(value, rng)
        elif key in ('scale', 'var', 'pfn_bn_scale', 'pfn_var'):
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ('bias', 'mean', 'pfn_bn_bias', 'pfn_mean'):
            out[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
        elif key == 'conv_cls_bias':
            out[key] = np.zeros(value.shape, np.float32)
        else:
            out[key] = np.asarray(value)
    return out


@pytest.fixture(scope='module')
def jax_run():
    cfg = _reduce(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=False,
                                       num_scenes=2, seed=3)
    batch = device_batch(next(iter(loader)))
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    variables = jax.device_get(jit_init(model, batch))
    rng = np.random.RandomState(0)
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)
    fused = jax.jit(lambda p, s, b: model.apply(
        {'params': p, 'batch_stats': s}, b,
        training=False)['batch_fused_preds'])(params, stats, batch)
    step = make_eval_step(model, cfg.MODEL.POST_PROCESSING,
                          len(cfg.CLASS_NAMES))
    preds = jax.device_get(step(params, stats, batch))
    return batch, params, stats, np.asarray(fused), preds


def test_pointpillar_slice_matches_make_eval_step(jax_run):
    batch, params, stats, want_fused, want = jax_run
    det = Detector(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                   state_dict=flax_to_state_dict(params, stats))
    tbatch = {k: torch.from_numpy(np.asarray(batch[k]))
              for k in ('voxels', 'voxel_coords', 'voxel_num_points')}
    out = det.forward(tbatch)
    got = det.postprocess(out)

    np.testing.assert_allclose(out['batch_fused_preds'].numpy(), want_fused,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got['num_preds'].numpy(),
                                  np.asarray(want['num_preds']))
    assert (got['num_candidates'] > 0).all() and (got['num_preds'] > 1).all()
    np.testing.assert_array_equal(got['pred_mask'].numpy(), want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'].numpy(),
                                  want['pred_labels'])
    np.testing.assert_allclose(got['pred_scores'].numpy(), want['pred_scores'],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got['pred_boxes'].numpy(), want['pred_boxes'],
                               rtol=0, atol=1e-4)


def test_predict_returns_trimmed_detections(jax_run):
    _, params, stats, _, want = jax_run
    det = Detector(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                   state_dict=flax_to_state_dict(params, stats))
    rng = np.random.RandomState(5)
    from lidardetection_tpu_torch.datasets.synthetic import make_scene
    points, _, _ = make_scene(rng, np.asarray(det.info['point_cloud_range']))
    (result,) = det.predict([points])
    n = len(result['boxes'])
    assert 0 < n <= 100 and result['boxes'].shape == (n, 7)
    assert result['scores'].shape == (n,) and (np.diff(result['scores']) <= 0).all()
    assert set(np.unique(result['labels'])) <= {1, 2, 3}


def test_anchors_and_decode_match_jax():
    from lidardetection_tpu.core.box_coders import ResidualCoder as JaxCoder
    from lidardetection_tpu.models.dense_heads.anchor_generator import (
        generate_anchors as jax_generate_anchors,
    )

    cfg = cfg_from_yaml_file(CFG).MODEL.DENSE_HEAD
    grid, pcr = (432, 496, 1), (0, -39.68, -3, 69.12, 39.68, 1)
    for got, want in zip(generate_anchors(cfg.ANCHOR_GENERATOR_CONFIG, grid, pcr)[0],
                         jax_generate_anchors(cfg.ANCHOR_GENERATOR_CONFIG, grid, pcr)[0]):
        np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(0)
    enc = (rng.randn(50, 7) * 0.3).astype(np.float32)
    anchors = np.abs(rng.randn(50, 7)).astype(np.float32) + 0.5
    want = np.asarray(JaxCoder().decode(enc, anchors))
    got = ResidualCoder().decode(torch.from_numpy(enc), torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ResidualCoder().encode(got, torch.from_numpy(anchors)).numpy(), enc,
        rtol=0, atol=1e-5)
