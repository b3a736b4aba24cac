"""The NuScenes CBGS SECOND multi-head slice, port against the JAX package,
on the CPU in f32: nuscenes_models/cbgs_second_multihead.yaml
(VoxelResBackBone8x, 10 classes over 6 head groups, the 9-dim velocity
code with the heading by sine and cosine, WeightedL1, multi-class NMS) cut
to CPU size as tests/test_variant_configs.py cuts it: 0.8 m voxels over
the yaml's range (a 128 x 128 x 40 grid), a 3000-voxel cap, a narrow 2D
backbone and head.

Both packages read the same batch: the port's synthetic scenes with their
5 point columns (x, y, z, intensity and a zero timestamp) and gt boxes
with velocities, voxelized on the host. The JAX model is initialised on
it, so its first layer is 5 wide (its own synthetic set would give it 4
columns; ROADMAP.md section 3).

  * eval: ``Detector`` against ``make_eval_step``: the kept mask and labels
    equal, the kept boxes within 1e-4 and their scores within 1e-5;
  * training: one step of ``Trainer``'s model against
    ``make_train_step``'s pieces: the anchor labels equal, the loss terms
    within 1e-5 relative, the BatchNorm statistics within 1e-4 of each
    leaf's largest value, every gradient leaf within 2e-3 relative L2.
    The gt boxes take their class's anchor size, so that the head groups
    have positive anchors; the pedestrian and traffic-cone group's anchors
    are too small to reach an IoU with any box at this grid's 6.4 m BEV
    cells, so its regression leaves are 0 in both packages.
"""

import jax
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.parallel.train_step import (
    device_batch, jit_init, make_eval_step,
)
from lidardetection_tpu_torch.config import (
    cfg_from_yaml_file, dataset_info, voxel_processor_cfg,
)
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.datasets.synthetic import (
    SyntheticScenes, scene_options,
)
from lidardetection_tpu_torch.ops.voxelize import build_batch
from lidardetection_tpu_torch.parallel import train_step
from lidardetection_tpu_torch.serve import Detector
from lidardetection_tpu_torch.train import Trainer
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CFG = 'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml'


def _reduce(cfg):
    data = cfg.DATA_CONFIG
    data.DATASET = 'SyntheticDataset'
    if 'DATA_AUGMENTOR' in data:
        del data.DATA_AUGMENTOR
    data.MAX_GT_BOXES = 24
    vox = voxel_processor_cfg(data)
    vox.VOXEL_SIZE = [0.8, 0.8, 0.2]
    vox.MAX_NUMBER_OF_VOXELS = {'train': 3000, 'test': 3000}
    m = cfg.MODEL
    m.COMPUTE_DTYPE = 'float32'
    m.BACKBONE_2D.LAYER_NUMS = [1, 1]
    m.BACKBONE_2D.NUM_FILTERS = [32, 64]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [32, 32]
    m.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 16
    m.DENSE_HEAD.SEPARATE_REG_CONFIG.NUM_MIDDLE_FILTER = 16
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 20
    return cfg


def _randomize(tree, rng):
    """Random BN affines and statistics and small biases (the class
    convolutions' focal prior, -4.6, puts every score under SCORE_THRESH)."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, 'items'):
            out[key] = _randomize(value, rng)
        elif key in ('scale', 'var'):
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ('bias', 'mean'):
            out[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
        else:
            out[key] = np.asarray(value)
    return out


def _leaves(tree, prefix=''):
    for key, value in tree.items():
        if hasattr(value, 'items'):
            yield from _leaves(value, f'{prefix}{key}/')
        else:
            yield prefix + key, np.asarray(value)


def _class_sized(gt, head_cfg, rng):
    """Each gt box given its class's anchor size (within 10%) and height,
    and the classes dealt in turn, so every head group has positives (the
    synthetic scenes size every NuScenes class alike)."""
    gt = gt.copy()
    agc = head_cfg.ANCHOR_GENERATOR_CONFIG
    for s in range(len(gt)):
        live = np.flatnonzero(gt[s, :, -1] > 0)
        for i, j in enumerate(live):
            c = agc[i % len(agc)]
            size = np.array(c['anchor_sizes'][0]) * rng.uniform(0.9, 1.1)
            gt[s, j, 3:6] = size
            gt[s, j, 2] = c['anchor_bottom_heights'][0] + size[2] / 2
            gt[s, j, -1] = i % len(agc) + 1
    return gt


@pytest.fixture(scope='module')
def case():
    cfg = _reduce(cfg_from_yaml_file(CFG))
    info = dataset_info(cfg.DATA_CONFIG)
    assert info['num_point_features'] == 5
    dataset = SyntheticScenes(
        cfg.CLASS_NAMES, info['point_cloud_range'], num_scenes=2, seed=3,
        max_gt_boxes=24, **scene_options(cfg.DATA_CONFIG, 5))
    scenes = [dataset[i] for i in range(2)]
    assert scenes[0][0].shape[1] == 5 and scenes[0][1].shape == (24, 10)
    vox = voxel_processor_cfg(cfg.DATA_CONFIG)
    host = build_batch([points for points, _ in scenes],
                       info['point_cloud_range'], info['voxel_size'],
                       int(vox.MAX_POINTS_PER_VOXEL), 3000)
    host['gt_boxes'] = _class_sized(np.stack([gt for _, gt in scenes]),
                                    cfg.MODEL.DENSE_HEAD, rng=np.random.RandomState(1))
    assert (host['gt_boxes'][..., -1] > 0).sum() > 8

    jcfg = _reduce(jax_cfg_from_yaml(CFG))
    batch = device_batch(host)
    model = jax_build_network(jcfg.MODEL, 10, jcfg.CLASS_NAMES, info)
    variables = jax.device_get(jit_init(model, batch))
    rng = np.random.RandomState(0)
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)
    preds = jax.device_get(make_eval_step(
        model, jcfg.MODEL.POST_PROCESSING, 10)(params, stats, batch))

    def loss_fn(p):
        out, mutated = model.apply({'params': p, 'batch_stats': stats}, batch,
                                   training=True, mutable=['batch_stats'])
        loss, tb = model.apply({'params': p, 'batch_stats': stats}, out,
                               method=model.loss)
        return loss, (tb, mutated['batch_stats'],
                      out['anchor_head_fwd']['box_cls_labels'])

    (_, train), grads = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params))
    return {'host': host, 'params': params, 'stats': stats, 'preds': preds,
            'train': train, 'grads': grads}


def test_eval_matches_make_eval_step(case):
    det = Detector(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                   state_dict=flax_to_state_dict(case['params'], case['stats']))
    batch = {k: torch.from_numpy(case['host'][k])
             for k in ('voxels', 'voxel_coords', 'voxel_num_points',
                       'num_voxels')}
    got = det.postprocess(det.forward(batch))
    want = case['preds']
    assert got['pred_boxes'].shape == (2, 10 * 20, 9)
    np.testing.assert_array_equal(got['pred_mask'].numpy(), want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'].numpy(),
                                  want['pred_labels'])
    mask = want['pred_mask']
    assert mask.sum() > 20 and len(np.unique(want['pred_labels'][mask])) > 5
    np.testing.assert_allclose(got['pred_boxes'].numpy(), want['pred_boxes'],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got['pred_scores'].numpy(), want['pred_scores'],
                               rtol=0, atol=1e-5)


def test_one_step_matches_make_train_step_pieces(case):
    tb, new_stats, labels = case['train']
    trainer = Trainer(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                      state_dict=flax_to_state_dict(case['params'],
                                                    case['stats']),
                      total_steps=2)
    batch = train_step.device_batch(case['host'], 'cpu')
    out = trainer.model(batch)
    loss, got_tb = trainer.model.loss(out)
    loss.backward()
    np.testing.assert_array_equal(
        out['anchor_head_fwd']['box_cls_labels'].numpy(), labels)
    assert (labels > 0).sum() > 10
    assert set(got_tb) == set(tb)
    for key, want in tb.items():
        np.testing.assert_allclose(float(got_tb[key].detach()), float(want),
                                   rtol=1e-5, err_msg=key)
    got_stats, = state_dict_to_flax(trainer.model.state_dict(), new_stats)
    for (key, g), (_, w) in zip(_leaves(got_stats), _leaves(new_stats)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)
    named = dict(trainer.model.named_parameters())
    got_grads, = state_dict_to_flax({k: p.grad for k, p in named.items()},
                                    case['grads'])
    n, zero = 0, []
    for (key, g), (_, w) in zip(_leaves(got_grads), _leaves(case['grads'])):
        # exactly 0 where JAX's is 0: a head with no positive anchor
        assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w), key
        if np.linalg.norm(w) == 0:
            zero.append(key)
        n += 1
    assert n == len(named)
    assert all(k.startswith('dense_head/rpn_heads_5/') for k in zero), zero
