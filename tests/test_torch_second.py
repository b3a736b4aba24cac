"""The SECOND serving slice, port against the JAX package, on the CPU.

Module by module (MeanVFE, VoxelBackBone8x and its residual variant,
HeightCompression) on small tables made from a numpy seed, then the whole
detector on the JAX package's own ``build_dataloader`` batch with converted
weights, at a reduced size: 0.2 m voxels (grid 352 x 400 x 40, the full
depth, so the z chain 41/21/11/5/2 is the real one), 2000-voxel cap, f32.

Integer results (stage coords and counts) must be equal. Float results
agree within 1e-4: the same f32 math in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.models.backbones_2d.map_to_bev import (
    HeightCompression as JaxHeightCompression,
)
from lidardetection_tpu.models.backbones_3d.spconv_backbone import (
    VoxelBackBone8x as JaxVoxelBackBone8x,
)
from lidardetection_tpu.models.backbones_3d.vfe import MeanVFE as JaxMeanVFE
from lidardetection_tpu.parallel.train_step import (
    device_batch, jit_init, make_eval_step,
)
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict
from lidardetection_tpu_torch.models.backbones_2d.map_to_bev import HeightCompression
from lidardetection_tpu_torch.models.backbones_3d.spconv_backbone import VoxelBackBone8x
from lidardetection_tpu_torch.models.backbones_3d.vfe import MeanVFE
from lidardetection_tpu_torch.ops.sparse_conv_cuda import rulebook_conv
from lidardetection_tpu_torch.serve import Detector

CFG = 'tools/cfgs/kitti_models/second.yaml'


def _randomize(tree, rng):
    """Random BN affines and statistics; class bias 0 so NMS sees live
    candidates (the focal init puts every score under SCORE_THRESH)."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, 'items'):
            out[key] = _randomize(value, rng)
        elif key in ('scale', 'var'):
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ('bias', 'mean'):
            out[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
        elif key == 'conv_cls_bias':
            out[key] = np.zeros(value.shape, np.float32)
        else:
            out[key] = np.asarray(value)
    return out


def _voxel_table(seed, grid_size, b=2, v=400, fill=(330, 250), c=4):
    """Unique random voxels in arrival (unsorted) order, -1 padded."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = grid_size
    coords = np.full((b, v, 3), -1, np.int32)
    feats = np.zeros((b, v, c), np.float32)
    for i, n in enumerate(fill):
        # a dense clump, so the strided stages keep neighbours
        keys = rng.choice(nz * (ny // 2) * (nx // 2), n, replace=False)
        z, y, x = np.unravel_index(keys, (nz, ny // 2, nx // 2))
        coords[i, :n] = np.stack([z, y, x], -1)
        feats[i, :n] = rng.randn(n, c)
    return feats, coords, np.asarray(fill, np.int32)


def test_mean_vfe_matches_jax():
    rng = np.random.RandomState(0)
    counts = rng.randint(0, 6, (2, 50)).astype(np.int32)
    voxels = rng.randn(2, 50, 5, 4).astype(np.float32)
    voxels *= (np.arange(5) < counts[..., None])[..., None]
    batch = {'voxels': voxels, 'voxel_num_points': counts}
    want = JaxMeanVFE().apply({}, {k: jnp.asarray(v) for k, v in batch.items()})
    got = MeanVFE()({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got['voxel_features'].numpy(),
                               np.asarray(want['voxel_features']),
                               rtol=0, atol=1e-6)


def test_height_compression_matches_jax():
    x = np.random.RandomState(1).randn(2, 2, 5, 6, 8).astype(np.float32)
    want = JaxHeightCompression(num_bev_features=16).apply(
        {}, {'encoded_spconv_tensor': jnp.asarray(x),
             'encoded_spconv_tensor_stride': 8})
    got = HeightCompression(16)({'encoded_spconv_tensor': torch.from_numpy(x),
                                 'encoded_spconv_tensor_stride': 8})
    np.testing.assert_array_equal(got['spatial_features'].numpy(),
                                  np.asarray(want['spatial_features']))
    assert got['spatial_features_stride'] == want['spatial_features_stride'] == 8


@pytest.mark.parametrize('residual', [False, True], ids=['plain', 'residual'])
def test_voxel_backbone_matches_jax(residual):
    grid_size = (16, 24, 40)  # (nx, ny, nz): sparse shape (41, 24, 16)
    feats, coords, num = _voxel_table(2, grid_size)
    batch = {'voxel_features': feats, 'voxel_coords': coords, 'num_voxels': num}
    jax_bb = JaxVoxelBackBone8x(model_cfg={}, input_channels=4,
                                grid_size=grid_size, residual=residual)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.device_get(jax_bb.init(jax.random.PRNGKey(0), jbatch))
    rng = np.random.RandomState(3)
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)
    want = jax.jit(lambda p, s, b: jax_bb.apply(
        {'params': p, 'batch_stats': s}, b, training=False))(
            params, stats, jbatch)

    bb = VoxelBackBone8x({}, 4, grid_size, residual=residual).eval()
    bb.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    before = rulebook_conv.launches
    with torch.inference_mode():
        got = bb({k: torch.from_numpy(v) for k, v in batch.items()})
    assert rulebook_conv.launches == before  # CPU tensors: the plain version

    assert bb.backbone_channels == jax_bb.backbone_channels
    assert got['multi_scale_3d_strides'] == want['multi_scale_3d_strides']
    for name, jst in want['multi_scale_3d_features'].items():
        tst = got['multi_scale_3d_features'][name]
        assert tst.spatial_shape == tuple(int(s) for s in jst.spatial_shape)
        np.testing.assert_array_equal(tst.coords.numpy(), np.asarray(jst.coords))
        np.testing.assert_array_equal(tst.num_voxels.numpy(),
                                      np.asarray(jst.num_voxels))
        assert int(tst.num_voxels.min()) > 0
        assert tst.features.shape[-1] == bb.backbone_channels[name]
        np.testing.assert_allclose(tst.features.numpy(), np.asarray(jst.features),
                                   rtol=0, atol=1e-4, err_msg=name)
    enc = got['encoded_spconv_tensor']
    assert tuple(enc.shape) == (2, 2, 3, 2, 128) and float(enc.abs().max()) > 0
    assert got['encoded_spconv_tensor_stride'] == 8
    np.testing.assert_allclose(enc.numpy(),
                               np.asarray(want['encoded_spconv_tensor']),
                               rtol=0, atol=1e-4)


def test_voxel_backbone_refuses_host_rulebooks():
    bb = VoxelBackBone8x({}, 4, (16, 24, 40)).eval()
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        bb({'voxel_features': torch.zeros(1, 8, 4),
            'rb_subm1': torch.zeros(1, 8, 27, dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match='training'):
        bb.train().convs[0](torch.zeros(1, 8, 4), torch.ones(1, 8, dtype=torch.bool),
                            torch.zeros(1, 8, 27, dtype=torch.int32))


def _reduce(cfg):
    """The size of tests/test_second_e2e.py: nz stays 40."""
    data = cfg.DATA_CONFIG
    data.DATASET = 'SyntheticDataset'
    data.MAX_POINTS = 8000
    if 'DATA_AUGMENTOR' in data:
        del data.DATA_AUGMENTOR
    vox = [p for p in data.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    vox.VOXEL_SIZE = [0.2, 0.2, 0.1]
    vox.MAX_NUMBER_OF_VOXELS = {'train': 2000, 'test': 2000}
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 32
    return cfg


@pytest.fixture(scope='module')
def jax_run():
    cfg = _reduce(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=False,
                                       num_scenes=2, seed=3)
    batch = device_batch(next(iter(loader)))
    assert not any(k.startswith('rb_') for k in batch)  # the on-device branch
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    variables = jax.device_get(jit_init(model, batch))
    rng = np.random.RandomState(0)
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)
    out = jax.jit(lambda p, s, b: {
        k: v for k, v in model.apply({'params': p, 'batch_stats': s}, b,
                                     training=False).items()
        if k in ('batch_fused_preds', 'encoded_spconv_tensor',
                 'spatial_features')})(params, stats, batch)
    step = make_eval_step(model, cfg.MODEL.POST_PROCESSING,
                          len(cfg.CLASS_NAMES))
    preds = jax.device_get(step(params, stats, batch))
    return batch, params, stats, jax.device_get(out), preds


def test_second_slice_matches_make_eval_step(jax_run):
    batch, params, stats, want_out, want = jax_run
    det = Detector(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                   state_dict=flax_to_state_dict(params, stats))
    tbatch = {k: torch.from_numpy(np.asarray(batch[k]))
              for k in ('voxels', 'voxel_coords', 'voxel_num_points',
                        'num_voxels')}
    out = det.forward(tbatch)
    got = det.postprocess(out)

    assert tuple(out['encoded_spconv_tensor'].shape) == (2, 2, 50, 44, 128)
    assert tuple(out['spatial_features'].shape) == (2, 50, 44, 256)
    for key in ('encoded_spconv_tensor', 'spatial_features',
                'batch_fused_preds'):
        np.testing.assert_allclose(out[key].numpy(), want_out[key],
                                   rtol=0, atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(got['num_preds'].numpy(),
                                  np.asarray(want['num_preds']))
    assert (got['num_candidates'] > 0).all() and (got['num_preds'] > 1).all()
    np.testing.assert_array_equal(got['pred_mask'].numpy(), want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'].numpy(),
                                  want['pred_labels'])
    np.testing.assert_allclose(got['pred_scores'].numpy(), want['pred_scores'],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got['pred_boxes'].numpy(), want['pred_boxes'],
                               rtol=0, atol=1e-4)


def test_second_predict_from_clouds(jax_run):
    """Raw clouds through the port's own voxelizer and the whole path."""
    _, params, stats, _, _ = jax_run
    det = Detector(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                   state_dict=flax_to_state_dict(params, stats))
    from lidardetection_tpu_torch.datasets.synthetic import make_scene
    points, _, _ = make_scene(np.random.RandomState(5),
                              np.asarray(det.info['point_cloud_range']))
    (result,) = det.predict([points])
    n = len(result['boxes'])
    assert 0 < n <= 32 and result['boxes'].shape == (n, 7)
    assert np.isfinite(result['boxes']).all()
    assert (np.diff(result['scores']) <= 0).all()
    assert set(np.unique(result['labels'])) <= {1, 2, 3}
