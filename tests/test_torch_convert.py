"""flax -> PyTorch weight conversion, BaseBEVBackbone against flax's, and
the SECOND tree's names."""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lidardetection_tpu.models.backbones_2d.bev_backbone import (
    BaseBEVBackbone as JaxBaseBEVBackbone,
)
from lidardetection_tpu.models.backbones_3d.spconv_backbone import (
    VoxelBackBone8x as JaxVoxelBackBone8x,
)
from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
from lidardetection_tpu_torch.convert import flax_to_state_dict
from lidardetection_tpu_torch.models import build_network
from lidardetection_tpu_torch.models.backbones_2d.bev_backbone import BaseBEVBackbone


@pytest.mark.parametrize('k', [2, 4])
def test_conv_transpose_kernel_is_flipped(k):
    """flax's ConvTranspose does not flip its kernel and PyTorch's does:
    the converted weight reproduces flax only with the spatial flip."""
    rng = np.random.RandomState(k)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)  # NHWC
    layer = fnn.ConvTranspose(16, (k, k), strides=(k, k), padding='VALID',
                              use_bias=False)
    variables = jax.device_get(layer.init(jax.random.PRNGKey(k), x))
    want = np.asarray(layer.apply(variables, x))
    kernel = variables['params']['kernel']  # HWIO
    w = flax_to_state_dict(
        {'ConvBNReLU_0': {'ConvTranspose_0': {'kernel': kernel}}}, {})
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.conv_transpose2d(x_t, w['units.0.weight'], stride=k)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)
    unflipped = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    wrong = F.conv_transpose2d(x_t, unflipped, stride=k).permute(0, 2, 3, 1)
    assert np.abs(wrong.numpy() - want).max() > 0.1


def _randomize_bn(tree, rng):
    out = {}
    for key, value in tree.items():
        if hasattr(value, 'items'):
            out[key] = _randomize_bn(value, rng)
        elif key in ('scale', 'var'):
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ('bias', 'mean'):
            out[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
        else:
            out[key] = np.asarray(value)
    return out


@pytest.mark.parametrize('cfg', [
    # stride blocks with k == s deblocks (the PointPillar shape)
    {'LAYER_NUMS': [1, 1], 'LAYER_STRIDES': [2, 2], 'NUM_FILTERS': [8, 16],
     'UPSAMPLE_STRIDES': [1, 2], 'NUM_UPSAMPLE_FILTERS': [8, 8]},
    # a fractional upsample stride: strided-conv "deblock"
    {'LAYER_NUMS': [1, 2], 'LAYER_STRIDES': [2, 2], 'NUM_FILTERS': [8, 16],
     'UPSAMPLE_STRIDES': [0.5, 1], 'NUM_UPSAMPLE_FILTERS': [8, 8]},
    # one more upsample stride than levels: a final deblock
    {'LAYER_NUMS': [1], 'LAYER_STRIDES': [2], 'NUM_FILTERS': [8],
     'UPSAMPLE_STRIDES': [1, 2], 'NUM_UPSAMPLE_FILTERS': [8]},
])
def test_bev_backbone_matches_flax(cfg):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 20, 6).astype(np.float32)  # NHWC
    jax_bb = JaxBaseBEVBackbone(model_cfg=cfg, input_channels=6)
    variables = jax.device_get(jax_bb.init(
        jax.random.PRNGKey(0), {'spatial_features': x}, training=False))
    params = _randomize_bn(variables['params'], rng)
    stats = _randomize_bn(variables['batch_stats'], rng)
    want = jax_bb.apply({'params': params, 'batch_stats': stats},
                        {'spatial_features': x}, training=False)

    bb = BaseBEVBackbone(cfg, 6).eval()
    bb.load_state_dict(flax_to_state_dict(params, stats))
    with torch.inference_mode():
        got = bb({'spatial_features': torch.from_numpy(x)})
    assert bb.num_bev_features == got['spatial_features_2d'].shape[-1]
    for key in want:
        if key.startswith('spatial_features_'):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.parametrize('name', ['VoxelBackBone8x', 'VoxelResBackBone8x'])
def test_second_tree_loads_strict(name):
    """A SECOND flax tree (its 3D backbone initialized by the JAX module on
    a tiny table, the other scopes as the PointPillar tests convert them)
    fills every parameter and buffer of the port's detector, and the
    sparse kernels keep their (K, C_in, C_out) layout."""
    cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/second.yaml')
    cfg.MODEL.BACKBONE_3D.NAME = name
    cfg.MODEL.BACKBONE_2D.LAYER_NUMS = [1, 1]
    model = build_network(cfg.MODEL, 3, dataset_info(cfg.DATA_CONFIG), seed=1)
    own = model.state_dict()

    coords = np.full((1, 8, 3), -1, np.int32)
    coords[0, :3] = [[0, 0, 0], [1, 1, 1], [2, 3, 1]]
    jax_bb = JaxVoxelBackBone8x(model_cfg={}, input_channels=4,
                                grid_size=(16, 16, 40),
                                residual=name == 'VoxelResBackBone8x')
    variables = jax.device_get(jax_bb.init(jax.random.PRNGKey(0), {
        'voxel_features': np.ones((1, 8, 4), np.float32),
        'voxel_coords': coords, 'num_voxels': np.asarray([3], np.int32)}))
    rng = np.random.RandomState(0)
    state = flax_to_state_dict(
        {'backbone_3d': _randomize_bn(variables['params'], rng)},
        {'backbone_3d': _randomize_bn(variables['batch_stats'], rng)})
    assert set(state) == {k for k in own if k.startswith('backbone_3d.')}
    n_layers = 19 if name == 'VoxelResBackBone8x' else 12
    assert sum(k.endswith('.kernel') for k in state) == n_layers
    down2 = 1 if name == 'VoxelResBackBone8x' else 2  # creation order
    kernel = variables['params'][f'SparseConvLayer_{down2}']['kernel']
    np.testing.assert_array_equal(
        state[f'backbone_3d.convs.{down2}.kernel'].numpy(), kernel)
    assert kernel.shape == (27, 16, 32)

    state.update({k: v for k, v in own.items()
                  if not k.startswith('backbone_3d.')})
    fresh = build_network(cfg.MODEL, 3, dataset_info(cfg.DATA_CONFIG), seed=2)
    fresh.load_state_dict(state, strict=True)
    got = fresh.state_dict()
    for key, value in state.items():
        assert torch.equal(got[key], value), key
