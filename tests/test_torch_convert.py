"""flax -> PyTorch weight conversion, and BaseBEVBackbone against flax's."""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lidardetection_tpu.models.backbones_2d.bev_backbone import (
    BaseBEVBackbone as JaxBaseBEVBackbone,
)
from lidardetection_tpu_torch.convert import flax_to_state_dict
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
