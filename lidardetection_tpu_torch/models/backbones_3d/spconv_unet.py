"""The sparse UNet of Part-A², UNetV2
(lidardetection_tpu/models/backbones_3d/spconv_unet.py:22-172).

The encoder is VoxelBackBone8x's (four stages 16-32-64-64, strides
1/2/2/2, and the (3,1,1)/(2,1,1) z-compression to the stride-8 encoded
tensor). The decoder climbs back with one UR block a stage: a lateral
SparseBasicBlock, the bottom-up features concatenated before it, a
submanifold ``conv_m`` plus the channel reduction (adjacent channel pairs
summed) as a residual, then an inverse convolution onto the finer stage's
table (or, at stage 1, a last submanifold ``conv5``). Every one of the 28
convolutions runs through kernel K3, the weight gradients through K4.

The rulebooks come from the batch when it carries the host plan's tables
(``rb_subm1`` and the rest, ``rb_inv4/3/2`` for the inverse convolutions;
``ops/sparse_plan.py``), else they are built on the device
(``ops/sparse.py``). An inverse convolution's input gradient is again a
K3 launch: over the paired strided convolution's forward rulebook
``rb_down<n>`` (same offset, ``W[k]^T``, no flip), with the lateral
table's mask. Off the plan it takes the plain scatter-add, as the JAX
package's device path does.

Outputs, besides VoxelBackBone8x's: ``point_features`` (B, V, 16) float32,
the decoder's features on the ``x_conv1`` table, ``point_coords`` (B, V,
3) its voxel centres and ``point_valid`` its mask.

``convs`` holds the SparseConvLayers and ``blocks`` the SparseBasicBlocks
in the JAX module's creation order (``SparseConvLayer_<n>`` /
``SparseBasicBlock_<n>`` there): the encoder's 12 convolutions (``out``
last), then per UR block its ``conv_m`` and its inverse convolution (or
``conv5``); the four blocks are the UR blocks' lateral ones.
"""

import torch
from torch import nn

from ...core.geometry import get_voxel_centers
from ...ops import sparse
from .spconv_backbone import (
    STAGES, SparseBasicBlock, SparseConvLayer, encode, encoder_layers,
)


def channel_reduction(x_cat, channels):
    """(B, V, 2C) -> (B, V, C): channel i is the sum of channels 2i and
    2i + 1 (the reference's ``reshape(B, n, C, -1).sum(-1)``), not of the
    two halves."""
    b, n, _ = x_cat.shape
    return x_cat.reshape(b, n, channels, -1).sum(-1)


class UNetV2(nn.Module):
    num_point_features = 16
    # the UR blocks in order: the lateral stage, conv_m's width, the stage
    # the inverse conv writes to, its width, its table (None: conv5)
    _DECODER = (('x_conv4', 64, 'x_conv3', 64, 'inv4'),
                ('x_conv3', 64, 'x_conv2', 32, 'inv3'),
                ('x_conv2', 32, 'x_conv1', 16, 'inv2'),
                ('x_conv1', 16, None, 16, None))

    def __init__(self, model_cfg, input_channels, grid_size, voxel_size,
                 point_cloud_range, dtype=None, generator=None):
        super().__init__()
        nx, ny, nz = (int(g) for g in grid_size)
        self.spatial_shape = (nz + 1, ny, nx)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.capacities = model_cfg.get('OUT_CAPACITIES', None)
        self.last_pad = int(model_cfg.get('last_pad', 0))
        self.backbone_channels = {'x_conv1': 16, 'x_conv2': 32,
                                  'x_conv3': 64, 'x_conv4': 64}
        kw = {'dtype': dtype, 'generator': generator}
        ch = self.backbone_channels
        self.with_out = bool(model_cfg.get('RETURN_ENCODED_TENSOR', True))
        convs, _ = encoder_layers(input_channels, ch, False,
                                  with_out=self.with_out, **kw)
        blocks = []
        bottom = ch['x_conv4']
        for lateral, width, _, up_width, inv in self._DECODER:
            c_lat = ch[lateral]
            blocks.append(SparseBasicBlock(c_lat, 27, **kw))
            convs.append(SparseConvLayer(bottom + c_lat, width, 27, subm=True,
                                         **kw))  # conv_m
            # the inverse conv, or conv5 at the last block
            convs.append(SparseConvLayer(width, up_width, 27, subm=inv is None,
                                         **kw))
            bottom = up_width
        self.convs = nn.ModuleList(convs)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, batch):
        host = 'rb_subm1' in batch
        convs, blocks = iter(self.convs), iter(self.blocks)
        stages, rules, st_out = encode(batch, convs, None, self.spatial_shape,
                                       self.capacities, self.last_pad,
                                       with_out=self.with_out)
        out = dict(batch)
        if st_out is not None:
            out.update(encoded_spconv_tensor=sparse.sparse_to_dense(st_out),
                       encoded_spconv_tensor_stride=8)

        # ---- decoder: the UR blocks ----
        x = stages['x_conv4'].features
        for lateral, width, up, _, inv in self._DECODER:
            lat = stages[lateral]
            vm, rule = lat.valid_mask, rules[lateral]
            x_trans = next(blocks)(lat.features, vm, rule)
            x_cat = torch.cat([x.to(x_trans.dtype), x_trans], dim=-1)
            x_m = next(convs)(x_cat, vm, rule)
            x = x_m + channel_reduction(x_cat, width).to(x_m.dtype)
            if inv is None:
                x = next(convs)(x, vm, rule)  # conv5
                continue
            up_st = stages[up]
            if host:
                inv_rule = batch[f'rb_{inv}']
            else:
                inv_rule = sparse.build_inverse_rulebook(
                    lat, up_st.coords, (3, 3, 3), (2, 2, 2),
                    dict(STAGES)[lateral])
            # df flows up -> down through the paired strided conv's forward
            # rulebook: the same offset enumeration, W[k]^T, no flip
            rb_bwd = batch.get(f'rb_{inv.replace("inv", "down")}') \
                if host else None
            x = next(convs)(x, up_st.valid_mask, inv_rule, rb_bwd=rb_bwd,
                            in_valid=vm)

        x_conv1 = stages['x_conv1']
        out['point_features'] = x.float()
        out['point_coords'] = get_voxel_centers(
            x_conv1.coords, 1, self.voxel_size, self.point_cloud_range)
        out['point_valid'] = x_conv1.valid_mask
        out['multi_scale_3d_features'] = stages
        out['multi_scale_3d_strides'] = {'x_conv1': 1, 'x_conv2': 2,
                                         'x_conv3': 4, 'x_conv4': 8}
        return out
