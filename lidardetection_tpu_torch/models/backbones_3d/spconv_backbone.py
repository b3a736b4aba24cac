"""Sparse 3D CNN backbones VoxelBackBone8x / VoxelResBackBone8x, eval
(lidardetection_tpu/models/backbones_3d/spconv_backbone.py:22-206).

A 4-stage sparse CNN (16-32-64-64, or 16-32-64-128 with residual blocks),
strides 1/2/2/2, then a (3,1,1)/(2,1,1) z-compression to the stride-8
encoded tensor. Each stage's rulebook is built once per forward
(ops/sparse.py) and shared by the stage's submanifold layers; every
convolution runs through kernel K3. The sparse shape is
grid_size[::-1] + [1, 0, 0], as in the reference.

``convs`` holds the SparseConvLayers and ``blocks`` the SparseBasicBlocks
in the JAX module's creation order (``SparseConvLayer_<n>`` /
``SparseBasicBlock_<n>`` there).
"""

import torch
from torch import nn

from ...ops import sparse
from ..layers import MaskedBatchNorm, lecun_normal_

HOST_PLAN_NOT_PORTED = (
    'host-built rulebooks (rb_* batch keys) are not ported yet: see '
    'ROADMAP.md queue 1, "Host rulebook plan"')


class SparseConvLayer(nn.Module):
    """One sparse convolution over a prebuilt rulebook + BN + ReLU.

    ``kernel`` is (K, C_in, C_out), the flax layout; rows of (B, V, C)
    activations that are not valid come out 0.
    """

    def __init__(self, in_channels, out_channels, kernel_volume,
                 use_relu=True, dtype=None, generator=None):
        super().__init__()
        self.use_relu, self.dtype = use_relu, dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel_volume, in_channels, out_channels))
        # flax's lecun_normal takes the fan-in over all but the last axis
        lecun_normal_(self.kernel, kernel_volume * in_channels, generator)
        self.bn = MaskedBatchNorm(out_channels, axis=-1)

    def forward(self, features, valid_mask, rulebook):
        cdt = self.dtype or features.dtype
        out = sparse.sparse_conv_apply(features.to(cdt), valid_mask, rulebook,
                                       self.kernel.to(cdt))
        out = self.bn(out.to(cdt))
        if self.use_relu:
            out = torch.relu(out)
        return out * valid_mask[..., None].to(out.dtype)


class SparseBasicBlock(nn.Module):
    """Residual submanifold block: two convolutions, ReLU after the sum."""

    def __init__(self, channels, kernel_volume, dtype=None, generator=None):
        super().__init__()
        self.convs = nn.ModuleList([
            SparseConvLayer(channels, channels, kernel_volume, dtype=dtype,
                            generator=generator),
            SparseConvLayer(channels, channels, kernel_volume, use_relu=False,
                            dtype=dtype, generator=generator)])

    def forward(self, features, valid_mask, rulebook):
        x = self.convs[0](features, valid_mask, rulebook)
        x = self.convs[1](x, valid_mask, rulebook)
        out = torch.relu(x + features.to(x.dtype))
        return out * valid_mask[..., None].to(out.dtype)


class VoxelBackBone8x(nn.Module):
    """``residual=True`` gives VoxelResBackBone8x (SparseBasicBlocks and a
    128-channel stage 4).

    Reads ``voxel_features`` (B, V, C), ``voxel_coords`` and ``num_voxels``;
    adds ``encoded_spconv_tensor`` (B, D, H, W, 128) dense, its stride, and
    ``multi_scale_3d_features`` (a SparseTensor per stage) with their
    strides. MODEL.BACKBONE_3D.OUT_CAPACITIES, when given, caps the four
    strided tables; the default is the input capacity.
    """

    num_point_features = 128

    def __init__(self, model_cfg, input_channels, grid_size, dtype=None,
                 residual=False, generator=None):
        super().__init__()
        nx, ny, nz = (int(g) for g in grid_size)
        self.spatial_shape = (nz + 1, ny, nx)
        self.capacities = model_cfg.get('OUT_CAPACITIES', None)
        self.residual = residual
        self.backbone_channels = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64,
                                  'x_conv4': 128 if residual else 64}
        kw = {'dtype': dtype, 'generator': generator}
        convs, blocks = [], []

        def subm(channels, n_blocks):
            made = blocks if residual else convs
            for _ in range(n_blocks):
                made.append(SparseBasicBlock(channels, 27, **kw) if residual
                            else SparseConvLayer(channels, channels, 27, **kw))

        # creation order of the JAX module: conv_input, conv1, then for
        # each later stage its downsample and its submanifold layers
        ch = self.backbone_channels
        convs.append(SparseConvLayer(input_channels, ch['x_conv1'], 27, **kw))
        subm(ch['x_conv1'], 1)
        c_in = ch['x_conv1']
        for name in ('x_conv2', 'x_conv3', 'x_conv4'):
            convs.append(SparseConvLayer(c_in, ch[name], 27, **kw))
            subm(ch[name], 2)
            c_in = ch[name]
        convs.append(SparseConvLayer(c_in, 128, 3, **kw))  # conv_out
        self.convs = nn.ModuleList(convs)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, batch):
        if any(key.startswith('rb_') for key in batch):
            raise NotImplementedError(HOST_PLAN_NOT_PORTED)
        feats = batch['voxel_features']
        cap = feats.shape[1]
        st = sparse.from_unsorted(feats, batch['voxel_coords'],
                                  batch['num_voxels'], self.spatial_shape)
        convs, blocks = iter(self.convs), iter(self.blocks)

        def subm_stack(st, n_blocks, first_plain=False):
            rule = sparse.build_subm_rulebook(st, (3, 3, 3))
            vm, f = st.valid_mask, st.features
            if first_plain:
                f = next(convs)(f, vm, rule)
            for _ in range(n_blocks):
                f = next(blocks if self.residual else convs)(f, vm, rule)
            return st._replace(features=f)

        def downsample(st, stride, padding, kernel, stage):
            capacity = cap if self.capacities is None \
                else int(self.capacities[stage])
            out_coords, out_num, out_shape = sparse.build_strided_out_coords(
                st, kernel, stride, padding, capacity)
            rule = sparse.build_strided_rulebook(
                st, out_coords, out_shape, kernel, stride, padding)
            f = next(convs)(st.features, out_coords[..., 0] >= 0, rule)
            return sparse.SparseTensor(f, out_coords, out_num, out_shape)

        stages = {}
        st = stages['x_conv1'] = subm_stack(st, 1, first_plain=True)
        for stage, (name, padding) in enumerate((
                ('x_conv2', (1, 1, 1)), ('x_conv3', (1, 1, 1)),
                ('x_conv4', (0, 1, 1)))):
            st = downsample(st, (2, 2, 2), padding, (3, 3, 3), stage)
            st = stages[name] = subm_stack(st, 2)
        # conv_out: z-compression (3,1,1)/(2,1,1), no padding
        st_out = downsample(st, (2, 1, 1), (0, 0, 0), (3, 1, 1), 3)

        return {
            **batch,
            'encoded_spconv_tensor': sparse.sparse_to_dense(st_out),
            'encoded_spconv_tensor_stride': 8,
            'multi_scale_3d_features': stages,
            'multi_scale_3d_strides': {'x_conv1': 1, 'x_conv2': 2,
                                       'x_conv3': 4, 'x_conv4': 8},
        }
