"""Sparse 3D CNN backbones VoxelBackBone8x / VoxelResBackBone8x
(lidardetection_tpu/models/backbones_3d/spconv_backbone.py:22-206).

A 4-stage sparse CNN (16-32-64-64, or 16-32-64-128 with residual blocks),
strides 1/2/2/2, then a (3,1,1)/(2,1,1) z-compression to the stride-8
encoded tensor. Each stage's rulebook is built once per forward
(ops/sparse.py) and shared by the stage's submanifold layers; every
convolution runs through kernel K3. The sparse shape is
grid_size[::-1] + [1, 0, 0], as in the reference.

The rulebooks come from the batch when it carries the host plan's tables
(``rb_subm1`` and the rest, ``ops/sparse_plan.py``; the table then sits
as the voxelizer sorted it), else they are built on the device. Both give
the same integers.

In training BatchNorm takes its statistics over the valid rows, every
layer's weight gradient runs through kernel K4, and the input gradient of
a submanifold layer through K3 over the offset-flipped rulebook. A strided
layer's input gradient runs through K3 over its transposed rulebook
``rb_<name>_bwd`` when the batch carries the training plan; the
device-built path has none and takes the plain scatter-add, as the JAX
package's device path does.

``convs`` holds the SparseConvLayers and ``blocks`` the SparseBasicBlocks
in the JAX module's creation order (``SparseConvLayer_<n>`` /
``SparseBasicBlock_<n>`` there).
"""

import torch
from torch import nn

from ...ops import sparse
from ..layers import MaskedBatchNorm, lecun_normal_

# the strided stages of the encoder: name, padding (kernel 3, stride 2)
STAGES = (('x_conv2', (1, 1, 1)), ('x_conv3', (1, 1, 1)),
          ('x_conv4', (0, 1, 1)))


def encode(batch, convs, blocks, spatial_shape, capacities, last_pad=0,
           with_out=True):
    """VoxelBackBone8x's encoder, shared with UNetV2's: the layers come from
    the iterators ``convs`` and ``blocks`` in creation order (``blocks``
    None: plain submanifold layers, else one SparseBasicBlock a layer).
    Returns the four stages' SparseTensors, each stage's submanifold
    rulebook, and conv_out's SparseTensor (padding ``last_pad``; None
    without `with_out`, a UNetV2 with RETURN_ENCODED_TENSOR false)."""
    feats = batch['voxel_features']
    cap = feats.shape[1]
    host = 'rb_subm1' in batch
    if host:  # the host voxelizer emits the table sorted
        st = sparse.SparseTensor(feats, batch['voxel_coords'],
                                 batch['num_voxels'], spatial_shape)
    else:
        st = sparse.from_unsorted(feats, batch['voxel_coords'],
                                  batch['num_voxels'], spatial_shape)

    def subm_stack(st, n_blocks, name, first_plain=False):
        rule = batch[f'rb_{name}'] if host \
            else sparse.build_subm_rulebook(st, (3, 3, 3))
        vm, f = st.valid_mask, st.features
        if first_plain:
            f = next(convs)(f, vm, rule)
        for _ in range(n_blocks):
            f = next(convs if blocks is None else blocks)(f, vm, rule)
        return st._replace(features=f), rule

    def downsample(st, stride, padding, kernel, stage, name):
        if host:
            out_coords = batch[f'rb_{name}_coords']
            out_num = batch[f'rb_{name}_num']
            rule = batch[f'rb_{name}']
            out_shape = tuple(
                (n + 2 * p - (k - 1) - 1) // s + 1 for n, k, s, p in
                zip(st.spatial_shape, kernel, stride, padding))
        else:
            capacity = cap if capacities is None else int(capacities[stage])
            out_coords, out_num, out_shape = sparse.build_strided_out_coords(
                st, kernel, stride, padding, capacity)
            rule = sparse.build_strided_rulebook(
                st, out_coords, out_shape, kernel, stride, padding)
        # the training plan's transposed rulebook, over the input table
        rb_bwd = batch.get(f'rb_{name}_bwd') if host else None
        f = next(convs)(st.features, out_coords[..., 0] >= 0, rule,
                        rb_bwd=rb_bwd, in_valid=st.valid_mask)
        return sparse.SparseTensor(f, out_coords, out_num, out_shape)

    stages, rules = {}, {}
    st, rules['x_conv1'] = subm_stack(st, 1, 'subm1', first_plain=True)
    stages['x_conv1'] = st
    for stage, (name, padding) in enumerate(STAGES):
        st = downsample(st, (2, 2, 2), padding, (3, 3, 3), stage,
                        f'down{stage + 2}')
        st, rules[name] = subm_stack(st, 2, f'subm{stage + 2}')
        stages[name] = st
    if not with_out:
        return stages, rules, None
    # conv_out: z-compression (3,1,1)/(2,1,1)
    st_out = downsample(st, (2, 1, 1), (last_pad,) * 3, (3, 1, 1), 3, 'out')
    return stages, rules, st_out


class SparseConvLayer(nn.Module):
    """One sparse convolution over a prebuilt rulebook + BN + ReLU.

    ``kernel`` is (K, C_in, C_out), the flax layout; rows of (B, V, C)
    activations that are not valid come out 0. ``subm`` marks a
    submanifold convolution on a shared table (see
    ``sparse.sparse_conv_apply``).
    """

    def __init__(self, in_channels, out_channels, kernel_volume,
                 use_relu=True, subm=False, dtype=None, generator=None):
        super().__init__()
        self.use_relu, self.subm, self.dtype = use_relu, subm, dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel_volume, in_channels, out_channels))
        # flax's lecun_normal takes the fan-in over all but the last axis
        lecun_normal_(self.kernel, kernel_volume * in_channels, generator)
        self.bn = MaskedBatchNorm(out_channels, axis=-1)

    def forward(self, features, valid_mask, rulebook, rb_bwd=None,
                in_valid=None):
        cdt = self.dtype or features.dtype
        out = sparse.sparse_conv_apply(
            features.to(cdt), valid_mask, rulebook, self.kernel.to(cdt),
            rb_bwd=rb_bwd, in_valid=in_valid, subm=self.subm)
        out = self.bn(out.to(cdt), mask=valid_mask)
        if self.use_relu:
            out = torch.relu(out)
        return out * valid_mask[..., None].to(out.dtype)


class SparseBasicBlock(nn.Module):
    """Residual submanifold block: two convolutions, ReLU after the sum."""

    def __init__(self, channels, kernel_volume, dtype=None, generator=None):
        super().__init__()
        self.convs = nn.ModuleList([
            SparseConvLayer(channels, channels, kernel_volume, subm=True,
                            dtype=dtype, generator=generator),
            SparseConvLayer(channels, channels, kernel_volume, use_relu=False,
                            subm=True, dtype=dtype, generator=generator)])

    def forward(self, features, valid_mask, rulebook):
        x = self.convs[0](features, valid_mask, rulebook)
        x = self.convs[1](x, valid_mask, rulebook)
        out = torch.relu(x + features.to(x.dtype))
        return out * valid_mask[..., None].to(out.dtype)


def encoder_layers(input_channels, channels, residual, with_out=True, **kw):
    """The encoder's layers in the JAX module's creation order: conv_input,
    conv1, then for each later stage its downsample and its submanifold
    layers (SparseBasicBlocks in ``blocks`` when `residual`), and conv_out
    to 128 channels when `with_out`. `channels` maps ``x_conv1``..
    ``x_conv4`` to widths."""
    convs, blocks = [], []

    def subm(width, n_blocks):
        made = blocks if residual else convs
        for _ in range(n_blocks):
            made.append(SparseBasicBlock(width, 27, **kw) if residual
                        else SparseConvLayer(width, width, 27, subm=True,
                                             **kw))

    convs.append(SparseConvLayer(input_channels, channels['x_conv1'], 27,
                                 subm=True, **kw))
    subm(channels['x_conv1'], 1)
    c_in = channels['x_conv1']
    for name, _ in STAGES:
        convs.append(SparseConvLayer(c_in, channels[name], 27, **kw))
        subm(channels[name], 2)
        c_in = channels[name]
    if with_out:
        convs.append(SparseConvLayer(c_in, 128, 3, **kw))  # conv_out
    return convs, blocks


class VoxelBackBone8x(nn.Module):
    """``residual=True`` gives VoxelResBackBone8x (SparseBasicBlocks and a
    128-channel stage 4).

    Reads ``voxel_features`` (B, V, C), ``voxel_coords`` and ``num_voxels``;
    adds ``encoded_spconv_tensor`` (B, D, H, W, 128) dense, its stride, and
    ``multi_scale_3d_features`` (a SparseTensor per stage) with their
    strides. With ``rb_subm1`` in the batch every table and rulebook comes
    from the host plan's ``rb_*`` keys. MODEL.BACKBONE_3D.OUT_CAPACITIES,
    when given, caps the four strided tables; the default is the input
    capacity.
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
        convs, blocks = encoder_layers(input_channels, self.backbone_channels,
                                       residual, dtype=dtype,
                                       generator=generator)
        self.convs = nn.ModuleList(convs)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, batch):
        stages, _, st_out = encode(
            batch, iter(self.convs), iter(self.blocks) if self.residual
            else None, self.spatial_shape, self.capacities)
        return {
            **batch,
            'encoded_spconv_tensor': sparse.sparse_to_dense(st_out),
            'encoded_spconv_tensor_stride': 8,
            'multi_scale_3d_features': stages,
            'multi_scale_3d_strides': {'x_conv1': 1, 'x_conv2': 2,
                                       'x_conv3': 4, 'x_conv4': 8},
        }
