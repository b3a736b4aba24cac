"""Voxel Set Abstraction, PV-RCNN's keypoint features (lidardetection_tpu/
models/backbones_3d/pfe.py:24-142).

FPS keypoints from the raw points, then one feature block per source: a
bilinear read of the BEV map (``bev``, channels-last (B, H, W, C) at the
map's stride) and a multi-scale set abstraction over the raw points and
over every sparse stage's voxel centres (``x_conv1``-``x_conv4``); the
blocks are fused by Dense + BatchNorm + ReLU. A sparse stage's valid rows
are a prefix of its table (``ops/sparse.py::SparseTensor``), so its valid
count is its source count.

``sa_layers.<n>`` are flax's ``PointnetSAModuleMSG_<n>`` in the JAX
module's creation order: ``raw_points`` first, then the sparse stages in
FEATURES_SOURCE order.
"""

import torch
from torch import nn

from ...core.geometry import get_voxel_centers
from ...ops import pointnet2 as p2
from ...ops.gather import gather_rows
from ..layers import POINT_BN, Dense, MaskedBatchNorm
from .pointnet2_modules import PointnetSAModuleMSG


def bilinear_interpolate(im, x, y):
    """(B, H, W, C), (B, N), (B, N) -> (B, N, C) (pfe.py:24-43)."""
    b, h, w, c = im.shape
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1, y1 = x0 + 1, y0 + 1
    x0c, x1c = x0.clamp(0, w - 1), x1.clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), y1.clamp(0, h - 1)
    flat = im.reshape(b, h * w, c)

    def at(yy, xx):
        return gather_rows(flat, yy * w + xx)

    x0f, x1f, y0f, y1f = (v.to(x.dtype) for v in (x0, x1, y0, y1))
    wa = (x1f - x) * (y1f - y)
    wb = (x1f - x) * (y - y0f)
    wc = (x - x0f) * (y1f - y)
    wd = (x - x0f) * (y - y0f)
    return (at(y0c, x0c) * wa[..., None] + at(y1c, x0c) * wb[..., None]
            + at(y0c, x1c) * wc[..., None] + at(y1c, x1c) * wd[..., None])


class VoxelSetAbstraction(nn.Module):
    """Args: model_cfg (MODEL.PFE); voxel_size, point_cloud_range;
    num_bev_features; num_rawpoint_features (x, y, z and features);
    backbone_channels: the sparse backbone's width per stage."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range,
                 num_bev_features, num_rawpoint_features, backbone_channels,
                 knobs=None, dtype=None, generator=None):
        super().__init__()
        if model_cfg.get('POINT_SOURCE', 'raw_points') != 'raw_points' or \
                model_cfg.get('SAMPLE_METHOD', 'FPS') != 'FPS':
            raise NotImplementedError('VSA keypoints come from FPS over raw '
                                      'points (pfe.py:71-72)')
        self.model_cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.num_keypoints = int(model_cfg['NUM_KEYPOINTS'])
        self.knobs = knobs
        self.sources = list(model_cfg['FEATURES_SOURCE'])

        def sa(src, in_channels):
            cfg = model_cfg['SA_LAYER'][src]
            return PointnetSAModuleMSG(
                npoint=self.num_keypoints, radii=cfg['POOL_RADIUS'],
                nsamples=cfg['NSAMPLE'], mlps=[list(m) for m in cfg['MLPS']],
                in_channels=in_channels, zero_empty=True, knobs=knobs,
                dtype=dtype, generator=generator)

        layers, self.sa_sources = [], []
        if 'raw_points' in self.sources:
            layers.append(sa('raw_points', num_rawpoint_features - 3))
            self.sa_sources.append('raw_points')
        for src in self.sources:
            if src not in ('bev', 'raw_points'):
                layers.append(sa(src, backbone_channels[src]))
                self.sa_sources.append(src)
        self.sa_layers = nn.ModuleList(layers)

        # blocks concatenate as the JAX module appends them: bev, raw
        # points, then the sparse stages
        self.concat_order = ['bev'] * ('bev' in self.sources) + self.sa_sources
        width = {src: layer.out_channels
                 for src, layer in zip(self.sa_sources, self.sa_layers)}
        width['bev'] = num_bev_features
        self.num_point_features_before_fusion = sum(
            width[src] for src in self.concat_order)
        self.num_point_features = int(model_cfg['NUM_OUTPUT_FEATURES'])
        self.dense = nn.ModuleList([Dense(
            self.num_point_features_before_fusion, self.num_point_features,
            bias=False, generator=generator)])
        self.bn = nn.ModuleList([MaskedBatchNorm(
            self.num_point_features, axis=-1, **POINT_BN)])

    def forward(self, batch):
        points, num_points = batch['points'], batch['num_points']
        xyz = points[..., 0:3].contiguous()
        kp_idx = p2.fps(xyz, num_points, self.num_keypoints, knobs=self.knobs)
        keypoints = p2.group_points(xyz, kp_idx[..., None]).squeeze(2)
        kp_num = torch.clamp(num_points, max=self.num_keypoints)
        kp_valid = torch.arange(self.num_keypoints, device=xyz.device) \
            < kp_num[:, None]

        feats = {}
        if 'bev' in self.sources:
            stride = batch.get('spatial_features_stride', 8)
            vx, vy = self.voxel_size[0], self.voxel_size[1]
            x_idx = (keypoints[..., 0] - self.point_cloud_range[0]) / vx / stride
            y_idx = (keypoints[..., 1] - self.point_cloud_range[1]) / vy / stride
            feats['bev'] = bilinear_interpolate(
                batch['spatial_features'].float(), x_idx, y_idx)
        for src, layer in zip(self.sa_sources, self.sa_layers):
            if src == 'raw_points':
                raw = points[..., 3:] if points.shape[-1] > 3 else None
                _, feats[src], _ = layer(xyz, raw, num_points,
                                         new_xyz=keypoints, new_xyz_num=kp_num)
                continue
            st = batch['multi_scale_3d_features'][src]
            centers = get_voxel_centers(
                st.coords, self.model_cfg['SA_LAYER'][src]['DOWNSAMPLE_FACTOR'],
                self.voxel_size, self.point_cloud_range)
            n_valid = (st.coords[..., 0] >= 0).sum(1)
            _, feats[src], _ = layer(centers, st.features.float(), n_valid,
                                     new_xyz=keypoints, new_xyz_num=kp_num)

        before = torch.cat([feats[src].float() for src in self.concat_order], -1)
        fused = torch.relu(self.bn[0](self.dense[0](before), mask=kp_valid))
        return {**batch,
                'point_features_before_fusion': before,
                'point_features': fused * kp_valid[..., None],
                'point_coords': keypoints,
                'point_valid': kp_valid,
                'num_keypoints': kp_num}
