"""Voxel feature encoders: MeanVFE and PillarVFE's eval single-PFN path
(lidardetection_tpu/models/backbones_3d/vfe.py:17-26 and :58-223).

Batch layout: voxels (B, V, P, 4) float32 at fixed capacity,
voxel_num_points (B, V) int32 (0 marks an empty slot), voxel_coords
(B, V, 3) int32 (z, y, x), -1 padded.

At eval BN is an affine, so the 10-feature augmentation
[xyz, i, xyz - mean, xyz - center] @ K splits into a per-point product of
the centered point with a (4, C) weight and a per-pillar bias row (the
algebra is in the JAX package's ops/vfe_tpu.py docstring). The per-point
part and the max over points run in kernel K1 (ops/vfe_cuda.py).
"""

import torch
from torch import nn

from ...ops.vfe_cuda import pillar_vfe
from ..layers import BN_EPS, lecun_normal_


class MeanVFE(nn.Module):
    """Mean of the points of each voxel -> ``voxel_features`` (B, V, C)."""

    def forward(self, batch):
        voxels = batch['voxels']  # (B, V, P, C)
        denom = batch['voxel_num_points'].to(voxels.dtype).clamp(min=1.0)
        return {**batch, 'voxel_features': voxels.sum(dim=2) / denom[..., None]}


class PillarVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, dtype=None, generator=None):
        super().__init__()
        num_filters = list(model_cfg['NUM_FILTERS'])
        if not (len(num_filters) == 1 and model_cfg.get('USE_NORM', True)
                and model_cfg.get('USE_ABSLOTE_XYZ', True)  # sic, reference key
                and not model_cfg.get('WITH_DISTANCE', False)
                and num_point_features == 4):
            raise NotImplementedError(
                'only the single-PFN PillarVFE (USE_NORM, absolute xyz, no '
                'distance, 4 point features) is ported: the multi-PFN stack '
                'is in ROADMAP.md queue 1, "Variants"')
        c = num_filters[0]
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.dtype = dtype
        # rows of pfn_kernel: [xyz (3), intensity (1), cluster (3), center (3)]
        self.pfn_kernel = nn.Parameter(torch.empty(10, c))
        lecun_normal_(self.pfn_kernel, 10, generator)
        self.pfn_bn_scale = nn.Parameter(torch.ones(c))
        self.pfn_bn_bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('pfn_mean', torch.zeros(c))
        self.register_buffer('pfn_var', torch.ones(c))

    def forward(self, batch):
        voxels = batch['voxels']  # (B, V, P, 4)
        npts = batch['voxel_num_points']  # (B, V)
        coords = batch['voxel_coords']  # (B, V, 3) zyx
        cdt = self.dtype or voxels.dtype

        pillar_valid = npts > 0
        denom = npts.to(voxels.dtype).clamp(min=1.0)[..., None]
        points_mean = voxels[..., :3].sum(dim=2) / denom  # (B, V, 3)
        vx, vy, vz = self.voxel_size
        off = self.point_cloud_range
        centers = torch.stack([
            coords[..., 2].to(voxels.dtype) * vx + (vx / 2 + off[0]),
            coords[..., 1].to(voxels.dtype) * vy + (vy / 2 + off[1]),
            coords[..., 0].to(voxels.dtype) * vz + (vz / 2 + off[2]),
        ], dim=-1)  # (B, V, 3)

        inv = torch.rsqrt(self.pfn_var + BN_EPS) * self.pfn_bn_scale
        shift = self.pfn_bn_bias - self.pfn_mean * inv
        k = self.pfn_kernel
        k_xyz, k_i, k_cl, k_ce = k[0:3], k[3:4], k[4:7], k[7:10]
        w4 = torch.cat([k_xyz + k_cl + k_ce, k_i], dim=0) * inv  # (4, C)
        mean_c = points_mean - centers
        pillar_bias = (centers @ k_xyz - mean_c @ k_cl) * inv + shift
        ctr4 = torch.cat([centers, torch.zeros_like(centers[..., :1])], dim=-1)
        features = pillar_vfe(voxels.contiguous(), ctr4, pillar_bias.contiguous(),
                              npts.contiguous(), w4.to(cdt), shift,
                              out_dtype=cdt)
        # zero invalid pillars so the scatter writes zeros
        features = features * pillar_valid[..., None].to(features.dtype)
        return {**batch, 'pillar_features': features}
