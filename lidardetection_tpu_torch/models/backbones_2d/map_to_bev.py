"""Sparse -> dense BEV projection (lidardetection_tpu/models/backbones_2d/
map_to_bev.py): PointPillarScatter (:17-37) and HeightCompression (:40-54).

Pillar rows go to their BEV cell through kernel K2 (ops/scatter_cuda.py);
padding pillars key to the ny*nx spill slot, which the kernel drops.
"""

import torch
from torch import nn

from ...ops.scatter_cuda import scatter_rows


class PointPillarScatter(nn.Module):
    def __init__(self, grid_size, num_bev_features):
        super().__init__()
        self.nx, self.ny, nz = (int(g) for g in grid_size)
        if nz != 1:
            raise ValueError(f'PointPillarScatter needs nz == 1, got {nz}')
        self.num_bev_features = num_bev_features

    def forward(self, batch):
        feats = batch['pillar_features']  # (B, V, C)
        coords = batch['voxel_coords']  # (B, V, 3) zyx, -1 padded
        nx, ny = self.nx, self.ny
        keys = torch.where(coords[..., 0] >= 0,
                           coords[..., 1] * nx + coords[..., 2],
                           torch.full_like(coords[..., 0], ny * nx))
        canvas = scatter_rows(feats.contiguous(),
                              keys.to(torch.int32).contiguous(), ny * nx)
        spatial = canvas.view(feats.shape[0], ny, nx, feats.shape[-1])
        return {**batch, 'spatial_features': spatial}  # NHWC


class HeightCompression(nn.Module):
    """Dense 3D volume -> BEV by folding depth into channels:
    ``encoded_spconv_tensor`` (B, D, H, W, C) -> ``spatial_features``
    (B, H, W, C*D), channel index c*D + d as the reference folds
    (B, C, D, H, W) -> (B, C*D, H, W)."""

    def __init__(self, num_bev_features):
        super().__init__()
        self.num_bev_features = num_bev_features

    def forward(self, batch):
        x = batch['encoded_spconv_tensor']
        b, d, h, w, c = x.shape
        x = x.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)
        return {**batch, 'spatial_features': x,
                'spatial_features_stride':
                    batch.get('encoded_spconv_tensor_stride', 8)}
