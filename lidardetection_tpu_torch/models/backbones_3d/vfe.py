"""Voxel feature encoders: MeanVFE and PillarVFE
(lidardetection_tpu/models/backbones_3d/vfe.py:17-223).

Batch layout: voxels (B, V, P, C) float32 at fixed capacity,
voxel_num_points (B, V) int32 (0 marks an empty slot), voxel_coords
(B, V, 3) int32 (z, y, x), -1 padded.

At eval BN is an affine, so the 10-feature augmentation
[xyz, i, xyz - mean, xyz - center] @ K splits into a per-point product of
the centered point with a (4, C) weight and a per-pillar bias row (the
algebra is in the JAX package's ops/vfe_tpu.py docstring). The per-point
part and the max over points run in kernel K1 (ops/vfe_cuda.py).

Training needs the batch statistics of the per-point activations, so it
materializes the (B, V, P, 10) @ (10, C) product in the compute dtype, as
the JAX package does, and shares ``pfn_kernel`` and ``pfn_bn_*`` with the
eval branch. Its BatchNorm statistics ``pfn_mean``/``pfn_var`` move by
``momentum`` (named in ``bn_statistics`` for precise-BN,
engine/bn_recalibrate.py).

Any other PillarVFE (several PFN layers, no BatchNorm, relative xyz,
the distance feature, or points with other than 4 features, as NuScenes'
5) takes the JAX package's general path (vfe.py:29-55 and :104-125): the
concatenated point features, masked, through a stack of `PFNLayer`s. K1's
contract (4 features, one layer) does not cover it, so no kernel runs
there, as in the JAX package.
"""

import torch
from torch import nn

from ...ops.vfe_cuda import pillar_vfe
from ...parallel.dist import batch_moments
from ..layers import BN_EPS, BN_MOMENTUM, Dense, MaskedBatchNorm, lecun_normal_


class MeanVFE(nn.Module):
    """Mean of the points of each voxel -> ``voxel_features`` (B, V, C)."""

    def forward(self, batch):
        voxels = batch['voxels']  # (B, V, P, C)
        denom = batch['voxel_num_points'].to(voxels.dtype).clamp(min=1.0)
        return {**batch, 'voxel_features': voxels.sum(dim=2) / denom[..., None]}


class PFNLayer(nn.Module):
    """Linear (+ masked BatchNorm) + ReLU, then the max over a pillar's
    points (vfe.py:29-55): the last layer returns (B, V, C), the others
    (B, V, P, C) with the max beside each point's C / 2 channels.
    ``dense.0`` and ``bn`` are flax's ``Dense_0`` and
    ``MaskedBatchNorm_0``; the Dense has a bias only without the norm."""

    def __init__(self, in_channels, out_channels, use_norm=True,
                 last_layer=False, dtype=None, generator=None):
        super().__init__()
        out = out_channels if last_layer else out_channels // 2
        self.last_layer, self.dtype = last_layer, dtype
        self.dense = nn.ModuleList([Dense(in_channels, out, bias=not use_norm,
                                          dtype=dtype, generator=generator)])
        self.bn = MaskedBatchNorm(out, axis=-1) if use_norm else None

    def forward(self, x, pillar_valid):
        x = self.dense[0](x)
        if self.bn is not None:
            # every point row of a valid pillar enters the statistics
            x = self.bn(x, mask=pillar_valid[..., None].expand(x.shape[:-1]))
        x = torch.relu(x)
        x_max = x.amax(dim=2, keepdim=True)
        if self.last_layer:
            return x_max.squeeze(2)
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarVFE(nn.Module):
    """The single-PFN layer of 4-feature points (K1's path) keeps its
    parameters here, ``pfn_*``; any other config builds ``pfn_layers``,
    whose BatchNorms hold their own statistics."""

    @property
    def bn_statistics(self):
        """The running statistics of the single-PFN path, for precise-BN;
        absent (AttributeError, so ``hasattr`` is false) on the stack."""
        if not self.fast:
            raise AttributeError('bn_statistics')
        return ('pfn_mean', 'pfn_var')

    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, dtype=None, generator=None):
        super().__init__()
        num_filters = list(model_cfg['NUM_FILTERS'])
        self.use_abs_xyz = model_cfg.get('USE_ABSLOTE_XYZ', True)  # sic
        self.with_distance = model_cfg.get('WITH_DISTANCE', False)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.dtype = dtype
        self.fast = (len(num_filters) == 1 and model_cfg.get('USE_NORM', True)
                     and self.use_abs_xyz and not self.with_distance
                     and num_point_features == 4)
        if not self.fast:
            c_in = num_point_features + 6 - (0 if self.use_abs_xyz else 3) \
                + int(self.with_distance)
            layers = []
            for i, nf in enumerate(num_filters):
                last = i == len(num_filters) - 1
                layers.append(PFNLayer(c_in, nf, model_cfg.get('USE_NORM', True),
                                       last, dtype=dtype, generator=generator))
                c_in = nf
            self.pfn_layers = nn.ModuleList(layers)
            return
        c = num_filters[0]
        # rows of pfn_kernel: [xyz (3), intensity (1), cluster (3), center (3)]
        self.pfn_kernel = nn.Parameter(torch.empty(10, c))
        lecun_normal_(self.pfn_kernel, 10, generator)
        self.pfn_bn_scale = nn.Parameter(torch.ones(c))
        self.pfn_bn_bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('pfn_mean', torch.zeros(c))
        self.register_buffer('pfn_var', torch.ones(c))
        self.momentum = BN_MOMENTUM

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

        if not self.fast:
            features = self._pfn_stack(voxels, npts, pillar_valid,
                                       points_mean, centers)
            features = features * pillar_valid[..., None].to(features.dtype)
            return {**batch, 'pillar_features': features}
        if self.training:
            features = self._train_features(voxels, npts, pillar_valid,
                                            points_mean, centers, cdt)
            features = features * pillar_valid[..., None].to(features.dtype)
            return {**batch, 'pillar_features': features}

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

    def _train_features(self, voxels, npts, pillar_valid, points_mean,
                        centers, cdt):
        """Linear + BN (batch statistics) + ReLU + max over the P slots.

        The statistics run over all P slots of the valid pillars: padded
        points count, as zeros, and no slot is masked before the max.
        """
        p = voxels.shape[2]
        point_mask = (torch.arange(p, device=voxels.device) < npts[..., None]) \
            & pillar_valid[..., None]
        xyz = voxels[..., :3]
        aug = torch.cat([voxels, xyz - points_mean[:, :, None],
                         xyz - centers[:, :, None]], dim=-1)
        aug = aug * point_mask[..., None].to(aug.dtype)
        z = aug.to(cdt) @ self.pfn_kernel.to(cdt)  # (B, V, P, C)
        zf = z.float()
        m = pillar_valid[..., None, None].float()
        s1 = (zf * m).sum((0, 1, 2))
        s2 = (zf * zf * m).sum((0, 1, 2))
        mean, var = batch_moments(m.sum() * p, s1, s2)  # the group's
        with torch.no_grad():
            m = self.momentum
            self.pfn_mean.copy_(m * self.pfn_mean + (1 - m) * mean)
            self.pfn_var.copy_(m * self.pfn_var + (1 - m) * var)
        inv = torch.rsqrt(var + BN_EPS) * self.pfn_bn_scale
        shift = self.pfn_bn_bias - mean * inv
        x = z * inv.to(z.dtype) + shift.to(z.dtype)
        return torch.relu(x).amax(dim=2)

    def _pfn_stack(self, voxels, npts, pillar_valid, points_mean, centers):
        """The general path: [point features (absolute xyz or not), cluster
        offset, centre offset, (distance)], padding points and pillars
        zeroed, through the PFN layers."""
        p = voxels.shape[2]
        xyz = voxels[..., :3]
        feats = [voxels if self.use_abs_xyz else voxels[..., 3:],
                 xyz - points_mean[:, :, None], xyz - centers[:, :, None]]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        features = torch.cat(feats, dim=-1)
        point_mask = (torch.arange(p, device=voxels.device) < npts[..., None]) \
            & pillar_valid[..., None]
        features = features * point_mask[..., None].to(features.dtype)
        for layer in self.pfn_layers:
            features = layer(features, pillar_valid)
        return features
