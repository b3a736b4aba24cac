"""PointNet++ set abstraction, channels-last (lidardetection_tpu/models/
backbones_3d/pointnet2_modules.py:19-180).

The shared MLPs are Dense + BatchNorm + ReLU over the (B, M, nsample, C)
group tensor. Their BatchNorms use eps 1e-5 and momentum 0.9, not the
detector's 1e-3 / 0.99. Only the ``npoint`` branch is ported (with and
without source features), as VSA calls it: relative coordinates always
join the features (``use_xyz``) and a group whose query found no neighbour
outputs zeros (``zero_empty``). GroupAll (``npoint=None``) is PointRCNN's.

With source features the first MLP layer is split, as in the JAX package:
``pre_proj_i`` projects the N source rows once, the projections are
gathered per group in their own dtype, and ``xyz_proj_i`` adds the
projected relative coordinates. The JAX package's eval-time bit-cast
packing of bf16 projections into float32 pairs (:104-123) gives the same
values and exists for XLA's gather billing; it has no counterpart here.
"""

import torch
from torch import nn

from ...ops import pointnet2 as p2
from ..layers import POINT_BN, Dense, MaskedBatchNorm

GROUP_ALL_NOT_PORTED = ('GroupAll set abstraction (npoint=None) is not ported '
                        'yet: see ROADMAP.md queue 1, "PointRCNN"')


class SharedMLP(nn.Module):
    """Dense (no bias) + BatchNorm + ReLU per channel count, over the last
    dim. ``dense.<n>`` / ``bn.<n>`` are flax's ``Dense_<n>`` /
    ``MaskedBatchNorm_<n>``."""

    def __init__(self, in_channels, channels, dtype=None, generator=None):
        super().__init__()
        dense, bn = [], []
        for c in channels:
            dense.append(Dense(in_channels, c, bias=False, dtype=dtype,
                               generator=generator))
            bn.append(MaskedBatchNorm(c, axis=-1, **POINT_BN))
            in_channels = c
        self.dense, self.bn = nn.ModuleList(dense), nn.ModuleList(bn)

    def forward(self, x, mask=None):
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x), mask=mask))
        return x


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (the npoint branch).

    Args:
        npoint: centers sampled by FPS when none are given.
        radii, nsamples, mlps: one entry per scale (mlps without the input
            width).
        in_channels: width of the source features, 0 for none.
        knobs: ``ops.pointnet2.PointOpKnobs`` (None = exact).
    """

    def __init__(self, npoint, radii, nsamples, mlps, in_channels,
                 knobs=None, dtype=None, generator=None):
        super().__init__()
        if npoint is None:
            raise NotImplementedError(GROUP_ALL_NOT_PORTED)
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), \
            tuple(nsamples)
        self.knobs = knobs
        kw = {'dtype': dtype, 'generator': generator}
        self.split = in_channels > 0
        if self.split:
            c0s = [int(m[0]) for m in mlps]
            self.pre_proj = nn.ModuleList(
                Dense(in_channels, c0, bias=False, **kw) for c0 in c0s)
            self.xyz_proj = nn.ModuleList(
                Dense(3, c0, bias=False, **kw) for c0 in c0s)
            self.pre_bn = nn.ModuleList(
                MaskedBatchNorm(c0, axis=-1, **POINT_BN) for c0 in c0s)
            self.mlps = nn.ModuleList(
                SharedMLP(int(m[0]), m[1:], **kw) for m in mlps)
        else:
            self.mlps = nn.ModuleList(SharedMLP(3, m, **kw) for m in mlps)
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, features, xyz_num, new_xyz=None, new_xyz_num=None):
        """xyz (B, N, 3); features (B, N, C) or None; xyz_num (B,).

        Returns new_xyz (B, M, 3), new_features (B, M, sum C_out),
        new_xyz_num (B,)."""
        if new_xyz is None:
            fps_idx = p2.fps(xyz, xyz_num, self.npoint, knobs=self.knobs)
            new_xyz = p2.group_points(xyz, fps_idx[..., None]).squeeze(2)
            new_xyz_num = torch.clamp(xyz_num, max=self.npoint)
        m = new_xyz.shape[1]
        center_valid = torch.arange(m, device=xyz.device) < new_xyz_num[:, None]
        queries = p2.ball_query_multi(self.radii, self.nsamples, xyz, xyz_num,
                                      new_xyz, center_valid, knobs=self.knobs)
        if self.split:  # each Dense computes in the model's dtype
            projs = [proj(features) for proj in self.pre_proj]
        outs = []
        for ri, (idx, empty) in enumerate(queries):
            grouped_xyz = p2.group_points(xyz, idx) - new_xyz[:, :, None, :]
            mask = center_valid[:, :, None].expand(idx.shape)
            if self.split:
                x = p2.group_points(projs[ri], idx) \
                    + self.xyz_proj[ri](grouped_xyz)
                x = torch.relu(self.pre_bn[ri](x, mask=mask))
                out = self.mlps[ri](x, mask)
            else:
                out = self.mlps[ri](grouped_xyz, mask)
            out = out.amax(dim=2)  # (B, M, C_out)
            keep = center_valid & ~empty
            outs.append(out * keep[..., None].to(out.dtype))
        return new_xyz, torch.cat(outs, dim=-1), new_xyz_num
