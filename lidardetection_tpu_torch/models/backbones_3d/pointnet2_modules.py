"""PointNet++ set abstraction and feature propagation, channels-last
(lidardetection_tpu/models/backbones_3d/pointnet2_modules.py:19-204).

The shared MLPs are Dense + BatchNorm + ReLU over the (B, M, nsample, C)
group tensor. Their BatchNorms use eps 1e-5 and momentum 0.9, not the
detector's 1e-3 / 0.99. Relative coordinates always join the features
(``use_xyz``). With ``zero_empty`` (VSA's) a group whose query found no
neighbour outputs zeros; without it (PointRCNN's) the group repeats source
0, as the query back-fills it. ``npoint=None`` is GroupAll: one group of
every point, centred at the origin, the absolute xyz joined to the
features, no FPS and no query.

With source features and ``npoint`` set the first MLP layer is split, as
in the JAX package: ``pre_proj_i`` projects the N source rows once, the
projections are gathered per group in their own dtype, and ``xyz_proj_i``
adds the projected relative coordinates. The JAX package's eval-time
bit-cast packing of bf16 projections into float32 pairs (:104-123) gives
the same values and exists for XLA's gather billing; it has no
counterpart here.
"""

import torch
from torch import nn

from ...ops import pointnet2 as p2
from ..layers import POINT_BN, Dense, MaskedBatchNorm


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
    """Multi-scale-grouping set abstraction.

    Args:
        npoint: centers sampled by FPS when none are given; None for
            GroupAll.
        radii, nsamples, mlps: one entry per scale (mlps without the input
            width).
        in_channels: width of the source features, 0 for none.
        zero_empty: zeros for a group with no neighbour.
        knobs: ``ops.pointnet2.PointOpKnobs`` (None = exact).
    """

    def __init__(self, npoint, radii, nsamples, mlps, in_channels,
                 zero_empty=False, knobs=None, dtype=None, generator=None):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), \
            tuple(nsamples)
        self.zero_empty, self.knobs = zero_empty, knobs
        kw = {'dtype': dtype, 'generator': generator}
        self.split = in_channels > 0 and npoint is not None
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
            self.mlps = nn.ModuleList(SharedMLP(3 + in_channels, m, **kw)
                                      for m in mlps)
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, features, xyz_num, new_xyz=None, new_xyz_num=None):
        """xyz (B, N, 3); features (B, N, C) or None; xyz_num (B,).

        Returns new_xyz (B, M, 3), new_features (B, M, sum C_out),
        new_xyz_num (B,); M = 1 for GroupAll."""
        if self.npoint is None:
            return self._group_all(xyz, features)
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
            keep = center_valid & ~empty if self.zero_empty else center_valid
            outs.append(out * keep[..., None].to(out.dtype))
        return new_xyz, torch.cat(outs, dim=-1), new_xyz_num

    def _group_all(self, xyz, features):
        """One group of all N points (padding included, as in the JAX
        package), its centre the origin (:75-77, :164-172)."""
        b = xyz.shape[0]
        grouped = xyz[:, None]
        if features is not None:  # float32 xyz with bf16 features: float32
            grouped = torch.cat([grouped, features[:, None]], dim=-1)
        outs = [mlp(grouped).amax(dim=2) for mlp in self.mlps]
        return (xyz.new_zeros((b, 1, 3)), torch.cat(outs, dim=-1),
                torch.ones(b, dtype=torch.int32, device=xyz.device))


class PointnetFPModule(nn.Module):
    """Feature propagation (:183-204): each unknown point's three nearest
    known points, their features interpolated by inverse distance and
    joined to its own, then a SharedMLP over the valid points. ``mlps.0``
    is flax's ``SharedMLP_0``.

    Args: in_channels, the known features' width plus the unknown
    features' (0 for none); mlp, the widths.
    """

    def __init__(self, in_channels, mlp, dtype=None, generator=None):
        super().__init__()
        self.mlps = nn.ModuleList([SharedMLP(in_channels, mlp, dtype=dtype,
                                             generator=generator)])

    def forward(self, unknown, known, unknown_feats, known_feats,
                unknown_num, known_num):
        """unknown (B, n, 3), known (B, m, 3), features channels-last ->
        (B, n, mlp[-1]), zero past unknown_num."""
        dists, idx = p2.three_nn(unknown, known, known_num)
        weight = p2.three_nn_weights(dists)
        # bf16 features times float32 weights, joined to the unknown
        # features: float32, cast by the first Dense, as in JAX
        x = p2.three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], dim=-1)
        mask = torch.arange(unknown.shape[1], device=unknown.device) \
            < unknown_num[:, None]
        out = self.mlps[0](x, mask)
        return out * mask[..., None].to(out.dtype)
