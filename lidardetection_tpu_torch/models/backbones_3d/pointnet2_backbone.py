"""PointRCNN's PointNet++ backbone (lidardetection_tpu/models/backbones_3d/
pointnet2_backbone.py:16-73): four multi-scale set abstraction levels over
the raw points, then four feature propagation levels back to every point.

The batch holds ``points`` (B, N, 3 + C) at a fixed capacity and
``num_points`` (B,). ``sa_layers.<n>`` are flax's ``PointnetSAModuleMSG_<n>``;
``fp_layers.<n>`` are its ``PointnetFPModule_<n>`` in creation order, which
starts at the deepest level: ``fp_layers.0`` interpolates level 4 onto
level 3, ``fp_layers.3`` level 1 onto the points.
"""

from torch import nn

from .pointnet2_modules import PointnetFPModule, PointnetSAModuleMSG


class PointNet2MSG(nn.Module):
    """Args: model_cfg, the BACKBONE_3D section; input_channels, 3 + the
    point features (x, y, z first); knobs, ``ops.pointnet2.PointOpKnobs``
    of the set abstractions' FPS and ball queries (None = exact)."""

    def __init__(self, model_cfg, input_channels, knobs=None, dtype=None,
                 generator=None):
        super().__init__()
        sa_cfg = model_cfg['SA_CONFIG']
        kw = {'dtype': dtype, 'generator': generator}
        channel_in = input_channels - 3
        skip_channels = [channel_in]
        sa = []
        for k, npoint in enumerate(sa_cfg['NPOINTS']):
            mlps = [list(m) for m in sa_cfg['MLPS'][k]]
            sa.append(PointnetSAModuleMSG(
                npoint=npoint, radii=sa_cfg['RADIUS'][k],
                nsamples=sa_cfg['NSAMPLE'][k], mlps=mlps,
                in_channels=channel_in, knobs=knobs, **kw))
            channel_in = sa[-1].out_channels
            skip_channels.append(channel_in)
        self.sa_layers = nn.ModuleList(sa)
        fp_mlps = model_cfg['FP_MLPS']
        fp = []
        # JAX's loop from i = -1: level i's features onto level i - 1
        for i in range(-1, -(len(fp_mlps) + 1), -1):
            known = fp_mlps[i + 1][-1] if i < -1 else skip_channels[-1]
            fp.append(PointnetFPModule(known + skip_channels[i - 1],
                                       fp_mlps[i], **kw))
        self.fp_layers = nn.ModuleList(fp)
        self.num_point_features = fp_mlps[0][-1]

    def forward(self, batch):
        points, num = batch['points'], batch['num_points']
        xyz = points[..., 0:3]
        features = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_feats, l_num = [xyz], [features], [num]
        for sa in self.sa_layers:
            new_xyz, new_feats, new_num = sa(l_xyz[-1], l_feats[-1], l_num[-1])
            l_xyz.append(new_xyz)
            l_feats.append(new_feats)
            l_num.append(new_num)
        for k, fp in enumerate(self.fp_layers):
            i = -1 - k
            l_feats[i - 1] = fp(l_xyz[i - 1], l_xyz[i], l_feats[i - 1],
                                l_feats[i], l_num[i - 1], l_num[i])
        return {**batch, 'point_features': l_feats[0].float(),
                'point_coords': xyz}
