"""PointRCNN's second stage (lidardetection_tpu/models/roi_heads/
pointrcnn_head.py): proposals, RoI point pooling (NUM_SAMPLED_POINTS a
RoI), the canonical transform, the xyz-up MLP and its merge with the point
features, a PointNet set abstraction stack over each RoI's points, and the
class and box FCs.

The pooled points and the point scores carry no gradient (the reference
pools without it); the RoIs do, through the canonical transform, so the
RCNN losses reach the point head's boxes as in the JAX package. The
(B, R) RoIs form one (B * R)-sample batch for the set abstractions. The
canonical rotation by -heading is elementwise float32.

Training takes the proposals of ``NMS_CONFIG.TRAIN``, samples
ROI_PER_IMAGE of them with their targets (``roi_head_utils``, four
uniform draws a sample from ``draw(name, shape)``), pools and classifies
those and emits ``roi_head_fwd`` for `loss`.
"""

import torch
from torch import nn

from ...core.box_coders import build_box_coder
from ...core.geometry import enlarge_box3d, rotate_points_along_z
from ...ops.roi_pool import roipoint_pool3d
from ..backbones_3d.pointnet2_modules import PointnetSAModuleMSG
from ..dense_heads.point_head import FCLayers
from ..layers import POINT_BN, Dense, MaskedBatchNorm
from . import roi_head_utils

N_PREFIX = 5  # pooled xyz, point score, depth: the xyz-up MLP's input


class ConvMLP(nn.Module):
    """Dense (with bias unless BatchNorm follows) (+ BatchNorm) + ReLU per
    width (pointrcnn_head.py:21-40); ``dense.<n>`` / ``bn.<n>`` are flax's
    ``Dense_<n>`` / ``MaskedBatchNorm_<n>``."""

    def __init__(self, in_channels, channels, use_bn=False, dtype=None,
                 generator=None):
        super().__init__()
        dense, bn = [], []
        for c in channels:
            dense.append(Dense(in_channels, c, bias=not use_bn, dtype=dtype,
                               generator=generator))
            if use_bn:
                bn.append(MaskedBatchNorm(c, axis=-1, **POINT_BN))
            in_channels = c
        self.dense, self.bn = nn.ModuleList(dense), nn.ModuleList(bn)

    def forward(self, x):
        for i, dense in enumerate(self.dense):
            x = dense(x)
            if len(self.bn):
                x = self.bn[i](x)
            x = torch.relu(x)
        return x


class PointRCNNHead(nn.Module):
    """``conv_mlps.0`` is the xyz-up MLP and ``conv_mlps.1`` the merge
    (flax's ``ConvMLP_0`` / ``ConvMLP_1``), ``sa_layers.<n>`` the set
    abstractions, ``fc_heads.0`` class and ``fc_heads.1`` box residuals
    (``FCHead_0`` / ``FCHead_1``)."""

    def __init__(self, model_cfg, input_channels, num_class=1, knobs=None,
                 dtype=None, generator=None):
        super().__init__()
        self.model_cfg = model_cfg
        tc = model_cfg['TARGET_CONFIG']
        self.box_coder = build_box_coder(tc['BOX_CODER'],
                                         **tc.get('BOX_CODER_CONFIG', {}))
        kw = {'dtype': dtype, 'generator': generator}
        use_bn = model_cfg.get('USE_BN', False)
        up = list(model_cfg['XYZ_UP_LAYER'])
        self.conv_mlps = nn.ModuleList([
            ConvMLP(N_PREFIX, up, use_bn=use_bn, **kw),
            ConvMLP(up[-1] + input_channels, up[-1:], use_bn=use_bn, **kw)])
        sa_cfg = model_cfg['SA_CONFIG']
        sa, channels = [], up[-1]
        for k, npoint in enumerate(sa_cfg['NPOINTS']):
            sa.append(PointnetSAModuleMSG(
                npoint=None if npoint == -1 else npoint,
                radii=[sa_cfg['RADIUS'][k]], nsamples=[sa_cfg['NSAMPLE'][k]],
                mlps=[list(sa_cfg['MLPS'][k])], in_channels=channels,
                knobs=knobs, **kw))
            channels = sa[-1].out_channels
        self.sa_layers = nn.ModuleList(sa)
        self.fc_heads = nn.ModuleList([
            FCLayers(channels, model_cfg['CLS_FC'], num_class, **kw),
            FCLayers(channels, model_cfg['REG_FC'],
                     self.box_coder.code_size * num_class, **kw)])
        with torch.no_grad():  # the box head's final layer: normal(0.001)
            self.fc_heads[1].dense[-1].kernel.normal_(0.0, 0.001,
                                                      generator=generator)

    def pool(self, batch, rois, roi_valid):
        """The RoIs' pooled points in their canonical frames, (B, R, S, 5 +
        C) of ``[local xyz, score, depth, point features]``, zero for an
        empty RoI (:88-135)."""
        cfg = self.model_cfg['ROI_POINT_POOL']
        coords = batch['point_coords']
        depth = torch.linalg.vector_norm(coords, dim=-1) \
            / cfg['DEPTH_NORMALIZER'] - 0.5
        feats = torch.cat([batch['point_cls_scores'].detach()[..., None],
                           depth[..., None], batch['point_features']], -1)
        pooled, empty = roipoint_pool3d(
            coords, feats, batch['num_points'],
            enlarge_box3d(rois[..., :7], cfg['POOL_EXTRA_WIDTH']), roi_valid,
            num_sampled_points=int(cfg['NUM_SAMPLED_POINTS']))
        pooled = pooled.detach()
        b, r, s = pooled.shape[:3]
        local = rotate_points_along_z(
            (pooled[..., 0:3] - rois[..., None, 0:3]).reshape(b * r, s, 3),
            -rois[..., 6].reshape(-1)).reshape(b, r, s, 3)
        pooled = torch.cat([local, pooled[..., 3:]], -1)
        return pooled.masked_fill(empty[..., None, None], 0.0)

    def forward(self, batch, draw=None):
        cfg = self.model_cfg
        if self.training and draw is None:
            raise ValueError('a training forward of the RoI head needs '
                             '`draw`, its source of uniforms')
        out = {**batch, **roi_head_utils.proposal_layer(
            batch, cfg['NMS_CONFIG']['TRAIN' if self.training else 'TEST'])}
        fwd = {}
        if self.training:
            b, n = out['rois'].shape[:2]
            r = int(cfg['TARGET_CONFIG']['ROI_PER_IMAGE'])
            draws = {name: draw(name, (b, n if size == 'N' else r))
                     for name, size in roi_head_utils.SAMPLE_DRAWS}
            fwd = roi_head_utils.assign_roi_targets(draws, out,
                                                    cfg['TARGET_CONFIG'])
            out.update(rois=fwd['rois'], roi_labels=fwd['roi_labels'],
                       roi_valid=torch.ones((b, r), dtype=torch.bool,
                                            device=out['rois'].device))
        rois, roi_valid = out['rois'], out['roi_valid']
        b, r = rois.shape[:2]
        pooled = self.pool(batch, rois, roi_valid)
        s = pooled.shape[2]
        # float32 pooled features with the bf16 xyz-up output: float32,
        # cast by the merge's Dense, as in JAX
        merged = self.conv_mlps[1](torch.cat(
            [self.conv_mlps[0](pooled[..., :N_PREFIX]),
             pooled[..., N_PREFIX:]], -1))
        xyz = pooled[..., 0:3].reshape(b * r, s, 3)
        feats = merged.reshape(b * r, s, -1)
        num = torch.full((b * r,), s, dtype=torch.int32, device=rois.device)
        for sa in self.sa_layers:
            xyz, feats, num = sa(xyz, feats, num)
        shared = feats.reshape(b * r, -1)
        rcnn_cls, rcnn_reg = self.fc_heads[0](shared), self.fc_heads[1](shared)
        if self.training:
            fwd.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
            out['roi_head_fwd'] = fwd
            return out
        cls_b, box_b = roi_head_utils.generate_rcnn_boxes(
            rois, rcnn_cls, rcnn_reg, self.box_coder)
        out.update({'batch_cls_preds': cls_b, 'batch_box_preds': box_b,
                    'batch_valid_preds': roi_valid,
                    'cls_preds_normalized': False})
        return out

    def loss(self, fwd):
        """The RCNN class and box losses (pointrcnn_head.py:171-177)."""
        loss_cfg = self.model_cfg['LOSS_CONFIG']
        cls_loss, tb_cls = roi_head_utils.roi_cls_loss(fwd, loss_cfg)
        reg_loss, tb_reg = roi_head_utils.roi_box_loss(fwd, self.box_coder,
                                                       loss_cfg)
        total = cls_loss + reg_loss
        return total, {**tb_cls, **tb_reg, 'rcnn_loss': total}
