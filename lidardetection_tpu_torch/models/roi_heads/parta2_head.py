"""Part-A²'s second stage (lidardetection_tpu/models/roi_heads/
parta2_head.py:22-169): proposals, RoI-aware pooling of the part features
and of the UNet's point features into POOL_SIZE^3 grids, two branches of
masked dense convolutions, the merge, the shared FC and the class and box
heads.

The reference runs submanifold sparse convolutions over the pooled grids;
the grids are small and dense, and a submanifold convolution there is a
dense 3x3x3 convolution of the input zeroed at the inactive cells, its
output masked back to the active ones (``MaskedDenseSubMConv3d``). The
grids are kept channels-first (B*R, C, X, Y, Z), so the merge flattens
channel-major as the reference does. The convolutions and the shared FC
(221184 x 256 at POOL_SIZE 12) are PyTorch's dense operators; the JAX
package computes them outside any Pallas kernel.

Training takes the proposals of ``NMS_CONFIG.TRAIN``, samples
ROI_PER_IMAGE of them with their targets (``roi_head_utils``, PV-RCNN's),
pools and classifies those, with dropout after every shared FC but the
last, and emits ``roi_head_fwd`` for `loss`. Random numbers come from
``draw(name, shape)``, as in ``pvrcnn_head``: the RoI sampling's four
draws a sample and ``dropout_<n>``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...core.box_coders import build_box_coder
from ...ops.roi_pool import roi_point_sample, roiaware_pool3d
from ..dense_heads.point_head import FCLayers
from ..layers import POINT_BN, Dense, MaskedBatchNorm, dropout, lecun_normal_
from . import roi_head_utils


class MaskedDenseSubMConv3d(nn.Module):
    """A submanifold convolution over a dense (N, C, X, Y, Z) grid with an
    activity mask (N, X, Y, Z) (parta2_head.py:22-44): inactive inputs
    zeroed, a 3x3x3 convolution with padding 1 and no bias in `dtype`,
    BatchNorm over the active cells (eps 1e-3, momentum 0.99), ReLU, the
    output masked again. ``weight`` is (C_out, C_in, 3, 3, 3) over the
    grid axes (X, Y, Z), the flax kernel (3, 3, 3, C_in, C_out)
    transposed."""

    def __init__(self, in_channels, out_channels, dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3, 3))
        lecun_normal_(self.weight, 27 * in_channels, generator)
        self.bn = MaskedBatchNorm(out_channels, axis=1)

    def forward(self, x, active):
        mask = active[:, None].to(x.dtype)
        x = x * mask
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.conv3d(x, self.weight.to(x.dtype), padding=1)
        x = torch.relu(self.bn(x, mask=active))
        return x * active[:, None].to(x.dtype)


class PartA2FCHead(nn.Module):
    """``sub_convs`` are flax's ``MaskedDenseSubMConv3d_<n>`` (0 and 1 the
    part branch, 2 and 3 the point-feature branch); ``dense.<n>`` /
    ``bn.<n>`` the shared FC; ``fc_heads.0`` (class) and ``fc_heads.1``
    (box residuals) flax's ``FCHead_0`` and ``FCHead_1``."""

    def __init__(self, model_cfg, input_channels, num_class=1, dtype=None,
                 generator=None):
        super().__init__()
        self.model_cfg = model_cfg
        tc = model_cfg['TARGET_CONFIG']
        self.box_coder = build_box_coder(tc['BOX_CODER'],
                                         **tc.get('BOX_CODER_CONFIG', {}))
        pool = model_cfg['ROI_AWARE_POOL']
        self.pool_size = int(pool['POOL_SIZE'])
        c0 = int(pool['NUM_FEATURES']) // 2
        kw = {'dtype': dtype, 'generator': generator}
        self.sub_convs = nn.ModuleList([
            MaskedDenseSubMConv3d(4, 64, **kw),
            MaskedDenseSubMConv3d(64, c0, **kw),
            MaskedDenseSubMConv3d(input_channels, 64, **kw),
            MaskedDenseSubMConv3d(64, c0, **kw)])
        c = 2 * c0 * self.pool_size ** 3
        dense, bn = [], []
        for width in model_cfg['SHARED_FC']:
            dense.append(Dense(c, width, bias=False, **kw))
            bn.append(MaskedBatchNorm(width, axis=-1, **POINT_BN))
            c = width
        self.dense, self.bn = nn.ModuleList(dense), nn.ModuleList(bn)
        self.fc_heads = nn.ModuleList([
            FCLayers(c, model_cfg['CLS_FC'], num_class, **kw),
            FCLayers(c, model_cfg['REG_FC'],
                     self.box_coder.code_size * num_class, **kw)])
        with torch.no_grad():  # the box head's final layer: normal(0.001)
            self.fc_heads[1].dense[-1].kernel.normal_(0.0, 0.001,
                                                      generator=generator)

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
        ps = self.pool_size

        # the part features: the part offsets (the raw point coordinates
        # with DISABLE_PART, the anchor-free variant) where the (detached)
        # score passes SEG_MASK_SCORE_THRESH, else 0, and the score
        coords = batch['point_coords']
        scores = out['point_cls_scores'].detach()
        keep = scores >= cfg['SEG_MASK_SCORE_THRESH']
        part = coords if cfg.get('DISABLE_PART', False) \
            else out['point_part_offset']
        part = part * keep[..., None]
        part_features = torch.cat([part, scores[..., None]], dim=-1)
        num = batch['point_valid'].sum(1)

        # one sampling of the in-box points feeds both pools
        sample = roi_point_sample(coords, num, rois[..., :7], roi_valid,
                                  cap=int(cfg.get('ROI_POINT_CAP', 1024)))
        pooled_part = roiaware_pool3d(coords, part_features, rois, sample,
                                      (ps, ps, ps), 'avg')
        pooled_rpn = roiaware_pool3d(coords, batch['point_features'], rois,
                                     sample, (ps, ps, ps), 'max')
        # (B, R, X, Y, Z, C) -> (B*R, C, X, Y, Z)
        pooled_part = pooled_part.reshape(b * r, ps, ps, ps, -1).permute(
            0, 4, 1, 2, 3)
        pooled_rpn = pooled_rpn.reshape(b * r, ps, ps, ps, -1).permute(
            0, 4, 1, 2, 3)
        active = pooled_part.abs().sum(1) > 0  # (B*R, X, Y, Z)

        x_part = self.sub_convs[1](self.sub_convs[0](pooled_part, active),
                                   active)
        x_rpn = self.sub_convs[3](self.sub_convs[2](pooled_rpn, active),
                                  active)
        # channel-major (C, X, Y, Z) flattening, the reference's
        x = torch.cat([x_rpn, x_part], dim=1).reshape(b * r, -1)
        rate = float(cfg.get('DP_RATIO', 0))
        last = len(self.dense) - 1
        for i, (dense, bn) in enumerate(zip(self.dense, self.bn)):
            x = torch.relu(bn(dense(x)))
            if self.training and rate > 0 and i != last:
                x = dropout(x, draw(f'dropout_{i}', x.shape), rate)
        rcnn_cls, rcnn_reg = self.fc_heads[0](x), self.fc_heads[1](x)
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
        """The RCNN class and box losses (parta2_head.py:163-169)."""
        loss_cfg = self.model_cfg['LOSS_CONFIG']
        cls_loss, tb_cls = roi_head_utils.roi_cls_loss(fwd, loss_cfg)
        reg_loss, tb_reg = roi_head_utils.roi_box_loss(fwd, self.box_coder,
                                                       loss_cfg)
        total = cls_loss + reg_loss
        return total, {**tb_cls, **tb_reg, 'rcnn_loss': total}
