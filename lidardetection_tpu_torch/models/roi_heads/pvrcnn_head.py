"""PV-RCNN's second stage (lidardetection_tpu/models/roi_heads/
pvrcnn_head.py:22-244): proposals, RoI-grid pooling of the keypoint
features, shared FC, class and box heads.

``RoIGridPool`` keeps the JAX module's design without its MXU form: each
RoI prefilters the ``CANDIDATE_CAP`` lowest-index keypoints within half
its diagonal plus the largest radius of its centre
(``ops/pointnet2.py::roi_candidates``); per grid point, the first
``nsample`` in-radius candidates are picked by rank
(``candidate_rank_select``) and their projected features gathered, where
the JAX package contracts a one-hot selection tensor on the MXU. The
selection is exact either way. Coordinates are re-centred on the RoI
centre in float32 before any bf16 cast (:106-117).

Training takes the proposals of ``NMS_CONFIG.TRAIN``, samples
ROI_PER_IMAGE of them with their targets (``roi_head_utils``), pools and
classifies those, with dropout after each shared FC, and emits
``roi_head_fwd`` for `loss`. Its random numbers come from ``draw(name,
shape)``, a caller's source of float32 uniforms in [0, 1): the RoI
sampling's four draws a sample and one per dropout layer
(``dropout_<n>``). In eval dropout is the identity.
"""

import torch
from torch import nn

from ...core.box_coders import build_box_coder
from ...core.geometry import rotate_points_along_z
from ...ops import pointnet2 as p2
from ...ops.gather import gather_rows
from ..backbones_3d.pointnet2_modules import SharedMLP
from ..dense_heads.point_head import FCLayers
from ..layers import POINT_BN, Dense, MaskedBatchNorm, dropout
from . import roi_head_utils


def get_dense_grid_points(rois, grid_size):
    """(..., 7) -> (..., g^3, 3) grid points in the RoI frame (:22-29)."""
    g = grid_size
    ar = torch.arange(g, dtype=torch.float32, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing='ij'), -1).reshape(-1, 3)
    local_size = rois[..., None, 3:6]
    return (idx + 0.5) / g * local_size - local_size / 2


def get_global_grid_points_of_roi(rois, grid_size):
    """(B, R, 7) -> (B, R, g^3, 3) world-frame grid points (:32-38)."""
    b, r = rois.shape[:2]
    local = get_dense_grid_points(rois, grid_size)
    flat = rotate_points_along_z(local.reshape(b * r, -1, 3),
                                 rois[..., 6].reshape(-1))
    return flat.reshape(b, r, -1, 3) + rois[..., None, 0:3]


class RoIGridPool(nn.Module):
    """Multi-scale pooling of keypoint features at RoI grid points
    (:41-142). ``pre_proj.<i>``, ``xyz_proj.<i>``, ``pre_bn.<i>`` and
    ``mlps.<i>`` carry flax's ``pre_proj_i``, ``xyz_proj_i``, ``pre_bn_i``
    and ``SharedMLP_i``."""

    def __init__(self, radii, nsamples, mlps, in_channels, k_cand=128,
                 dtype=None, generator=None):
        super().__init__()
        self.radii, self.nsamples = tuple(radii), tuple(nsamples)
        self.k_cand = int(k_cand)
        kw = {'dtype': dtype, 'generator': generator}
        c0s = [int(m[0]) for m in mlps]
        self.pre_proj = nn.ModuleList(
            Dense(in_channels, c0, bias=False, **kw) for c0 in c0s)
        self.xyz_proj = nn.ModuleList(Dense(3, c0, bias=False, **kw) for c0 in c0s)
        self.pre_bn = nn.ModuleList(
            MaskedBatchNorm(c0, axis=-1, **POINT_BN) for c0 in c0s)
        self.mlps = nn.ModuleList(SharedMLP(int(m[0]), m[1:], **kw) for m in mlps)
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, kp_xyz, kp_feats, kp_num, rois, roi_valid, grid_pts):
        """kp_xyz (B, N, 3); kp_feats (B, N, C); kp_num (B,); rois (B, R, 7);
        roi_valid (B, R); grid_pts (B, R, G, 3) -> (B, R, G, sum C_out)."""
        b, rr, gg = grid_pts.shape[:3]
        k = self.k_cand
        # the candidates and the selection are indices: no gradient
        sizes = rois[..., 3:6].detach()
        # eps-guarded norm: padded RoIs have zero sizes
        size2 = p2._sum3(sizes * sizes)
        r_cand = 0.5 * torch.sqrt(size2.clamp(min=1e-12)) + float(max(self.radii))
        r_cand = torch.where(roi_valid, r_cand, torch.zeros_like(r_cand))
        cand_idx, cand_live = p2.roi_candidates(
            kp_xyz, kp_num, rois[..., 0:3].detach(), r_cand, k)
        flat = cand_idx.reshape(b, rr * k, 1)
        cand_xyz = p2.group_points(kp_xyz, flat).reshape(b, rr, k, 3)
        ctr = rois[..., None, 0:3]
        cxyz_in, gpts_in = cand_xyz - ctr, grid_pts - ctr  # f32, then the cast

        outs = []
        for ri, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            proj = self.pre_proj[ri](kp_feats)
            c0 = proj.shape[-1]
            cand_proj = p2.group_points(proj, flat).reshape(b, rr, k, c0) \
                + self.xyz_proj[ri](cxyz_in)
            sel, empty = p2.candidate_rank_select(
                cand_xyz, cand_live, grid_pts.detach(), radius, nsample)
            grp = gather_rows(cand_proj.reshape(b * rr, k, c0),
                              sel.reshape(b * rr, gg * nsample))
            x = grp.reshape(b, rr, gg, nsample, c0) \
                - self.xyz_proj[ri](gpts_in)[:, :, :, None, :]
            x = x.masked_fill(empty[..., None, None], 0.0)
            x = x.reshape(b, rr * gg, nsample, c0)
            mask = roi_valid.repeat_interleave(gg, dim=1)[:, :, None].expand(
                x.shape[:3])
            x = torch.relu(self.pre_bn[ri](x, mask=mask))
            out = self.mlps[ri](x, mask).amax(dim=2).reshape(b, rr, gg, -1)
            keep = (roi_valid[:, :, None] & ~empty)[..., None]
            outs.append(out * keep.to(out.dtype))
        return torch.cat(outs, dim=-1)


class PVRCNNHead(nn.Module):
    """Proposals (NMS over the dense head's boxes), RoI-grid pooling,
    shared FC, ``fc_heads.0`` (class) and ``fc_heads.1`` (box residuals);
    eval emits the RoIs' class logits and decoded boxes for
    post-processing. ``dense.<n>`` / ``bn.<n>`` are the shared FC."""

    def __init__(self, model_cfg, input_channels, num_class=1, dtype=None,
                 generator=None):
        super().__init__()
        self.model_cfg = model_cfg
        tc = model_cfg['TARGET_CONFIG']
        self.box_coder = build_box_coder(tc['BOX_CODER'],
                                         **tc.get('BOX_CODER_CONFIG', {}))
        pool = model_cfg['ROI_GRID_POOL']
        self.grid_size = int(pool['GRID_SIZE'])
        self.roi_grid_pool = RoIGridPool(
            pool['POOL_RADIUS'], pool['NSAMPLE'], [list(m) for m in pool['MLPS']],
            input_channels, k_cand=pool.get('CANDIDATE_CAP', 128), dtype=dtype,
            generator=generator)
        c = self.grid_size ** 3 * self.roi_grid_pool.out_channels
        dense, bn = [], []
        for width in model_cfg['SHARED_FC']:
            dense.append(Dense(c, width, bias=False, dtype=dtype,
                               generator=generator))
            bn.append(MaskedBatchNorm(width, axis=-1, **POINT_BN))
            c = width
        self.dense, self.bn = nn.ModuleList(dense), nn.ModuleList(bn)
        reg_tracking = self.reg_tracking = bool(
            tc.get('REG_TRACKING_INFO', False))
        self.fc_heads = nn.ModuleList([
            FCLayers(c, model_cfg['CLS_FC'], num_class, dtype=dtype,
                     generator=generator),
            FCLayers(c, model_cfg['REG_FC'],
                     self.box_coder.code_size * num_class + 8 * reg_tracking,
                     dtype=dtype, generator=generator)])
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
        g = self.grid_size
        kp_feats = batch['point_features'] \
            * batch['point_cls_scores'].detach()[..., None]
        grid_pts = get_global_grid_points_of_roi(rois[..., :7], g)
        pooled = self.roi_grid_pool(batch['point_coords'], kp_feats,
                                    batch['num_keypoints'],
                                    rois[..., :7], roi_valid, grid_pts)
        # (B, R, g^3, C) -> (B*R, C*g^3): the reference's (C, g^3) flattening
        x = pooled.reshape(b * r, g ** 3, -1).transpose(1, 2).reshape(b * r, -1)
        rate = float(cfg.get('DP_RATIO', 0))
        for i, (dense, bn) in enumerate(zip(self.dense, self.bn)):
            x = torch.relu(bn(dense(x)))
            if self.training and rate > 0:
                x = dropout(x, draw(f'dropout_{i}', x.shape), rate)
        rcnn_cls, rcnn_reg = self.fc_heads[0](x), self.fc_heads[1](x)
        if self.training:
            fwd.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg,
                       reg_tracking_info=self.reg_tracking)
            out['roi_head_fwd'] = fwd
            return out
        cls_b, box_b = roi_head_utils.generate_rcnn_boxes(
            rois, rcnn_cls, rcnn_reg, self.box_coder)
        out.update({'batch_cls_preds': cls_b, 'batch_box_preds': box_b,
                    'batch_valid_preds': roi_valid,
                    'cls_preds_normalized': False})
        return out

    def loss(self, fwd):
        """The RCNN class and box losses (pvrcnn_head.py:238-244)."""
        loss_cfg = self.model_cfg['LOSS_CONFIG']
        cls_loss, tb_cls = roi_head_utils.roi_cls_loss(fwd, loss_cfg)
        reg_loss, tb_reg = roi_head_utils.roi_box_loss(fwd, self.box_coder,
                                                       loss_cfg)
        total = cls_loss + reg_loss
        return total, {**tb_cls, **tb_reg, 'rcnn_loss': total}
