"""Two-stage RoI machinery (lidardetection_tpu/models/roi_heads/
roi_head_utils.py): the proposal layer, RoI target sampling with the
canonical transform, the RCNN losses and the decode of the second stage's
boxes.

The sampling takes its random numbers as arguments: four uniform draws a
sample (``subsample_rois``), so a caller can hand it any source's draws,
the JAX package's included. Sorts are stable, as ``jnp.argsort`` is.
Gradients reach the RoIs, as in the JAX package: through the IoU that
sets the ``roi_iou`` class targets, the canonical transform and the
corner loss, into the dense head's boxes (the reference's proposal layer
runs without gradients; ROADMAP.md section 3).
"""

import numpy as np
import torch

from ...core import losses
from ...core.geometry import rotate_points_along_z
from ...core.iou3d import boxes_iou3d, nms_bev_batched
from ...ops.gather import gather_rows
from ...parallel.dist import batch_normalizer

# the names of the four uniform draws of a sample's RoI sampling, with the
# length of each: N (the proposals) or R (ROI_PER_IMAGE)
SAMPLE_DRAWS = (('roi_fg_perm', 'N'), ('roi_fg_rep', 'R'),
                ('roi_hard', 'R'), ('roi_easy', 'R'))


def proposal_layer(batch, nms_cfg):
    """Rotated-BEV NMS over the dense head's decoded boxes, scored by the
    largest raw class logit. Returns rois (B, P, 7+), roi_scores (B, P),
    roi_labels (B, P) 1-based (0 = empty), roi_valid (B, P), P =
    NMS_POST_MAXSIZE. NMS picks indices only, so it runs without autograd;
    the RoIs are gathered from the boxes with their gradient."""
    box_preds = batch['batch_box_preds']
    cls_preds = batch['batch_cls_preds']
    scores = cls_preds.amax(-1)
    labels = cls_preds.argmax(-1)
    idx, mask, _, _ = nms_bev_batched(
        box_preds[..., 0:7].detach(), scores.detach(),
        thresh=nms_cfg['NMS_THRESH'],
        pre_maxsize=int(nms_cfg['NMS_PRE_MAXSIZE']),
        post_maxsize=int(nms_cfg['NMS_POST_MAXSIZE']),
        valid_mask=batch.get('batch_valid_preds'))
    rois = gather_rows(box_preds, idx)
    return {
        'rois': rois * mask[..., None],
        'roi_scores': torch.where(mask, torch.gather(scores, 1, idx),
                                  torch.zeros_like(scores[:, :1])),
        'roi_labels': torch.where(mask, torch.gather(labels, 1, idx) + 1,
                                  torch.zeros_like(idx)),
        'roi_valid': mask,
    }


def generate_rcnn_boxes(rois, cls_preds, box_preds, box_coder):
    """The second stage's (B*R, ...) outputs as (B, R, nc) logits and world
    boxes: residuals decoded against the RoI at the origin, rotated by its
    heading, moved to its centre."""
    b, r = rois.shape[:2]
    code = box_coder.code_size
    local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:code]], -1)
    decoded = box_coder.decode(box_preds.reshape(b, r, -1)[..., 0:code], local)
    decoded = rotate_points_along_z(decoded.reshape(b * r, 1, -1),
                                    rois[..., 6].reshape(-1)).reshape(b, r, -1)
    decoded = torch.cat([decoded[..., 0:3] + rois[..., 0:3], decoded[..., 3:]], -1)
    return cls_preds.reshape(b, r, -1), decoded


def _masked_choice_with_replacement(u, member_mask):
    """u (B, R) uniforms in [0, 1), member_mask (B, N) -> (B, R) picks of
    the members, uniform with replacement, and the member counts (B,)
    (roi_head_utils.py:48)."""
    cnt = member_mask.sum(-1)
    order = torch.sort((~member_mask).to(torch.uint8), dim=-1, stable=True)[1]
    pick = torch.floor(u * cnt.clamp(min=1)[:, None].float()).long()
    return torch.gather(order, 1, pick), cnt


def _masked_permutation(u, member_mask):
    """u (B, N) uniforms -> a random order of each sample's members, the
    members first (roi_head_utils.py:64), and the member counts."""
    scores = torch.where(member_mask, u, torch.full_like(u, 2.0))
    return torch.sort(scores, dim=-1, stable=True)[1], member_mask.sum(-1)


def subsample_rois(draws, max_overlaps, roi_valid, sampler_cfg):
    """ROI_PER_IMAGE RoIs a sample, foreground, hard and easy background
    in the reference's shares (roi_head_utils.py:72-126).

    Args: draws, the four uniform draws of ``SAMPLE_DRAWS`` by name, (B, N)
    or (B, R); max_overlaps (B, N); roi_valid (B, N). Returns (B, R) int64
    indices into N.
    """
    roi_per_image = int(sampler_cfg['ROI_PER_IMAGE'])
    fg_thresh = min(sampler_cfg['REG_FG_THRESH'], sampler_cfg['CLS_FG_THRESH'])
    bg_lo = float(sampler_cfg['CLS_BG_THRESH_LO'])
    reg_fg = float(sampler_cfg['REG_FG_THRESH'])
    hard_ratio = float(sampler_cfg['HARD_BG_RATIO'])
    fg_per_image = int(np.round(float(sampler_cfg['FG_RATIO']) * roi_per_image))

    ov = torch.where(roi_valid, max_overlaps, torch.full_like(max_overlaps, -1.0))
    fg_mask = ov >= fg_thresh
    easy_mask = roi_valid & (ov < bg_lo)
    hard_mask = roi_valid & (ov >= bg_lo) & (ov < reg_fg)

    fg_perm, n_fg = _masked_permutation(draws['roi_fg_perm'], fg_mask)
    fg_rep, _ = _masked_choice_with_replacement(draws['roi_fg_rep'], fg_mask)
    hard_pick, n_hard = _masked_choice_with_replacement(draws['roi_hard'],
                                                        hard_mask)
    easy_pick, n_easy = _masked_choice_with_replacement(draws['roi_easy'],
                                                        easy_mask)
    n_fg, n_hard, n_easy = n_fg[:, None], n_hard[:, None], n_easy[:, None]
    n_bg = n_hard + n_easy
    both_bg = (n_hard > 0) & (n_easy > 0)

    # foreground and background both exist
    n_fg_used = n_fg.clamp(max=fg_per_image)
    n_bg_used = roi_per_image - n_fg_used
    n_hard_used = torch.where(
        both_bg,
        torch.minimum((n_bg_used.float() * hard_ratio).long(), n_hard),
        torch.where(n_hard > 0, n_bg_used, torch.zeros_like(n_bg_used)))
    slot = torch.arange(roi_per_image, device=ov.device)[None, :]
    is_fg_slot = slot < n_fg_used
    is_hard_slot = ~is_fg_slot & (slot < n_fg_used + n_hard_used)
    fg_first = torch.gather(
        fg_perm, 1, slot.clamp(max=fg_perm.shape[1] - 1).expand(len(ov), -1))
    both = torch.where(is_fg_slot, fg_first,
                       torch.where(is_hard_slot, hard_pick, easy_pick))
    # background only: the same routing with no foreground slot
    n_hard_only = torch.where(
        both_bg, n_hard.clamp(max=int(np.round(roi_per_image * hard_ratio))),
        torch.where(n_hard > 0, torch.full_like(n_hard, roi_per_image),
                    torch.zeros_like(n_hard)))
    only_bg = torch.where(slot < n_hard_only, hard_pick, easy_pick)
    return torch.where((n_fg > 0) & (n_bg > 0), both,
                       torch.where(n_fg > 0, fg_rep, only_bg))


def max_iou_with_gt(rois, roi_labels, gt_boxes, by_class):
    """Each RoI's largest 3D IoU over a sample's valid gt boxes, of its own
    class when `by_class` (roi_head_utils.py:129-135, :152-158), and that
    box's index. rois (B, N, 7+), roi_labels (B, N), gt_boxes (B, G, 8) ->
    (B, N) float32, (B, N) int64."""
    gt_labels = gt_boxes[..., -1].long()
    compat = (gt_labels > 0)[:, None, :]
    if by_class:
        compat = compat & (roi_labels[:, :, None] == gt_labels[:, None, :])
    iou = torch.stack([boxes_iou3d(r[:, 0:7], g[:, 0:7])
                       for r, g in zip(rois, gt_boxes)])
    iou = torch.where(compat, iou, torch.zeros_like(iou))
    return iou.amax(-1), iou.argmax(-1)


def sample_rois_for_rcnn(draws, rois, roi_scores, roi_labels, roi_valid,
                         gt_boxes, sampler_cfg, gt_boxes_enlarged=None,
                         gt_tracking=None):
    """Match the proposals to the gt and sample ROI_PER_IMAGE of them
    (roi_head_utils.py:138-177). `gt_boxes_enlarged` (the multiframe swept
    boxes), when given, is what the proposals are matched to; the targets
    come from `gt_boxes`, with `gt_tracking` (B, G, 8) appended to each
    (REG_TRACKING_INFO). Returns a dict of (B, R, ...) tensors, with
    ``sampled_inds``, the proposals' indices."""
    max_ov, gt_assign = max_iou_with_gt(
        rois, roi_labels,
        gt_boxes if gt_boxes_enlarged is None else gt_boxes_enlarged,
        sampler_cfg.get('SAMPLE_ROI_BY_EACH_CLASS', False))
    if gt_tracking is not None:
        gt_boxes = torch.cat([gt_boxes, gt_tracking], dim=-1)
    sampled = subsample_rois(draws, max_ov, roi_valid, sampler_cfg)

    return {
        'rois': gather_rows(rois, sampled),
        'gt_of_rois': gather_rows(gt_boxes,
                                  torch.gather(gt_assign, 1, sampled)),
        'gt_iou_of_rois': gather_rows(max_ov, sampled),
        'roi_scores': torch.gather(roi_scores, 1, sampled),
        'roi_labels': torch.gather(roi_labels, 1, sampled),
        'sampled_inds': sampled,
    }


def assign_roi_targets(draws, batch, sampler_cfg):
    """Sampled RoIs and their targets (roi_head_utils.py:180-237): the
    regression mask, the class targets of CLS_SCORE_TYPE and the gt boxes
    in each RoI's canonical frame (centre at the origin, heading relative
    to the RoI's, flipped into [-pi/2, pi/2]); ``gt_of_rois_src`` keeps
    them in the world frame for the corner loss.

    With REG_TRACKING_INFO (multiframe) each gt box carries its tracking
    targets after its class (roi_head_utils.py:183-197): the displacement
    from frame 0 to 1 and from 1 to 2 and the headings of frames 0 and 1,
    from the batch's ``locations`` (B, G, T, 3) and ``rotations_y`` (B, G,
    T); the proposals are matched to ``gt_boxes_enlarged`` when the dense
    head made them."""
    gt_tracking = None
    if sampler_cfg.get('REG_TRACKING_INFO', False):
        loc, roty = batch['locations'], batch['rotations_y']
        gt_tracking = torch.cat([loc[:, :, 1] - loc[:, :, 0],
                                 loc[:, :, 2] - loc[:, :, 1],
                                 roty[:, :, 0:2]], dim=-1)
    t = sample_rois_for_rcnn(draws, batch['rois'], batch['roi_scores'],
                             batch['roi_labels'], batch['roi_valid'],
                             batch['gt_boxes'], sampler_cfg,
                             gt_boxes_enlarged=batch.get('gt_boxes_enlarged'),
                             gt_tracking=gt_tracking)
    ious = t['gt_iou_of_rois']
    t['reg_valid_mask'] = (ious > sampler_cfg['REG_FG_THRESH']).long()
    if sampler_cfg['CLS_SCORE_TYPE'] == 'cls':
        labels = (ious > sampler_cfg['CLS_FG_THRESH']).float()
        ignore = (ious > sampler_cfg['CLS_BG_THRESH']) & \
            (ious < sampler_cfg['CLS_FG_THRESH'])
        t['rcnn_cls_labels'] = torch.where(ignore, torch.full_like(labels, -1.0),
                                           labels)
    elif sampler_cfg['CLS_SCORE_TYPE'] == 'roi_iou':
        lo, hi = sampler_cfg['CLS_BG_THRESH'], sampler_cfg['CLS_FG_THRESH']
        t['rcnn_cls_labels'] = ((ious - lo) / (hi - lo)).clamp(0.0, 1.0)
    else:
        raise NotImplementedError(sampler_cfg['CLS_SCORE_TYPE'])

    rois, gt = t['rois'], t['gt_of_rois']
    t['gt_of_rois_src'] = gt
    roi_ry = rois[..., 6] % (2 * np.pi)
    local = torch.cat([gt[..., 0:3] - rois[..., 0:3], gt[..., 3:]], -1)
    b, r = local.shape[:2]
    local = rotate_points_along_z(local.reshape(b * r, 1, -1),
                                  -roi_ry.reshape(-1)).reshape(gt.shape)
    # the heading too, relative to the RoI's (the roi_ry fix of the JAX
    # package, roi_head_utils.py:222-230)
    heading = (local[..., 6] - roi_ry) % (2 * np.pi)
    opposite = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
    heading = torch.where(opposite, (heading + np.pi) % (2 * np.pi), heading)
    heading = torch.where(heading > np.pi, heading - 2 * np.pi, heading)
    heading = heading.clamp(-np.pi / 2, np.pi / 2)
    t['gt_of_rois'] = torch.cat([local[..., :6], heading[..., None],
                                 local[..., 7:]], -1)
    return t


def roi_box_loss(fwd, box_coder, loss_cfg):
    """RCNN box residual loss, smooth-L1 in each RoI's frame, plus the
    corner loss in the world frame when CORNER_LOSS_REGULARIZATION
    (roi_head_utils.py:240-278). Returns (loss, terms)."""
    code = box_coder.code_size
    reg_valid = fwd['reg_valid_mask'].reshape(-1).float()
    gt_ct = fwd['gt_of_rois'][..., 0:code].reshape(-1, code)
    gt_src = fwd['gt_of_rois_src'][..., 0:code].reshape(-1, code)
    rcnn_reg = fwd['rcnn_reg'].reshape(-1, fwd['rcnn_reg'].shape[-1])
    rois = fwd['rois'].reshape(-1, fwd['rois'].shape[-1])[:, 0:code]
    fg_sum = batch_normalizer(reg_valid.sum())
    w = loss_cfg['LOSS_WEIGHTS']
    if loss_cfg['REG_LOSS'] != 'smooth-l1':
        raise NotImplementedError(loss_cfg['REG_LOSS'])

    zeros = torch.zeros_like(rois[:, 0:3])
    rois_anchor = torch.cat([zeros, rois[:, 3:6], zeros[:, :1], rois[:, 7:]], -1)
    reg_targets = box_coder.encode(gt_ct, rois_anchor)
    if fwd.get('reg_tracking_info', False):
        # gt_of_rois: the box (code), its class, the tracking targets (8)
        track = fwd['gt_of_rois'][..., code + 1:]
        reg_targets = torch.cat(
            [reg_targets, track.reshape(reg_targets.shape[0], -1)], -1)
    loss_reg = losses.weighted_smooth_l1_loss(
        rcnn_reg[None, :, 0:reg_targets.shape[-1]], reg_targets[None],
        code_weights=w['code_weights'])
    loss_reg = (loss_reg[0].sum(-1) * reg_valid).sum() / fg_sum
    loss_reg = loss_reg * w['rcnn_reg_weight']
    tb = {'rcnn_loss_reg': loss_reg}

    if loss_cfg.get('CORNER_LOSS_REGULARIZATION', False):
        anchors = torch.cat([zeros, rois[:, 3:]], -1)
        decoded = box_coder.decode(rcnn_reg[:, 0:code], anchors)
        decoded = rotate_points_along_z(decoded[:, None, :], rois[:, 6])[:, 0]
        decoded = torch.cat([decoded[:, 0:3] + rois[:, 0:3], decoded[:, 3:]], -1)
        corner = losses.corner_loss_lidar(decoded[:, 0:7], gt_src[:, 0:7])
        loss_corner = (corner * reg_valid).sum() / fg_sum
        loss_corner = loss_corner * w['rcnn_corner_weight']
        loss_reg = loss_reg + loss_corner
        tb['rcnn_loss_corner'] = loss_corner
    return loss_reg, tb


def roi_cls_loss(fwd, loss_cfg):
    """RCNN class loss over the RoIs whose target is not ignored (-1)
    (roi_head_utils.py:281-302). Returns (loss, terms)."""
    rcnn_cls = fwd['rcnn_cls']
    labels = fwd['rcnn_cls_labels'].reshape(-1)
    valid = (labels >= 0).float()
    if loss_cfg['CLS_LOSS'] == 'BinaryCrossEntropy':
        p = torch.sigmoid(rcnn_cls.reshape(-1))
        per_roi = -(labels * torch.log(p.clamp(min=1e-7))
                    + (1 - labels) * torch.log((1 - p).clamp(min=1e-7)))
    elif loss_cfg['CLS_LOSS'] == 'CrossEntropy':
        logits = rcnn_cls.reshape(-1, rcnn_cls.shape[-1])
        per_roi = -torch.log_softmax(logits, -1).gather(
            1, labels.clamp(min=0).long()[:, None])[:, 0]
    else:
        raise NotImplementedError(loss_cfg['CLS_LOSS'])
    loss = (per_roi * valid).sum() / batch_normalizer(valid.sum())
    loss = loss * loss_cfg['LOSS_WEIGHTS']['rcnn_cls_weight']
    return loss, {'rcnn_loss_cls': loss}
