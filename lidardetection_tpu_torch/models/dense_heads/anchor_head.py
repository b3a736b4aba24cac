"""AnchorHeadSingle and its loss (lidardetection_tpu/models/dense_heads/
anchor_head.py:45-248 and :288-366).

The three 1x1 heads (class, box, direction) keep separate parameters with
the flax names and layouts, ``conv_*_kernel`` (C_in, out) and
``conv_*_bias``, and run as ONE product whose output columns are
interleaved per anchor ([a0: cls|box|dir][a1: ...]). Eval defers the box
decode: the head emits ``batch_fused_preds`` (B, H, W, na*tot) and
post-processing decodes only the rows it keeps, through
``anchor_from_idx`` and ``decode_box_fn``. Training de-interleaves the
product into ``cls_preds`` / ``box_preds`` / ``dir_cls_preds`` in float32,
assigns targets and emits ``anchor_head_fwd`` for `anchor_head_loss`.

Ahead of a second stage (``predict_boxes_when_training``, PV-RCNN) eval
does not defer, and training emits them beside ``anchor_head_fwd``:
``batch_cls_preds`` (B, N_anchors, nc) float32 logits and
``batch_box_preds`` decoded in float32 for every anchor, for the proposal
layer (anchor_head.py:123-143, :237-241).
"""

import math

import numpy as np
import torch
from torch import nn

from ...core import losses
from ...core.box_coders import build_box_coder
from ...core.geometry import (
    boxes_to_corners_3d, limit_period, rotate_points_along_z,
)
from ..layers import lecun_normal_
from . import target_assigner
from .anchor_generator import flatten_anchors, generate_anchors


def build_head_anchors(model_cfg, grid_size, point_cloud_range):
    """Flat anchors (numpy) and the head's anchor and coder facts."""
    agc = model_cfg['ANCHOR_GENERATOR_CONFIG']
    ta_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
    box_coder = build_box_coder(ta_cfg['BOX_CODER'],
                                **ta_cfg.get('BOX_CODER_CONFIG', {}))
    anchors_list, num_per_loc = generate_anchors(
        agc, grid_size, point_cloud_range, anchor_ndim=box_coder.full_code_size)
    flat, anchor_class = flatten_anchors(anchors_list)
    return {
        'flat_anchors': flat,
        'anchor_class': anchor_class,
        'matched_t': np.array([c['matched_threshold'] for c in agc],
                              np.float32)[anchor_class],
        'unmatched_t': np.array([c['unmatched_threshold'] for c in agc],
                                np.float32)[anchor_class],
        'num_anchors_per_location': sum(num_per_loc),
        'box_coder': box_coder,
        'feature_map_size': anchors_list[0].shape[:3],  # (nz, ny, nx)
    }


class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, grid_size,
                 point_cloud_range, dtype=None, predict_boxes_when_training=False,
                 generator=None):
        super().__init__()
        info = build_head_anchors(model_cfg, grid_size, point_cloud_range)
        self.model_cfg = model_cfg
        self.predict_boxes_when_training = predict_boxes_when_training
        self.box_coder = info['box_coder']
        self.num_class = num_class
        self.dtype = dtype
        na = self.num_anchors_per_location = info['num_anchors_per_location']
        code = self.box_coder.full_code_size
        self.use_dir = model_cfg.get('USE_DIRECTION_CLASSIFIER', False)
        self.num_dir_bins = model_cfg['NUM_DIR_BINS'] if self.use_dir else 0
        if model_cfg['TARGET_ASSIGNER_CONFIG'].get('POS_FRACTION', -1) >= 0:
            raise NotImplementedError(
                'POS_FRACTION subsampling is used by no shipped config and '
                'is not implemented')
        c_in = input_channels

        def param(shape, fill=None, std=None):
            t = torch.empty(shape)
            if fill is not None:
                nn.init.constant_(t, fill)
            elif std is not None:
                nn.init.normal_(t, 0.0, std, generator=generator)
            else:
                lecun_normal_(t, shape[0], generator)
            return nn.Parameter(t)

        # focal-style class bias (pi = 0.01), box weights std 0.001
        pi = 0.01
        self.conv_cls_kernel = param((c_in, na * num_class))
        self.conv_cls_bias = param((na * num_class,),
                                   fill=-math.log((1 - pi) / pi))
        self.conv_box_kernel = param((c_in, na * code), std=0.001)
        self.conv_box_bias = param((na * code,), fill=0.0)
        if self.use_dir:
            self.conv_dir_kernel = param((c_in, na * self.num_dir_bins))
            self.conv_dir_bias = param((na * self.num_dir_bins,), fill=0.0)

        # the dense anchor grid is separable: x from the column, y from the
        # row, the rest from an (na, code - 2) table; otherwise gather rows
        nz, ny, nx = (int(v) for v in info['feature_map_size'])
        self.nx = nx
        fa = info['flat_anchors']
        ar = fa.reshape(nz * ny, nx, na, fa.shape[-1])
        xs, ys, tab = ar[0, :, 0, 0], ar[:, 0, 0, 1], ar[0, 0, :, 2:]
        recon = np.concatenate([
            np.broadcast_to(xs[None, :, None, None], ar[..., :1].shape),
            np.broadcast_to(ys[:, None, None, None], ar[..., 1:2].shape),
            np.broadcast_to(tab[None, None], ar[..., 2:].shape)], axis=-1)
        self.separable = bool(np.allclose(recon, ar))
        tables = {'flat_anchors': fa,
                  'anchor_class': info['anchor_class'].astype(np.int32),
                  'matched_t': info['matched_t'],
                  'unmatched_t': info['unmatched_t']}
        if self.separable:
            tables.update(anchor_xs=xs, anchor_ys=ys, anchor_tab=tab)
        for name, arr in tables.items():
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)),
                                 persistent=False)

    def fused_weights(self):
        """(C_in, na*tot) weight and (na*tot,) bias, columns per anchor."""
        na, nc = self.num_anchors_per_location, self.num_class
        code, nd = self.box_coder.full_code_size, self.num_dir_bins
        ws, bs = [], []
        for a in range(na):
            ws += [self.conv_cls_kernel[:, a * nc:(a + 1) * nc],
                   self.conv_box_kernel[:, a * code:(a + 1) * code]]
            bs += [self.conv_cls_bias[a * nc:(a + 1) * nc],
                   self.conv_box_bias[a * code:(a + 1) * code]]
            if self.use_dir:
                ws.append(self.conv_dir_kernel[:, a * nd:(a + 1) * nd])
                bs.append(self.conv_dir_bias[a * nd:(a + 1) * nd])
        return torch.cat(ws, dim=1), torch.cat(bs)

    def anchor_from_idx(self, idx):
        """Anchors (..., code) of flat anchor ids (..., ) in head row order."""
        if not self.separable:
            return self.flat_anchors[idx]
        na = self.num_anchors_per_location
        a, pos = idx % na, idx // na
        return torch.cat([self.anchor_xs[pos % self.nx][..., None],
                          self.anchor_ys[pos // self.nx][..., None],
                          self.anchor_tab[a]], dim=-1)

    def decode_boxes(self, raw, dir_raw, anchor_rows):
        """Residual decode in float32, then the direction-bin fix-up."""
        boxes = self.box_coder.decode(raw.float(), anchor_rows)
        if self.use_dir:
            dir_offset = self.model_cfg.get('DIR_OFFSET', 0.78539)
            dir_limit = self.model_cfg.get('DIR_LIMIT_OFFSET', 0.0)
            dir_labels = dir_raw.float().argmax(dim=-1)
            period = 2 * np.pi / self.num_dir_bins
            dir_rot = limit_period(boxes[..., 6] - dir_offset, dir_limit, period)
            heading = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
            boxes = torch.cat([boxes[..., :6], heading[..., None],
                               boxes[..., 7:]], dim=-1)
        return boxes

    def _train_forward(self, batch, fused):
        """De-interleaved float32 predictions and the assigned targets."""
        bsz, h, w, _ = fused.shape
        na, nc = self.num_anchors_per_location, self.num_class
        code, nd = self.box_coder.full_code_size, self.num_dir_bins
        fused5 = fused.reshape(bsz, h, w, na, nc + code + nd)
        fwd = {
            'cls_preds': fused5[..., :nc].reshape(bsz, h, w, na * nc).float(),
            'box_preds': fused5[..., nc:nc + code].reshape(
                bsz, h, w, na * code).float(),
        }
        if self.use_dir:
            fwd['dir_cls_preds'] = fused5[..., nc + code:].reshape(
                bsz, h, w, na * nd).float()
        gt_enlarged = None
        if self.model_cfg.get('USE_MULTIFRAME_ENLARGED_GT_BOXES', False):
            gt_enlarged = compute_multiframe_enlarged_gt(
                batch['gt_boxes'], batch['locations'], batch['rotations_y'])
            fwd['gt_boxes_enlarged'] = gt_enlarged
        ta_cfg = self.model_cfg['TARGET_ASSIGNER_CONFIG']
        match_height = ta_cfg.get('MATCH_HEIGHT', False)
        if ta_cfg['NAME'] == 'ATSS':
            fwd.update(target_assigner.atss_assign_targets(
                self.flat_anchors, batch['gt_boxes'], self.box_coder,
                topk=int(ta_cfg.get('TOPK', 9)), match_height=match_height))
        else:
            fwd.update(target_assigner.assign_targets(
                self.flat_anchors, self.anchor_class, self.matched_t,
                self.unmatched_t, batch['gt_boxes'], self.box_coder,
                match_height=match_height, gt_boxes_enlarged=gt_enlarged))
        return fwd

    def loss(self, fwd):
        return anchor_head_loss(fwd, self.flat_anchors, self.num_class,
                                self.model_cfg)

    def forward(self, batch):
        x = batch['spatial_features_2d']  # (B, H, W, C)
        cdt = self.dtype or x.dtype
        w, b = self.fused_weights()
        fused = x.to(cdt) @ w.to(cdt) + b.to(cdt)  # (B, H, W, na*tot)
        code = self.box_coder.full_code_size
        if self.predict_boxes_when_training:
            nc = self.num_class
            rows = fused.reshape(fused.shape[0], -1, nc + code + self.num_dir_bins)
            dir_raw = rows[..., nc + code:] if self.use_dir else None
            batch = {**batch,
                     'batch_cls_preds': rows[..., :nc].float(),
                     'batch_box_preds': self.decode_boxes(
                         rows[..., nc:nc + code], dir_raw, self.flat_anchors[None]),
                     'cls_preds_normalized': False}
        if self.training:
            fwd = self._train_forward(batch, fused)
            out = {**batch, 'anchor_head_fwd': fwd}
            if 'gt_boxes_enlarged' in fwd:  # the RoI targets match to them
                out['gt_boxes_enlarged'] = fwd['gt_boxes_enlarged']
            return out
        if self.predict_boxes_when_training:
            return batch
        return {
            **batch,
            'batch_fused_preds': fused,
            'head_raw_sizes': (self.num_class, code, self.num_dir_bins),
            'head_layout': (fused.shape[1], fused.shape[2],
                            self.num_anchors_per_location),
            'anchor_from_idx': self.anchor_from_idx,
            'decode_box_fn': self.decode_boxes,
            'cls_preds_normalized': False,
        }


def compute_multiframe_enlarged_gt(gt_boxes, locations, rotations_y):
    """The BEV extent of each gt box swept over its frame poses
    (anchor_head.py:259-286): its corners at every frame's location and
    heading, in the current box's frame; dx and dy become the swept
    extents. gt_boxes (B, G, 8+), locations (B, G, T, 3), rotations_y
    (B, G, T) -> (B, G, 8+)."""
    b, g, t, _ = locations.shape
    d = gt_boxes.shape[-1]
    flat = gt_boxes.reshape(b * g, d)
    loc = locations.reshape(b * g, t, 3)
    rot = rotations_y.reshape(b * g, t)
    corners = torch.cat([
        boxes_to_corners_3d(torch.cat([loc[:, i], flat[:, 3:6],
                                       rot[:, i:i + 1]], dim=-1))
        for i in range(t)], dim=1)  # (BG, 8T, 3)
    local = rotate_points_along_z(corners - flat[:, None, 0:3], -flat[:, 6])
    length = local[:, :, 0].amax(1) - local[:, :, 0].amin(1)
    width = local[:, :, 1].amax(1) - local[:, :, 1].amin(1)
    return torch.cat([flat[:, :3], length[:, None], width[:, None], flat[:, 5:]],
                     dim=-1).reshape(b, g, d)


def add_sin_difference(boxes1, boxes2, dim=6):
    """sin(a - b) = sin a cos b - cos a sin b, split over the two operands
    of the heading regression."""
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return b1, b2


def get_direction_target(flat_anchors, reg_targets, dir_offset, num_bins):
    """One-hot direction-bin targets from the gt heading."""
    rot_gt = reg_targets[..., 6] + flat_anchors[None, :, 6]
    offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * np.pi)
    bins = torch.floor(offset_rot / (2 * np.pi / num_bins)).long()
    bins = bins.clamp(0, num_bins - 1)
    return torch.nn.functional.one_hot(bins, num_bins).to(reg_targets.dtype)


def anchor_head_loss(fwd, flat_anchors, num_class, model_cfg):
    """RPN class + regression (+ direction) loss.

    Args: fwd with cls_preds (B, H, W, na*nc), box_preds, dir_cls_preds
    (optional), box_cls_labels (B, A), box_reg_targets (B, A, code).
    Returns (scalar loss, dict of the terms).
    """
    weights_cfg = model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
    cls_preds, box_preds = fwd['cls_preds'], fwd['box_preds']
    labels = fwd['box_cls_labels']  # (B, A)
    b = cls_preds.shape[0]

    cared = labels >= 0
    positives = labels > 0
    pos_normalizer = positives.sum(dim=1, keepdim=True).float().clamp(min=1.0)
    reg_weights = positives.float() / pos_normalizer
    cls_weights = cared.float() / pos_normalizer

    cls_targets = torch.where(cared, labels, torch.zeros_like(labels))
    if num_class == 1:
        cls_targets = torch.where(positives, torch.ones_like(labels),
                                  cls_targets)
    one_hot = torch.nn.functional.one_hot(
        cls_targets.long(), num_class + 1)[..., 1:].to(cls_preds.dtype)
    cls_loss = losses.sigmoid_focal_loss(
        cls_preds.reshape(b, -1, num_class), one_hot, cls_weights).sum() / b
    cls_loss = cls_loss * weights_cfg['cls_weight']

    code = fwd['box_reg_targets'].shape[-1]
    box_preds_sin, reg_targets_sin = add_sin_difference(
        box_preds.reshape(b, -1, code), fwd['box_reg_targets'])
    loc_loss = losses.weighted_smooth_l1_loss(
        box_preds_sin, reg_targets_sin, reg_weights,
        code_weights=weights_cfg['code_weights']).sum() / b
    loc_loss = loc_loss * weights_cfg['loc_weight']

    tb = {'rpn_loss_cls': cls_loss, 'rpn_loss_loc': loc_loss}
    box_loss = loc_loss
    if 'dir_cls_preds' in fwd:
        num_bins = model_cfg['NUM_DIR_BINS']
        dir_targets = get_direction_target(
            flat_anchors, fwd['box_reg_targets'],
            dir_offset=model_cfg.get('DIR_OFFSET', 0.78539), num_bins=num_bins)
        weights = positives.float()
        weights = weights / weights.sum(-1, keepdim=True).clamp(min=1.0)
        dir_loss = losses.weighted_cross_entropy_loss(
            fwd['dir_cls_preds'].reshape(b, -1, num_bins), dir_targets,
            weights).sum() / b
        dir_loss = dir_loss * weights_cfg['dir_weight']
        box_loss = box_loss + dir_loss
        tb['rpn_loss_dir'] = dir_loss

    tb['rpn_loss'] = cls_loss + box_loss
    return tb['rpn_loss'], tb
