"""The multi-head anchor head of the NuScenes CBGS detectors and
second_multihead.yaml (lidardetection_tpu/models/dense_heads/
anchor_head_multi.py): a shared Conv + BN + ReLU, then one ``SingleHead``
a head group, each with its own class, box and direction convolutions.

Anchors are laid out per class as (S, R, nz, ny, nx), the classes
concatenated (`flatten_anchors_multihead`), not in the single head's
(nz, ny, nx, S, R) order, and each head's predictions follow it: (anchor,
H, W) a head. With SEPARATE_MULTIHEAD the labels stay global class ids and
each head's focal loss slices the one-hot by its classes' offset, as the
JAX package does (its divergence note at anchor_head_multi.py:9-15).

Eval decodes every anchor (the direction bins applied) and hands
``batch_cls_preds`` as a list of each head's (B, N_h, nc_h) logits with
``multihead_label_mapping``, for the multi-class NMS of
post_processing.py; the single head's deferred decode is not taken.

Tensors are channels-last (B, H, W, C) at both ends, as the BEV backbone
hands them; the convolutions run on NCHW views.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core import losses
from ...core.box_coders import build_box_coder
from ...core.geometry import limit_period
from ..backbones_2d.bev_backbone import BaseBEVBackbone
from ..layers import ConvBNReLU, lecun_normal_
from . import target_assigner
from .anchor_generator import generate_anchors
from .anchor_head import add_sin_difference, get_direction_target

FOCAL_PI = 0.01  # the class convolutions' prior: bias -log((1 - pi) / pi)


def flatten_anchors_multihead(anchors_list):
    """Per-class (nz, ny, nx, S, R, D) -> (S*R*nz*ny*nx, D), classes
    concatenated, and each row's 0-based class."""
    flats, class_ids = [], []
    for i, a in enumerate(anchors_list):
        f = np.transpose(a, (3, 4, 0, 1, 2, 5)).reshape(-1, a.shape[-1])
        flats.append(f)
        class_ids.append(np.full(f.shape[0], i, np.int32))
    return np.concatenate(flats, 0), np.concatenate(class_ids, 0)


def build_multihead_anchors(model_cfg, grid_size, point_cloud_range):
    """Flat anchors (numpy), their per-anchor thresholds and the coder."""
    agc = model_cfg['ANCHOR_GENERATOR_CONFIG']
    ta_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
    box_coder = build_box_coder(ta_cfg['BOX_CODER'],
                                **ta_cfg.get('BOX_CODER_CONFIG', {}))
    anchors_list, num_per_loc = generate_anchors(
        agc, grid_size, point_cloud_range, anchor_ndim=box_coder.full_code_size)
    flat, anchor_class = flatten_anchors_multihead(anchors_list)
    return {
        'flat_anchors': flat,
        'anchor_class': anchor_class,
        'matched_t': np.array([c['matched_threshold'] for c in agc],
                              np.float32)[anchor_class],
        'unmatched_t': np.array([c['unmatched_threshold'] for c in agc],
                                np.float32)[anchor_class],
        'num_anchors_per_location': num_per_loc,
        'box_coder': box_coder,
    }


class Conv2d(nn.Module):
    """flax ``nn.Conv`` with a bias, square kernel, stride 1 and padding
    k // 2: ``weight`` (O, I, k, k), ``bias`` (O,). Computes in `dtype`
    when one is given."""

    def __init__(self, in_channels, out_channels, kernel_size, dtype=None,
                 bias_fill=0.0, fan_out_scale=False, generator=None):
        super().__init__()
        k = kernel_size
        self.dtype, self.padding = dtype, k // 2
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        if fan_out_scale:  # variance_scaling(2.0, 'fan_out', truncated)
            lecun_normal_(self.weight, out_channels * k * k / 2.0, generator)
        else:
            lecun_normal_(self.weight, in_channels * k * k, generator)
        self.bias = nn.Parameter(torch.full((out_channels,), float(bias_fill)))

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


def _anchor_major(y, na):
    """NCHW (B, na*c, H, W) -> (B, na*H*W, c), the (anchor, H, W) order."""
    b, _, h, w = y.shape
    return y.reshape(b, na, -1, h, w).permute(0, 1, 3, 4, 2).reshape(
        b, na * h * w, -1)


class SingleHead(nn.Module):
    """One head group. ``units`` are the flax ``ConvBNReLU_<n>`` (the
    middle stacks: the class branch's, then each REG_LIST term's, each
    its own parameters) and ``convs`` the flax ``Conv_<n>``, both in
    creation order: class, the box terms (or one box conv), direction;
    ``backbone`` the optional mini BaseBEVBackbone (``LAYER_NUMS`` in the
    head's config)."""

    def __init__(self, model_cfg, rpn_head_cfg, input_channels, num_class,
                 num_anchors_per_location, code_size, separate_reg_config=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = {'dtype': dtype, 'generator': generator}
        self.na, self.num_class, self.code_size = (
            num_anchors_per_location, num_class, code_size)
        self.backbone = None
        c = input_channels
        if rpn_head_cfg.get('LAYER_NUMS'):
            self.backbone = BaseBEVBackbone(rpn_head_cfg, c, **kw)
            c = self.backbone.num_bev_features
        na, bias = self.na, -math.log((1 - FOCAL_PI) / FOCAL_PI)
        units, convs = [], []
        self.separate = separate_reg_config is not None
        if self.separate:
            depth = int(separate_reg_config['NUM_MIDDLE_CONV'])
            width = int(separate_reg_config['NUM_MIDDLE_FILTER'])
            self.reg_channels = [int(r.split(':')[1])
                                 for r in separate_reg_config['REG_LIST']]

            def middle_stack():
                cin = c
                for _ in range(depth):
                    units.append(ConvBNReLU(cin, width, 3, 1, padding=1, **kw))
                    cin = width
                return cin

            convs.append(Conv2d(middle_stack(), na * num_class, 3,
                                bias_fill=bias, **kw))
            for ch in self.reg_channels:
                convs.append(Conv2d(middle_stack(), na * ch, 3,
                                    fan_out_scale=True, **kw))
            self.depth = depth
        else:
            convs += [Conv2d(c, na * num_class, 1, bias_fill=bias, **kw),
                      Conv2d(c, na * code_size, 1, **kw)]
        self.use_dir = model_cfg.get('USE_DIRECTION_CLASSIFIER', None) is not None
        if self.use_dir:
            convs.append(Conv2d(c, na * int(model_cfg['NUM_DIR_BINS']), 1, **kw))
        self.units, self.convs = nn.ModuleList(units), nn.ModuleList(convs)

    def forward(self, x):
        """x (B, H, W, C) -> class (B, na*H*W, nc), box (B, na*H*W, code),
        direction (B, na*H*W, bins) or None, in float32."""
        if self.backbone is not None:
            x = self.backbone({'spatial_features': x})['spatial_features_2d']
        x = x.permute(0, 3, 1, 2)  # NCHW view
        na = self.na
        if self.separate:
            def middle(branch, y):
                for unit in self.units[branch * self.depth:
                                       (branch + 1) * self.depth]:
                    y = unit(y)
                return y

            cls = self.convs[0](middle(0, x))
            box = torch.cat([_anchor_major(conv(middle(i + 1, x)), na)
                             for i, conv in enumerate(
                                 self.convs[1:1 + len(self.reg_channels)])],
                            dim=-1)
        else:
            cls = self.convs[0](x)
            box = _anchor_major(self.convs[1](x), na)
        dir_preds = _anchor_major(self.convs[-1](x), na).float() \
            if self.use_dir else None
        return _anchor_major(cls, na).float(), box.float(), dir_preds


class AnchorHeadMulti(nn.Module):
    """``shared_conv`` and ``rpn_heads.<i>`` carry the flax names."""

    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range, dtype=None,
                 predict_boxes_when_training=False, generator=None):
        super().__init__()
        info = build_multihead_anchors(model_cfg, grid_size, point_cloud_range)
        self.model_cfg, self.num_class = model_cfg, num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        self.box_coder = info['box_coder']
        self.separate_multihead = model_cfg.get('SEPARATE_MULTIHEAD', False)
        if model_cfg['TARGET_ASSIGNER_CONFIG'].get('POS_FRACTION', -1) >= 0:
            raise NotImplementedError(
                'POS_FRACTION subsampling is used by no shipped config and '
                'is not implemented')
        kw = {'dtype': dtype, 'generator': generator}
        c = input_channels
        self.shared_conv = None
        if model_cfg.get('SHARED_CONV_NUM_FILTER'):
            width = int(model_cfg['SHARED_CONV_NUM_FILTER'])
            self.shared_conv = ConvBNReLU(c, width, 3, 1, padding=1, **kw)
            c = width
        all_classes = [n for hc in model_cfg['RPN_HEAD_CFGS']
                       for n in hc['HEAD_CLS_NAME']]
        heads, label_indices, num_classes = [], [], []
        for hc in model_cfg['RPN_HEAD_CFGS']:
            na = sum(info['num_anchors_per_location'][all_classes.index(n)]
                     for n in hc['HEAD_CLS_NAME'])
            nc = len(hc['HEAD_CLS_NAME']) if self.separate_multihead \
                else num_class
            heads.append(SingleHead(
                model_cfg, hc, c, nc, na, self.box_coder.full_code_size,
                model_cfg.get('SEPARATE_REG_CONFIG'), **kw))
            label_indices.append(tuple(class_names.index(n) + 1
                                       for n in hc['HEAD_CLS_NAME']))
            num_classes.append(nc)
        self.rpn_heads = nn.ModuleList(heads)
        self.head_label_indices = tuple(label_indices)
        self.head_num_classes = tuple(num_classes)
        self.use_dir = heads[0].use_dir
        for name in ('flat_anchors', 'anchor_class', 'matched_t', 'unmatched_t'):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(info[name])), persistent=False)

    def decode_boxes(self, box_preds, dir_preds):
        """Every anchor's box, decoded in float32, the direction bins
        applied."""
        boxes = self.box_coder.decode(box_preds, self.flat_anchors[None])
        if dir_preds is None:
            return boxes
        cfg = self.model_cfg
        dir_offset = cfg.get('DIR_OFFSET', 0.78539)
        period = 2 * np.pi / cfg['NUM_DIR_BINS']
        dir_rot = limit_period(boxes[..., 6] - dir_offset,
                               cfg.get('DIR_LIMIT_OFFSET', 0.0), period)
        heading = dir_rot + dir_offset \
            + period * dir_preds.argmax(-1).to(boxes.dtype)
        return torch.cat([boxes[..., :6], heading[..., None], boxes[..., 7:]],
                         dim=-1)

    def forward(self, batch):
        x = batch['spatial_features_2d']  # (B, H, W, C)
        if self.shared_conv is not None:
            x = self.shared_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        cls_list, box_list, dir_list = [], [], []
        for head in self.rpn_heads:
            c, b, d = head(x)
            cls_list.append(c)
            box_list.append(b)
            if d is not None:
                dir_list.append(d)
        out = dict(batch)
        if self.training:
            fwd = {'cls_preds': cls_list, 'box_preds': box_list,
                   'dir_cls_preds': dir_list or None}
            fwd.update(target_assigner.assign_targets(
                self.flat_anchors, self.anchor_class, self.matched_t,
                self.unmatched_t, batch['gt_boxes'], self.box_coder,
                match_height=self.model_cfg['TARGET_ASSIGNER_CONFIG'].get(
                    'MATCH_HEIGHT', False)))
            out['anchor_head_fwd'] = fwd
        if not self.training or self.predict_boxes_when_training:
            out['batch_box_preds'] = self.decode_boxes(
                torch.cat(box_list, dim=1),
                torch.cat(dir_list, dim=1) if dir_list else None)
            if self.separate_multihead:
                out['batch_cls_preds'] = cls_list
                out['multihead_label_mapping'] = self.head_label_indices
            else:
                out['batch_cls_preds'] = torch.cat(cls_list, dim=1)
            out['cls_preds_normalized'] = False
        return out

    def loss(self, fwd):
        """Multi-head RPN loss (anchor_head_multi.py:240-317): a focal loss
        a head over its slice of the anchors (and of the one-hot classes
        with SEPARATE_MULTIHEAD), L1 or smooth-L1 regression with the sine
        difference when there are direction bins, a direction
        cross-entropy a head."""
        cfg = self.model_cfg
        w = cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
        pos_w, neg_w = w.get('pos_cls_weight', 1.0), w.get('neg_cls_weight', 1.0)
        reg_loss = losses.weighted_l1_loss \
            if cfg['LOSS_CONFIG'].get('REG_LOSS_TYPE', 'WeightedSmoothL1Loss') \
            == 'WeightedL1Loss' else losses.weighted_smooth_l1_loss
        labels = fwd['box_cls_labels']  # (B, A) global class ids
        cared, positives, negatives = labels >= 0, labels > 0, labels == 0
        pos_norm = positives.sum(1, keepdim=True).float().clamp(min=1.0)
        cls_weights = (negatives * neg_w + positives * pos_w).float() / pos_norm
        reg_weights = positives.float() / pos_norm
        one_hot = F.one_hot(torch.where(cared, labels, 0).long(),
                            self.num_class + 1)[..., 1:].float()
        b = fwd['cls_preds'][0].shape[0]

        total_cls = 0.0
        start = c_idx = 0
        for idx, cls_pred in enumerate(fwd['cls_preds']):
            nc, a_head = self.head_num_classes[idx], cls_pred.shape[1]
            oh = one_hot[:, start:start + a_head]
            if self.separate_multihead:
                oh = oh[..., c_idx:c_idx + nc]
                c_idx += nc
            loss = losses.sigmoid_focal_loss(
                cls_pred, oh, cls_weights[:, start:start + a_head]).sum() / b
            total_cls = total_cls + loss * w['cls_weight']
            start += a_head

        reg_targets = fwd['box_reg_targets']
        use_dir = fwd.get('dir_cls_preds') is not None
        if use_dir:
            dir_targets = get_direction_target(
                self.flat_anchors, reg_targets,
                dir_offset=cfg.get('DIR_OFFSET', 0.78539),
                num_bins=cfg['NUM_DIR_BINS'])
            dir_weights = positives.float()
            dir_weights = dir_weights / dir_weights.sum(-1, keepdim=True).clamp(
                min=1.0)
        total_box = 0.0
        start = 0
        for idx, box_pred in enumerate(fwd['box_preds']):
            a_head = box_pred.shape[1]
            rt = reg_targets[:, start:start + a_head]
            bp, rt = add_sin_difference(box_pred, rt) if use_dir \
                else (box_pred, rt)
            loc = reg_loss(bp, rt, reg_weights[:, start:start + a_head],
                           code_weights=w['code_weights']).sum() / b
            total_box = total_box + loc * w['loc_weight']
            if use_dir:
                dl = losses.weighted_cross_entropy_loss(
                    fwd['dir_cls_preds'][idx],
                    dir_targets[:, start:start + a_head],
                    dir_weights[:, start:start + a_head]).sum() / b
                total_box = total_box + dl * w['dir_weight']
            start += a_head

        rpn_loss = total_cls + total_box
        return rpn_loss, {'rpn_loss_cls': total_cls, 'rpn_loss_loc': total_box,
                          'rpn_loss': rpn_loss}
