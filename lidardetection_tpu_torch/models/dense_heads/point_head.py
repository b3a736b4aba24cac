"""The point heads (lidardetection_tpu/models/dense_heads/point_head.py):
``FCLayers``, ``PointHeadSimple`` (PV-RCNN's keypoint foreground head)
and its multiframe counterpart ``PointHeadSimpleMultiFrame``,
``PointHeadBox`` (PointRCNN's first stage: foreground and a box a point)
and ``PointIntraPartOffsetHead`` (Part-A²'s foreground and intra-object
part offsets, and a box a point when its TARGET_CONFIG names a coder),
their point targets and losses.

Points are (B, N) padded batches; padding points are labelled -1
(ignored), so they carry no loss weight.
"""

import torch
from torch import nn

from ...core import losses
from ...core.box_coders import build_box_coder
from ...core.geometry import (
    enlarge_box3d, points_in_boxes_id, rotate_points_along_z,
)
from ...parallel.dist import batch_normalizer
from ..layers import POINT_BN, Dense, MaskedBatchNorm


def assign_point_targets(point_coords, point_valid, gt_boxes, extra_width,
                         num_class, box_coder=None, ret_box_labels=False,
                         ret_part_labels=False):
    """Foreground labels of points, the ``set_ignore_flag`` branch of
    point_head.py:20-66: a point inside a valid gt box takes its class (1
    when `num_class` is 1), a point inside only the box grown by
    `extra_width` is ignored (-1), any other point is background (0), and
    padding points are ignored.

    With `ret_box_labels`, also each foreground point's box encoded by
    `box_coder` against the point with the box's class (:54-57), and 0
    for every other point.

    With `ret_part_labels`, also each foreground point's place in its box
    (:59-63): ``rotate(point - centre, -heading) / (dx, dy, dz) + 0.5``,
    in [0, 1]^3 inside the box, and 0 for every other point.

    Args: point_coords (B, N, 3); point_valid (B, N) bool; gt_boxes (B, M,
    8), the class last (0 = padding). Returns {'point_cls_labels': (B, N)
    int64}, with `ret_box_labels` 'point_box_labels' (B, N, code) and
    with `ret_part_labels` 'point_part_labels' (B, N, 3).
    """
    gt_valid = gt_boxes[..., -1] > 0
    box_id = points_in_boxes_id(point_coords, gt_boxes[..., :7], gt_valid)
    fg = box_id >= 0
    ext_id = points_in_boxes_id(
        point_coords, enlarge_box3d(gt_boxes[..., :7], extra_width), gt_valid)
    ignore = fg ^ (ext_id >= 0)
    if num_class > 1:
        matched = torch.gather(gt_boxes[..., -1], 1, box_id.clamp(min=0))
        cls_of_point = matched.long()
    else:
        cls_of_point = torch.ones_like(box_id)
    labels = torch.where(fg, cls_of_point, -ignore.long())
    out = {'point_cls_labels': torch.where(point_valid, labels,
                                           torch.full_like(labels, -1))}
    if not (ret_box_labels or ret_part_labels):
        return out
    b, n = box_id.shape
    matched = torch.gather(gt_boxes, 1, box_id.clamp(min=0)[..., None]
                           .expand(-1, -1, gt_boxes.shape[-1]))
    if ret_box_labels:
        enc = box_coder.encode(matched[..., :7], point_coords,
                               matched[..., -1].long())
        out['point_box_labels'] = torch.where(fg[..., None], enc,
                                              torch.zeros_like(enc))
    if ret_part_labels:
        local = rotate_points_along_z(
            (point_coords - matched[..., 0:3]).reshape(b * n, 1, 3),
            -matched[..., 6].reshape(-1)).reshape(b, n, 3)
        part = local / matched[..., 3:6] + 0.5
        out['point_part_labels'] = torch.where(fg[..., None], part,
                                               torch.zeros_like(part))
    return out


def point_cls_loss(point_cls_preds, point_cls_labels, num_class, weight=1.0):
    """Focal foreground loss over all points (point_head.py:69-83): weight
    1 on background and foreground points, 0 on ignored ones, over the
    foreground count. Returns (loss, the count clamped to >= 1)."""
    labels = point_cls_labels.reshape(-1)
    preds = point_cls_preds.reshape(-1, num_class)
    positives = labels > 0
    cls_weights = ((labels == 0) | positives).float()
    pos_normalizer = batch_normalizer(positives.sum().float())
    cls_weights = cls_weights / pos_normalizer
    one_hot = torch.nn.functional.one_hot(
        labels.clamp(min=0), num_class + 1)[..., 1:].to(preds.dtype)
    loss = losses.sigmoid_focal_loss(preds[None], one_hot[None],
                                     cls_weights[None]).sum()
    return loss * weight, pos_normalizer


def point_box_loss(point_box_preds, point_box_labels, point_cls_labels,
                   code_weights=None, weight=1.0):
    """Smooth-L1 box loss over the foreground points, each weighted 1 over
    their count (point_head.py:84-95)."""
    labels = point_cls_labels.reshape(-1)
    preds = point_box_preds.reshape(-1, point_box_preds.shape[-1])
    targets = point_box_labels.reshape(-1, preds.shape[-1])
    pos = (labels > 0).float()
    reg_weights = pos / batch_normalizer(pos.sum())
    loss = losses.weighted_smooth_l1_loss(
        preds[None], targets[None], reg_weights[None],
        code_weights=code_weights).sum()
    return loss * weight


def point_part_loss(point_part_preds, point_part_labels, point_cls_labels,
                    weight=1.0):
    """Binary cross-entropy of the part offsets over the foreground points
    (point_head.py:98-110), the sigmoid clamped to [1e-7, 1 - 1e-7] inside
    the logs, over 3 x the foreground count."""
    labels = point_cls_labels.reshape(-1)
    preds = point_part_preds.reshape(-1, 3)
    targets = point_part_labels.reshape(-1, 3)
    pos = labels > 0
    pos_normalizer = batch_normalizer(pos.sum().float())
    p = torch.sigmoid(preds)
    bce = -(targets * torch.log(p.clamp(min=1e-7))
            + (1 - targets) * torch.log((1 - p).clamp(min=1e-7)))
    loss = (bce.sum(-1) * pos).sum() / (3 * pos_normalizer)
    return loss * weight


class FCLayers(nn.Module):
    """Dense (no bias) + BatchNorm + ReLU per width, then a plain Dense with
    bias in float32 (point_head.py:113-135; also the RoI head's ``FCHead``,
    roi_heads/pointrcnn_head.py:43-66, which is the same stack without the
    mask). ``dense.<n>`` / ``bn.<n>`` are flax's ``Dense_<n>`` /
    ``MaskedBatchNorm_<n>``."""

    def __init__(self, in_channels, fc_cfg, output_channels, dtype=None,
                 generator=None):
        super().__init__()
        dense, bn = [], []
        for c in fc_cfg:
            dense.append(Dense(in_channels, c, bias=False, dtype=dtype,
                               generator=generator))
            bn.append(MaskedBatchNorm(c, axis=-1, **POINT_BN))
            in_channels = c
        dense.append(Dense(in_channels, output_channels, generator=generator))
        self.dense, self.bn = nn.ModuleList(dense), nn.ModuleList(bn)

    def forward(self, x, valid_mask=None):
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x), mask=valid_mask))
        return self.dense[-1](x.float())


class PointHeadSimple(nn.Module):
    """Per-keypoint class scores: ``point_cls_scores`` = max over classes of
    the sigmoid of ``FCLayers`` (point_head.py:138-171). In training it
    also emits ``point_head_fwd``: the logits and the point targets, for
    `loss`."""

    def __init__(self, model_cfg, num_class, input_channels, dtype=None,
                 generator=None):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        self.fc_layers = FCLayers(input_channels, model_cfg['CLS_FC'],
                                  num_class, dtype=dtype, generator=generator)

    def forward(self, batch):
        key = 'point_features_before_fusion' \
            if self.model_cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False) \
            else 'point_features'
        valid = batch['point_valid']
        preds = self.fc_layers(batch[key], valid)
        out = {**batch, 'point_cls_scores': torch.sigmoid(preds).amax(-1)}
        if self.training:
            targets = assign_point_targets(
                batch['point_coords'], valid, batch['gt_boxes'],
                self.model_cfg['TARGET_CONFIG']['GT_EXTRA_WIDTH'],
                self.num_class)
            out['point_head_fwd'] = {'point_cls_preds': preds, **targets}
        return out

    def loss(self, fwd):
        w = self.model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
        loss, pos = point_cls_loss(fwd['point_cls_preds'],
                                   fwd['point_cls_labels'], self.num_class,
                                   w['point_cls_weight'])
        return loss, {'point_loss_cls': loss, 'point_pos_num': pos}


class PointHeadSimpleMultiFrame(nn.Module):
    """The multiframe keypoint head (point_head.py:321-383): one score a
    class and stacked frame, ``point_cls_scores`` their largest sigmoid.
    Training labels the points once per frame, against the gt boxes moved
    to that frame's pose (the batch's ``locations`` and
    ``rotations_y``), and `loss` is one focal loss over all frames'
    columns with one normaliser, the foreground count over every frame."""

    def __init__(self, model_cfg, num_class, input_channels, stack_frame_size,
                 dtype=None, generator=None):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        self.stack_frame_size = stack_frame_size
        self.fc_layers = FCLayers(input_channels, model_cfg['CLS_FC'],
                                  num_class * stack_frame_size, dtype=dtype,
                                  generator=generator)

    def forward(self, batch):
        key = 'point_features_before_fusion' \
            if self.model_cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False) \
            else 'point_features'
        valid = batch['point_valid']
        preds = self.fc_layers(batch[key], valid)
        out = {**batch, 'point_cls_scores': torch.sigmoid(preds).amax(-1)}
        if self.training:
            gt = batch['gt_boxes']
            labels = []
            for i in range(self.stack_frame_size):
                gt_i = torch.cat([batch['locations'][:, :, i], gt[..., 3:6],
                                  batch['rotations_y'][:, :, i, None],
                                  gt[..., 7:]], dim=-1)
                labels.append(assign_point_targets(
                    batch['point_coords'], valid, gt_i,
                    self.model_cfg['TARGET_CONFIG']['GT_EXTRA_WIDTH'],
                    self.num_class)['point_cls_labels'])
            out['point_head_fwd'] = {'point_cls_preds': preds,
                                     'point_cls_labels_list': tuple(labels)}
        return out

    def loss(self, fwd):
        w = self.model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
        labels = torch.stack([l.reshape(-1) for l in fwd['point_cls_labels_list']],
                             dim=-1)  # (B*N, T)
        preds = fwd['point_cls_preds'].reshape(
            -1, self.num_class * self.stack_frame_size)
        positives = labels > 0
        pos_norm = batch_normalizer(positives.sum().float())
        cls_weights = (((labels == 0) | positives).float() / pos_norm).sum(-1)
        one_hot = torch.cat([
            torch.nn.functional.one_hot(l.clamp(min=0), self.num_class + 1)
            [..., 1:] for l in labels.unbind(-1)], dim=-1).to(preds.dtype)
        loss = losses.sigmoid_focal_loss(preds[None], one_hot[None],
                                         cls_weights[None]).sum()
        loss = loss * w['point_cls_weight']
        return loss, {'point_loss_cls': loss, 'point_pos_num': pos_norm}


def decoded_point_boxes(out, cls_preds, box_preds, box_coder, valid):
    """Puts in `out` the point boxes for the proposal layer
    (point_head.py:211-219): each point's box decoded with its best class
    (``argmax + 1``, in training too), its logits, and the validity
    mask."""
    out.update(batch_cls_preds=cls_preds,
               batch_box_preds=box_coder.decode(box_preds, out['point_coords'],
                                                cls_preds.argmax(-1) + 1),
               batch_valid_preds=valid, cls_preds_normalized=False)


class PointHeadBox(nn.Module):
    """PointRCNN's first stage (point_head.py:174-233): per point the class
    logits (``cls_layers``) and a box (``box_layers``, decoded by the
    TARGET_CONFIG's coder), ``point_cls_scores`` = max over classes of
    the sigmoid. The decoded boxes go to the RoI head in training too
    (``predict_boxes_when_training``). In training it also emits
    ``point_head_fwd``: the logits, the box residuals and the targets."""

    def __init__(self, model_cfg, num_class, input_channels,
                 predict_boxes_when_training=True, dtype=None, generator=None):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        tc = model_cfg['TARGET_CONFIG']
        self.box_coder = build_box_coder(tc['BOX_CODER'],
                                         **tc.get('BOX_CODER_CONFIG', {}))
        self.cls_layers = FCLayers(input_channels, model_cfg['CLS_FC'],
                                   num_class, dtype=dtype, generator=generator)
        self.box_layers = FCLayers(input_channels, model_cfg['REG_FC'],
                                   self.box_coder.full_code_size, dtype=dtype,
                                   generator=generator)

    def forward(self, batch):
        feats, valid = batch['point_features'], batch['point_valid']
        cls_preds = self.cls_layers(feats, valid)
        box_preds = self.box_layers(feats, valid)
        out = {**batch, 'point_cls_scores': torch.sigmoid(cls_preds).amax(-1)}
        if self.training:
            targets = assign_point_targets(
                batch['point_coords'], valid, batch['gt_boxes'],
                self.model_cfg['TARGET_CONFIG']['GT_EXTRA_WIDTH'],
                self.num_class, box_coder=self.box_coder, ret_box_labels=True)
            out['point_head_fwd'] = {'point_cls_preds': cls_preds,
                                     'point_box_preds': box_preds, **targets}
        if not self.training or self.predict_boxes_when_training:
            decoded_point_boxes(out, cls_preds, box_preds, self.box_coder,
                                valid)
        return out

    def loss(self, fwd):
        w = self.model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
        cls_loss, pos = point_cls_loss(fwd['point_cls_preds'],
                                       fwd['point_cls_labels'], self.num_class,
                                       w['point_cls_weight'])
        box_loss = point_box_loss(fwd['point_box_preds'],
                                  fwd['point_box_labels'],
                                  fwd['point_cls_labels'],
                                  code_weights=w.get('code_weights'),
                                  weight=w['point_box_weight'])
        return cls_loss + box_loss, {'point_loss_cls': cls_loss,
                                     'point_loss_box': box_loss,
                                     'point_pos_num': pos}


class PointIntraPartOffsetHead(nn.Module):
    """Part-A²'s point head (point_head.py:236-318): per voxel centre the
    foreground score, ``point_cls_scores`` = max over classes of the
    sigmoid of ``cls_layers``, and the part offsets, ``point_part_offset``
    = sigmoid of ``part_reg_layers`` (both ``FCLayers``; PartA2.yaml's
    empty CLS_FC and PART_FC make each one Dense from the 16 UNet
    channels). With a TARGET_CONFIG.BOX_CODER also a box a point
    (``box_layers``), decoded for the proposal layer as ``PointHeadBox``
    decodes it when ``predict_boxes_when_training`` or in eval. In
    training it also emits ``point_head_fwd``: the logits, the foreground
    labels, the part targets (and box targets), for `loss`."""

    def __init__(self, model_cfg, num_class, input_channels,
                 predict_boxes_when_training=False, dtype=None,
                 generator=None):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        tc = model_cfg['TARGET_CONFIG']
        self.box_coder = build_box_coder(
            tc['BOX_CODER'], **tc.get('BOX_CODER_CONFIG', {})) \
            if tc.get('BOX_CODER') else None
        self.cls_layers = FCLayers(input_channels, model_cfg['CLS_FC'],
                                   num_class, dtype=dtype, generator=generator)
        self.part_reg_layers = FCLayers(input_channels, model_cfg['PART_FC'],
                                        3, dtype=dtype, generator=generator)
        self.box_layers = None if self.box_coder is None else FCLayers(
            input_channels, model_cfg['REG_FC'], self.box_coder.full_code_size,
            dtype=dtype, generator=generator)

    def forward(self, batch):
        feats, valid = batch['point_features'], batch['point_valid']
        cls_preds = self.cls_layers(feats, valid)
        part_preds = self.part_reg_layers(feats, valid)
        out = {**batch, 'point_cls_scores': torch.sigmoid(cls_preds).amax(-1),
               'point_part_offset': torch.sigmoid(part_preds)}
        box_preds = None if self.box_layers is None \
            else self.box_layers(feats, valid)
        if self.training:
            targets = assign_point_targets(
                batch['point_coords'], valid, batch['gt_boxes'],
                self.model_cfg['TARGET_CONFIG']['GT_EXTRA_WIDTH'],
                self.num_class, box_coder=self.box_coder,
                ret_box_labels=box_preds is not None, ret_part_labels=True)
            out['point_head_fwd'] = {'point_cls_preds': cls_preds,
                                     'point_part_preds': part_preds, **targets}
            if box_preds is not None:
                out['point_head_fwd']['point_box_preds'] = box_preds
        if box_preds is not None and (not self.training
                                      or self.predict_boxes_when_training):
            decoded_point_boxes(out, cls_preds, box_preds, self.box_coder,
                                valid)
        return out

    def loss(self, fwd):
        w = self.model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
        cls_loss, pos = point_cls_loss(fwd['point_cls_preds'],
                                       fwd['point_cls_labels'], self.num_class,
                                       w['point_cls_weight'])
        part_loss = point_part_loss(fwd['point_part_preds'],
                                    fwd['point_part_labels'],
                                    fwd['point_cls_labels'],
                                    w['point_part_weight'])
        tb = {'point_loss_cls': cls_loss, 'point_loss_part': part_loss,
              'point_pos_num': pos}
        total = cls_loss + part_loss
        if 'point_box_preds' in fwd:
            tb['point_loss_box'] = point_box_loss(
                fwd['point_box_preds'], fwd['point_box_labels'],
                fwd['point_cls_labels'], code_weights=w.get('code_weights'),
                weight=w.get('point_box_weight', 1.0))
            total = total + tb['point_loss_box']
        return total, tb
