"""Class-agnostic and multi-class NMS with fixed-size outputs
(lidardetection_tpu/models/model_utils/nms_utils.py).

``NMS_TYPE: nms_gpu`` walks the rotated BEV IoU; any other type the
nearest axis-aligned rectangles' IoU (the JAX package's ``nms_normal_bev``).
Both are `core/iou3d.py::nms_bev_batched`, whose rows are independent
walks: the multi-class NMS hands it every (sample, class) pair of a batch
as one row, so all of them advance in one walk, each pair's keep list the
one the JAX package's per-class, per-sample ``nms_bev`` gives.
"""

import torch

from ...core.iou3d import nms_bev_batched


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None,
                       valid_mask=None, assume_sorted=False):
    """Rows of (R, N) scores and (R, N, 7+) boxes, each its own walk.

    Returns (selected (R, post) int64 into N, padded with 0; mask (R, post)
    bool; num (R,); rows_read (R,) numpy, the IoU rows each walk read)."""
    if valid_mask is None:
        valid_mask = torch.ones_like(box_scores, dtype=torch.bool)
    if score_thresh is not None:
        valid_mask = valid_mask & (box_scores >= score_thresh)
    return nms_bev_batched(
        box_preds[..., 0:7], box_scores, thresh=nms_config['NMS_THRESH'],
        pre_maxsize=int(nms_config['NMS_PRE_MAXSIZE']),
        post_maxsize=int(nms_config['NMS_POST_MAXSIZE']),
        valid_mask=valid_mask, assume_sorted=assume_sorted,
        aligned=nms_config['NMS_TYPE'] != 'nms_gpu')


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None):
    """Per-class NMS of a batch: (B, N, nc) scores, (B, N, 7+) boxes.

    Returns scores (B, nc * post), labels (B, nc * post) 0-based class
    ids, boxes (B, nc * post, 7+) and the keep mask (B, nc * post), class
    k's `post` slots at [k * post, (k + 1) * post) and zero where not
    kept, as the JAX package's ``multi_classes_nms`` lays them out per
    sample; and rows_read (B, nc) numpy."""
    b, n, nc = cls_scores.shape
    post = int(nms_config['NMS_POST_MAXSIZE'])
    rows = cls_scores.permute(0, 2, 1).reshape(b * nc, n)
    boxes = box_preds[:, None].expand(b, nc, n, box_preds.shape[-1])
    idx, mask, _, rows_read = class_agnostic_nms(
        rows, boxes.reshape(b * nc, n, -1), nms_config, score_thresh)
    scores = torch.where(mask, torch.gather(rows, 1, idx),
                         torch.zeros_like(rows[:, :1]))
    kept = torch.gather(box_preds, 1, idx.reshape(b, nc * post)[..., None]
                        .expand(-1, -1, box_preds.shape[-1]))
    mask = mask.reshape(b, nc * post)
    labels = torch.arange(nc, device=cls_scores.device).repeat_interleave(
        post).expand(b, -1)
    return (scores.reshape(b, nc * post), labels, kept * mask[..., None],
            mask, rows_read.reshape(b, nc))
