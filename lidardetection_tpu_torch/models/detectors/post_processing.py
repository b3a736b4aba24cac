"""Eval post-processing: score threshold and rotated NMS
(lidardetection_tpu/models/detectors/post_processing.py:31-179).

Single-stage heads take the deferred-decode branch: candidates are ranked
on the raw logits (sigmoid is monotonic), each BEV pixel's best class
logit ranks the pixels, the top ``n_pix`` pixels' rows are gathered and
re-ranked exactly, and only the kept NMS_PRE_MAXSIZE rows are upcast,
passed through the sigmoid and decoded; the score threshold is applied in
logit space. Its ``approx_max_k`` over pixels (batch > 1) is an exact
top-k here. A two-stage head (PV-RCNN) hands decoded boxes: the sigmoid
probabilities are thresholded and NMS'd, labelled by ``roi_labels``.
Outputs are padded to NMS_POST_MAXSIZE with a mask and a count, as in the
JAX package. With ``MULTI_CLASSES_NMS`` (the multi-head detectors) every
class of every head runs its own NMS (``_multi_class_post_processing``):
the outputs hold each head's classes x NMS_POST_MAXSIZE slots, the kept
rows marked by ``pred_mask`` with gaps between them, so a reader selects
by the mask, not by the count. ``NMS_TYPE`` other than ``nms_gpu`` walks
the axis-aligned IoU. ``compute_recall`` counts the gt boxes that the kept
boxes (and the RoIs) cover, for the evaluator.
"""

import numpy as np
import torch

from ...core.iou3d import boxes_iou3d, top_k
from ..model_utils.nms_utils import class_agnostic_nms, multi_classes_nms


def post_processing(batch, post_cfg, num_class):
    """Args:
        batch: a single-stage head's output with batch_fused_preds
            (B, H, W, na*tot), head_raw_sizes, head_layout,
            anchor_from_idx, decode_box_fn (+ optional batch_valid_preds
            (B, N)), or a two-stage head's with batch_cls_preds (B, N, nc),
            batch_box_preds (B, N, 7+), batch_valid_preds and roi_labels
            (B, N); both with cls_preds_normalized.
    Returns dict: pred_boxes (B, post, 7+), pred_scores (B, post),
    pred_labels (B, post) (1-based, 0 = empty), pred_mask (B, post) bool,
    num_preds (B,), and num_candidates (B,): live rows entering NMS.
    """
    nms_cfg = post_cfg['NMS_CONFIG']
    if nms_cfg.get('MULTI_CLASSES_NMS', False):
        return _multi_class_post_processing(batch, post_cfg, num_class)
    score_thresh = post_cfg.get('SCORE_THRESH', None)
    normalized = batch.get('cls_preds_normalized', False)
    if 'decode_box_fn' not in batch:
        return _decoded_post_processing(batch, nms_cfg, score_thresh,
                                        normalized)

    fused = batch['batch_fused_preds']  # (B, H, W, na*tot)
    nc, code, nd = batch['head_raw_sizes']
    h, w, na = batch['head_layout']
    tot = nc + code + nd
    bsz, hw = fused.shape[0], h * w
    dev = fused.device
    flat = fused.reshape(bsz, hw, na * tot)

    lane_is_cls = torch.zeros(na * tot, dtype=torch.bool, device=dev)
    for a in range(na):
        lane_is_cls[a * tot:a * tot + nc] = True
    pix_rank = flat.masked_fill(~lane_is_cls, -float('inf')).amax(-1).float()

    pre = min(int(nms_cfg['NMS_PRE_MAXSIZE']), hw * na)
    if nms_cfg.get('EXACT_TOPK', False):
        # the top `pre` pixels hold the top `pre` anchors
        n_pix = min(((pre + 127) // 128) * 128, hw)
    else:
        n_pix = min(((-(-pre // na) + 127) // 128) * 128, hw)
    if n_pix >= hw:
        pix_i = torch.arange(hw, device=dev).expand(bsz, hw)
    else:
        _, pix_i = top_k(pix_rank, n_pix)
    rows_pix = torch.gather(flat, 1, pix_i[..., None].expand(-1, -1, na * tot))
    cand = rows_pix.reshape(bsz, -1, tot)  # (B, n_pix*na, tot)
    cand_i = (pix_i[:, :, None] * na
              + torch.arange(na, device=dev)[None, None, :]).reshape(bsz, -1)

    cand_rank = cand[..., :nc].amax(-1).float()
    cand_valid = torch.ones_like(cand_rank, dtype=torch.bool)
    valid = batch.get('batch_valid_preds')
    if valid is not None:
        cand_valid &= torch.gather(valid, 1, cand_i)
    if score_thresh is not None:
        thr = float(score_thresh) if normalized else \
            float(np.log(score_thresh / (1.0 - score_thresh)))
        cand_valid &= cand_rank >= thr
    masked = cand_rank.masked_fill(~cand_valid, -float('inf'))
    top_s, sel = top_k(masked, min(pre, masked.shape[1]))
    rows = torch.gather(cand, 1, sel[..., None].expand(-1, -1, tot))
    top_i = torch.gather(cand_i, 1, sel)

    cls_rows = rows[..., :nc].float()
    probs = cls_rows if normalized else torch.sigmoid(cls_rows)
    scores = probs.amax(-1)
    labels = probs.argmax(-1) + 1
    dir_rows = rows[..., nc + code:] if nd else None
    box_preds = batch['decode_box_fn'](rows[..., nc:nc + code], dir_rows,
                                       batch['anchor_from_idx'](top_i))
    live = torch.isfinite(top_s)
    scores = torch.where(live, scores, torch.zeros_like(scores))

    # candidates come out of a top-k, so they already descend by score
    idx, mask, num, _ = class_agnostic_nms(scores, box_preds, nms_cfg,
                                           valid_mask=live, assume_sorted=True)

    return _kept(box_preds, scores, labels, idx, mask, num, live)


def _decoded_post_processing(batch, nms_cfg, score_thresh, normalized):
    """The branch for heads that hand decoded boxes (post_processing.py:
    141-179 of the JAX package): probabilities thresholded, then NMS."""
    cls_raw = batch['batch_cls_preds']
    box_preds = batch['batch_box_preds']
    valid = batch['batch_valid_preds']
    scores = (cls_raw if normalized else torch.sigmoid(cls_raw)).amax(-1)
    labels = batch['roi_labels'].long()
    if score_thresh is not None:
        valid = valid & (scores >= score_thresh)
    idx, mask, num, _ = class_agnostic_nms(scores, box_preds, nms_cfg,
                                           valid_mask=valid)
    return _kept(box_preds, scores, labels, idx, mask, num, valid)


def _multi_class_post_processing(batch, post_cfg, num_class):
    """Per-class NMS (post_processing.py:211-251 of the JAX package):
    ``batch_cls_preds`` is a list of each head's (B, N_h, nc_h) logits with
    ``multihead_label_mapping``, each head's global class ids (1-based),
    or one (B, N, num_class) tensor; ``batch_box_preds`` (B, sum N_h, 7+)
    holds the heads' rows in order. Each head's (sample, class) pairs go
    through one NMS walk. ``num_candidates`` counts the (anchor, class)
    scores that pass SCORE_THRESH; ``rows_read``, (B, sum nc_h) numpy, the
    IoU rows each class's walk read."""
    nms_cfg = post_cfg['NMS_CONFIG']
    score_thresh = post_cfg.get('SCORE_THRESH', None)
    box_preds = batch['batch_box_preds']
    cls_preds = batch['batch_cls_preds']
    if isinstance(cls_preds, (list, tuple)):
        mappings = batch['multihead_label_mapping']
    else:
        cls_preds = [cls_preds]
        mappings = [tuple(range(1, num_class + 1))]
    normalized = batch.get('cls_preds_normalized', False)
    thr = -float('inf') if score_thresh is None else score_thresh
    parts = {k: [] for k in ('pred_scores', 'pred_labels', 'pred_boxes',
                             'pred_mask')}
    rows_read, live = [], 0
    start = 0
    for head_cls, mapping in zip(cls_preds, mappings):
        n = head_cls.shape[1]
        probs = head_cls.float() if normalized else torch.sigmoid(head_cls.float())
        scores, labels, boxes, mask, read = multi_classes_nms(
            probs, box_preds[:, start:start + n], nms_cfg, score_thresh)
        global_labels = torch.tensor(mapping, device=labels.device)[labels]
        parts['pred_scores'].append(scores)
        parts['pred_labels'].append(torch.where(mask, global_labels, 0))
        parts['pred_boxes'].append(boxes)
        parts['pred_mask'].append(mask)
        rows_read.append(read)
        live = live + (probs >= thr).sum((1, 2))
        start += n
    out = {k: torch.cat(v, dim=1) for k, v in parts.items()}
    out['num_preds'] = out['pred_mask'].sum(1)
    out['num_candidates'] = live
    out['rows_read'] = np.concatenate(rows_read, axis=1)
    return out


def _kept(box_preds, scores, labels, idx, mask, num, live):
    """The NMS survivors, zero-padded to NMS_POST_MAXSIZE."""
    sel_boxes = torch.gather(
        box_preds, 1, idx[..., None].expand(-1, -1, box_preds.shape[-1]))
    zero = torch.zeros((), device=scores.device)
    return {
        'pred_boxes': sel_boxes * mask[..., None],
        'pred_scores': torch.where(mask, torch.gather(scores, 1, idx), zero),
        'pred_labels': torch.where(mask, torch.gather(labels, 1, idx),
                                   torch.zeros_like(idx)),
        'pred_mask': mask,
        'num_preds': num,
        'num_candidates': live.sum(1),
    }


def compute_recall(pred_boxes, pred_mask, gt_boxes, thresh_list, rois=None,
                   roi_mask=None):
    """Recall counters against the gt (post_processing.py:182 of the JAX
    package, generate_recall_record in the reference).

    Args:
        pred_boxes (B, N, 7+), pred_mask (B, N) bool, gt_boxes (B, G, 8)
        with the class last (0 = padding); rois (B, R, 7+) and roi_mask
        (B, R) optional.
    Returns a dict of 0-d int64 tensors: 'gt', the count of valid gt boxes,
    and 'rcnn_<t>' (and 'roi_<t>' with rois), the count of valid gt boxes
    whose best 3D IoU with a kept box (an RoI) is above t. The IoU is
    elementwise float32 (core/iou3d.py).
    """
    gt_valid = gt_boxes[..., -1] > 0  # (B, G)

    def best_iou(boxes, mask):
        best = []
        for b in range(boxes.shape[0]):
            iou = boxes_iou3d(boxes[b, :, :7].float(),
                              gt_boxes[b, :, :7].float())  # (N, G)
            iou = torch.where(mask[b][:, None] & gt_valid[b][None, :], iou,
                              torch.zeros_like(iou))
            best.append(iou.amax(0))
        return torch.stack(best)  # (B, G)

    best = best_iou(pred_boxes, pred_mask)
    out = {'gt': gt_valid.sum()}
    for t in thresh_list:
        out[f'rcnn_{t}'] = ((best > t) & gt_valid).sum()
    if rois is not None:
        best_roi = best_iou(rois, roi_mask)
        for t in thresh_list:
            out[f'roi_{t}'] = ((best_roi > t) & gt_valid).sum()
    return out
