"""Single-stage eval post-processing: top-k, deferred decode, rotated NMS
(the deferred-decode branch of
lidardetection_tpu/models/detectors/post_processing.py:58-179).

Candidates are ranked on the raw logits (sigmoid is monotonic): each BEV
pixel's best class logit ranks the pixels, the top ``n_pix`` pixels' rows
are gathered and re-ranked exactly, and only the kept NMS_PRE_MAXSIZE rows
are upcast, passed through the sigmoid and decoded. The score threshold
is applied in logit space. Outputs are padded to NMS_POST_MAXSIZE with a
mask and a count, as in the JAX package. Its ``approx_max_k`` over pixels
(batch > 1) is an exact top-k here.
"""

import numpy as np
import torch

from ...core.iou3d import nms_bev_batched, top_k

VARIANTS_NOT_PORTED = 'see ROADMAP.md queue 1, "Variants"'


def post_processing(batch, post_cfg, num_class):
    """Args:
        batch: head output with batch_fused_preds (B, H, W, na*tot),
            head_raw_sizes, head_layout, anchor_from_idx, decode_box_fn,
            cls_preds_normalized (+ optional batch_valid_preds (B, N)).
    Returns dict: pred_boxes (B, post, 7+), pred_scores (B, post),
    pred_labels (B, post) (1-based, 0 = empty), pred_mask (B, post) bool,
    num_preds (B,), and num_candidates (B,): live rows entering NMS.
    """
    nms_cfg = post_cfg['NMS_CONFIG']
    if nms_cfg.get('MULTI_CLASSES_NMS', False):
        raise NotImplementedError(f'multi-class NMS is not ported yet: '
                                  f'{VARIANTS_NOT_PORTED}')
    if nms_cfg['NMS_TYPE'] != 'nms_gpu':
        raise NotImplementedError(f'NMS_TYPE {nms_cfg["NMS_TYPE"]} is not '
                                  f'ported yet: {VARIANTS_NOT_PORTED}')
    if 'decode_box_fn' not in batch:
        raise NotImplementedError(
            'only the deferred-decode single-stage branch is ported; '
            'two-stage heads are in ROADMAP.md queue 1, "PV-RCNN"')
    score_thresh = post_cfg.get('SCORE_THRESH', None)
    normalized = batch.get('cls_preds_normalized', False)

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

    post = int(nms_cfg['NMS_POST_MAXSIZE'])
    # candidates come out of a top-k, so they already descend by score
    idx, mask, num = nms_bev_batched(
        box_preds[..., 0:7], scores, thresh=nms_cfg['NMS_THRESH'],
        pre_maxsize=int(nms_cfg['NMS_PRE_MAXSIZE']), post_maxsize=post,
        valid_mask=live, assume_sorted=True)

    sel_boxes = torch.gather(
        box_preds, 1, idx[..., None].expand(-1, -1, box_preds.shape[-1]))
    zero = torch.zeros((), device=dev)
    return {
        'pred_boxes': sel_boxes * mask[..., None],
        'pred_scores': torch.where(mask, torch.gather(scores, 1, idx), zero),
        'pred_labels': torch.where(mask, torch.gather(labels, 1, idx),
                                   torch.zeros_like(idx)),
        'pred_mask': mask,
        'num_preds': num,
        'num_candidates': live.sum(1),
    }
