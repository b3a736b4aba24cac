"""Two-stage RoI machinery, eval (lidardetection_tpu/models/roi_heads/
roi_head_utils.py:22-45 and :305-317): the proposal layer and the decode
of the second stage's boxes. RoI target sampling and the RCNN losses are
ROADMAP.md queue 1, "PV-RCNN training".
"""

import torch

from ...core.geometry import rotate_points_along_z
from ...core.iou3d import nms_bev_batched


def proposal_layer(batch, nms_cfg):
    """Rotated-BEV NMS over the dense head's decoded boxes, scored by the
    largest raw class logit. Returns rois (B, P, 7+), roi_scores (B, P),
    roi_labels (B, P) 1-based (0 = empty), roi_valid (B, P), P =
    NMS_POST_MAXSIZE."""
    box_preds = batch['batch_box_preds']
    cls_preds = batch['batch_cls_preds']
    scores = cls_preds.amax(-1)
    labels = cls_preds.argmax(-1)
    idx, mask, _ = nms_bev_batched(
        box_preds[..., 0:7], scores, thresh=nms_cfg['NMS_THRESH'],
        pre_maxsize=int(nms_cfg['NMS_PRE_MAXSIZE']),
        post_maxsize=int(nms_cfg['NMS_POST_MAXSIZE']),
        valid_mask=batch.get('batch_valid_preds'))
    rois = torch.gather(box_preds, 1,
                        idx[..., None].expand(-1, -1, box_preds.shape[-1]))
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
