"""Rotated BEV/3D IoU and exact greedy rotated-BEV NMS.

The intersection area is the JAX package's fixed-dataflow formulation
(lidardetection_tpu/core/iou3d.py:67-225): each rectangle's edges are
clipped to the other (Liang-Barsky against four half-planes) and the
clipped segments are summed with the shoelace formula. Every dot in it is
written out as elementwise float32 multiply-adds, never ``einsum`` or
``matmul``: a reduced-precision product (bf16 on the TPU, TF32 on the
card) breaks the collinear-edge tie handling for near-identical boxes.

NMS is exact greedy in score order (rotated, or on the nearest
axis-aligned rectangles for ``nms_normal``), walked in blocks as the JAX package
walks it (lidardetection_tpu/core/iou3d.py:420-595): the next `block` live
candidates of every sample have their IoU rows against all candidates
computed on the device, one copy to the host resolves the block in order
and removes what its kept rows suppress, and the walk stops at
`post_maxsize` kept rows. Only the rows the walk reaches are computed.
"""

import math

import numpy as np
import torch

from .geometry import corners_bev, limit_period

_PAR_TOL = 1e-4   # |n.d| <= tol*|d| -> treat edge as parallel to the face
_TIE_TOL = 1e-3   # signed-distance window for boundary-coincidence ties (m)


def _rect_halfplanes(boxes):
    """Half-plane form of rotated rectangles: inside iff n_k . x <= c_k.

    Args: boxes (..., 7). Returns normals (..., 4, 2), offsets (..., 4).
    """
    h = boxes[..., 6]
    c, s = torch.cos(h), torch.sin(h)
    u = torch.stack([c, s], dim=-1)    # box x-axis
    v = torch.stack([-s, c], dim=-1)   # box y-axis
    n = torch.stack([u, -u, v, -v], dim=-2)  # (..., 4, 2)
    center = boxes[..., 0:2]
    half = torch.stack([boxes[..., 3], boxes[..., 3], boxes[..., 4],
                        boxes[..., 4]], dim=-1) / 2
    return n, (n * center[..., None, :]).sum(-1) + half


def _clipped_edges_contribution(pa1, pa2, nb, cb, second_pass=False):
    """Shoelace contribution of A-edges clipped to rectangle B.

    Args:
        pa1, pa2: (..., 4, 2) edge endpoints of A (consistent winding);
        nb: (..., 4, 2) B half-plane normals; cb: (..., 4) offsets;
        second_pass: reject an edge lying ON a face of B (within _TIE_TOL)
            that runs in the same direction as B's own edge there, so
            shared boundary pieces count once across the two passes.
    Returns (...,): sum over A's edges of cross(p(t0), p(t1)) for the part
    of the edge inside B.
    """
    d = pa2 - pa1  # (..., 4, 2)
    len_d = torch.sqrt((d * d).sum(-1))[..., :, None]  # (..., 4e, 1)
    nd = (nb[..., None, :, :] * d[..., :, None, :]).sum(-1)  # (..., 4e, 4k)
    nf = (nb[..., None, :, :] * pa1[..., :, None, :]).sum(-1) - cb[..., None, :]
    is_par = nd.abs() <= _PAR_TOL * len_d
    t_at = -nf / torch.where(is_par, torch.ones_like(nd), nd)
    t_lo = torch.where(~is_par & (nd < 0), t_at, torch.zeros_like(t_at))
    t_hi = torch.where(~is_par & (nd > 0), t_at, torch.ones_like(t_at))
    reject = is_par & (nf > _TIE_TOL)
    if second_pass:
        same_dir = (d[..., :, None, 0] * nb[..., None, :, 1]
                    - d[..., :, None, 1] * nb[..., None, :, 0]) > 0
        reject = reject | (is_par & (nf.abs() <= _TIE_TOL) & same_dir)
    t0 = t_lo.amax(-1).clamp(min=0.0)  # (..., 4e)
    t1 = t_hi.amin(-1).clamp(max=1.0)
    valid = (t1 > t0) & ~reject.any(-1)
    p0 = pa1 + t0[..., None] * d
    p1 = pa1 + t1[..., None] * d
    cross = p0[..., 0] * p1[..., 1] - p0[..., 1] * p1[..., 0]
    return torch.where(valid, cross, torch.zeros_like(cross)).sum(-1)


def _box_clip_parts(boxes):
    """(corners (..., 4, 2), normals (..., 4, 2), offsets (..., 4))."""
    return (corners_bev(boxes),) + _rect_halfplanes(boxes)


def _pair_overlap_parts(parts_a, parts_b):
    """Intersection area from broadcastable `_box_clip_parts`."""
    ca, na, caa = parts_a
    cb, nb, cbb = parts_b
    contrib_a = _clipped_edges_contribution(
        ca, torch.roll(ca, -1, dims=-2), nb, cbb)
    contrib_b = _clipped_edges_contribution(
        cb, torch.roll(cb, -1, dims=-2), na, caa, second_pass=True)
    return (contrib_a + contrib_b).abs() / 2


def boxes_overlap_bev(boxes_a, boxes_b):
    """Rotated BEV intersection area, all pairs: (N, 7), (M, 7) -> (N, M).

    Rows go in chunks so the ~16-float-per-pair clipping workspace stays
    near 128 MB per temporary, as in the JAX package.
    """
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    parts_b = tuple(p[None] for p in _box_clip_parts(boxes_b))
    row_chunk = max(1, min(n, 2 ** 25 // max(m * 16, 1)))
    out = [_pair_overlap_parts(
        tuple(p[:, None] for p in _box_clip_parts(boxes_a[r:r + row_chunk])),
        parts_b) for r in range(0, n, row_chunk)]
    return torch.cat(out, dim=0) if out else boxes_a.new_zeros((0, m))


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU, all pairs."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    return overlap / (area_a[:, None] + area_b[None, :] - overlap).clamp(min=1e-6)


def boxes_iou3d(boxes_a, boxes_b):
    """3D IoU with z-extent overlap, all pairs."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)  # (N, M)
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    z_overlap = (torch.minimum(za2[:, None], zb2[None, :])
                 - torch.maximum(za1[:, None], zb1[None, :])).clamp(min=0)
    overlap_3d = overlap_bev * z_overlap
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return overlap_3d / (vol_a[:, None] + vol_b[None, :]
                         - overlap_3d).clamp(min=1e-6)


def top_k(x, k):
    """Top k along the last axis, ties to the lower index (lax.top_k's
    order, which ``torch.topk`` does not promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _iou_parts(parts_a, area_a, parts_b, area_b):
    """IoU from broadcastable `_box_clip_parts` and areas, with the
    operations of `boxes_iou_bev`."""
    overlap = _pair_overlap_parts(parts_a, parts_b)
    return overlap / (area_a + area_b - overlap).clamp(min=1e-6)


def nms_bev_batched(boxes, scores, thresh, pre_maxsize, post_maxsize,
                    valid_mask=None, assume_sorted=False, block=32,
                    adaptive_tier=512, aligned=False):
    """Batched rotated-BEV greedy NMS (lidardetection_tpu/core/iou3d.py:544),
    or with `aligned` the axis-aligned one of ``nms_normal_bev`` (:637).

    Args: boxes (B, N, 7); scores (B, N); valid_mask (B, N) optional bool.
        assume_sorted: scores already descend along N with invalid rows at
            the tail (straight out of a top-k), so the pre-NMS sort is
            skipped when pre_maxsize covers N.
        block: live candidates resolved together per sample and step.
        adaptive_tier: when no sample has more live candidates than this,
            the walk runs on that prefix of the score order (live rows sort
            first, so the result is the same); 0 disables.
        aligned: the IoU of each box's nearest axis-aligned BEV rectangle
            (``boxes_iou_normal``), as the JAX package's ``nms_normal_bev``
            walks it, in place of the rotated IoU.
    Returns: (indices (B, post) int64 into the input N axis, padded with 0;
    keep_mask (B, post) bool; num_kept (B,) int64; rows_read (B,) int64
    numpy, the IoU rows each sample's walk computed).

    A candidate j is suppressed by a kept i when IoU(i, j) > thresh, with i
    as the first rectangle of the pair, as in the JAX package. A kept row
    is removed explicitly: the self-IoU of identical rectangles can round
    to 0.
    """
    bsz, n = scores.shape
    dev = scores.device
    if valid_mask is None:
        valid_mask = torch.ones_like(scores, dtype=torch.bool)
    neg_inf = torch.tensor(-float('inf'), dtype=scores.dtype, device=dev)
    masked = torch.where(valid_mask, scores, neg_inf)
    k = min(pre_maxsize, n)
    if assume_sorted and k == n:
        top_scores = masked
        order = torch.arange(n, device=dev).expand(bsz, n)
        top_boxes = boxes
    else:
        top_scores, order = top_k(masked, k)
        top_boxes = torch.gather(
            boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    live = (top_scores > neg_inf).cpu().numpy()
    width = k
    if adaptive_tier and k > adaptive_tier \
            and live.sum(1).max() <= adaptive_tier:
        width = adaptive_tier
    live = live[:, :width].copy()
    all_boxes = top_boxes[:, :width, :7]
    rows = torch.arange(bsz, device=dev)[:, None]
    if aligned:
        rect = boxes3d_lidar_to_aligned_bev_boxes(all_boxes)  # (B, W, 4)

        def block_iou(idx):
            return _iou_normal(rect[rows, idx][:, :, None], rect[:, None])
    else:
        parts = _box_clip_parts(all_boxes)
        area = all_boxes[..., 3] * all_boxes[..., 4]
        all_parts = tuple(p[:, None] for p in parts)

        def block_iou(idx):
            return _iou_parts(tuple(p[rows, idx][:, :, None] for p in parts),
                              area[rows, idx][:, :, None], all_parts,
                              area[:, None, :])

    kept = [[] for _ in range(bsz)]
    rows_read = np.zeros(bsz, np.int64)
    m = min(block, width)
    while True:
        active = [s for s in range(bsz)
                  if len(kept[s]) < post_maxsize and live[s].any()]
        if not active:
            break
        # the next m live candidates of each active sample, in score order
        blk = np.zeros((bsz, m), np.int64)
        count = np.zeros(bsz, np.int64)
        for s in active:
            pos = np.flatnonzero(live[s])[:m]
            blk[s, :pos.size], count[s] = pos, pos.size
        iou = block_iou(torch.from_numpy(blk).to(dev))
        sup = (iou > thresh).cpu().numpy()  # (B, m, width)
        for s in active:
            rows_read[s] += count[s]
            done = []  # block rows kept, in order
            for j in range(count[s]):
                if any(sup[s, d, blk[s, j]] for d in done):
                    continue
                done.append(j)
                kept[s].append(int(blk[s, j]))
                if len(kept[s]) == post_maxsize:
                    break
            live[s] &= ~sup[s, done].any(0)
            live[s, blk[s, done]] = False

    num = np.array([len(kp) for kp in kept], np.int64)
    kept_pos = np.zeros((bsz, post_maxsize), np.int64)
    for s, kp in enumerate(kept):
        kept_pos[s, :len(kp)] = kp
    num_kept = torch.from_numpy(num).to(dev)
    keep_mask = torch.arange(post_maxsize, device=dev)[None, :] < num_kept[:, None]
    out = torch.where(keep_mask, torch.gather(
        order, 1, torch.from_numpy(kept_pos).to(dev)), 0)
    return out, keep_mask, num_kept, rows_read


def _iou_normal(a, b):
    """Axis-aligned IoU of broadcastable (..., 4) [x1, y1, x2, y2] boxes."""
    x_min = torch.maximum(a[..., 0], b[..., 0])
    x_max = torch.minimum(a[..., 2], b[..., 2])
    y_min = torch.maximum(a[..., 1], b[..., 1])
    y_max = torch.minimum(a[..., 3], b[..., 3])
    x_len = (x_max - x_min).clamp(min=0)
    y_len = (y_max - y_min).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    intersection = x_len * y_len
    return intersection / (area_a + area_b - intersection).clamp(min=1e-6)


def boxes_iou_normal(boxes_a, boxes_b):
    """Axis-aligned IoU of (N, 4) and (M, 4) [x1, y1, x2, y2] boxes -> (N, M)
    (lidardetection_tpu/core/iou3d.py:30). Elementwise float32 in the JAX
    code's operation order: the target assigner compares these values for
    equality."""
    return _iou_normal(boxes_a[:, None], boxes_b[None, :])


def boxes3d_lidar_to_aligned_bev_boxes(boxes3d):
    """(..., 7+) -> (..., 4) nearest axis-aligned BEV box (iou3d.py:47)."""
    rot_angle = limit_period(boxes3d[..., 6], offset=0.5, period=math.pi).abs()
    swap = rot_angle >= math.pi / 4
    dx = torch.where(swap, boxes3d[..., 4], boxes3d[..., 3])
    dy = torch.where(swap, boxes3d[..., 3], boxes3d[..., 4])
    half = torch.stack([dx, dy], dim=-1) / 2
    return torch.cat([boxes3d[..., 0:2] - half, boxes3d[..., 0:2] + half],
                     dim=-1)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """Axis-aligned-approximation BEV IoU, all pairs (iou3d.py:59)."""
    return boxes_iou_normal(boxes3d_lidar_to_aligned_bev_boxes(boxes_a),
                            boxes3d_lidar_to_aligned_bev_boxes(boxes_b))
