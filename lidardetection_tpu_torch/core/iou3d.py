"""Rotated BEV/3D IoU and exact greedy rotated-BEV NMS.

The intersection area is the JAX package's fixed-dataflow formulation
(lidardetection_tpu/core/iou3d.py:67-225): each rectangle's edges are
clipped to the other (Liang-Barsky against four half-planes) and the
clipped segments are summed with the shoelace formula. Every dot in it is
written out as elementwise float32 multiply-adds, never ``einsum`` or
``matmul``: a reduced-precision product (bf16 on the TPU, TF32 on the
card) breaks the collinear-edge tie handling for near-identical boxes.

NMS is exact greedy in score order: one IoU-above-threshold matrix over the
live candidates, computed on the device in row chunks and packed to bits,
then the greedy sweep on the host (as the reference's CUDA NMS does its
final pass). The JAX package's blocked and adaptive-tier loops are a TPU
latency device and have no counterpart here.
"""

import numpy as np
import torch

from .geometry import corners_bev

_PAR_TOL = 1e-4   # |n.d| <= tol*|d| -> treat edge as parallel to the face
_TIE_TOL = 1e-3   # signed-distance window for boundary-coincidence ties (m)
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits bit order


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


def _greedy_sweep(packed, post_maxsize):
    """Greedy pass over a packed suppression matrix, rows in score order:
    keep a row unless an earlier kept row suppresses it."""
    removed = np.zeros(packed.shape[1], np.uint8)
    keep = []
    for i in range(packed.shape[0]):
        if (removed[i >> 3] >> (7 - (i & 7))) & 1:
            continue
        keep.append(i)
        if len(keep) == post_maxsize:
            break
        removed |= packed[i]
    return keep


def nms_bev_batched(boxes, scores, thresh, pre_maxsize, post_maxsize,
                    valid_mask=None, assume_sorted=False):
    """Batched rotated-BEV greedy NMS (lidardetection_tpu/core/iou3d.py:544).

    Args: boxes (B, N, 7); scores (B, N); valid_mask (B, N) optional bool.
        assume_sorted: scores already descend along N with invalid rows at
            the tail (straight out of a top-k), so the pre-NMS sort is
            skipped when pre_maxsize covers N.
    Returns: (indices (B, post) int64 into the input N axis, padded with 0;
    keep_mask (B, post) bool; num_kept (B,) int64).

    A candidate j is suppressed by a kept i when IoU(i, j) > thresh, with i
    as the first rectangle of the pair, as in the JAX package.
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
    top_valid = top_scores > neg_inf
    bits = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=dev)

    out = torch.zeros((bsz, post_maxsize), dtype=torch.int64, device=dev)
    num_kept = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    for s in range(bsz):
        pos = torch.nonzero(top_valid[s]).squeeze(1)  # live, in score order
        live = int(pos.numel())
        if live == 0:
            continue
        bx = top_boxes[s, pos, :7]
        sup = (boxes_iou_bev(bx, bx) > thresh).to(torch.uint8)
        width = -(-live // 8) * 8
        sup = torch.nn.functional.pad(sup, (0, width - live))
        packed = (sup.view(live, width // 8, 8) * bits).sum(
            -1, dtype=torch.uint8)
        keep = _greedy_sweep(packed.cpu().numpy(), post_maxsize)
        kept = pos[torch.as_tensor(keep, device=dev)]
        out[s, :len(keep)] = order[s, kept]
        num_kept[s] = len(keep)
    keep_mask = torch.arange(post_maxsize, device=dev)[None, :] < num_kept[:, None]
    return out, keep_mask, num_kept
