"""RoI point pooling, in plain PyTorch (lidardetection_tpu/ops/roi_pool.py;
the JAX package computes it in XLA, outside any Pallas kernel, and so does
the port until a card measurement says it needs a kernel).

``roi_point_sample`` picks the first ``cap`` in-box points of each RoI in
index order. PointRCNN's ``roipoint_pool3d`` gathers them with their
features, repeating a RoI's hits to fill its slots. Part-A²'s
``roiaware_pool3d`` puts each sampled point (one sample for both of its
pools) in its cell of the RoI's (out_x, out_y, out_z) grid and reduces the
cells by max or by mean.

The forward is deterministic on the card: the max of a cell does not
depend on the order it is taken in, and the mean's sums run cell by cell
in the sampled points' order (``torch.segment_reduce`` over the rows
sorted by cell, a stable sort), where an ``index_add_`` would add in no
fixed order. That is what lets the bucketed eval's detections equal the
device-built path's, and one request equal the next; chip_smoke.py
(``avg_pool_cost``) times the ``index_add_`` pool beside it. The backward
is deterministic too: the sampled points' features are read by
``gather.gather_rows``, whose backward adds each point's contributions in
the order of the slots that read it (a stable sort and a segmented sum),
where the gradient of ``torch.gather`` would add them with float atomics
in no fixed order. The max's gradient is shared evenly among the points
that tie for it, as JAX's ``_scatter_extremal_jvp`` shares it.
"""

import torch

from ..core.geometry import points_in_boxes_3d
from .gather import gather_rows


def roi_point_sample(points, point_num, rois, roi_valid, cap):
    """The first `cap` in-box points of each RoI, in index order.

    Args: points (B, N, 3); point_num (B,), the live points being the
    first ones; rois (B, R, 7+); roi_valid (B, R) bool; cap: int.
    Returns idx (B, R, cap) int64 point indices, ascending, 0 past the
    RoI's hit count, and hit (B, R, cap) bool. The JAX package takes the
    `cap` best of a (-index) score with ``top_k``; a running count of the
    in-box points places each in its slot here, with the same lists.
    """
    b, n = points.shape[:2]
    r = rois.shape[1]
    pvalid = torch.arange(n, device=points.device)[None, :] < point_num[:, None]
    inside = points_in_boxes_3d(points, rois[..., :7]).transpose(1, 2)
    inside = inside & pvalid[:, None, :] & roi_valid[..., None]  # (B, R, N)
    rank = torch.cumsum(inside, dim=-1, dtype=torch.int32) - 1
    slot = torch.where(inside & (rank < cap), rank, cap).long()
    idx = torch.zeros((b, r, cap + 1), dtype=torch.long, device=points.device)
    # every slot below cap is written once; slot `cap` takes the rest
    idx.scatter_(2, slot, torch.arange(n, device=points.device).expand(b, r, n))
    count = inside.sum(-1, keepdim=True)
    hit = torch.arange(cap, device=points.device) < count
    return torch.where(hit, idx[..., :cap], 0), hit


def roipoint_pool3d(points, point_features, point_num, rois, roi_valid,
                    num_sampled_points=512):
    """A fixed number of in-RoI points a box with their features (:15-61,
    the reference's roipoint_pool3d_kernel.cu:38-130): the RoI's first
    `num_sampled_points` in-box points in index order, slot ``k`` past its
    hit count repeating slot ``k % count``; an empty or invalid RoI gives
    zeros and is flagged.

    Args: points (B, N, 3); point_features (B, N, C); point_num (B,);
    rois (B, R, 7+); roi_valid (B, R) bool.
    Returns pooled (B, R, S, 3 + C) of ``[xyz, features]`` and empty (B,
    R) bool.
    """
    s = int(num_sampled_points)
    idx, hit = roi_point_sample(points, point_num, rois, roi_valid, s)
    cnt = hit.sum(-1, keepdim=True)
    empty = cnt[..., 0] == 0
    slots = torch.arange(s, device=points.device)
    idx = torch.gather(idx, 2, slots % cnt.clamp(min=1))
    data = torch.cat([points, point_features], dim=-1)
    pooled = gather_rows(data, idx)
    return pooled.masked_fill(empty[..., None, None], 0.0), empty


def pool_cells(points, rois, sample, out_size):
    """Each sampled point's cell in ``roiaware_pool3d``: (B, R * S) int64,
    ``roi * ncell + cell``, and ``R * ncell`` (a spare row) for a slot
    past the RoI's hits."""
    ox, oy, oz = (int(s) for s in out_size)
    ncell = ox * oy * oz
    idx, hit = sample
    b, r, s = idx.shape
    with torch.no_grad():  # the cells are indices
        spts = torch.gather(points, 1, idx.reshape(b, r * s)[
            ..., None].expand(-1, -1, 3)).reshape(b, r, s, 3)
        boxes = rois[..., :7].detach()
        shift = spts - boxes[:, :, None, 0:3]
        cosa = torch.cos(-boxes[..., 6])[..., None]
        sina = torch.sin(-boxes[..., 6])[..., None]
        lx = shift[..., 0] * cosa - shift[..., 1] * sina
        ly = shift[..., 0] * sina + shift[..., 1] * cosa
        lz = shift[..., 2] + boxes[..., 5:6] / 2  # z from the box bottom
        dx, dy, dz = boxes[..., 3:4], boxes[..., 4:5], boxes[..., 5:6]
        cx = ((lx + dx / 2) / torch.clamp(dx / ox, min=1e-9)).to(
            torch.int32).clamp(0, ox - 1)
        cy = ((ly + dy / 2) / torch.clamp(dy / oy, min=1e-9)).to(
            torch.int32).clamp(0, oy - 1)
        cz = (lz / torch.clamp(dz / oz, min=1e-9)).to(
            torch.int32).clamp(0, oz - 1)
        cell = (cx * oy + cy) * oz + cz  # (B, R, S)
        roi = torch.arange(r, device=idx.device)[None, :, None]
        return torch.where(hit, roi * ncell + cell, r * ncell).reshape(b, r * s)


def roiaware_pool3d(points, point_features, rois, sample, out_size,
                    pool_method):
    """Pool point features into each RoI's local grid
    (roiaware_pool3d_kernel.cu:111-235 of the reference).

    Each sampled point's cell: its offset from the RoI centre rotated by
    -heading, shifted to the box's corner (z from the box bottom), over the
    cell size, truncated toward zero (not floored) and clipped into the
    grid, as the JAX package's ``astype(int32)`` then ``clip`` do. 'max'
    starts each cell at -inf and turns an empty cell into 0; 'avg' is the
    sum over max(count, 1).

    Args: points (B, N, 3); point_features (B, N, C); rois (B, R, 7+);
    sample: the (idx, hit) of `roi_point_sample` on these points and
    RoIs (Part-A² shares one between its two pools); out_size (out_x,
    out_y, out_z); pool_method 'max' or 'avg'. Returns (B, R, out_x,
    out_y, out_z, C) in the dtype of point_features.
    """
    ox, oy, oz = (int(s) for s in out_size)
    ncell = ox * oy * oz
    idx, _ = sample
    b, r, s = idx.shape
    c = point_features.shape[-1]
    sfeats = gather_rows(point_features, idx.reshape(b, r * s))
    flat = pool_cells(points, rois, sample, out_size)
    if pool_method == 'max':
        index = flat[..., None].expand(-1, -1, c)
        canvas = sfeats.new_full((b, r * ncell + 1, c), -float('inf'))
        canvas = canvas.scatter_reduce(1, index, sfeats, 'amax',
                                       include_self=True)[:, :-1]
        canvas = torch.where(torch.isinf(canvas), torch.zeros_like(canvas),
                             canvas)
    elif pool_method == 'avg':
        rows = r * ncell + 1
        order = torch.argsort(flat, dim=1, stable=True)
        seg = (torch.gather(flat, 1, order)
               + torch.arange(b, device=idx.device)[:, None] * rows).reshape(-1)
        # each cell's rows start where the sorted cells first reach it: no
        # host sync, where bincount's output size would take one
        offsets = torch.searchsorted(
            seg, torch.arange(b * rows + 1, device=idx.device))
        count = offsets.diff()
        ssum = torch.segment_reduce(
            gather_rows(sfeats, order).reshape(b * r * s, c), 'sum',
            offsets=offsets, axis=0, unsafe=True, initial=0.0)
        # the count of a cell is its hits: the misses all go to the spare row
        canvas = (ssum / count.clamp(min=1).to(ssum.dtype)[:, None]).reshape(
            b, rows, c)[:, :-1]
    else:
        raise NotImplementedError(pool_method)
    return canvas.reshape(b, r, ox, oy, oz, c)
