"""The point processors of a point-based config (copy of lidardetection_tpu/
datasets/processor/data_processor.py:31-133): the range mask, near/far-aware
sampling, the shuffle and the fixed-capacity padding, on host numpy.

The JAX package's processors draw from numpy's global generator; these take
an ``np.random.RandomState`` that the caller owns. ``RandomState(s)`` draws
what ``np.random.seed(s)`` followed by the global calls draws, so the same
seed gives the same points bit for bit. The voxelizer is
``ops/voxelize.py``.
"""

import numpy as np

NEAR_DEPTH = 40.0  # data_processor.py:101: points nearer are subsampled first


def mask_points_by_range(points, limit_range):
    """(N,) bool: x and y inside the range, bounds included."""
    return ((points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
            & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4]))


def mask_boxes_outside_range(boxes, limit_range, min_num_corners=1):
    """(N, 7+) -> (N,) bool: boxes with at least `min_num_corners` of their
    8 corners inside the range (the training processor's box filter)."""
    if len(boxes) == 0:
        return np.zeros(0, dtype=bool)
    template = np.array([[x, y, z] for z in (-1, 1) for x, y in
                         ((1, 1), (1, -1), (-1, -1), (-1, 1))], np.float32) / 2
    corners = boxes[:, None, 3:6] * template[None]
    ca, sa = np.cos(boxes[:, 6:7]), np.sin(boxes[:, 6:7])
    corners = np.stack([corners[..., 0] * ca - corners[..., 1] * sa,
                        corners[..., 0] * sa + corners[..., 1] * ca,
                        corners[..., 2]], axis=-1) + boxes[:, None, 0:3]
    limit_range = np.asarray(limit_range, np.float32)
    inside = ((corners >= limit_range[0:3])
              & (corners <= limit_range[3:6])).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners


def mask_points_and_boxes_outside_range(points, limit_range, gt_boxes=None,
                                        remove_outside_boxes=False):
    """The in-range points and, with `remove_outside_boxes` (training), the
    gt boxes with a corner in the range (:31-45). Returns (points,
    gt_boxes)."""
    limit_range = np.asarray(limit_range, np.float32)
    points = points[mask_points_by_range(points, limit_range)]
    if gt_boxes is not None and remove_outside_boxes:
        gt_boxes = gt_boxes[mask_boxes_outside_range(gt_boxes, limit_range)]
    return points, gt_boxes


def shuffle_points(points, rng):
    """The points in a random order (:47-54)."""
    return points[rng.permutation(points.shape[0])]


def sample_points(points, num_points, rng):
    """`num_points` of the points (:92-120), -1 for all: fewer are drawn
    without replacement, the points at least 40 m away all kept when
    there are fewer of them than `num_points`; more are the points and
    draws with replacement; either way in a random order."""
    if num_points == -1:
        return points
    if num_points < len(points):
        pts_depth = np.linalg.norm(points[:, 0:3], axis=1)
        near_idxs = np.where(pts_depth < NEAR_DEPTH)[0]
        far_idxs = np.where(pts_depth >= NEAR_DEPTH)[0]
        if num_points > len(far_idxs):
            near_choice = rng.choice(near_idxs, num_points - len(far_idxs),
                                     replace=False)
            choice = np.concatenate((near_choice, far_idxs), axis=0)
        else:
            choice = rng.choice(np.arange(len(points)), num_points,
                                replace=False)
    else:
        choice = np.arange(len(points))
        if num_points > len(points):
            extra = rng.choice(choice, num_points - len(points))
            choice = np.concatenate((choice, extra), axis=0)
    rng.shuffle(choice)
    return points[choice]


def pad_points(points, max_points):
    """(max_points, C) float32, the first `max_points` points then zeros,
    and their count (:122-133)."""
    n = min(len(points), max_points)
    out = np.zeros((max_points, points.shape[1]), np.float32)
    out[:n] = points[:n]
    return out, np.int32(n)


def process_points(points, processor_cfgs, point_cloud_range, training, rng):
    """A cloud through a point-based config's DATA_PROCESSOR chain in its
    order (mask, sample, shuffle) in the split's mode; `rng` draws the
    sample and the shuffle."""
    mode = 'train' if training else 'test'
    for cfg in processor_cfgs:
        name = cfg['NAME']
        if name == 'mask_points_and_boxes_outside_range':
            points, _ = mask_points_and_boxes_outside_range(
                points, point_cloud_range)
        elif name == 'sample_points':
            points = sample_points(points, cfg['NUM_POINTS'][mode], rng)
        elif name == 'shuffle_points':
            if cfg['SHUFFLE_ENABLED'][mode]:
                points = shuffle_points(points, rng)
        else:
            raise NotImplementedError(f'point processor {name}')
    return points
