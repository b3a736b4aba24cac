"""The per-sample processors (copy of lidardetection_tpu/datasets/
processor/data_processor.py): the range mask, near/far-aware sampling, the
shuffle and the fixed-capacity padding as functions, on host numpy, and
the ``DataProcessor`` chain of a config's DATA_PROCESSOR over them, which
voxelizes with ``ops/voxelize.py::voxelize_np``.

The JAX package's processors draw from numpy's global generator; these take
an ``np.random.RandomState`` that the caller owns. ``RandomState(s)`` draws
what ``np.random.seed(s)`` followed by the global calls draws, so the same
seed gives the same points bit for bit.

Two things of the JAX chain are left out. The TPU scatter's tile
histogram (``bev_tile_starts``) is a TPU workaround: the CUDA scatter
writes each row straight to its key. And the raw points are padded to
MAX_POINTS only where the model reads them (``config.raw_point_capacity``);
elsewhere a sample keeps its in-range points as they are.
"""

import warnings

import numpy as np

from ...config import grid_size_from_range

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


def pad_clouds(clouds, max_points=0):
    """points (B, M, C) float32, each cloud's first M points then zeros,
    and num_points (B,) int32: M is `max_points`, or the largest cloud's
    length where it is 0 (a config with no MAX_POINTS)."""
    m = max_points or max(len(c) for c in clouds)
    padded, num = zip(*(pad_points(np.asarray(c, np.float32), m)
                        for c in clouds))
    return np.stack(padded), np.asarray(num, np.int32)


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


class DataProcessor:
    """A config's DATA_PROCESSOR entries, chained in their order (JAX
    :16-137). ``forward(data_dict, rng)`` runs them on one sample; `rng`
    draws the shuffle and the sample. `max_points`, when given, pads the
    raw points to it and adds ``num_points`` (0: no padding, the count
    added all the same, and ``collate_batch`` pads a batch's clouds to its
    largest)."""

    def __init__(self, processor_configs, point_cloud_range, training,
                 max_points=None):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.mode = 'train' if training else 'test'
        self.grid_size = self.voxel_size = None
        self.max_points = max_points
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            cur_processor = getattr(self, cur_cfg['NAME'])(config=cur_cfg)
            self.data_processor_queue.append(cur_processor)

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None,
                                            rng=None):
        if data_dict is None:
            return lambda d, rng: self.mask_points_and_boxes_outside_range(
                d, config, rng)
        mask = mask_points_by_range(data_dict['points'], self.point_cloud_range)
        data_dict['points'] = data_dict['points'][mask]
        if data_dict.get('gt_boxes', None) is not None \
                and config.get('REMOVE_OUTSIDE_BOXES', False) and self.training:
            box_mask = mask_boxes_outside_range(
                data_dict['gt_boxes'], self.point_cloud_range, min_num_corners=1)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][box_mask]
            for key in ('gt_names', 'locations', 'rotations_y'):
                if key in data_dict and data_dict[key] is not None \
                        and len(data_dict[key]) == len(box_mask):
                    data_dict[key] = data_dict[key][box_mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return lambda d, rng: self.shuffle_points(d, config, rng)
        if config['SHUFFLE_ENABLED'][self.mode]:
            data_dict['points'] = shuffle_points(data_dict['points'], rng)
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            self.voxel_size = np.asarray(config['VOXEL_SIZE'], np.float32)
            self.grid_size = grid_size_from_range(
                self.point_cloud_range, self.voxel_size)
            self.max_points_per_voxel = config['MAX_POINTS_PER_VOXEL']
            self.max_voxels = config['MAX_NUMBER_OF_VOXELS'][self.mode]
            return lambda d, rng: self.transform_points_to_voxels(d, config, rng)
        from ...ops.voxelize import voxelize_np

        voxels, coords, npts, nv = voxelize_np(
            data_dict['points'], self.point_cloud_range, self.voxel_size,
            self.max_points_per_voxel, self.max_voxels)
        if nv >= self.max_voxels and not self.training:
            # the table keeps the first voxels in scan order (eval does not
            # shuffle): a spatially biased crop that can zero AP
            warnings.warn(
                f'MAX_NUMBER_OF_VOXELS[test]={self.max_voxels} saturated '
                f'(scene produced >= cap); eval truncation is spatially '
                f'biased and can zero AP — raise the cap', RuntimeWarning,
                stacklevel=2)
        data_dict['voxels'] = voxels
        data_dict['voxel_coords'] = coords
        data_dict['voxel_num_points'] = npts
        data_dict['num_voxels'] = np.int32(nv)
        return data_dict

    def sample_points(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return lambda d, rng: self.sample_points(d, config, rng)
        data_dict['points'] = sample_points(
            data_dict['points'], config['NUM_POINTS'][self.mode], rng)
        return data_dict

    def forward(self, data_dict, rng):
        for cur_processor in self.data_processor_queue:
            data_dict = cur_processor(data_dict, rng)
        points = np.asarray(data_dict['points'], np.float32)
        if self.max_points is None:
            data_dict['points'] = points
        else:
            data_dict['points'], data_dict['num_points'] = pad_points(
                points, self.max_points or len(points))
        return data_dict
