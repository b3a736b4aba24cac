"""World flips, rotation and scaling of boxes and points (copy of
lidardetection_tpu/datasets/augmentor/augmentor_utils.py), with the
velocity columns and the multiframe `locations` / `rotations_y` side
arrays. Each draws from the caller's `rng` (``np.random.RandomState``) the
call the JAX package makes on numpy's global generator, so
``RandomState(s)`` gives what ``np.random.seed(s)`` gives there.
"""

import numpy as np

from ...core.np_geometry import rotate_points_along_z


def _result(gt_boxes, points, locations, rotations_y):
    if locations is not None and rotations_y is not None:
        return gt_boxes, points, locations, rotations_y
    return gt_boxes, points


def random_flip_along_x(gt_boxes, points, rng, locations=None,
                        rotations_y=None):
    enable = rng.choice([False, True], replace=False, p=[0.5, 0.5])
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
        if locations is not None and rotations_y is not None:
            locations[:, :, 1] = -locations[:, :, 1]
            rotations_y = -rotations_y
    return _result(gt_boxes, points, locations, rotations_y)


def random_flip_along_y(gt_boxes, points, rng, locations=None,
                        rotations_y=None):
    enable = rng.choice([False, True], replace=False, p=[0.5, 0.5])
    if enable:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
        if locations is not None and rotations_y is not None:
            locations[:, :, 0] = -locations[:, :, 0]
            rotations_y = -(rotations_y + np.pi)
    return _result(gt_boxes, points, locations, rotations_y)


def global_rotation(gt_boxes, points, rot_range, rng, locations=None,
                    rotations_y=None):
    noise_rotation = rng.uniform(rot_range[0], rot_range[1])
    points = rotate_points_along_z(points[np.newaxis],
                                   np.array([noise_rotation]))[0]
    gt_boxes[:, 0:3] = rotate_points_along_z(
        gt_boxes[np.newaxis, :, 0:3], np.array([noise_rotation]))[0]
    gt_boxes[:, 6] += noise_rotation
    if gt_boxes.shape[1] > 7:  # velocity (vx, vy)
        vel = np.hstack([gt_boxes[:, 7:9], np.zeros((gt_boxes.shape[0], 1))])
        gt_boxes[:, 7:9] = rotate_points_along_z(
            vel[np.newaxis], np.array([noise_rotation]))[0][:, 0:2]
    if locations is not None and rotations_y is not None:
        n = locations.shape[0]
        locations = rotate_points_along_z(
            locations, np.array([noise_rotation] * n))
        rotations_y = rotations_y + noise_rotation
    return _result(gt_boxes, points, locations, rotations_y)


def global_scaling(gt_boxes, points, scale_range, rng, locations=None,
                   rotations_y=None):
    if scale_range[1] - scale_range[0] < 1e-3:
        return _result(gt_boxes, points, locations, rotations_y)
    noise_scale = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= noise_scale
    gt_boxes[:, :6] *= noise_scale
    if locations is not None and rotations_y is not None:
        locations = locations * noise_scale
    return _result(gt_boxes, points, locations, rotations_y)
