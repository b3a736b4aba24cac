"""Ground planes of blank highway scenes (copy of lidardetection_tpu/
datasets/plusai/fake_lidar_dataset/plane_estimation.py): a RANSAC fit of
z = a x + b y + d (random minimal triples, then least squares over the
best triple's inliers), the plane's pitch, and the rotation that levels a
scene.
"""

import math
import os
import pickle
from pathlib import Path

import numpy as np


def find_plane(points, residual_threshold=0.02, num_iters=200, seed=0):
    """RANSAC plane fit z = a x + b y + d (plane_estimation.py:11-20), the
    triples drawn from ``RandomState(seed)``. Returns (a, b, d)."""
    pts = np.asarray(points, np.float64)
    xy = np.c_[pts[:, :2], np.ones(len(pts))]
    z = pts[:, 2]
    rng = np.random.RandomState(seed)
    best_inliers, best = 0, None
    n = len(pts)
    for _ in range(num_iters):
        idx = rng.choice(n, 3, replace=False)
        A, zz = xy[idx], z[idx]
        try:
            coef = np.linalg.solve(A, zz)
        except np.linalg.LinAlgError:
            continue
        resid = np.abs(xy @ coef - z)
        inliers = int((resid < residual_threshold).sum())
        if inliers > best_inliers:
            best_inliers, best = inliers, resid < residual_threshold
    if best is None or best.sum() < 3:
        coef, *_ = np.linalg.lstsq(xy, z, rcond=None)
    else:
        coef, *_ = np.linalg.lstsq(xy[best], z[best], rcond=None)
    a, b, d = coef
    return float(a), float(b), float(d)


def angle_rotate(a, b, d):
    """The fitted plane's roll about x (plane_estimation.py:23-30)."""
    x = np.arange(30)
    y = np.arange(30)
    X, Y = np.meshgrid(x, y)
    Z = a * X + b * Y + d
    rad = math.atan2(Y[1][0] - Y[0][0], (Z[1][0] - Z[0][0]))
    return np.pi / 2 - rad


def get_angle_pitch(a, b, d):
    """The plane's pitch along x (plane_estimation.py:32-33)."""
    return -math.atan2(a, 1)


def pts_rotation_pitch(points, pitch_angle):
    """A cloud rotated about the y axis by `pitch_angle`
    (plane_estimation.py:62-70)."""
    c, s = np.cos(pitch_angle), np.sin(pitch_angle)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    out = np.array(points, np.float64, copy=True)
    out[:, :3] = out[:, :3] @ rot.T
    return out


def gen_rectified_plane(points, residual_threshold=0.02):
    """A scene levelled so that its ground plane is horizontal
    (plane_estimation.py:73-88)."""
    a, b, d = find_plane(points, residual_threshold)
    return pts_rotation_pitch(points, -get_angle_pitch(a, b, d))


def _load_txt_scene(path):
    return np.loadtxt(path, dtype=np.float64)


def estimate_ground_plane_batch(file_path):
    """The planes of every ``.txt`` blank scene in a folder, pickled as
    {scene name: (a, b, d)} into ``ground_plane_params.pkl`` there
    (plane_estimation.py:36-59)."""
    blank_scene_path = Path(file_path)
    params = {}
    for name in sorted(os.listdir(blank_scene_path)):
        if not name.endswith('.txt'):
            continue
        scene = _load_txt_scene(blank_scene_path / name)
        params[name] = find_plane(scene)
    with open(blank_scene_path / 'ground_plane_params.pkl', 'wb') as f:
        pickle.dump(params, f)
    return params
