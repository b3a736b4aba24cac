"""Synthetic LiDAR scenes (copy of lidardetection_tpu/datasets/synthetic.py
``make_scene`` and ``_beam_ground``): deterministic request clouds made
from a seed, for the server's CLI and the chip smoke run.
"""

import numpy as np

CLASS_SIZE = {
    'Car': (3.9, 1.6, 1.56),
    'Pedestrian': (0.8, 0.6, 1.73),
    'Cyclist': (1.76, 0.6, 1.73),
    'Truck': (6.4, 2.5, 3.5),
    'Tram': (11.2, 2.9, 4.0),
}
CLASS_Z = {'Car': -1.0, 'Pedestrian': -0.73, 'Cyclist': -0.73,
           'Truck': 0.0, 'Tram': 0.0}
_DEFAULT_SIZE, _DEFAULT_Z = (4.0, 1.8, 1.6), -1.0  # unknown class fallback


def _beam_ground(rng, point_cloud_range, num_ground):
    """Ground returns of a spinning lidar: concentric per-beam rings with
    range and height jitter, thinned by striding the azimuth order."""
    x1, y1, z1, x2, y2, z2 = (float(v) for v in point_cloud_range[:6])
    h = 1.73  # sensor height above ground
    elev = np.deg2rad(np.linspace(-24.9, -1.8, 64))  # beam elevations
    radii = h / np.tan(-elev)
    r_max = float(np.hypot(max(abs(x1), abs(x2)), max(abs(y1), abs(y2))))
    radii = radii[radii < r_max]
    dphi = np.deg2rad(0.2)  # sensor azimuth resolution
    phis = np.arange(-np.pi, np.pi, dphi)
    r = np.repeat(radii, len(phis))
    phi = np.tile(phis, len(radii))
    r = r * (1.0 + rng.randn(r.size) * 0.004)
    phi = phi + rng.randn(r.size) * (dphi * 0.1)
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    inside = (x > x1) & (x < x2) & (y > y1) & (y < y2)
    x, y = x[inside], y[inside]
    if x.size > num_ground:
        step = x.size / num_ground
        keep = (np.arange(num_ground) * step).astype(np.int64)
        x, y = x[keep], y[keep]
    z = np.full_like(x, -h) + rng.randn(x.size) * 0.03
    inten = rng.rand(x.size)
    return np.stack([x, y, z, inten], axis=1)


def make_scene(rng, point_cloud_range, num_objects=8, points_per_obj=120,
               num_ground=18000, class_names=('Car', 'Pedestrian', 'Cyclist')):
    """One scene: beam-ring ground returns + points on object box surfaces.

    Args:
        rng: np.random.RandomState.
    Returns (points (N, 4) float32, gt_boxes (M, 7) float32, gt_names (M,)).
    """
    x1, y1, z1, x2, y2, z2 = point_cloud_range
    gt_boxes, gt_names, obj_points = [], [], []
    for _ in range(num_objects):
        name = class_names[rng.randint(len(class_names))]
        dx, dy, dz = CLASS_SIZE.get(name, _DEFAULT_SIZE)
        diag = float(np.hypot(dx, dy))
        # rejection-sample a placement that overlaps no earlier box
        for _attempt in range(50):
            cx = rng.uniform(x1 + 5, x2 - 5)
            cy = rng.uniform(y1 + 5, y2 - 5)
            ok = all(
                np.hypot(cx - b[0], cy - b[1])
                > (diag + np.hypot(b[3], b[4])) / 2 + 0.5
                for b in gt_boxes)
            if ok:
                break
        else:
            continue  # crowded range: drop the object rather than overlap
        cz = CLASS_Z.get(name, _DEFAULT_Z)
        heading = rng.uniform(-np.pi, np.pi)
        sx = rng.uniform(0.9, 1.15)
        box = [cx, cy, cz, dx * sx, dy * sx, dz * sx, heading]
        gt_boxes.append(box)
        gt_names.append(name)
        # points on the two visible faces + top, in the local frame
        n = points_per_obj
        u = rng.rand(n)
        v = rng.rand(n)
        face = rng.randint(0, 3, n)
        lx = np.where(face == 0, (u - 0.5) * dx,
                      np.where(face == 1, -dx / 2, (u - 0.5) * dx))
        ly = np.where(face == 0, -dy / 2,
                      np.where(face == 1, (u - 0.5) * dy,
                               (rng.rand(n) - 0.5) * dy))
        lz = np.where(face == 2, dz / 2, (v - 0.5) * dz)
        ca, sa = np.cos(heading), np.sin(heading)
        px = lx * ca - ly * sa + cx
        py = lx * sa + ly * ca + cy
        pz = lz * sx + cz
        inten = rng.rand(n).astype(np.float32)
        obj_points.append(np.stack([px, py, pz, inten], axis=1))

    ground = _beam_ground(rng, point_cloud_range, num_ground)
    points = np.concatenate([ground] + obj_points, axis=0).astype(np.float32)
    return points, np.array(gt_boxes, np.float32), np.array(gt_names)
