"""Synthetic dataset trees on disk, made from a seed: the KITTI layout that
``datasets/kitti/kitti_dataset.py`` reads and the NuScenes one that
``datasets/nuscenes/nuscenes_dataset.py`` reads, for the tests and the chip
smoke run (no dataset is in the repository).

A scan is a spinning lidar's: each beam at its elevation and each azimuth
step gives a return on the ground (the sensor 1.73 m above it) or on a
wall at a distance drawn per azimuth sector, with an intensity; the
returns inside an object's box are replaced by points on the box's
faces, fewer the farther the box. ``HDL64E`` (64 beams, 0.18 degrees:
~120k returns, ~19k of them in the KITTI camera's view and range) and
``HDL32E`` (32 beams, ~26k returns a sweep) are the two sensors.

``write_kitti_tree`` writes ``ImageSets/``, ``training/{velodyne, calib,
label_2, image_2, planes}`` (labels in the camera frame with a DontCare
line, a flat road plane, the images as black PNGs written with zlib);
``write_nuscenes_tree`` writes ``<version>/samples``, ``<version>/sweeps``
(5 columns: x, y, z, intensity, ring) and the infos that NuScenes' info
creation would write (``gt_boxes`` (G, 9) with velocities, one NaN among
them, ``gt_names``, ``num_lidar_pts``, the sweeps with their transforms
and time lags).
"""

import pickle
import struct
import zlib
from pathlib import Path

import numpy as np

from ..core import np_geometry as npg

SENSOR_HEIGHT = 1.73
HDL64E = {'elevation_deg': (-24.9, 2.0), 'beams': 64, 'azimuth_steps': 2000}
HDL32E = {'elevation_deg': (-30.67, 10.67), 'beams': 32, 'azimuth_steps': 820}
KITTI_IMAGE = (375, 1242)  # (height, width)
# KITTI-like camera: x_cam = -y_lidar, y_cam = -z_lidar, z_cam = x_lidar
KITTI_V2C = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]], np.float32)
KITTI_P2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                     [0, 0, 1, 0.003]], np.float32)
OBJECT_SIZE = {  # (dx, dy, dz)
    'Car': (3.9, 1.6, 1.56), 'Pedestrian': (0.8, 0.6, 1.73),
    'Cyclist': (1.76, 0.6, 1.73), 'car': (4.6, 1.95, 1.73),
    'truck': (6.9, 2.5, 2.8), 'pedestrian': (0.7, 0.7, 1.75),
    'barrier': (0.5, 2.5, 1.0), 'traffic_cone': (0.4, 0.4, 1.1),
    'bicycle': (1.7, 0.6, 1.3),
}


def lidar_scan(rng, sensor, boxes=np.zeros((0, 7)), points_per_box=6000.0):
    """One scan from a sensor at the origin, SENSOR_HEIGHT above the
    ground: (N, 5) float32, x, y, z, intensity and the beam index.
    The returns inside `boxes` (G, 7) are replaced by points just inside
    their faces, about `points_per_box` / distance of them."""
    lo, hi = np.deg2rad(sensor['elevation_deg'])
    elev = np.linspace(lo, hi, sensor['beams'])
    phi = np.linspace(-np.pi, np.pi, sensor['azimuth_steps'], endpoint=False)
    e, p = np.meshgrid(elev, phi, indexing='ij')
    beam = np.broadcast_to(np.arange(sensor['beams'])[:, None], e.shape)
    sectors = 36
    wall = rng.uniform(15.0, 90.0, sectors)[
        ((p + np.pi) / (2 * np.pi) * sectors).astype(int) % sectors]
    # horizontal distance to the ground or to the sector's wall
    ground = np.where(e < 0, SENSOR_HEIGHT / np.tan(-np.minimum(e, -1e-6)),
                      np.inf)
    d = np.minimum(ground, wall) * (1.0 + rng.randn(*e.shape) * 0.003)
    pts = np.stack([d * np.cos(p), d * np.sin(p), d * np.tan(e),
                    rng.rand(*e.shape), beam], -1).reshape(-1, 5)
    if len(boxes):
        pts = npg.remove_points_in_boxes(pts, np.asarray(boxes, np.float64))
        faces = [pts]
        for box in boxes:
            n = int(points_per_box / max(np.hypot(box[0], box[1]), 3.0))
            u, v, w = rng.rand(3, n)
            face = rng.randint(0, 3, n)
            dx, dy, dz = box[3:6] * 0.96  # just inside the faces
            lx = np.where(face == 1, -dx / 2, (u - 0.5) * dx)
            ly = np.where(face == 0, -dy / 2, np.where(face == 1, (u - 0.5) * dy,
                                                     (w - 0.5) * dy))
            lz = np.where(face == 2, dz / 2, (v - 0.5) * dz)
            ca, sa = np.cos(box[6]), np.sin(box[6])
            faces.append(np.stack([lx * ca - ly * sa + box[0],
                                   lx * sa + ly * ca + box[1], lz + box[2],
                                   rng.rand(n), rng.randint(0, sensor['beams'], n)],
                                  -1))
        pts = np.concatenate(faces)
    return pts.astype(np.float32)


def place_boxes(rng, names, x_range, y_range, in_view=None):
    """(G, 7) boxes of the classes `names` on the ground, apart from each
    other; `in_view(x, y)` rejects centres outside a field of view."""
    boxes = []
    for name in names:
        dx, dy, dz = OBJECT_SIZE[name]
        for _ in range(100):
            cx, cy = rng.uniform(*x_range), rng.uniform(*y_range)
            if in_view is not None and not in_view(cx, cy):
                continue
            if all(np.hypot(cx - b[0], cy - b[1]) > (np.hypot(dx, dy)
                                                     + np.hypot(b[3], b[4])) / 2 + 1.0
                   for b in boxes):
                break
        boxes.append([cx, cy, -SENSOR_HEIGHT + dz / 2, dx, dy, dz,
                      rng.uniform(-np.pi, np.pi)])
    return np.asarray(boxes, np.float64).reshape(-1, 7)


def write_png(path, height, width):
    """A black 8-bit grayscale PNG of the given size."""
    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))

    rows = b''.join(b'\x00' + bytes(width) for _ in range(height))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, 0,
                                             0, 0, 0))
                + chunk(b'IDAT', zlib.compress(rows, 9)) + chunk(b'IEND', b''))


class _Calib:
    """The tree's lidar -> rect -> image projections (R0 the identity)."""

    def lidar_to_rect(self, pts):
        return np.hstack([pts, np.ones((len(pts), 1))]) @ KITTI_V2C.T

    def rect_to_img(self, pts):
        hom = np.hstack([pts, np.ones((len(pts), 1))]) @ KITTI_P2.T
        return hom[:, 0:2] / hom[:, 2:3], hom[:, 2] - KITTI_P2.T[3, 2]


def kitti_label_line(name, box, calib):
    """A label line of a lidar box: its camera-frame bottom centre, (h, w,
    l), rotation_y and the image box of its corners, cut to the image."""
    cam = npg.boxes3d_lidar_to_kitti_camera(box[None], calib)[0]
    img = npg.boxes3d_kitti_camera_to_imageboxes(cam[None], calib,
                                                 image_shape=KITTI_IMAGE)[0]
    alpha = -np.arctan2(-box[1], box[0]) + cam[6]
    x, y, z = cam[0:3]
    l, h, w = cam[3:6]
    return (f'{name} 0.00 0 {alpha:.2f} {img[0]:.2f} {img[1]:.2f} {img[2]:.2f} '
            f'{img[3]:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} '
            f'{cam[6]:.2f}')


def write_kitti_tree(root, num_train, num_val, seed=0, sensor=HDL64E,
                     objects=('Car', 'Car', 'Car', 'Car', 'Pedestrian',
                              'Pedestrian', 'Cyclist')):
    """A KITTI tree at `root`: frames 0 .. num_train - 1 in the train
    split, the next `num_val` in val, an empty test split; each frame a
    `sensor` scan with `objects` in the camera's view, 5-60 m ahead."""
    root = Path(root)
    (root / 'ImageSets').mkdir(parents=True, exist_ok=True)
    ids = [f'{i:06d}' for i in range(num_train + num_val)]
    for split, split_ids in (('train', ids[:num_train]),
                             ('val', ids[num_train:]), ('test', [])):
        (root / 'ImageSets' / f'{split}.txt').write_text('\n'.join(split_ids))
    base = root / 'training'
    for sub in ('velodyne', 'calib', 'label_2', 'image_2', 'planes'):
        (base / sub).mkdir(parents=True, exist_ok=True)
    identity = np.eye(3, dtype=np.float32)
    calib_txt = '\n'.join(
        [f'P{i}: ' + ' '.join('%.6e' % v for v in KITTI_P2.flatten())
         for i in range(4)]
        + ['R0_rect: ' + ' '.join('%.6e' % v for v in identity.flatten()),
           'Tr_velo_to_cam: ' + ' '.join('%.6e' % v for v in KITTI_V2C.flatten()),
           'Tr_imu_to_velo: ' + ' '.join('%.6e' % v for v in KITTI_V2C.flatten())])
    calib = _Calib()

    def in_view(x, y):
        return abs(y) < 0.75 * x

    for k, fid in enumerate(ids):
        rng = np.random.RandomState(seed * 1000 + k)
        boxes = place_boxes(rng, objects, (5.0, 60.0), (-30.0, 30.0), in_view)
        lidar_scan(rng, sensor, boxes)[:, :4].tofile(base / 'velodyne' / f'{fid}.bin')
        (base / 'calib' / f'{fid}.txt').write_text(calib_txt)
        lines = [kitti_label_line(n, b, calib) for n, b in zip(objects, boxes)]
        lines.append('DontCare -1 -1 -10 500.00 160.00 520.00 170.00 -1 -1 -1 '
                     '-1000 -1000 -1000 -10')
        (base / 'label_2' / f'{fid}.txt').write_text('\n'.join(lines) + '\n')
        write_png(base / 'image_2' / f'{fid}.png', *KITTI_IMAGE)
        (base / 'planes' / f'{fid}.txt').write_text(
            f'# Plane\nWidth 4\nHeight 1\n0 -1 0 {SENSOR_HEIGHT}\n')
    return ids


def write_nuscenes_tree(root, num_train, num_val, sweeps=9, seed=0,
                        version='v1.0-trainval', max_sweeps=10, sensor=HDL32E,
                        objects=('car', 'car', 'car', 'truck', 'pedestrian',
                                 'pedestrian', 'barrier', 'traffic_cone',
                                 'bicycle')):
    """A NuScenes tree at `root`/`version`: `num_train` + `num_val` key
    frames, each with `sweeps` earlier sweeps (the ego moving 0.5 m a sweep
    along x, 0.05 s apart), and ``nuscenes_infos_<max_sweeps>sweeps_
    {train,val}.pkl``. Returns the version's directory."""
    base = Path(root) / version
    for sub in ('samples/LIDAR_TOP', 'sweeps/LIDAR_TOP'):
        (base / sub).mkdir(parents=True, exist_ok=True)
    infos = []
    for k in range(num_train + num_val):
        rng = np.random.RandomState(seed * 1000 + k)
        boxes = place_boxes(rng, objects, (-45.0, 45.0), (-45.0, 45.0))
        vel = rng.randn(len(boxes), 2) * 2.0
        vel[-1] = np.nan  # a box with no velocity annotation
        key = f'samples/LIDAR_TOP/frame{k:04d}.bin'
        scan = lidar_scan(rng, sensor, boxes)
        scan.tofile(base / key)
        inside = npg.points_in_boxes(scan[:, :3].astype(np.float64), boxes)
        sweep_infos = []
        for s in range(1, sweeps + 1):
            path = f'sweeps/LIDAR_TOP/frame{k:04d}_sweep{s}.bin'
            moved = boxes.copy()
            moved[:, 0] += 0.5 * s  # the ego 0.5 m further back a sweep
            lidar_scan(rng, sensor, moved).tofile(base / path)
            transform = np.eye(4)
            transform[0, 3] = -0.5 * s
            sweep_infos.append({'lidar_path': path, 'transform_matrix': transform,
                                'time_lag': 0.05 * s})
        infos.append({
            'lidar_path': key, 'token': f'token{k:04d}', 'sweeps': sweep_infos,
            'gt_boxes': np.concatenate([boxes, vel], axis=1),
            'gt_names': np.array(objects),
            'num_lidar_pts': inside.sum(axis=0).astype(np.int64)})
    for split, part in (('train', infos[:num_train]), ('val', infos[num_train:])):
        with open(base / f'nuscenes_infos_{max_sweeps}sweeps_{split}.pkl', 'wb') as f:
            pickle.dump(part, f)
    return base
