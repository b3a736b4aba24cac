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

The fork's trees are highway scenes ahead of a moving truck, the ground
0.5 m below the lidar frame's origin, at the configs' ranges: a sensor
may see a sector only (``azimuth_deg``), stand higher (``height``) and
have its walls farther (``wall_m``).
``write_plusai_tree`` writes single frames with odometry and uuid-keyed
obstacles (``mot_dataset/<scene>``) and stacks them into the multiframe
tree with the port's ``gen_mot_dataset`` (``PLUSAI``: 3 x ~50k returns a
sample in [2, 162] x [-16, 16] m); ``write_livox_tree`` a Livox tree
(``LIVOX``: 64k returns a frame in [0, 152] x [-16, 16] m, fine class
names); ``write_mix_tree`` a Livox tree and a fake-lidar tree (blank
scenes, their ground planes, an object database, ``generate_fake_lidar``)
mixed by the port's ``generate_mix_dataset``. Each writes the split lists
the loaders read; the infos come from ``create_plusai_infos`` and
``create_livox_infos``.
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
    'bicycle': (1.7, 0.6, 1.3), 'Truck': (10.7, 2.75, 3.8),
    'bus': (11.0, 2.9, 3.2), 'police_car': (4.9, 1.9, 1.6),
}
# the fork's sensors: forward sectors of long-range lidars on a truck
PLUSAI = {'elevation_deg': (-14.0, 2.0), 'beams': 64, 'azimuth_steps': 800,
          'azimuth_deg': (-60.0, 60.0), 'height': 2.5, 'wall_m': (60.0, 170.0)}
LIVOX = {'elevation_deg': (-12.5, 12.5), 'beams': 64, 'azimuth_steps': 1000,
         'azimuth_deg': (-41.0, 41.0), 'height': 2.0, 'wall_m': (40.0, 160.0)}
FORK_GROUND = -0.5  # the ground's z in the fork's lidar frames
HIGHWAY_X, HIGHWAY_Y = (8.0, 145.0), (-10.0, 10.0)  # where boxes are placed
EGO_SPEED = 25.0  # m/s, the PlusAI truck's


def lidar_scan(rng, sensor, boxes=np.zeros((0, 7)), points_per_box=6000.0):
    """One scan from a sensor at the origin, SENSOR_HEIGHT (or the
    sensor's ``height``) above the ground: (N, 5) float32, x, y, z,
    intensity and the beam index.
    The returns inside `boxes` (G, 7) are replaced by points just inside
    their faces, about `points_per_box` / distance of them."""
    lo, hi = np.deg2rad(sensor['elevation_deg'])
    elev = np.linspace(lo, hi, sensor['beams'])
    if 'azimuth_deg' in sensor:
        a_lo, a_hi = np.deg2rad(sensor['azimuth_deg'])
        phi = np.linspace(a_lo, a_hi, sensor['azimuth_steps'])
    else:
        phi = np.linspace(-np.pi, np.pi, sensor['azimuth_steps'],
                          endpoint=False)
    e, p = np.meshgrid(elev, phi, indexing='ij')
    beam = np.broadcast_to(np.arange(sensor['beams'])[:, None], e.shape)
    sectors = 36
    wall = rng.uniform(*sensor.get('wall_m', (15.0, 90.0)), sectors)[
        ((p + np.pi) / (2 * np.pi) * sectors).astype(int) % sectors]
    # horizontal distance to the ground or to the sector's wall
    height = sensor.get('height', SENSOR_HEIGHT)
    ground = np.where(e < 0, height / np.tan(-np.minimum(e, -1e-6)),
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


def place_boxes(rng, names, x_range, y_range, in_view=None,
                ground=-SENSOR_HEIGHT, heading=None):
    """(G, 7) boxes of the classes `names` on the ground (at z `ground`),
    apart from each other; `in_view(x, y)` rejects centres outside a field
    of view; headings uniform, or drawn by `heading(rng)`."""
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
        boxes.append([cx, cy, ground + dz / 2, dx, dy, dz,
                      rng.uniform(-np.pi, np.pi) if heading is None
                      else heading(rng)])
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


def _highway_heading(rng):
    return rng.normal(0.0, 0.05)  # along the road


def fork_scan(rng, sensor, boxes=np.zeros((0, 7))):
    """A fork sensor's scan with the ground at FORK_GROUND: (N, 4) float32
    x, y, z, intensity; `boxes` (G, 7) in the same frame."""
    lift = sensor['height'] + FORK_GROUND
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7).copy()
    boxes[:, 2] -= lift
    scan = lidar_scan(rng, sensor, boxes)[:, :4]
    scan[:, 2] += lift
    return scan


def write_split_lists(root, ids, num_val):
    """``ImageSets/{train,val}.txt`` under `root`: the last `num_val` of
    `ids` in val, the others in train."""
    root = Path(root)
    (root / 'ImageSets').mkdir(parents=True, exist_ok=True)
    cut = len(ids) - num_val
    for split, part in (('train', ids[:cut]), ('val', ids[cut:])):
        (root / 'ImageSets' / f'{split}.txt').write_text('\n'.join(part))


def write_plusai_tree(root, num_scenes, frames_per_scene, seed=0,
                      sensor=PLUSAI, objects=('Car',) * 6 + ('Truck',) * 3):
    """A PlusAI multiframe tree under `root`: per scene, `frames_per_scene`
    single frames 0.1 s apart (``mot_dataset/<scene>/pointcloud/*.bin``,
    float32 x, y, z, intensity in the truck's frame; ``label/*.pkl`` with
    the timestamp, the odometry pose and the uuid-keyed obstacle list) of
    a truck driving at EGO_SPEED along x among `objects` moving along
    the road, stacked three at a time by ``gen_mot_dataset.
    prepare_multiframe_dataset`` into ``multiframe/<scene>``; the last
    scene in val. Returns the multiframe tree's root."""
    from .plusai.mot_dataset.gen_mot_dataset import prepare_multiframe_dataset

    root = Path(root)
    dt = 0.1
    scenes = [f'scene_{s:03d}' for s in range(num_scenes)]
    for s, scene in enumerate(scenes):
        rng = np.random.RandomState(seed * 1000 + s)
        base = root / 'mot_dataset' / scene
        (base / 'pointcloud').mkdir(parents=True, exist_ok=True)
        (base / 'label').mkdir(parents=True, exist_ok=True)
        start = place_boxes(rng, objects, HIGHWAY_X, HIGHWAY_Y,
                            ground=FORK_GROUND, heading=_highway_heading)
        speed = rng.uniform(15.0, 30.0, len(start))
        for i in range(frames_per_scene):
            ego = EGO_SPEED * dt * i
            boxes = start.copy()  # in the frame of the truck at frame i
            boxes[:, 0] += speed * np.cos(start[:, 6]) * dt * i - ego
            boxes[:, 1] += speed * np.sin(start[:, 6]) * dt * i
            fork_scan(rng, sensor, boxes).tofile(
                base / 'pointcloud' / f'{i:06d}.bin')
            obstacles = [{
                'uuid': f'{scene}-{k}',
                'position': {'x': b[0], 'y': b[1], 'z': b[2]},
                'direction': {'x': np.cos(b[6]), 'y': np.sin(b[6])},
                'velocity': {'x': v * np.cos(b[6]) - EGO_SPEED,
                             'y': v * np.sin(b[6]), 'z': 0.0},
                'size': [b[3], b[4], b[5]], 'is_front_car': False,
            } for k, (b, v) in enumerate(zip(boxes, speed))]
            with open(base / 'label' / f'{i:06d}.pkl', 'wb') as f:
                pickle.dump({'timestamp': 1000.0 + dt * i,
                             'trans': np.array([ego, 0.0, 0.0]),
                             'quat': np.array([0.0, 0.0, 0.0, 1.0]),
                             'bag_name': scene, 'frame_index': i,
                             'obstacle_list': obstacles}, f)
    prepare_multiframe_dataset(root)
    multiframe = root / 'multiframe'
    ids = {scene: [f'{scene}/pointcloud/{p.name}' for p in
                   sorted((multiframe / scene / 'pointcloud').iterdir())]
           for scene in scenes}
    write_split_lists(multiframe, [i for s in scenes for i in ids[s]],
                      len(ids[scenes[-1]]))
    return multiframe


def write_livox_tree(root, num_frames, num_val, seed=0, sensor=LIVOX,
                     objects=('car', 'car', 'police_car', 'car', 'truck',
                              'bus', 'car', 'truck'), columns=4):
    """A Livox tree at `root`: ``pointcloud/<id>.bin`` (float64, x, y, z,
    intensity; x, y, z with `columns` 3), ``label/<id>.pkl`` (the fine
    class names, ``box3d_lidar``) and the split lists, the last `num_val`
    frames in val. Returns the ids."""
    root = Path(root)
    (root / 'pointcloud').mkdir(parents=True, exist_ok=True)
    (root / 'label').mkdir(parents=True, exist_ok=True)
    ids = [f'{i:06d}' for i in range(num_frames)]
    for k, fid in enumerate(ids):
        rng = np.random.RandomState(seed * 1000 + k)
        boxes = place_boxes(rng, objects, HIGHWAY_X, HIGHWAY_Y,
                            ground=FORK_GROUND, heading=_highway_heading)
        scan = fork_scan(rng, sensor, boxes)
        scan[:, :columns].astype(np.float64).tofile(
            root / 'pointcloud' / f'{fid}.bin')
        with open(root / 'label' / f'{fid}.pkl', 'wb') as f:
            pickle.dump([{'name': n, 'box3d_lidar': b}
                         for n, b in zip(objects, boxes)], f)
    write_split_lists(root, ids, num_val)
    return ids


def write_mix_tree(root, num_frames, num_val, seed=0):
    """A Mix tree under `root`, the fork's pipeline end to end with the
    port's generators: a Livox tree (``root/livox/training``); a labelled
    highway tree of x, y, z clouds with Car and Truck names
    (``root/objects``) and its object database (``gen_gt_database``);
    two object-free scans as ``.txt`` with their ground planes
    (``estimate_ground_plane_batch``); a fake-lidar tree from them
    (``generate_fake_lidar``, ``root/fake/training``); the two mixed into
    ``root/mix/training`` (``generate_mix_dataset``), whose last `num_val`
    frames are the val split. Returns the mixed tree's root (a config's
    DATA_PATH)."""
    from .mix_data.gen_mix_dataset import generate_mix_dataset
    from .plusai.fake_lidar_dataset import (
        create_groundtruth_database, estimate_ground_plane_batch,
        generate_fake_lidar,
    )

    root = Path(root)
    write_livox_tree(root / 'livox' / 'training', num_frames, 0, seed=seed)
    objects = ('Car', 'Car', 'Car', 'Truck', 'Truck')
    write_livox_tree(root / 'objects', 4, 0, seed=seed + 1, objects=objects,
                     columns=3)
    create_groundtruth_database(root / 'objects')
    blank = root / 'blank'
    blank.mkdir(parents=True, exist_ok=True)
    for k in range(2):
        rng = np.random.RandomState(seed * 1000 + 500 + k)
        np.savetxt(blank / f'scene{k}.txt',
                   fork_scan(rng, LIVOX)[:, :3].astype(np.float64), fmt='%.4f')
    estimate_ground_plane_batch(blank)
    generate_fake_lidar(num_frames, len(objects) + 2,
                        gt_data_path=root / 'objects', blank_scene_path=blank,
                        output_path=root / 'fake' / 'training', seed=seed)
    mix = root / 'mix' / 'training'
    ids = generate_mix_dataset(root / 'livox', root / 'fake', root / 'mix',
                               num_frames, seed=seed)
    write_split_lists(mix, ids, num_val)
    return mix
