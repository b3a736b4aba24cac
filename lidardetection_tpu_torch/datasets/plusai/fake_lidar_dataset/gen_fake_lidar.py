"""Fake-lidar scenes from an object database (copy of lidardetection_tpu/
datasets/plusai/fake_lidar_dataset/gen_fake_lidar.py): database objects
pasted into blank highway scenes, each box set on the scene's RANSAC
ground plane, overlaps rejected by rotated BEV IoU, written as
``pointcloud/<id>.bin`` (float64 x, y, z) and ``label/<id>.pkl`` in the
Livox / Mix layout.
"""

import pickle
from pathlib import Path

import numpy as np

from ....core.np_geometry import boxes_bev_iou_cpu, remove_points_in_boxes
from .plane_estimation import _load_txt_scene, find_plane

# Car : Truck : Tram sampling shares (gen_fake_lidar.py:31-40)
CATEGORY_DIST = {'Car': 50, 'Truck': 35, 'Tram': 15}


def get_lidar(file_path, num_feats=3):
    pts = np.fromfile(file_path, dtype=np.float64)
    return pts.reshape(-1, num_feats)


def sample_groundtruth_objects(gt_dbinfos, scene, ground_plane_params,
                               num_sample_objects, object_range, root_path,
                               rng):
    """`num_sample_objects` draws from `rng` of database objects, filtered
    by points, range and size, overlaps rejected, each set on the ground,
    pasted into `scene` (gen_fake_lidar.py:20-103). Returns (scene points,
    the sampled objects)."""
    cats = [c for c in CATEGORY_DIST if gt_dbinfos.get(c)]
    weights = np.array([CATEGORY_DIST[c] for c in cats], np.float64)
    weights /= weights.sum()

    sampled_objects, sampled_boxes, object_pts = [], [], []
    for _ in range(num_sample_objects):
        category = cats[rng.choice(len(cats), p=weights)]
        obj = dict(gt_dbinfos[category][rng.randint(len(gt_dbinfos[category]))])
        box = np.array(obj['box3d_lidar'], np.float64, copy=True)

        if obj.get('num_points_in_gt', 1 << 30) < 10:
            continue
        if not (object_range[0] < box[0] < object_range[3]
                and object_range[1] < box[1] < object_range[4]
                and object_range[2] < box[2] < object_range[5]):
            continue
        # size filter (gen_fake_lidar.py:57-61)
        if box[3] <= 3.5 or not (1.5 < box[4] < 5.0) or not (1.0 < box[5] < 6.0):
            continue
        if sampled_boxes:
            enlarged = box.copy()
            enlarged[3] += 1.0
            enlarged[4] += 0.5
            prev = np.stack(sampled_boxes)
            iou = boxes_bev_iou_cpu(prev[:, :7], enlarged[None, :7])
            if iou.sum() > 0:
                continue
        a, b, d = ground_plane_params
        ground = float(np.clip(a * box[0] + b * box[1] + d, -0.6, 0.6))
        box[2] = ground + box[5] / 2
        obj['box3d_lidar'] = box
        sampled_boxes.append(box)
        sampled_objects.append(obj)

        pts = get_lidar(Path(root_path) / obj['path']).copy()
        pts[:, :3] += box[:3]
        object_pts.append(pts)

    if not object_pts:
        return scene, []
    boxes_np = np.stack(sampled_boxes)
    enlarged = boxes_np.copy()
    enlarged[:, 3] += 0.05
    enlarged[:, 4] += 0.05
    enlarged[:, 5] *= 2
    scene = remove_points_in_boxes(scene[:, :3], enlarged[:, :7])
    return np.concatenate([scene, np.concatenate(object_pts)[:, :3]]), \
        sampled_objects


def generate_fake_lidar(num_frames, num_objects_per_frame, object_range=None,
                        gt_data_path=None, blank_scene_path=None,
                        output_path=None, seed=0):
    """`num_frames` fake scenes under `output_path`, every draw from
    ``RandomState(seed)`` (gen_fake_lidar.py:105-198); returns their ids
    (all in ``ImageSets/train.txt``)."""
    object_range = object_range or (0, -20, -3, 150, 20, 3)
    blank_scene_path = Path(blank_scene_path)
    scenes = sorted(p for p in blank_scene_path.iterdir()
                    if p.suffix == '.txt')
    with open(blank_scene_path / 'ground_plane_params.pkl', 'rb') as f:
        plane_params = pickle.load(f)
    with open(Path(gt_data_path) / 'plusai_gt_dbinfos.pkl', 'rb') as f:
        gt_dbinfos = pickle.load(f)

    out = Path(output_path)
    (out / 'pointcloud').mkdir(parents=True, exist_ok=True)
    (out / 'label').mkdir(parents=True, exist_ok=True)
    (out / 'ImageSets').mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = []
    for idx in range(num_frames):
        scene_file = scenes[rng.randint(len(scenes))]
        scene = _load_txt_scene(scene_file)
        params = plane_params.get(scene_file.name) or find_plane(scene)
        scene_pts, objs = sample_groundtruth_objects(
            gt_dbinfos, scene, params, num_objects_per_frame, object_range,
            gt_data_path, rng)
        fid = f'{idx:06d}'
        scene_pts.astype(np.float64).tofile(out / 'pointcloud' / f'{fid}.bin')
        labels = [{'name': o['name'], 'box3d_lidar': o['box3d_lidar'],
                   'num_points_in_gt': o.get('num_points_in_gt', 0)}
                  for o in objs]
        with open(out / 'label' / f'{fid}.pkl', 'wb') as f:
            pickle.dump(labels, f)
        ids.append(fid)
    with open(out / 'ImageSets' / 'train.txt', 'w') as f:
        f.write('\n'.join(ids))
    return ids
