"""The object database of a Livox-layout tree (copy of lidardetection_tpu/
datasets/plusai/fake_lidar_dataset/gen_gt_database.py): every labelled
object's points, box-centred, as ``gt_database/<id>_<name>_<i>.bin``
(float64 x, y, z) and ``plusai_gt_dbinfos.pkl``, the input of
``gen_fake_lidar.sample_groundtruth_objects``.
"""

import pickle
from pathlib import Path

import numpy as np

from ....core.np_geometry import points_in_boxes


def get_lidar(file_path, num_feats=3):
    return np.fromfile(file_path, dtype=np.float64).reshape(-1, num_feats)


def create_groundtruth_database(root_path, used_classes=None, split='train',
                                num_feats=3):
    """One ``.bin`` an object of the split's frames
    (gen_gt_database.py:361-430); returns the db infos by class."""
    root = Path(root_path)
    db_dir = root / 'gt_database'
    db_dir.mkdir(parents=True, exist_ok=True)
    ids = (root / 'ImageSets' / f'{split}.txt').read_text().splitlines()

    db_infos = {}
    for fid in ids:
        pts = get_lidar(root / 'pointcloud' / f'{fid}.bin', num_feats)
        with open(root / 'label' / f'{fid}.pkl', 'rb') as f:
            labels = pickle.load(f)
        if not labels:
            continue
        boxes = np.stack([np.asarray(o['box3d_lidar'], np.float64)
                          for o in labels])
        inside = points_in_boxes(pts[:, :3], boxes[:, :7])  # (N, M)
        for i, obj in enumerate(labels):
            name = obj['name']
            if used_classes is not None and name not in used_classes:
                continue
            gt_pts = pts[inside[:, i]].copy()
            gt_pts[:, :3] -= boxes[i, :3]
            filename = f'{fid}_{name}_{i}.bin'
            gt_pts.astype(np.float64).tofile(db_dir / filename)
            db_infos.setdefault(name, []).append({
                'name': name,
                'path': str(Path('gt_database') / filename),
                'image_idx': fid,
                'gt_idx': i,
                'box3d_lidar': boxes[i],
                'num_points_in_gt': int(inside[:, i].sum()),
            })
    with open(root / 'plusai_gt_dbinfos.pkl', 'wb') as f:
        pickle.dump(db_infos, f)
    return db_infos
