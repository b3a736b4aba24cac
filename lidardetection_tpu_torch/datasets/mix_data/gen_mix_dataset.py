"""Mixed trees (copy of lidardetection_tpu/datasets/mix_data/
gen_mix_dataset.py): frames of a Livox tree (float64 x, y, z, intensity,
fine class names, the sensor 0.32 m higher) and of a fake-lidar tree
(float64 x, y, z) drawn in a 5 : 3 ratio into one ``training/
{pointcloud,label}`` tree that ``MixDataset`` reads, as x, y, z only.
"""

import os
import pickle
from pathlib import Path

import numpy as np

LIVOX_HEIGHT_OFFSET = 0.32
LIVOX_CAR_NAMES = ('car', 'police_car')
LIVOX_TRUCK_NAMES = ('bus', 'truck', 'Engineering_vehicles', 'trailer')


def get_lidar(file_path, dataset_idx):
    pts = np.fromfile(file_path)
    if dataset_idx == 0:  # livox: (N, 4) float, drop intensity, level height
        pts = pts.reshape(-1, 4)[:, :3].copy()
        pts[:, 2] -= LIVOX_HEIGHT_OFFSET
    else:  # fake lidar: (N, 3)
        pts = pts.reshape(-1, 3)
    return pts


def get_label(file_path, dataset_idx):
    with open(file_path, 'rb') as f:
        labels = pickle.load(f)
    if dataset_idx == 0:
        for label in labels:
            if label['name'] in LIVOX_CAR_NAMES:
                label['name'] = 'Car'
            elif label['name'] in LIVOX_TRUCK_NAMES:
                label['name'] = 'Truck'
            box = np.asarray(label['box3d_lidar'], np.float64)
            box[2] -= LIVOX_HEIGHT_OFFSET
            label['box3d_lidar'] = box
    return labels


def generate_mix_dataset(livox_path, fake_lidar_path, output_path, num_frames,
                         livox_percent=5, fake_lidar_percent=3, seed=0):
    livox_path, fake_lidar_path = Path(livox_path), Path(fake_lidar_path)
    output_path = Path(output_path)
    pools = [
        sorted(os.listdir(livox_path / 'training' / 'pointcloud')),
        sorted(os.listdir(fake_lidar_path / 'training' / 'pointcloud')),
    ]
    roots = [livox_path, fake_lidar_path]
    (output_path / 'training' / 'pointcloud').mkdir(parents=True,
                                                    exist_ok=True)
    (output_path / 'training' / 'label').mkdir(parents=True, exist_ok=True)

    rng = np.random.RandomState(seed)
    ids = []
    for frame_idx in range(num_frames):
        dataset_idx = 0 if rng.randint(
            0, livox_percent + fake_lidar_percent) < livox_percent else 1
        if not pools[dataset_idx]:  # pool exhausted: fall back to the other
            dataset_idx = 1 - dataset_idx
            if not pools[dataset_idx]:
                break
        pick = rng.randint(len(pools[dataset_idx]))
        frame_name = pools[dataset_idx].pop(pick)
        root = roots[dataset_idx]
        pts = get_lidar(root / 'training' / 'pointcloud' / frame_name,
                        dataset_idx)
        labels = get_label(
            root / 'training' / 'label' / frame_name.replace('bin', 'pkl'),
            dataset_idx)
        fid = f'{frame_idx:06d}'
        pts.tofile(output_path / 'training' / 'pointcloud' / f'{fid}.bin')
        with open(output_path / 'training' / 'label' / f'{fid}.pkl',
                  'wb') as f:
            pickle.dump(labels, f)
        ids.append(fid)
    return ids
