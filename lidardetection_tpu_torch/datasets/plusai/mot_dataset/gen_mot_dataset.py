"""Multiframe (MOT) trees from single frames (copy of lidardetection_tpu/
datasets/plusai/mot_dataset/gen_mot_dataset.py): from a per-scene
``mot_dataset/<scene>/{pointcloud,label}`` tree of single frames (each
label with its timestamp, odometry pose and uuid-keyed obstacles), the
``multiframe/<scene>`` tree: each sample stacks STACK_FRAME_SIZE
consecutive clouds in the base frame's coordinates (with a frame-index
column) and follows each obstacle across the frames by uuid, a missing
observation filled by interpolation or a constant velocity. The labels are
the ``obstacles`` lists of frames that ``PlusAIMultiframeDataset`` reads.

The bag front end of the JAX package's source (``process_single_bag``)
needs rosbag and is not carried (``plusai_bag_dataset.py``). The obstacles
are kept by their observation at the stack's own base frame: the JAX
package's ``process_obstacles`` reads frame 1 whatever the stack, so its
``gen_single_frame_dataset`` (a stack of one) raises IndexError.
"""

import logging
import math
import os
import pickle
from pathlib import Path

import numpy as np

from ....utils.common import transform_mtx

STACK_FRAME_SIZE = 3
BASE_FRAME_INDEX = 1
MAX_TIME_STEP = 0.15
FRAME_DT = 0.1  # 100 ms lidar period (gen_mot_dataset.py:134,138)

logger = logging.getLogger(__name__)


def get_obstacle_class(obstacle):
    """Length-based Car/Truck split (gen_mot_dataset.py:152-159)."""
    return 'Car' if obstacle['size'][0] < 6.0 else 'Truck'


def is_stack_frame_valid(stack_labels):
    """Consecutive-timestamp check (gen_mot_dataset.py:171-176)."""
    for a, b in zip(stack_labels[:-1], stack_labels[1:]):
        if abs(float(a['timestamp']) - float(b['timestamp'])) > MAX_TIME_STEP:
            return False
    return True


def process_obstacles(obstacles_dict, base_frame_index=BASE_FRAME_INDEX):
    """uuid dict -> list of per-frame tracks, gap-filled
    (gen_mot_dataset.py:107-150): interpolate when bracketed by
    observations, extrapolate with constant velocity otherwise; drop tracks
    unobserved at the base frame or unfixable."""

    def process_single_instance(obstacle):
        window = len(obstacle)
        left = 0
        for i in range(window):
            if obstacle[i]:
                left = i
                continue
            right = i + 1
            while right < window - 1 and not obstacle[right]:
                right += 1
            has_l = bool(obstacle[left])
            has_r = right < window and bool(obstacle[right])
            if has_l and has_r:
                ratio = (right - i) / float(right - left)
                obstacle[i].update(obstacle[left])
                obstacle[i]['location'] = (
                    obstacle[left]['location'] * ratio
                    + obstacle[right]['location'] * (1.0 - ratio))
                obstacle[i]['velocity'] = (
                    obstacle[left]['velocity'] * ratio
                    + obstacle[right]['velocity'] * (1.0 - ratio))
                obstacle[i]['heading'] = (
                    obstacle[left]['heading'] * ratio
                    + obstacle[right]['heading'] * (1.0 - ratio))
            elif has_l and obstacle[left]['velocity'][0] > -20.0:
                obstacle[i].update(obstacle[left])
                obstacle[i]['location'] = (
                    obstacle[left]['location']
                    + obstacle[left]['velocity'] * FRAME_DT * (i - left))
            elif has_r and obstacle[right]['velocity'][0] > -20.0:
                obstacle[i].update(obstacle[right])
                obstacle[i]['location'] = (
                    obstacle[right]['location']
                    + obstacle[right]['velocity'] * FRAME_DT * (i - right))
            else:
                return False
            left = i
        return True

    out = []
    for obs in obstacles_dict.values():
        if not obs[base_frame_index]:
            continue
        if process_single_instance(obs):
            out.append(obs)
    return out


def _read_frame(data_path, scene, frame_name):
    label_file = Path(data_path) / 'mot_dataset' / scene / 'label' / \
        f'{frame_name}.pkl'
    with open(label_file, 'rb') as f:
        annos = pickle.load(f)
    pcd_file = Path(data_path) / 'mot_dataset' / scene / 'pointcloud' / \
        f'{frame_name}.bin'
    cloud = np.fromfile(pcd_file, dtype=np.float32).reshape(-1, 4)
    return annos, cloud


def prepare_multiframe_scenes(scene_list, data_path,
                              stack_frame_size=STACK_FRAME_SIZE,
                              base_frame_index=BASE_FRAME_INDEX):
    """Stack frames + track obstacles per scene
    (gen_mot_dataset.py:178-272)."""
    for scene in scene_list:
        out_lidar = Path(data_path) / 'multiframe' / scene / 'pointcloud'
        out_label = Path(data_path) / 'multiframe' / scene / 'label'
        out_lidar.mkdir(parents=True, exist_ok=True)
        out_label.mkdir(parents=True, exist_ok=True)
        files = sorted(os.listdir(
            Path(data_path) / 'mot_dataset' / scene / 'label'))
        frame_idx = 0
        for i0 in range(0, len(files) - stack_frame_size + 1):
            stack_labels, stack_pcds, poses = [], [], []
            for i2 in range(stack_frame_size):
                name = files[i0 + i2][:-4]
                annos, cloud = _read_frame(data_path, scene, name)
                stack_labels.append(annos)
                poses.append(transform_mtx(np.asarray(annos['trans']),
                                           np.asarray(annos['quat'])))
                cloud = np.c_[cloud, np.full(len(cloud), i2, np.float32)]
                stack_pcds.append(cloud)
            if not is_stack_frame_valid(stack_labels):
                logger.info('skipping discontinuous stack at %s in %s',
                            stack_labels[base_frame_index]['timestamp'],
                            scene)
                continue

            base = stack_labels[base_frame_index]
            final = {k: base[k] for k in
                     ('timestamp', 'trans', 'quat', 'bag_name', 'frame_index')
                     if k in base}
            obstacles = {}
            base_inv = np.linalg.inv(poses[base_frame_index])
            for i in range(stack_frame_size):
                delta = base_inv @ poses[i]
                stack_pcds[i][:, :3] = \
                    (delta[:3, :3] @ stack_pcds[i][:, :3].T + delta[:3, 3:]).T
                for obs in stack_labels[i]['obstacle_list']:
                    pos = obs['position']
                    direc = obs['direction']
                    if None in (pos['x'], pos['y'], pos['z']) or \
                            None in (direc['x'], direc['y']):
                        logger.info('obs %s has invalid pose, skipped',
                                    obs['uuid'])
                        continue
                    vel = obs['velocity']
                    if None in (vel['x'], vel['y'], vel['z']):
                        velocity = np.array([-100.0, 0.0, 0.0])
                    else:
                        velocity = delta[:3, :3] @ np.array(
                            [vel['x'], vel['y'], vel['z']])
                    uuid = obs['uuid']
                    if uuid not in obstacles:
                        obstacles[uuid] = [{} for _ in range(stack_frame_size)]
                    location = delta[:3, :3] @ np.array(
                        [pos['x'], pos['y'], pos['z']]) + delta[:3, 3]
                    obstacles[uuid][i] = {
                        'class': get_obstacle_class(obs),
                        'size': obs['size'],
                        'is_front_car': obs.get('is_front_car', False),
                        'location': location,
                        'heading': math.atan2(direc['y'], direc['x']),
                        'velocity': velocity,
                    }
            final['obstacles'] = process_obstacles(obstacles,
                                                   base_frame_index)
            np.vstack(stack_pcds).tofile(out_lidar / f'{frame_idx:06d}.bin')
            with open(out_label / f'{frame_idx:06d}.pkl', 'wb') as f:
                pickle.dump(final, f)
            frame_idx += 1


def prepare_multiframe_dataset(data_path):
    """All scenes under mot_dataset/ (gen_mot_dataset.py:274-303)."""
    scenes = sorted(os.listdir(Path(data_path) / 'mot_dataset'))
    prepare_multiframe_scenes(scenes, data_path)
    return scenes


def gen_single_frame_dataset(data_path):
    """Single-frame variant: stack size 1, base 0
    (gen_mot_dataset.py:467-505)."""
    scenes = sorted(os.listdir(Path(data_path) / 'mot_dataset'))
    prepare_multiframe_scenes(scenes, data_path, stack_frame_size=1,
                              base_frame_index=0)
    return scenes
