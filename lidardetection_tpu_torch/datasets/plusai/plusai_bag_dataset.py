"""Frame stacking and a folder-of-clouds dataset (copy of the parts of
lidardetection_tpu/datasets/plusai/plusai_bag_dataset.py that need no ROS):
``stack_frames_to_base`` moves a run of frames into the base frame's
coordinates with a frame-index column, and ``DemoDataset`` reads a folder
of ``.bin`` (float32, x, y, z, intensity) or ``.npy`` clouds for
inference.

The ROS-bag readers (``UnifyLidar``, ``BagMultiframeDatasetUnifyLidar``,
``BagMultiframeDataset``) read bags through ``rosbag`` and
``sensor_msgs``; the port does not carry them, and each raises on
construction, naming the packages.
"""

import glob
from pathlib import Path

import numpy as np

from ...utils.common import transform_mtx
from ..dataset import DatasetTemplate

ROS_NEEDED = ('the ROS-bag readers need the rosbag and sensor_msgs packages, '
              'which the port does not carry: read clouds from a folder with '
              'DemoDataset (see ROADMAP.md section 1, "Not queued")')


def stack_frames_to_base(frame_list, base_frame_index):
    """(timestamp, (trans, quat), points) frames stacked in the base
    frame: each cloud gains its frame index as a last column and is moved
    by base_pose^-1 @ frame_pose (plusai_bag_dataset.py:157-173)."""
    base = frame_list[base_frame_index]
    base_inv = np.linalg.inv(transform_mtx(base[1][0], base[1][1]))
    stack = []
    for idx, (_, pose, pts) in enumerate(frame_list):
        cur = np.concatenate(
            [pts, np.full((pts.shape[0], 1), idx, np.float32)], axis=-1)
        delta = base_inv @ transform_mtx(pose[0], pose[1])
        cur[:, 0:3] = (delta[0:3, 0:3] @ cur[:, 0:3].T + delta[0:3, 3:]).T
        stack.append(cur)
    return np.vstack(stack)


class _NeedsROS:
    def __init__(self, *args, **kwargs):
        raise ImportError(f'{type(self).__name__}: {ROS_NEEDED}')


class UnifyLidar(_NeedsROS):
    """Several lidar topics of a bag merged into frames
    (plusai_bag_dataset.py:16-96): needs rosbag and sensor_msgs."""


class BagMultiframeDatasetUnifyLidar(_NeedsROS):
    """A bag's frames, stacked (plusai_bag_dataset.py:92-186): needs
    rosbag and sensor_msgs."""


class BagMultiframeDataset(_NeedsROS):
    """A bag's unified lidar topic, stacked (plusai_bag_dataset.py:
    187-291): needs rosbag and sensor_msgs."""


class DemoDataset(DatasetTemplate):
    """The clouds of a folder (or one file), sorted by name
    (plusai_bag_dataset.py:292-338)."""

    def __init__(self, dataset_cfg, class_names, training=False,
                 root_path=None, logger=None, ext='.bin', seed=0):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger,
                         seed=seed)
        self.ext = ext
        root = Path(root_path)
        self.sample_file_list = sorted(glob.glob(str(root / f'*{ext}'))) \
            if root.is_dir() else [str(root)]

    def __len__(self):
        return len(self.sample_file_list)

    def get_item(self, index, rng):
        if self.ext == '.bin':
            points = np.fromfile(self.sample_file_list[index],
                                 dtype=np.float32).reshape(-1, 4)
        elif self.ext == '.npy':
            points = np.load(self.sample_file_list[index])
        else:
            raise NotImplementedError(self.ext)
        return self.prepare_data({'points': points, 'frame_id': index}, rng)
