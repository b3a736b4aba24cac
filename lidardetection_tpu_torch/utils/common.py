"""Host utilities of the data layer (copy of lidardetection_tpu/utils/
common.py): the name filters of the gt arrays, the rank-0 logger, the
run's generators, and the poses of the fork's multiframe data (a 4x4 pose
from a translation and a quaternion, and the pose at a time between two
odometry samples).

The JAX package's ``set_random_seed`` seeds numpy's and Python's global
generators; here ``set_random_seed`` returns the generators instead, and
every random draw of the data layer takes its ``np.random.RandomState``
from the caller.
"""

import logging
import random

import numpy as np


def keep_arrays_by_name(gt_names, used_classes):
    """Indices of entries whose name is in used_classes (common_utils.py:229)."""
    inds = [i for i, x in enumerate(gt_names) if x in used_classes]
    return np.array(inds, dtype=np.int64)


def drop_arrays_by_name(gt_names, used_classes):
    inds = [i for i, x in enumerate(gt_names) if x not in used_classes]
    return np.array(inds, dtype=np.int64)


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """Rank-0 console+file logger (common_utils.py:116-129)."""
    logger = logging.getLogger(__name__ + f'.rank{rank}')
    logger.setLevel(log_level if rank == 0 else 'ERROR')
    logger.propagate = False
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else 'ERROR')
        console.setFormatter(formatter)
        logger.addHandler(console)
    if log_file is not None:
        # the newest run's file: a process that made the logger before
        # (another tool, another run) still gets this run's log
        for old in [h for h in logger.handlers
                    if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(old)
            old.close()
        fh = logging.FileHandler(log_file)
        fh.setLevel(log_level if rank == 0 else 'ERROR')
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def set_random_seed(seed):
    """The run's host generators made from `seed`: (``random.Random``,
    ``np.random.RandomState``). Nothing global is seeded."""
    return random.Random(seed), np.random.RandomState(seed)


def transform_mtx(trans, quat):
    """4x4 pose from a translation and a quaternion (x, y, z, w)
    (common_utils.py:15-19, the fork's pose utilities)."""
    from scipy.spatial.transform import Rotation

    pose = np.eye(4)
    pose[0:3, 0:3] = Rotation.from_quat(quat).as_matrix()
    pose[:3, 3] = trans
    return pose


def interpolate_pose(pose1, pose2, t1, t2, t_out):
    """Linear translation and slerp rotation (common_utils.py:22-28)."""
    from scipy.spatial.transform import Rotation, Slerp

    tau = (t_out - t1) / (t2 - t1)
    trans = (1 - tau) * np.asarray(pose1[0]) + tau * np.asarray(pose2[0])
    slerp = Slerp([t1, t2], Rotation.from_quat([pose1[1], pose2[1]]))
    quat = slerp(t_out).as_quat()
    return trans, quat


def get_best_pose(timestamp, poses):
    """The pose at `timestamp`, interpolated between the odometry samples
    `poses` = (timestamps, [(trans, quat)]) around it (common_utils.py:
    31-43)."""
    import bisect

    timestamps, pose_list = poses
    after_i = min(bisect.bisect_left(timestamps, timestamp),
                  len(timestamps) - 1)
    before_i = max(0, after_i - 1)
    if before_i == after_i:
        return pose_list[before_i]
    return interpolate_pose(pose_list[before_i], pose_list[after_i],
                            timestamps[before_i], timestamps[after_i],
                            timestamp)
