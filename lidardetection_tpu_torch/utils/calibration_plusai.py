"""PlusAI lidar extrinsics (copy of lidardetection_tpu/utils/
calibration_plusai.py): ``Tr_lidar_to_imu`` of a calibration database's
OpenCV FileStorage YAML, ``<car>_<date>_<name>.yml``.

As in the JAX package, the file is read by OpenCV's ``cv2.FileStorage``
where ``cv2`` imports, and else parsed as YAML (the ``%YAML`` directive
and the ``!!opencv-matrix`` tags taken out). ``cv2`` is imported only
when a file is read. A node that is not an ``opencv-matrix`` of rows, cols
and data raises ValueError on either path, naming ``cv2``.
"""

import os
import re

import numpy as np


def load_lidar_calib(car, calib_name, calib_date, calib_db_path):
    """The (4, 4) float32 lidar -> IMU transform of a calibration file."""
    calib_file_name = os.path.join(
        calib_db_path, f'{car}_{calib_date}_{calib_name}.yml')
    if not os.path.isfile(calib_file_name):
        raise FileNotFoundError(calib_file_name)
    try:
        import cv2
    except ImportError:
        return _parse_opencv_matrix_yaml(calib_file_name, 'Tr_lidar_to_imu')
    return _read_opencv_matrix(cv2, calib_file_name, 'Tr_lidar_to_imu')


def _read_opencv_matrix(cv2, path, node):
    """An opencv-matrix node of a FileStorage file, read by cv2."""
    try:
        # the node reads from the storage: the storage must outlive it
        storage = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        mat = storage.getNode(node).mat()
    except cv2.error as e:
        raise ValueError(f'{path}: cv2.FileStorage cannot read node '
                         f'{node!r}: {e}') from e
    if mat is None:
        raise ValueError(f'{path}: node {node!r} is not an opencv-matrix '
                         '(cv2.FileStorage reads no matrix there)')
    return mat.astype(np.float32)


def _parse_opencv_matrix_yaml(path, node):
    """An opencv-matrix node (rows, cols, data) of a FileStorage YAML."""
    import yaml

    with open(path) as f:
        text = f.read()
    text = re.sub(r'^%YAML.*\n', '', text)
    text = text.replace('!!opencv-matrix', '')
    try:
        mat = yaml.safe_load(text)[node]
        return np.array(mat['data'], np.float32).reshape(mat['rows'],
                                                         mat['cols'])
    except (yaml.YAMLError, KeyError, TypeError, ValueError) as e:
        raise ValueError(
            f'{path}: node {node!r} is not an opencv-matrix that YAML reads; '
            'such a file needs OpenCV\'s FileStorage (cv2), which does not '
            'import here') from e
