"""PlusAI lidar extrinsics (copy of lidardetection_tpu/utils/
calibration_plusai.py): ``Tr_lidar_to_imu`` of a calibration database's
OpenCV FileStorage YAML, ``<car>_<date>_<name>.yml``.

The file is read as YAML (the ``%YAML`` directive and the
``!!opencv-matrix`` tags taken out), with no OpenCV: the card's machine
has no ``cv2``. A file that YAML cannot read, or whose node is not an
``opencv-matrix`` of rows, cols and data, raises, naming ``cv2``, the
reader that would be needed.
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
    return _parse_opencv_matrix_yaml(calib_file_name, 'Tr_lidar_to_imu')


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
            'such a file needs OpenCV\'s FileStorage (cv2), which the port '
            'does not use') from e
