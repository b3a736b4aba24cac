"""The PlusAI calibration reader (``utils/calibration_plusai.py``) against
the JAX package's, on files that OpenCV's ``cv2.FileStorage`` wrote (a
float64 and a float32 matrix): through ``cv2`` where it imports, and
through the YAML parser where it does not (``cv2`` hidden from both
readers). Both paths give the JAX reader's matrix and each other's."""

import sys

import numpy as np
import pytest

from lidardetection_tpu.utils import calibration_plusai as jax_calib
from lidardetection_tpu_torch.utils import calibration_plusai

cv2 = pytest.importorskip('cv2')


def write_calib(root, dtype):
    matrix = (np.arange(16).reshape(4, 4) / 7 - 1).astype(dtype)
    matrix[:3, 3] = [1.25, -0.5, 1.75]
    storage = cv2.FileStorage(str(root / 'truck1_20200101_lidar0.yml'),
                              cv2.FILE_STORAGE_WRITE)
    storage.write('Tr_lidar_to_imu', matrix)
    storage.release()
    return matrix, ('truck1', 'lidar0', '20200101', str(root))


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('reader', ['cv2', 'yaml'])
def test_reader_equals_jax_on_a_file_that_cv2_wrote(reader, dtype, tmp_path,
                                                    monkeypatch):
    matrix, args = write_calib(tmp_path, dtype)
    via_cv2 = calibration_plusai.load_lidar_calib(*args)
    if reader == 'yaml':
        monkeypatch.setitem(sys.modules, 'cv2', None)
        with pytest.raises(ImportError):
            import cv2 as _  # noqa: F401
    got = calibration_plusai.load_lidar_calib(*args)
    want = jax_calib.load_lidar_calib(*args)
    assert got.dtype == want.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, via_cv2)
    np.testing.assert_allclose(got, matrix, rtol=1e-7, atol=0)
