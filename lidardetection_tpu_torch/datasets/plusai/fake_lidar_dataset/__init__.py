from .gen_fake_lidar import generate_fake_lidar, sample_groundtruth_objects
from .gen_gt_database import create_groundtruth_database
from .plane_estimation import (
    estimate_ground_plane_batch, find_plane, gen_rectified_plane,
    get_angle_pitch, pts_rotation_pitch,
)
