"""KITTI label files (copy of lidardetection_tpu/utils/object3d_kitti.py):
one ``Object3d`` a line, its difficulty level from the 2D box height,
truncation and occlusion."""

import numpy as np


def get_objects_from_label(label_file):
    with open(label_file, 'r') as f:
        lines = f.readlines()
    return [Object3d(line) for line in lines]


def cls_type_to_id(cls_type):
    type_to_id = {'Car': 1, 'Pedestrian': 2, 'Cyclist': 3, 'Van': 4}
    return type_to_id.get(cls_type, -1)


class Object3d:
    def __init__(self, line):
        label = line.strip().split(' ')
        self.src = line
        self.cls_type = label[0]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[1])
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array(
            (float(label[4]), float(label[5]), float(label[6]), float(label[7])),
            dtype=np.float32)
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])  # noqa: E741
        self.loc = np.array(
            (float(label[11]), float(label[12]), float(label[13])),
            dtype=np.float32)
        self.dis_to_cam = np.linalg.norm(self.loc)
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level_str = None
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self):
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = 'Easy'
            return 0
        elif height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = 'Moderate'
            return 1
        elif height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = 'Hard'
            return 2
        self.level_str = 'UnKnown'
        return -1

    def generate_corners3d(self):
        """(8, 3) camera-frame corners."""
        l, h, w = self.l, self.h, self.w
        x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
        y = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
        z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
        rot = np.array([[np.cos(self.ry), 0, np.sin(self.ry)],
                        [0, 1, 0],
                        [-np.sin(self.ry), 0, np.cos(self.ry)]])
        corners = (rot @ np.vstack([x, y, z])).T
        return corners + self.loc

    def to_kitti_format(self):
        return ('%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f '
                '%.2f %.2f %.2f') % (
            self.cls_type, self.truncation, int(self.occlusion), self.alpha,
            self.box2d[0], self.box2d[1], self.box2d[2], self.box2d[3],
            self.h, self.w, self.l, self.loc[0], self.loc[1], self.loc[2],
            self.ry)
