"""KITTI calib files and their projections (copy of
lidardetection_tpu/utils/calibration_kitti.py): lidar, rectified camera and
image frames."""

import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()
    def parse(i):
        return np.array(lines[i].strip().split(' ')[1:], dtype=np.float32)
    return {'P2': parse(2).reshape(3, 4),
            'P3': parse(3).reshape(3, 4),
            'R0': parse(4).reshape(3, 3),
            'Tr_velo2cam': parse(5).reshape(3, 4)}


class Calibration:
    def __init__(self, calib_file):
        calib = calib_file if isinstance(calib_file, dict) \
            else get_calib_from_file(calib_file)
        self.P2 = calib['P2']
        self.R0 = calib['R0']
        self.V2C = calib['Tr_velo2cam']
        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def cart_to_hom(pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def rect_to_lidar(self, pts_rect):
        pts_rect_hom = self.cart_to_hom(pts_rect)
        r0_ext = np.eye(4, dtype=np.float32)
        r0_ext[:3, :3] = self.R0
        v2c_ext = np.eye(4, dtype=np.float32)
        v2c_ext[:3, :4] = self.V2C
        pts_lidar = pts_rect_hom @ np.linalg.inv((r0_ext @ v2c_ext).T)
        return pts_lidar[:, 0:3]

    def lidar_to_rect(self, pts_lidar):
        pts_hom = self.cart_to_hom(pts_lidar)
        return pts_hom @ (self.V2C.T @ self.R0.T)

    def rect_to_img(self, pts_rect):
        pts_hom = self.cart_to_hom(pts_rect)
        pts_2d_hom = pts_hom @ self.P2.T
        pts_img = (pts_2d_hom[:, 0:2].T / pts_hom[:, 2]).T
        pts_depth = pts_2d_hom[:, 2] - self.P2.T[3, 2]
        return pts_img, pts_depth

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.concatenate(
            (x.reshape(-1, 1), y.reshape(-1, 1), depth_rect.reshape(-1, 1)), axis=1)

    def corners3d_to_img_boxes(self, corners3d):
        n = corners3d.shape[0]
        hom = np.concatenate((corners3d, np.ones((n, 8, 1))), axis=2)
        img_pts = hom @ self.P2.T
        x = img_pts[:, :, 0] / img_pts[:, :, 2]
        y = img_pts[:, :, 1] / img_pts[:, :, 2]
        boxes = np.concatenate(
            (x.min(1)[:, None], y.min(1)[:, None],
             x.max(1)[:, None], y.max(1)[:, None]), axis=1)
        boxes_corner = np.concatenate(
            (x.reshape(-1, 8, 1), y.reshape(-1, 8, 1)), axis=2)
        return boxes, boxes_corner
