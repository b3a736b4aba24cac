"""Per-point feature selection (copy of lidardetection_tpu/datasets/
processor/point_feature_encoder.py): x, y, z and the config's
``used_feature_list`` columns of the source points, in that order."""

import numpy as np


class PointFeatureEncoder:
    def __init__(self, config, point_cloud_range=None):
        self.point_encoding_config = config
        assert self.point_encoding_config['src_feature_list'][0:3] == ['x', 'y', 'z']
        self.used_feature_list = list(self.point_encoding_config['used_feature_list'])
        self.src_feature_list = list(self.point_encoding_config['src_feature_list'])
        self.point_cloud_range = point_cloud_range

    @property
    def num_point_features(self):
        return getattr(self, self.point_encoding_config['encoding_type'])(points=None)

    def forward(self, data_dict):
        data_dict['points'], use_lead_xyz = getattr(
            self, self.point_encoding_config['encoding_type'])(data_dict['points'])
        data_dict['use_lead_xyz'] = use_lead_xyz
        return data_dict

    def absolute_coordinates_encoding(self, points=None):
        if points is None:
            return len(self.used_feature_list)
        point_feature_list = [points[:, 0:3]]
        for x in self.used_feature_list:
            if x in ['x', 'y', 'z']:
                continue
            idx = self.src_feature_list.index(x)
            point_feature_list.append(points[:, idx:idx + 1])
        return np.concatenate(point_feature_list, axis=1), True
