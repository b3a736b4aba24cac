"""The augmentation queue of a DATA_AUGMENTOR (copy of lidardetection_tpu/
datasets/augmentor/data_augmentor.py): gt sampling, then the world flip,
rotation and scaling in the config's order, the multiframe `locations` /
`rotations_y` carried along; it ends by wrapping the heading into [-pi, pi)
and applying the gt validity mask. ``forward(data_dict, rng)`` draws from
`rng` in the JAX package's order.
"""

from functools import partial

import numpy as np

from ...core.np_geometry import limit_period
from . import augmentor_utils
from .database_sampler import DataBaseSampler


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.data_augmentor_queue = []
        aug_list = augmentor_configs['AUG_CONFIG_LIST'] \
            if isinstance(augmentor_configs, dict) else augmentor_configs
        disable = augmentor_configs.get('DISABLE_AUG_LIST', []) \
            if isinstance(augmentor_configs, dict) else []
        for cur_cfg in aug_list:
            if cur_cfg['NAME'] in disable:
                continue
            self.data_augmentor_queue.append(
                getattr(self, cur_cfg['NAME'])(config=cur_cfg))

    def gt_sampling(self, config=None):
        return DataBaseSampler(
            root_path=self.root_path, sampler_cfg=config,
            class_names=self.class_names, logger=self.logger)

    @staticmethod
    def _world_op(data_dict, fn, *args):
        if 'locations' in data_dict and 'rotations_y' in data_dict:
            gt, pts, loc, rot = fn(
                data_dict['gt_boxes'], data_dict['points'], *args,
                locations=data_dict['locations'],
                rotations_y=data_dict['rotations_y'])
            data_dict['locations'] = loc
            data_dict['rotations_y'] = rot
        else:
            gt, pts = fn(data_dict['gt_boxes'], data_dict['points'], *args)
        data_dict['gt_boxes'] = gt
        data_dict['points'] = pts
        return data_dict

    def random_world_flip(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        for cur_axis in config['ALONG_AXIS_LIST']:
            assert cur_axis in ('x', 'y')
            fn = getattr(augmentor_utils, f'random_flip_along_{cur_axis}')
            data_dict = self._world_op(data_dict, fn, rng)
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config['WORLD_ROT_ANGLE']
        if not isinstance(rot_range, list):
            rot_range = [-rot_range, rot_range]
        return self._world_op(data_dict, augmentor_utils.global_rotation,
                              rot_range, rng)

    def random_world_scaling(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        return self._world_op(data_dict, augmentor_utils.global_scaling,
                              config['WORLD_SCALE_RANGE'], rng)

    def forward(self, data_dict, rng):
        for cur_augmentor in self.data_augmentor_queue:
            if isinstance(cur_augmentor, DataBaseSampler):
                data_dict = cur_augmentor(data_dict, rng)
            else:
                data_dict = cur_augmentor(data_dict=data_dict, rng=rng)

        data_dict['gt_boxes'][:, 6] = limit_period(
            data_dict['gt_boxes'][:, 6], offset=0.5, period=2 * np.pi)
        data_dict.pop('calib', None)
        data_dict.pop('road_plane', None)
        if 'gt_boxes_mask' in data_dict:
            mask = data_dict.pop('gt_boxes_mask')
            data_dict['gt_boxes'] = data_dict['gt_boxes'][mask]
            data_dict['gt_names'] = data_dict['gt_names'][mask]
        return data_dict
