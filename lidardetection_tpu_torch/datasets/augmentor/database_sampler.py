"""Ground-truth database sampling, ``gt_sampling`` (copy of
lidardetection_tpu/datasets/augmentor/database_sampler.py): object point
clouds cut out of the training scans (``create_groundtruth_database``) are
pasted into a scene, the collisions rejected by rotated BEV IoU
(``core/np_geometry.py::boxes_bev_iou_cpu``, the host library), with the
PREPARE filters, per-class fixed-number sampling through an index
permutation drawn anew whenever a class's pointer runs out,
LIMIT_WHOLE_SCENE, the KITTI road-plane lift and the multiframe side
arrays.

The random draws (the permutations, SAMPLE_ROT_ANGLE) come from the
caller's `rng`, in the JAX package's order. The pointers are state of the
sampler, so of each loader process, as in the JAX package.
"""

import pickle
from pathlib import Path

import numpy as np

from ...core.np_geometry import (
    boxes_bev_iou_cpu, remove_points_in_boxes, rotate_points_along_z,
)


def _enlarge(boxes, extra):
    out = boxes.copy()
    out[:, 3:6] += np.asarray(extra)
    return out


def boxes3d_kitti_fakelidar_to_lidar(boxes3d_lidar):
    """(N, 7) [x,y,z,w,l,h,r] old-lidar bottom-z -> unified (box_utils.py:108)."""
    w, l, h, r = (boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5],
                  boxes3d_lidar[:, 5:6], boxes3d_lidar[:, 6:7])
    boxes3d_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate(
        [boxes3d_lidar[:, 0:3], l, w, h, -(r + np.pi / 2)], axis=-1)


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.class_names = class_names
        self.sampler_cfg = sampler_cfg
        self.logger = logger
        self.db_infos = {name: [] for name in class_names}

        for db_info_path in sampler_cfg['DB_INFO_PATH']:
            path = self.root_path.resolve() / db_info_path
            with open(str(path), 'rb') as f:
                infos = pickle.load(f)
            for cur_class in class_names:
                self.db_infos[cur_class].extend(infos.get(cur_class, []))

        for func_name, val in sampler_cfg['PREPARE'].items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        self.sample_class_num = {}
        self.limit_whole_scene = sampler_cfg.get('LIMIT_WHOLE_SCENE', False)
        for x in sampler_cfg['SAMPLE_GROUPS']:
            class_name, sample_num = x.split(':')
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = sample_num
            self.sample_groups[class_name] = {
                'sample_num': sample_num,
                'pointer': len(self.db_infos[class_name]),
                'indices': np.arange(len(self.db_infos[class_name])),
            }

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        new = {}
        for key, dinfos in db_infos.items():
            new[key] = [i for i in dinfos
                        if i['difficulty'] not in removed_difficulty]
            if self.logger:
                self.logger.info('db filter by difficulty %s: %d => %d',
                                 key, len(dinfos), len(new[key]))
        return new

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(':')
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                filtered = [i for i in db_infos[name]
                            if i['num_points_in_gt'] >= min_num]
                if self.logger:
                    self.logger.info('db filter by min points %s: %d => %d',
                                     name, len(db_infos[name]), len(filtered))
                db_infos[name] = filtered
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group, rng):
        """Epoch-pointer sampling (database_sampler.py:79-95)."""
        sample_num = int(sample_group['sample_num'])
        pointer, indices = sample_group['pointer'], sample_group['indices']
        if pointer >= len(self.db_infos[class_name]):
            indices = rng.permutation(len(self.db_infos[class_name]))
            pointer = 0
        sampled = [self.db_infos[class_name][idx]
                   for idx in indices[pointer:pointer + sample_num]]
        sample_group['pointer'] = pointer + sample_num
        sample_group['indices'] = indices
        return sampled

    @staticmethod
    def put_boxes_on_road_planes(gt_boxes, road_planes, calib):
        """KITTI road-plane lift (database_sampler.py:99-116)."""
        a, b, c, d = road_planes
        center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
        cur_height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        center_cam[:, 1] = cur_height_cam
        cur_lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
        mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - cur_lidar_height
        gt_boxes[:, 2] -= mv_height
        return gt_boxes, mv_height

    def add_sampled_boxes_to_scene(self, data_dict, sampled_gt_boxes,
                                   total_valid_sampled_dict, rng):
        gt_boxes_mask = data_dict['gt_boxes_mask']
        gt_boxes = data_dict['gt_boxes'][gt_boxes_mask]
        gt_names = data_dict['gt_names'][gt_boxes_mask]
        points = data_dict['points']
        mv_height = None
        if self.sampler_cfg.get('USE_ROAD_PLANE', False) \
                and 'road_plane' in data_dict:
            sampled_gt_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_gt_boxes, data_dict['road_plane'], data_dict['calib'])
            data_dict.pop('calib', None)
            data_dict.pop('road_plane', None)

        noise_rotation = None
        if 'SAMPLE_ROT_ANGLE' in self.sampler_cfg:
            noise_rotation = rng.uniform(
                self.sampler_cfg['SAMPLE_ROT_ANGLE'][0],
                self.sampler_cfg['SAMPLE_ROT_ANGLE'][1],
                sampled_gt_boxes.shape[0])

        obj_points_list = []
        for idx, info in enumerate(total_valid_sampled_dict):
            obj_points = np.fromfile(
                str(self.root_path / info['path']), dtype=np.float32
            ).reshape([-1, self.sampler_cfg['NUM_POINT_FEATURES']])
            if noise_rotation is not None:
                sampled_gt_boxes[idx, 6] += noise_rotation[idx]
                obj_points = rotate_points_along_z(
                    obj_points[np.newaxis], np.array([noise_rotation[idx]]))[0]
            obj_points[:, :3] += info['box3d_lidar'][:3]
            if mv_height is not None:
                obj_points[:, 2] -= mv_height[idx]
            obj_points_list.append(obj_points)

        obj_points = np.concatenate(obj_points_list, axis=0)
        sampled_gt_names = np.array([x['name'] for x in total_valid_sampled_dict])

        large_sampled = _enlarge(sampled_gt_boxes[:, 0:7],
                                 self.sampler_cfg['REMOVE_EXTRA_WIDTH'])
        points = remove_points_in_boxes(points, large_sampled)
        points = np.concatenate([obj_points, points], axis=0)
        data_dict['gt_boxes'] = np.concatenate([gt_boxes, sampled_gt_boxes], axis=0)
        data_dict['gt_names'] = np.concatenate([gt_names, sampled_gt_names], axis=0)
        data_dict['points'] = points

        if 'locations' in data_dict and 'rotations_y' in data_dict:
            sample_locations = np.concatenate(
                [info['locations'][np.newaxis] for info in total_valid_sampled_dict], axis=0)
            if mv_height is not None:
                sample_locations[:, :, 2] -= mv_height[:, np.newaxis]
            sample_rotations_y = np.concatenate(
                [info['rotations_y'][np.newaxis] for info in total_valid_sampled_dict], axis=0)
            if noise_rotation is not None:
                sample_rotations_y += noise_rotation[:, np.newaxis]
                sample_locations -= sampled_gt_boxes[:, np.newaxis, 0:3]
                sample_locations = rotate_points_along_z(sample_locations, noise_rotation)
                sample_locations += sampled_gt_boxes[:, np.newaxis, 0:3]
            data_dict['locations'] = np.concatenate(
                [data_dict['locations'], sample_locations], axis=0)
            data_dict['rotations_y'] = np.concatenate(
                [data_dict['rotations_y'], sample_rotations_y], axis=0)
        return data_dict

    def __call__(self, data_dict, rng):
        gt_boxes = data_dict['gt_boxes']
        gt_names = data_dict['gt_names'].astype(str)
        existed_boxes = gt_boxes
        total_valid_sampled_dict = []
        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = np.sum(class_name == gt_names)
                sample_group['sample_num'] = str(
                    int(self.sample_class_num[class_name]) - num_gt)
            if int(sample_group['sample_num']) > 0:
                sampled_dict = self.sample_with_fixed_number(class_name,
                                                             sample_group, rng)
                if not sampled_dict:
                    continue
                sampled_boxes = np.stack(
                    [x['box3d_lidar'] for x in sampled_dict], axis=0
                ).astype(np.float32)
                if self.sampler_cfg.get('DATABASE_WITH_FAKELIDAR', False):
                    sampled_boxes = boxes3d_kitti_fakelidar_to_lidar(sampled_boxes)

                if 'REMOVE_SAMPLE_BOXES_EXTRA_WIDTH' in self.sampler_cfg:
                    extra = self.sampler_cfg['REMOVE_SAMPLE_BOXES_EXTRA_WIDTH']
                    iou1 = boxes_bev_iou_cpu(_enlarge(sampled_boxes[:, 0:7], extra),
                                             _enlarge(existed_boxes[:, 0:7], extra))
                    iou2 = boxes_bev_iou_cpu(_enlarge(sampled_boxes[:, 0:7], extra),
                                             _enlarge(sampled_boxes[:, 0:7], extra))
                else:
                    iou1 = boxes_bev_iou_cpu(sampled_boxes[:, 0:7], existed_boxes[:, 0:7])
                    iou2 = boxes_bev_iou_cpu(sampled_boxes[:, 0:7], sampled_boxes[:, 0:7])

                iou2[range(len(sampled_boxes)), range(len(sampled_boxes))] = 0
                iou1 = iou1 if iou1.shape[1] > 0 else iou2
                valid_mask = ((iou1.max(axis=1) + iou2.max(axis=1)) == 0).nonzero()[0]
                valid_sampled_dict = [sampled_dict[x] for x in valid_mask]
                valid_sampled_boxes = sampled_boxes[valid_mask]

                existed_boxes = np.concatenate(
                    (existed_boxes, valid_sampled_boxes), axis=0)
                total_valid_sampled_dict.extend(valid_sampled_dict)

        sampled_gt_boxes = existed_boxes[gt_boxes.shape[0]:, :]
        if len(total_valid_sampled_dict) > 0:
            data_dict = self.add_sampled_boxes_to_scene(
                data_dict, sampled_gt_boxes, total_valid_sampled_dict, rng)
        data_dict.pop('gt_boxes_mask')
        return data_dict
