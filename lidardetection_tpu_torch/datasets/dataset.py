"""The dataset template (copy of lidardetection_tpu/datasets/dataset.py).

``prepare_data(data_dict, rng)`` is a sample's way from a loader's raw
dict to the fixed-shape one a batch stacks: the augmentor (training), the
class filter, the point feature encoder, the processor chain (range mask,
shuffle, voxelizer), the host plan's rulebooks for a sparse 3D backbone
(``ops/sparse_plan.py``), and the gt boxes padded to MAX_GT_BOXES with the
1-based class id last (0 marks padding). Every random draw comes from
`rng`, an ``np.random.RandomState``, in the JAX package's order: the same
seed gives the same sample bit for bit.

A dataset draws its items from its ``rng`` attribute, ``RandomState(seed)``
at first; the loader (``datasets/__init__.py``) gives each worker process
a generator of its own. ``set_model(model_cfg)`` fits the samples to the
model that reads them: the host plan (``set_sparse_plan``) and the raw
points padded to MAX_POINTS only where the model reads them
(``config.raw_point_capacity``); without it they are padded, as the JAX
package pads them.
"""

from pathlib import Path

import numpy as np

from ..config import dataset_info, raw_point_capacity
from ..ops.sparse_plan import build_host_rulebooks, config_plan
from ..utils.common import keep_arrays_by_name
from .processor.data_processor import DataProcessor, pad_clouds
from .processor.point_feature_encoder import PointFeatureEncoder

# keys a batch keeps as they are, not stacked (dataset.py:163-166)
HOST_KEYS = ('frame_id', 'metadata', 'calib', 'use_lead_xyz', 'image_shape')


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None, seed=0):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.rng = np.random.RandomState(seed)
        self.root_path = Path(root_path) if root_path is not None else \
            Path(dataset_cfg['DATA_PATH']) if dataset_cfg else None
        if dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(dataset_cfg['POINT_CLOUD_RANGE'], np.float32)
        self.max_gt_boxes = int(dataset_cfg.get('MAX_GT_BOXES', 64))
        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg['POINT_FEATURE_ENCODING'],
            point_cloud_range=self.point_cloud_range)
        if self.training and dataset_cfg.get('DATA_AUGMENTOR'):
            from .augmentor.data_augmentor import DataAugmentor
            self.data_augmentor = DataAugmentor(
                self.root_path, dataset_cfg['DATA_AUGMENTOR'], class_names,
                logger=logger)
        else:
            self.data_augmentor = None
        self.data_processor = DataProcessor(
            dataset_cfg['DATA_PROCESSOR'],
            point_cloud_range=self.point_cloud_range, training=self.training,
            max_points=int(dataset_cfg.get('MAX_POINTS', 0)) or None)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.total_epochs = 0
        self._merge_all_iters_to_one_epoch = False
        self.sparse_plan = None

    def set_sparse_plan(self, model_cfg):
        """The host rulebook plan of the model's sparse 3D backbone at this
        split's voxel cap (with the transposed tables in training), or
        None."""
        self.sparse_plan = config_plan(
            {'DATA_CONFIG': self.dataset_cfg, 'MODEL': model_cfg},
            training=self.training)

    def set_model(self, model_cfg):
        """Fit the samples to the model that reads them: its host plan, and
        the raw points padded to MAX_POINTS only if it reads them."""
        self.set_sparse_plan(model_cfg)
        self.data_processor.max_points = raw_point_capacity(
            {'DATA_CONFIG': self.dataset_cfg, 'MODEL': model_cfg})

    @property
    def mode(self):
        return 'train' if self.training else 'test'

    @property
    def dataset_info(self):
        """Static info the network builder needs."""
        return dataset_info(self.dataset_cfg)

    def merge_all_iters_to_one_epoch(self, merge=True, epochs=None):
        self._merge_all_iters_to_one_epoch = merge
        self.total_epochs = epochs if merge else 0

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        return self.get_item(index, self.rng)

    def get_item(self, index, rng):
        """Sample `index`, its random draws from `rng`."""
        raise NotImplementedError

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        raise NotImplementedError

    def prepare_data(self, data_dict, rng):
        """Per-sample pipeline (dataset.py:97-151). Returns fixed-shape dict."""
        if self.training:
            assert 'gt_boxes' in data_dict
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict['gt_names']], dtype=bool)
            if self.data_augmentor is not None:
                data_dict = self.data_augmentor.forward(
                    {**data_dict, 'gt_boxes_mask': gt_boxes_mask}, rng)
            else:
                data_dict['gt_boxes'] = data_dict['gt_boxes'][gt_boxes_mask]
                data_dict['gt_names'] = data_dict['gt_names'][gt_boxes_mask]
            if len(data_dict['gt_boxes']) == 0:
                new_index = rng.randint(len(self))
                return self.get_item(new_index, rng)

        if data_dict.get('gt_boxes', None) is not None:
            selected = keep_arrays_by_name(data_dict['gt_names'], self.class_names)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][selected]
            data_dict['gt_names'] = data_dict['gt_names'][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict['gt_names']],
                dtype=np.int32)
            data_dict['gt_boxes'] = np.concatenate(
                (data_dict['gt_boxes'],
                 gt_classes.reshape(-1, 1).astype(np.float32)), axis=1)
            for key in ('locations', 'rotations_y'):
                if data_dict.get(key, None) is not None:
                    data_dict[key] = data_dict[key][selected]

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict, rng)
        data_dict.pop('gt_names', None)

        if self.sparse_plan is not None and 'voxel_coords' in data_dict:
            data_dict.update(build_host_rulebooks(
                self.sparse_plan, data_dict['voxel_coords'],
                data_dict['num_voxels']))

        # fixed-capacity gt padding (class col 0 marks padding)
        if data_dict.get('gt_boxes', None) is not None:
            gt = data_dict['gt_boxes']
            out = np.zeros((self.max_gt_boxes, gt.shape[1]), np.float32)
            n = min(len(gt), self.max_gt_boxes)
            out[:n] = gt[:n]
            data_dict['gt_boxes'] = out
            for key in ('locations', 'rotations_y'):
                if data_dict.get(key, None) is not None:
                    arr = data_dict[key]
                    padded = np.zeros((self.max_gt_boxes, *arr.shape[1:]),
                                      np.float32)
                    padded[:n] = arr[:n]
                    data_dict[key] = padded
        return data_dict

    @staticmethod
    def collate_batch(batch_list):
        """Stack fixed-shape samples into a batch dict. Points that were
        not padded (no ``num_points``: the model does not read them) are
        left out; clouds kept whole (a config with no MAX_POINTS) are
        padded to the batch's largest."""
        keys = batch_list[0].keys()
        ret = {}
        for key in keys:
            if key == 'points' and 'num_points' not in keys:
                continue
            vals = [s[key] for s in batch_list]
            if key == 'points':
                ret[key] = pad_clouds(vals)[0]
                continue
            if key in HOST_KEYS:
                ret[key] = np.asarray(vals) if key != 'calib' else vals
                continue
            ret[key] = np.stack(vals, axis=0)
        ret['batch_size'] = len(batch_list)
        return ret

    def array_batch_keys(self):
        """Keys forwarded to the device step."""
        keys = ['voxels', 'voxel_coords', 'voxel_num_points', 'num_voxels',
                'points', 'num_points', 'gt_boxes']
        if self.sparse_plan is not None:
            keys += self.sparse_plan.batch_keys()
        return keys
