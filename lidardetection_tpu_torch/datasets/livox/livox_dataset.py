"""The Livox datasets (copy of lidardetection_tpu/datasets/livox/
livox_dataset.py): a tree of ``pointcloud/<id>.bin`` (float64 x, y, z,
intensity) and ``label/<id>.pkl`` (a list of ``{'name', 'box3d_lidar'}``),
with ``ImageSets/{train,val}.txt`` listing the ids; the fine class names
fused (car, police_car -> Car; bus, truck, Engineering_vehicles, trailer
-> Truck); the PlusAI datasets' protocol and KITTI evaluation.

``create_livox_infos`` writes the infos and the gt database under the
names a config reads (its INFO_PATH and gt_sampling's DB_INFO_PATH); the
JAX package has no counterpart, and writes them by hand:

    python -m lidardetection_tpu_torch.datasets.livox.livox_dataset \
        create_livox_infos tools/cfgs/dataset_configs/livox_dataset.yaml <root>
"""

import pickle
from pathlib import Path

import numpy as np

from ..plusai.plusai_dataset import PlusAIDataset

NAME_FUSION = {
    'car': 'Car', 'police_car': 'Car',
    'bus': 'Truck', 'truck': 'Truck', 'Engineering_vehicles': 'Truck',
    'trailer': 'Truck',
}


class LivoxDataset(PlusAIDataset):
    STACK_FRAME_SIZE = 1
    BASE_FRAME_IDX = 0

    def get_lidar(self, idx):
        lidar_file = self.root_split_path / 'pointcloud' / f'{idx}.bin'
        assert lidar_file.exists(), lidar_file
        # float64 clouds (livox_dataset.py:67: np.fromfile's default dtype)
        return np.fromfile(str(lidar_file)).reshape(-1, 4).astype(np.float32)

    def get_label(self, idx):
        label_file = self.root_split_path / 'label' / f'{idx}.pkl'
        with open(label_file, 'rb') as f:
            return pickle.load(f)

    def get_infos(self, num_workers=4, has_label=True, sample_id_list=None):
        """An info dict a sample, the class names fused
        (livox_dataset.py:83-140)."""
        import concurrent.futures as futures

        def process_single_scene(sample_idx):
            info = {'point_cloud': {'num_features': 4, 'lidar_idx': sample_idx},
                    'image': {'image_idx': sample_idx,
                              'image_shape': np.array([1920, 1080])},
                    'calib': {'P2': np.eye(4), 'R0_rect': np.eye(4),
                              'Tr_velo_to_cam': np.eye(4)}}
            if has_label:
                obj_labels = self.get_label(sample_idx)
                a = {}
                if len(obj_labels):
                    names = [NAME_FUSION.get(o['name'], o['name'])
                             for o in obj_labels]
                    n = len(obj_labels)
                    boxes = np.array([o['box3d_lidar'] for o in obj_labels],
                                     np.float64)
                    a['name'] = np.array(names)
                    a['truncated'] = np.zeros(n)
                    a['occluded'] = np.zeros(n, np.int64)
                    a['alpha'] = np.zeros(n)
                    a['bbox'] = np.ones((n, 4))
                    a['dimensions'] = boxes[:, 3:6]
                    a['location'] = boxes[:, 0:3]
                    a['rotation_y'] = boxes[:, 6]
                    a['score'] = np.ones(n)
                    a['difficulty'] = np.zeros(n, np.int32)
                    a['index'] = np.arange(n, dtype=np.int32)
                    a['gt_boxes_lidar'] = boxes[:, :7]
                info['annos'] = a
            return info

        sample_id_list = sample_id_list or self.sample_id_list
        with futures.ThreadPoolExecutor(num_workers) as executor:
            infos = executor.map(process_single_scene, sample_id_list)
        return list(infos)


class LivoxMultiFrameDataset(LivoxDataset):
    """The multiframe Livox variant (livox_multiframe_dataset.py): stacked
    5-feature float32 clouds and each box's pose in each frame, the
    PlusAI multiframe protocol."""

    STACK_FRAME_SIZE = 3
    BASE_FRAME_IDX = 1

    def get_lidar(self, idx):
        lidar_file = self.root_split_path / 'pointcloud' / f'{idx}.bin'
        assert lidar_file.exists(), lidar_file
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 5)

    get_infos = PlusAIDataset.get_infos


def db_info_names(dataset_cfg):
    """The gt database files that gt_sampling reads in `dataset_cfg`."""
    augmentor = dataset_cfg.get('DATA_AUGMENTOR') or {}
    return [name for aug in augmentor.get('AUG_CONFIG_LIST', [])
            if aug['NAME'] == 'gt_sampling' for name in aug['DB_INFO_PATH']]


def create_livox_infos(dataset_cfg, class_names, data_path, save_path=None,
                       workers=4):
    """The infos of the config's train and test splits under its INFO_PATH
    names, and the train split's gt database under gt_sampling's (first)
    DB_INFO_PATH name, for the config's dataset class (Livox or Mix)."""
    from .. import dataset_class

    save_path = Path(save_path or data_path)
    dataset = dataset_class(dataset_cfg['DATASET'])(
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=data_path, training=False)
    for mode in ('train', 'test'):
        dataset.set_split(dataset_cfg['DATA_SPLIT'][mode])
        infos = dataset.get_infos(num_workers=workers, has_label=True)
        for name in dataset_cfg['INFO_PATH'][mode]:
            with open(save_path / name, 'wb') as f:
                pickle.dump(infos, f)
    names = db_info_names(dataset_cfg)
    if names:
        dataset.create_groundtruth_database(
            save_path / dataset_cfg['INFO_PATH']['train'][0], split='train',
            db_info_name=names[0])


def main(argv=None):
    """``create_livox_infos <dataset or model yaml> <root>``."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[0] != 'create_livox_infos':
        raise SystemExit('usage: python -m lidardetection_tpu_torch.datasets.'
                         'livox.livox_dataset create_livox_infos <yaml> <root>')
    from ...config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(argv[1])
    classes = list(cfg.get('CLASS_NAMES', ['Car', 'Truck']))
    create_livox_infos(cfg.get('DATA_CONFIG', cfg), classes, Path(argv[2]))


if __name__ == '__main__':
    main()
