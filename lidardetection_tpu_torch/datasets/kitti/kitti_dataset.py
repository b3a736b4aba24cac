"""The KITTI dataset (copy of lidardetection_tpu/datasets/kitti/
kitti_dataset.py): info pickles, the field-of-view crop, the camera -> lidar
gt transform, prediction dicts in the camera protocol, the official
evaluation, and the info and gt-database creation:

    python -m lidardetection_tpu_torch.datasets.kitti.kitti_dataset \
        create_kitti_infos tools/cfgs/dataset_configs/kitti_dataset.yaml <root>

writes ``kitti_infos_{train,val,trainval,test}.pkl``, ``gt_database/`` and
``kitti_dbinfos_train.pkl`` under <root>, a tree with ``ImageSets/`` and
``training/{velodyne,calib,label_2,image_2,planes}``.

Image sizes are read from the PNG header (``png_size``), with no image
library. ``generate_prediction_dicts`` takes the rows that ``pred_mask``
marks: the multi-class NMS leaves gaps between the kept rows, which the JAX
package's copy, reading the first ``num_preds`` slots, misreads.
"""

import copy
import pickle
import struct
from pathlib import Path

import numpy as np

from ...core import np_geometry as npg
from ...utils import calibration_kitti, object3d_kitti
from ..dataset import DatasetTemplate


def drop_info_with_name(info, name):
    """common_utils.drop_info_with_name: drop entries matching `name`."""
    keep = [i for i, x in enumerate(info['name']) if x != name]
    return {key: (val[keep] if isinstance(val, np.ndarray)
                  and len(val) == len(info['name']) else val)
            for key, val in info.items()}


def png_size(path):
    """(height, width) of a PNG file, from its IHDR chunk: the 8-byte
    signature, the chunk's length and type, then width and height as
    big-endian uint32."""
    with open(path, 'rb') as f:
        head = f.read(24)
    if head[:8] != b'\x89PNG\r\n\x1a\n' or head[12:16] != b'IHDR':
        raise ValueError(f'{path}: not a PNG file')
    width, height = struct.unpack('>II', head[16:24])
    return height, width


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, seed=0):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger,
                         seed=seed)
        self.split = dataset_cfg['DATA_SPLIT'][self.mode]
        self.root_split_path = self.root_path / (
            'training' if self.split != 'test' else 'testing')
        split_file = self.root_path / 'ImageSets' / f'{self.split}.txt'
        self.sample_id_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else None
        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
        if self.logger:
            self.logger.info('Loading KITTI dataset')
        for info_path in self.dataset_cfg['INFO_PATH'][mode]:
            path = self.root_path / info_path
            if not path.exists():
                continue
            with open(path, 'rb') as f:
                self.kitti_infos.extend(pickle.load(f))
        if self.logger:
            self.logger.info('Total samples for KITTI dataset: %d',
                             len(self.kitti_infos))

    def set_split(self, split):
        self.split = split
        self.root_split_path = self.root_path / (
            'training' if split != 'test' else 'testing')
        split_file = self.root_path / 'ImageSets' / f'{split}.txt'
        self.sample_id_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else None

    def get_lidar(self, idx):
        f = self.root_split_path / 'velodyne' / f'{idx}.bin'
        assert f.exists(), f
        return np.fromfile(str(f), dtype=np.float32).reshape(-1, 4)

    def get_image_shape(self, idx):
        f = self.root_split_path / 'image_2' / f'{idx}.png'
        assert f.exists(), f
        return np.array(png_size(f), dtype=np.int32)

    def get_label(self, idx):
        f = self.root_split_path / 'label_2' / f'{idx}.txt'
        assert f.exists(), f
        return object3d_kitti.get_objects_from_label(f)

    def get_calib(self, idx):
        f = self.root_split_path / 'calib' / f'{idx}.txt'
        assert f.exists(), f
        return calibration_kitti.Calibration(f)

    def get_road_plane(self, idx):
        f = self.root_split_path / 'planes' / f'{idx}.txt'
        if not f.exists():
            return None
        with open(f, 'r') as fh:
            lines = fh.readlines()
        plane = np.asarray([float(i) for i in lines[3].split()])
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        """Build info dicts per scene (kitti_dataset.py:119-193)."""
        import concurrent.futures as futures

        def process_single_scene(sample_idx):
            info = {'point_cloud': {'num_features': 4, 'lidar_idx': sample_idx}}
            info['image'] = {'image_idx': sample_idx,
                             'image_shape': self.get_image_shape(sample_idx)}
            calib = self.get_calib(sample_idx)
            p2 = np.concatenate([calib.P2, np.array([[0., 0., 0., 1.]])], axis=0)
            r0 = np.zeros([4, 4], dtype=calib.R0.dtype)
            r0[3, 3] = 1.
            r0[:3, :3] = calib.R0
            v2c = np.concatenate([calib.V2C, np.array([[0., 0., 0., 1.]])], axis=0)
            info['calib'] = {'P2': p2, 'R0_rect': r0, 'Tr_velo_to_cam': v2c}

            if has_label:
                obj_list = self.get_label(sample_idx)
                a = {
                    'name': np.array([o.cls_type for o in obj_list]),
                    'truncated': np.array([o.truncation for o in obj_list]),
                    'occluded': np.array([o.occlusion for o in obj_list]),
                    'alpha': np.array([o.alpha for o in obj_list]),
                    'bbox': np.concatenate(
                        [o.box2d.reshape(1, 4) for o in obj_list], axis=0),
                    'dimensions': np.array([[o.l, o.h, o.w] for o in obj_list]),
                    'location': np.concatenate(
                        [o.loc.reshape(1, 3) for o in obj_list], axis=0),
                    'rotation_y': np.array([o.ry for o in obj_list]),
                    'score': np.array([o.score for o in obj_list]),
                    'difficulty': np.array([o.level for o in obj_list], np.int32),
                }
                num_objects = len([o for o in obj_list if o.cls_type != 'DontCare'])
                num_gt = len(a['name'])
                a['index'] = np.array(
                    list(range(num_objects)) + [-1] * (num_gt - num_objects),
                    dtype=np.int32)
                loc = a['location'][:num_objects]
                dims = a['dimensions'][:num_objects]
                rots = a['rotation_y'][:num_objects]
                loc_lidar = calib.rect_to_lidar(loc)
                l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
                loc_lidar[:, 2] += h[:, 0] / 2
                a['gt_boxes_lidar'] = np.concatenate(
                    [loc_lidar, l, w, h, -(np.pi / 2 + rots[..., None])], axis=1)
                info['annos'] = a

                if count_inside_pts:
                    points = self.get_lidar(sample_idx)
                    pts_rect = calib.lidar_to_rect(points[:, 0:3])
                    fov_flag = npg.mask_points_in_fov(
                        pts_rect, info['image']['image_shape'], calib)
                    pts_fov = points[fov_flag]
                    corners = npg.boxes_to_corners_3d(a['gt_boxes_lidar'])
                    num_in = -np.ones(num_gt, dtype=np.int32)
                    for k in range(num_objects):
                        num_in[k] = npg.in_hull(pts_fov[:, 0:3], corners[k]).sum()
                    a['num_points_in_gt'] = num_in
            return info

        sample_id_list = sample_id_list or self.sample_id_list
        with futures.ThreadPoolExecutor(num_workers) as executor:
            infos = executor.map(process_single_scene, sample_id_list)
        return list(infos)

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split='train'):
        """Per-object point extraction for gt_sampling (kitti_dataset.py:193)."""
        database_save_path = Path(self.root_path) / (
            'gt_database' if split == 'train' else f'gt_database_{split}')
        db_info_save_path = Path(self.root_path) / f'kitti_dbinfos_{split}.pkl'
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)

        for k, info in enumerate(infos):
            print(f'gt_database sample: {k + 1}/{len(infos)}')
            sample_idx = info['point_cloud']['lidar_idx']
            points = self.get_lidar(sample_idx)
            annos = info['annos']
            gt_boxes = annos['gt_boxes_lidar']
            inside = npg.points_in_boxes(points[:, 0:3], gt_boxes)  # (N, M)
            for i in range(gt_boxes.shape[0]):
                name = annos['name'][i]
                filename = f'{sample_idx}_{name}_{i}.bin'
                filepath = database_save_path / filename
                gt_points = points[inside[:, i]]
                gt_points[:, :3] -= gt_boxes[i, :3]
                with open(filepath, 'w') as f:
                    gt_points.tofile(f)
                if used_classes is None or name in used_classes:
                    db_info = {
                        'name': name,
                        'path': str(filepath.relative_to(self.root_path)),
                        'image_idx': sample_idx, 'gt_idx': i,
                        'box3d_lidar': gt_boxes[i],
                        'num_points_in_gt': gt_points.shape[0],
                        'difficulty': annos['difficulty'][i],
                        'bbox': annos['bbox'][i], 'score': annos['score'][i],
                    }
                    all_db_infos.setdefault(name, []).append(db_info)
        for k, v in all_db_infos.items():
            print(f'Database {k}: {len(v)}')
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Lidar preds -> KITTI camera-protocol annos (kitti_dataset.py:246)."""

        def template(n):
            return {
                'name': np.zeros(n), 'truncated': np.zeros(n),
                'occluded': np.zeros(n), 'alpha': np.zeros(n),
                'bbox': np.zeros([n, 4]), 'dimensions': np.zeros([n, 3]),
                'location': np.zeros([n, 3]), 'rotation_y': np.zeros(n),
                'score': np.zeros(n), 'boxes_lidar': np.zeros([n, 7]),
            }

        annos = []
        for index in range(batch_dict['batch_size']):
            kept = np.asarray(pred_dicts['pred_mask'][index], bool)
            n = int(kept.sum())
            pred_boxes = np.asarray(pred_dicts['pred_boxes'][index])[kept][:, :7]
            pred_scores = np.asarray(pred_dicts['pred_scores'][index])[kept]
            pred_labels = np.asarray(pred_dicts['pred_labels'][index])[kept].astype(int)
            single = template(n)
            single['frame_id'] = batch_dict['frame_id'][index]
            if n > 0:
                calib = batch_dict['calib'][index]
                image_shape = batch_dict['image_shape'][index]
                boxes_cam = npg.boxes3d_lidar_to_kitti_camera(pred_boxes, calib)
                boxes_img = npg.boxes3d_kitti_camera_to_imageboxes(
                    boxes_cam, calib, image_shape=image_shape)
                single['name'] = np.array(class_names)[pred_labels - 1]
                single['alpha'] = (-np.arctan2(-pred_boxes[:, 1], pred_boxes[:, 0])
                                   + boxes_cam[:, 6])
                single['bbox'] = boxes_img
                single['dimensions'] = boxes_cam[:, 3:6]
                single['location'] = boxes_cam[:, 0:3]
                single['rotation_y'] = boxes_cam[:, 6]
                single['score'] = pred_scores
                single['boxes_lidar'] = pred_boxes
            annos.append(single)

            if output_path is not None:
                out = Path(output_path)
                out.mkdir(parents=True, exist_ok=True)
                with open(out / f"{single['frame_id']}.txt", 'w') as f:
                    for i in range(n):
                        bbox, loc = single['bbox'][i], single['location'][i]
                        dims = single['dimensions'][i]
                        print('%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                              '%.4f %.4f %.4f %.4f %.4f %.4f' % (
                                  single['name'][i], single['alpha'][i],
                                  bbox[0], bbox[1], bbox[2], bbox[3],
                                  dims[1], dims[2], dims[0],
                                  loc[0], loc[1], loc[2],
                                  single['rotation_y'][i], single['score'][i]),
                              file=f)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """The official KITTI protocol of `det_annos` against the infos'
        annos. The loader fills the last eval batch with the first frames
        again: annos past the infos' count are that padding and are left
        out."""
        if 'annos' not in self.kitti_infos[0]:
            return None, {}
        from .kitti_object_eval import eval as kitti_eval

        eval_det = copy.deepcopy(det_annos[:len(self.kitti_infos)])
        eval_gt = [copy.deepcopy(info['annos']) for info in self.kitti_infos]
        return kitti_eval.get_official_eval_result(eval_gt, eval_det, class_names)

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.kitti_infos) * self.total_epochs
        return len(self.kitti_infos)

    def get_item(self, index, rng):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.kitti_infos)
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info['point_cloud']['lidar_idx']
        points = self.get_lidar(sample_idx)
        calib = self.get_calib(sample_idx)
        img_shape = info['image']['image_shape']
        if self.dataset_cfg.get('FOV_POINTS_ONLY', False):
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            fov_flag = npg.mask_points_in_fov(pts_rect, img_shape, calib)
            points = points[fov_flag]

        input_dict = {'points': points, 'frame_id': sample_idx, 'calib': calib}
        if 'annos' in info:
            annos = drop_info_with_name(info['annos'], name='DontCare')
            gt_boxes_camera = np.concatenate(
                [annos['location'], annos['dimensions'],
                 annos['rotation_y'][..., None]], axis=1).astype(np.float32)
            input_dict['gt_names'] = annos['name']
            input_dict['gt_boxes'] = npg.boxes3d_kitti_camera_to_lidar(
                gt_boxes_camera, calib)
            road_plane = self.get_road_plane(sample_idx)
            if road_plane is not None:
                input_dict['road_plane'] = road_plane

        data_dict = self.prepare_data(input_dict, rng)
        data_dict['image_shape'] = img_shape
        data_dict['calib'] = calib  # kept for prediction-dict generation
        return data_dict


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path, workers=4):
    """(kitti_dataset.py:386-423)."""
    dataset = KittiDataset(dataset_cfg=dataset_cfg, class_names=class_names,
                           root_path=data_path, training=False)
    save_path = Path(save_path)
    train_filename = save_path / 'kitti_infos_train.pkl'
    val_filename = save_path / 'kitti_infos_val.pkl'

    print('---------------Start to generate data infos---------------')
    dataset.set_split('train')
    infos_train = dataset.get_infos(workers, has_label=True, count_inside_pts=True)
    with open(train_filename, 'wb') as f:
        pickle.dump(infos_train, f)
    dataset.set_split('val')
    infos_val = dataset.get_infos(workers, has_label=True, count_inside_pts=True)
    with open(val_filename, 'wb') as f:
        pickle.dump(infos_val, f)
    with open(save_path / 'kitti_infos_trainval.pkl', 'wb') as f:
        pickle.dump(infos_train + infos_val, f)
    dataset.set_split('test')
    infos_test = dataset.get_infos(workers, has_label=False, count_inside_pts=False)
    with open(save_path / 'kitti_infos_test.pkl', 'wb') as f:
        pickle.dump(infos_test, f)

    print('---------------Start create groundtruth database---------------')
    dataset.set_split('train')
    dataset.create_groundtruth_database(train_filename, split='train')
    print('---------------Data preparation Done---------------')


def main(argv=None):
    """``create_kitti_infos <dataset yaml> <root>``: the infos and the gt
    database of the KITTI tree at <root>, written under it."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[0] != 'create_kitti_infos':
        raise SystemExit('usage: python -m lidardetection_tpu_torch.datasets.'
                         'kitti.kitti_dataset create_kitti_infos <dataset '
                         'yaml> <root>')
    from ...config import cfg_from_yaml_file

    root = Path(argv[2])
    create_kitti_infos(dataset_cfg=cfg_from_yaml_file(argv[1]),
                       class_names=['Car', 'Pedestrian', 'Cyclist'],
                       data_path=root, save_path=root)


if __name__ == '__main__':
    main()
