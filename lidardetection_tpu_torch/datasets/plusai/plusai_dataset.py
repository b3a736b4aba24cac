"""The PlusAI datasets (copy of lidardetection_tpu/datasets/plusai/
plusai_dataset.py): info pickles over 5-feature stacked clouds (x, y, z,
intensity, frame index) with pickled obstacle labels; the multiframe
variant carries each box's pose in every stacked frame (``locations``,
``rotations_y``) for the tracking targets. Evaluation is the KITTI
protocol with the lidar boxes moved into a pseudo-camera frame.

A tree holds ``ImageSets/{train,val}.txt`` listing ``<scene>/pointcloud/
<frame>.bin`` paths, and ``<scene>/label/<frame>.pkl`` beside each cloud
(``{'obstacles': [...]}``, each obstacle a dict, or in the multiframe
layout a list of one dict a stacked frame). The infos and the gt database:

    python -m lidardetection_tpu_torch.datasets.plusai.plusai_dataset \
        create_plusai_infos tools/cfgs/dataset_configs/\
plusai_multiframe_dataset.yaml <root>

writes ``plusai_infos_{train,val}.pkl``, ``gt_database/`` and
``plusai_dbinfos_train.pkl`` under <root>.

Two readings differ from the JAX package's, where its copy misreads:
``generate_prediction_dicts`` takes the rows that ``pred_mask`` marks (the
multi-class NMS leaves gaps), and ``evaluation`` leaves out the annos past
the infos' count (the loader's padding) and the frames with no obstacles
(the JAX package drops their gt but keeps their detections, so the two
lists lose step).
"""

import copy
import pickle
from pathlib import Path

import numpy as np

from ...core import np_geometry as npg
from ..dataset import DatasetTemplate
from ..kitti.kitti_dataset import drop_info_with_name


def lidar_anno_to_pseudo_camera(location, dims_lwh, rotation_y):
    """Lidar-frame boxes -> the KITTI protocol's camera fields (x_c = -y,
    y_c = -z + h / 2 at the bottom, z_c = x, ry = -heading - pi / 2,
    dimensions (l, h, w))."""
    loc = np.stack([-location[:, 1],
                    -location[:, 2] + dims_lwh[:, 2] / 2,
                    location[:, 0]], axis=1)
    rots = -rotation_y - np.pi / 2
    dims = dims_lwh[:, [0, 2, 1]]
    return loc, dims, rots


class PlusAIDataset(DatasetTemplate):
    """The single-frame PlusAI dataset (plusai_dataset.py)."""

    STACK_FRAME_SIZE = 1
    BASE_FRAME_IDX = 0

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, seed=0):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger,
                         seed=seed)
        self.split = dataset_cfg['DATA_SPLIT'][self.mode]
        self.root_split_path = self.root_path
        self.set_split(self.split)
        self.stack_frame_size = int(dataset_cfg.get(
            'STACK_FRAME_SIZE', self.STACK_FRAME_SIZE))
        self.base_frame_idx = self.BASE_FRAME_IDX
        self.plusai_infos = []
        self.include_plusai_data(self.mode)

    def set_split(self, split):
        """The split's sample ids (empty where it has no list)."""
        self.split = split
        split_file = self.root_path / 'ImageSets' / f'{split}.txt'
        self.sample_id_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else []

    def include_plusai_data(self, mode):
        if self.logger:
            self.logger.info('Loading PlusAI dataset ...')
        for info_path in self.dataset_cfg['INFO_PATH'][mode]:
            path = self.root_path / info_path
            if not path.exists():
                continue
            with open(path, 'rb') as f:
                self.plusai_infos.extend(pickle.load(f))
        if self.logger:
            self.logger.info('Total samples for PlusAI dataset: %d',
                             len(self.plusai_infos))

    def get_lidar(self, idx):
        lidar_file = self.root_split_path / idx
        assert lidar_file.exists(), lidar_file
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 5)

    def get_label(self, idx):
        scene_name, _, frame = idx.split('/')
        label_file = (self.root_split_path / scene_name / 'label'
                      / (frame[:-4] + '.pkl'))
        with open(label_file, 'rb') as f:
            return pickle.load(f)

    def get_infos(self, num_workers=4, has_label=True, sample_id_list=None):
        """An info dict a sample (plusai_multiframe_dataset.py:88-150): the
        base frame's boxes, and in the multiframe layout every frame's
        poses and velocities."""
        import concurrent.futures as futures

        multiframe = self.stack_frame_size > 1

        def process_single_scene(sample_idx):
            info = {'point_cloud': {'num_features': 5, 'lidar_idx': sample_idx},
                    'image': {'image_idx': sample_idx,
                              'image_shape': np.array([1920, 1080])},
                    'calib': {'P2': np.eye(4), 'R0_rect': np.eye(4),
                              'Tr_velo_to_cam': np.eye(4)}}
            if has_label:
                obstacles = self.get_label(sample_idx)['obstacles']
                a = {}
                if len(obstacles) > 0:
                    base = self.base_frame_idx
                    if multiframe:
                        def get(obj):
                            return obj[base]
                    else:
                        def get(obj):
                            return obj
                    a['name'] = np.array([get(o)['class'] for o in obstacles])
                    n = len(obstacles)
                    a['truncated'] = np.zeros(n)
                    a['occluded'] = np.zeros(n, np.int64)
                    a['alpha'] = np.zeros(n)
                    a['bbox'] = np.ones((n, 4))
                    a['dimensions'] = np.array(
                        [get(o)['size'] for o in obstacles])  # lwh, lidar
                    a['location'] = np.array(
                        [get(o)['location'] for o in obstacles])
                    a['rotation_y'] = np.array(
                        [get(o)['heading'] for o in obstacles])
                    a['score'] = np.ones(n)
                    a['difficulty'] = np.zeros(n, np.int32)
                    if multiframe:
                        a['locations'] = np.array(
                            [[f['location'] for f in o] for o in obstacles])
                        a['rotations_y'] = np.array(
                            [[f['heading'] for f in o] for o in obstacles])
                        a['velocities'] = np.array(
                            [[f.get('velocity', [0, 0, 0]) for f in o]
                             for o in obstacles])
                    a['index'] = np.arange(n, dtype=np.int32)
                    a['gt_boxes_lidar'] = np.concatenate(
                        [a['location'], a['dimensions'],
                         a['rotation_y'][..., None]], axis=1)
                info['annos'] = a
            return info

        sample_id_list = sample_id_list or self.sample_id_list
        with futures.ThreadPoolExecutor(num_workers) as executor:
            infos = executor.map(process_single_scene, sample_id_list)
        return list(infos)

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split='train', db_info_name=None):
        """Each object's points, box-centred, a ``.bin`` file each under
        ``gt_database/``, and their db infos in `db_info_name` (default
        ``plusai_dbinfos_<split>.pkl``) (plusai_multiframe_dataset.py:
        151-216)."""
        database_save_path = Path(self.root_path) / (
            'gt_database' if split == 'train' else f'gt_database_{split}')
        db_info_save_path = Path(self.root_path) / (
            db_info_name or f'plusai_dbinfos_{split}.pkl')
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)
        for info in infos:
            sample_idx = info['point_cloud']['lidar_idx']
            annos = info.get('annos', {})
            if not annos:
                continue
            points = self.get_lidar(sample_idx)
            gt_boxes = annos['gt_boxes_lidar']
            inside = npg.points_in_boxes(points[:, 0:3], gt_boxes)
            for i in range(gt_boxes.shape[0]):
                name = annos['name'][i]
                filename = f"{sample_idx.replace('/', '_')}_{name}_{i}.bin"
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
                    if 'locations' in annos:
                        db_info['locations'] = annos['locations'][i]
                        db_info['rotations_y'] = annos['rotations_y'][i]
                    all_db_infos.setdefault(name, []).append(db_info)
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """The kept detections of each sample (the rows ``pred_mask``
        marks) as annos in the pseudo-camera frame, with their lidar boxes."""
        annos = []
        for index in range(batch_dict['batch_size']):
            kept = np.asarray(pred_dicts['pred_mask'][index], bool)
            n = int(kept.sum())
            boxes = np.asarray(pred_dicts['pred_boxes'][index])[kept][:, :7]
            scores = np.asarray(pred_dicts['pred_scores'][index])[kept]
            labels = np.asarray(pred_dicts['pred_labels'][index])[kept].astype(int)
            loc, dims, rots = lidar_anno_to_pseudo_camera(
                boxes[:, 0:3], boxes[:, 3:6], boxes[:, 6]) if n else \
                (np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
            annos.append({
                'name': np.array(class_names)[labels - 1] if n else np.zeros(0),
                'truncated': np.zeros(n), 'occluded': np.zeros(n, np.int64),
                'alpha': np.full(n, -10.0),
                'bbox': np.ones((n, 4)) * [0, 0, 50, 50],
                'dimensions': dims, 'location': loc, 'rotation_y': rots,
                'score': scores, 'boxes_lidar': boxes,
                'frame_id': batch_dict['frame_id'][index],
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """The KITTI protocol in the pseudo-camera frame
        (plusai_dataset.py:262-272), over the frames with obstacles."""
        if not self.plusai_infos or 'annos' not in self.plusai_infos[0]:
            return None, {}
        from ..kitti.kitti_object_eval import eval as kitti_eval

        gt_annos, dt_annos = [], []
        for info, det in zip(self.plusai_infos, det_annos):
            a = copy.deepcopy(info['annos'])
            if not a:
                continue
            loc, dims, rots = lidar_anno_to_pseudo_camera(
                a['location'], a['dimensions'], a['rotation_y'])
            a['location'], a['dimensions'], a['rotation_y'] = loc, dims, rots
            a['bbox'] = np.ones((len(loc), 4)) * [0, 0, 50, 50]
            gt_annos.append(a)
            dt_annos.append(copy.deepcopy(det))
        present = [c for c in class_names
                   if c.lower() in kitti_eval.CLASS_NAMES_EVAL]
        if not present:
            return 'no kitti-protocol-evaluable classes', {}
        return kitti_eval.get_official_eval_result(gt_annos, dt_annos, present)

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.plusai_infos) * self.total_epochs
        return len(self.plusai_infos)

    def get_item(self, index, rng):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.plusai_infos)
        info = copy.deepcopy(self.plusai_infos[index])
        sample_idx = info['point_cloud']['lidar_idx']
        points = self.get_lidar(sample_idx)
        input_dict = {'points': points, 'frame_id': sample_idx}
        if 'annos' in info:
            annos = info['annos']
            if not annos:
                input_dict.update({
                    'gt_names': np.array([], dtype='<U12'),
                    'gt_boxes': np.zeros((0, 7), np.float32),
                })
                if self.stack_frame_size > 1:
                    t = self.stack_frame_size
                    input_dict['locations'] = np.zeros((0, t, 3), np.float32)
                    input_dict['rotations_y'] = np.zeros((0, t), np.float32)
            else:
                annos = drop_info_with_name(annos, name='DontCare')
                input_dict['gt_names'] = annos['name']
                input_dict['gt_boxes'] = annos['gt_boxes_lidar']
                if 'locations' in annos:
                    input_dict['locations'] = annos['locations']
                    input_dict['rotations_y'] = annos['rotations_y']
        data_dict = self.prepare_data(input_dict, rng)
        data_dict['image_shape'] = info['image']['image_shape']
        return data_dict


class PlusAIMultiframeDataset(PlusAIDataset):
    """The multiframe variant (plusai_multiframe_dataset.py:11-354): three
    stacked frames with each box's pose in each; the base frame is 1."""

    STACK_FRAME_SIZE = 3
    BASE_FRAME_IDX = 1


def create_plusai_infos(dataset_cfg, class_names, data_path, save_path,
                        workers=4, multiframe=True):
    """The train and val infos and the train split's gt database
    (plusai_multiframe_dataset.py:356-393)."""
    cls = PlusAIMultiframeDataset if multiframe else PlusAIDataset
    data_path, save_path = Path(data_path), Path(save_path)
    dataset = cls(dataset_cfg=dataset_cfg, class_names=class_names,
                  root_path=data_path, training=False)
    for split, fname in (('train', 'plusai_infos_train.pkl'),
                         ('val', 'plusai_infos_val.pkl')):
        dataset.set_split(split)
        infos = dataset.get_infos(num_workers=workers, has_label=True)
        with open(save_path / fname, 'wb') as f:
            pickle.dump(infos, f)
        if split == 'train':
            dataset.create_groundtruth_database(save_path / fname, split=split)


def main(argv=None):
    """``create_plusai_infos <dataset yaml> <root>``: the infos and the gt
    database of the PlusAI tree at <root> (multiframe where the yaml's
    STACK_FRAME_SIZE or its DATASET says so), written under it."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[0] != 'create_plusai_infos':
        raise SystemExit('usage: python -m lidardetection_tpu_torch.datasets.'
                         'plusai.plusai_dataset create_plusai_infos <dataset '
                         'yaml> <root>')
    from ...config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(argv[1])
    root = Path(argv[2])
    multiframe = cfg['DATASET'] == 'PlusAIMultiframeDataset' or \
        int(cfg.get('STACK_FRAME_SIZE', 1)) > 1
    create_plusai_infos(cfg, ['Car', 'Truck'], root, root,
                        multiframe=multiframe)


if __name__ == '__main__':
    main()
