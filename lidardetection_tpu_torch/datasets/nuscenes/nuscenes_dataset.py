"""The NuScenes dataset (copy of lidardetection_tpu/datasets/nuscenes/
nuscenes_dataset.py): info pickles, a key frame with sweeps drawn from its
earlier ones (a fifth column of time lag), CBGS class-balanced resampling,
velocity gt (code size 9), the gt database of gt_sampling, and the
KITTI-protocol evaluation of ``EVAL_METRIC: kitti``.

The sweeps a sample takes are drawn from the caller's `rng`; CBGS draws
from ``RandomState(seed)`` of the dataset's seed. The official NDS / mAP
evaluation (``_nuscenes_official_eval``) and the info creation from raw
NuScenes (``nuscenes_utils.create_nuscenes_info``) need the
nuscenes-devkit, imported when asked for, as in the JAX package; without
it ``evaluation`` returns the JAX package's message and no metric.

``_kitti_style_eval`` hands the protocol the class ids of the config's
classes that it knows (car, pedestrian, truck): the JAX package's copy
hands it NuScenes' lower-case names, which the protocol's name table does
not hold, and raises.
"""

import copy
import pickle
from pathlib import Path

import numpy as np

from ...core import np_geometry as npg
from ..dataset import DatasetTemplate


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, seed=0):
        root_path = (Path(root_path) if root_path is not None
                     else Path(dataset_cfg['DATA_PATH'])) / dataset_cfg['VERSION']
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger,
                         seed=seed)
        self.infos = []
        self.include_nuscenes_data(self.mode)
        if self.training and dataset_cfg.get('BALANCED_RESAMPLING', False):
            self.infos = self.balanced_infos_resampling(
                self.infos, np.random.RandomState(seed))

    def include_nuscenes_data(self, mode):
        if self.logger:
            self.logger.info('Loading NuScenes dataset')
        for info_path in self.dataset_cfg['INFO_PATH'][mode]:
            path = self.root_path / info_path
            if not path.exists():
                continue
            with open(path, 'rb') as f:
                self.infos.extend(pickle.load(f))
        if self.logger:
            self.logger.info('Total samples for NuScenes dataset: %d',
                             len(self.infos))

    def balanced_infos_resampling(self, infos, rng):
        """CBGS class-balanced resampling (nuscenes_dataset.py:39-74,
        https://arxiv.org/abs/1908.09492), its draws from `rng`."""
        if self.class_names is None:
            return infos
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info['gt_names']):
                if name in self.class_names:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        cls_dist = {k: len(v) / max(duplicated, 1) for k, v in cls_infos.items()}
        sampled = []
        frac = 1.0 / len(self.class_names)
        ratios = [frac / max(v, 1e-8) for v in cls_dist.values()]
        for cur_infos, ratio in zip(cls_infos.values(), ratios):
            if len(cur_infos) == 0:
                continue
            sampled += rng.choice(
                cur_infos, int(len(cur_infos) * ratio)).tolist()
        if self.logger:
            self.logger.info('Total samples after balanced resampling: %d',
                             len(sampled))
        return sampled

    def get_sweep(self, sweep_info):
        def remove_ego_points(points, center_radius=1.0):
            mask = ~((np.abs(points[:, 0]) < center_radius)
                     & (np.abs(points[:, 1]) < center_radius))
            return points[mask]

        lidar_path = self.root_path / sweep_info['lidar_path']
        points_sweep = np.fromfile(str(lidar_path), dtype=np.float32
                                   ).reshape([-1, 5])[:, :4]
        points_sweep = remove_ego_points(points_sweep).T
        if sweep_info['transform_matrix'] is not None:
            num_points = points_sweep.shape[1]
            points_sweep[:3, :] = sweep_info['transform_matrix'].dot(
                np.vstack((points_sweep[:3, :], np.ones(num_points))))[:3, :]
        cur_times = sweep_info['time_lag'] * np.ones((1, points_sweep.shape[1]))
        return points_sweep.T, cur_times.T

    def get_lidar_with_sweeps(self, index, rng, max_sweeps=1):
        info = self.infos[index]
        lidar_path = self.root_path / info['lidar_path']
        points = np.fromfile(str(lidar_path), dtype=np.float32
                             ).reshape([-1, 5])[:, :4]
        sweep_points_list = [points]
        sweep_times_list = [np.zeros((points.shape[0], 1))]
        n_pick = min(max_sweeps - 1, len(info['sweeps']))
        for k in rng.choice(len(info['sweeps']), n_pick, replace=False):
            points_sweep, times_sweep = self.get_sweep(info['sweeps'][k])
            sweep_points_list.append(points_sweep)
            sweep_times_list.append(times_sweep)
        points = np.concatenate(sweep_points_list, axis=0)
        times = np.concatenate(sweep_times_list, axis=0).astype(points.dtype)
        return np.concatenate((points, times), axis=1)

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * self.total_epochs
        return len(self.infos)

    def get_item(self, index, rng):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = copy.deepcopy(self.infos[index])
        points = self.get_lidar_with_sweeps(
            index, rng, max_sweeps=self.dataset_cfg['MAX_SWEEPS'])
        input_dict = {
            'points': points,
            'frame_id': Path(info['lidar_path']).stem,
            'metadata': {'token': info['token']},
        }
        if 'gt_boxes' in info:
            if self.dataset_cfg.get('FILTER_MIN_POINTS_IN_GT', False):
                mask = info['num_lidar_pts'] > \
                    self.dataset_cfg['FILTER_MIN_POINTS_IN_GT'] - 1
            else:
                mask = slice(None)
            input_dict['gt_names'] = info['gt_names'][mask]
            input_dict['gt_boxes'] = info['gt_boxes'][mask]

        data_dict = self.prepare_data(input_dict, rng)
        if self.dataset_cfg.get('SET_NAN_VELOCITY_TO_ZEROS', False) \
                and 'gt_boxes' in data_dict:
            gt = data_dict['gt_boxes']
            gt[np.isnan(gt)] = 0
            data_dict['gt_boxes'] = gt
        if not self.dataset_cfg.get('PRED_VELOCITY', True) \
                and 'gt_boxes' in data_dict:
            data_dict['gt_boxes'] = data_dict['gt_boxes'][:, [0, 1, 2, 3, 4, 5, 6, -1]]
        return data_dict

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        annos = []
        for index in range(batch_dict['batch_size']):
            kept = np.asarray(pred_dicts['pred_mask'][index], bool)
            n = int(kept.sum())
            boxes = np.asarray(pred_dicts['pred_boxes'][index])[kept]
            scores = np.asarray(pred_dicts['pred_scores'][index])[kept]
            labels = np.asarray(pred_dicts['pred_labels'][index])[kept].astype(int)
            single = {
                'name': np.array(class_names)[labels - 1] if n else np.zeros(0),
                'score': scores, 'boxes_lidar': boxes, 'pred_labels': labels,
                'frame_id': batch_dict['frame_id'][index],
                'metadata': batch_dict['metadata'][index]
                if 'metadata' in batch_dict else None,
            }
            annos.append(single)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        eval_metric = kwargs.get('eval_metric', 'nuscenes')
        if eval_metric == 'kitti':
            return self._kitti_style_eval(det_annos, class_names)
        try:
            from nuscenes.nuscenes import NuScenes  # noqa: F401
        except ImportError:
            return ('nuscenes-devkit not installed; install it for official '
                    'NDS/mAP evaluation (falling back to no metric)'), {}
        return self._nuscenes_official_eval(det_annos, class_names, **kwargs)

    def _kitti_style_eval(self, det_annos, class_names):
        """The official KITTI protocol over the NuScenes boxes, in a
        camera frame of fixed axes with a 50-pixel image box, for the
        classes the protocol knows."""
        from ..kitti.kitti_object_eval import eval as kitti_eval

        def to_kitti(anno, boxes):
            n = len(boxes)
            return {
                'name': anno['name'], 'truncated': np.zeros(n),
                'occluded': np.zeros(n, np.int64), 'alpha': np.full(n, -10.0),
                'bbox': np.tile([0, 0, 50, 50], (n, 1)).astype(np.float64),
                'dimensions': boxes[:, [3, 5, 4]] if n else np.zeros((0, 3)),
                'location': np.stack([-boxes[:, 1], -boxes[:, 2], boxes[:, 0]],
                                     axis=1) if n else np.zeros((0, 3)),
                'rotation_y': -boxes[:, 6] - np.pi / 2 if n else np.zeros(0),
                'score': anno.get('score', np.ones(n)),
            }

        gt_annos = []
        for info in self.infos:
            boxes = info['gt_boxes'][:, :7]
            gt_annos.append(to_kitti({'name': info['gt_names']}, boxes))
        # annos past the infos' count are the last batch's padding
        dt_annos = [to_kitti(a, np.asarray(a['boxes_lidar'])[:, :7]
                             if len(a['boxes_lidar']) else np.zeros((0, 7)))
                    for a in det_annos[:len(self.infos)]]
        present = [kitti_eval.CLASS_NAMES_EVAL.index(c.lower())
                   for c in class_names
                   if c.lower() in kitti_eval.CLASS_NAMES_EVAL]
        if not present:
            return 'no kitti-protocol-evaluable classes', {}
        return kitti_eval.get_official_eval_result(gt_annos, dt_annos, present)

    def _nuscenes_official_eval(self, det_annos, class_names, **kwargs):
        """The devkit's detection eval (nuscenes_dataset.py:202-236): the
        detections in the global frame as the results JSON, then
        ``NuScenesEval`` under ``detection_cvpr_2019``; returns
        ``format_nuscene_results`` of its summary."""
        import json

        from nuscenes.nuscenes import NuScenes

        from . import nuscenes_utils
        nusc = NuScenes(version=self.dataset_cfg['VERSION'],
                        dataroot=str(self.root_path), verbose=True)
        # annos past the infos' count are the last batch's padding
        nusc_annos = nuscenes_utils.transform_det_annos_to_nusc_annos(
            det_annos[:len(self.infos)], nusc)
        nusc_annos['meta'] = {'use_camera': False, 'use_lidar': True,
                              'use_radar': False, 'use_map': False,
                              'use_external': False}
        output_path = Path(kwargs.get('output_path', '.'))
        output_path.mkdir(exist_ok=True, parents=True)
        res_path = str(output_path / 'results_nusc.json')
        with open(res_path, 'w') as f:
            json.dump(nusc_annos, f)
        if self.dataset_cfg['VERSION'] == 'v1.0-test':
            return 'No ground-truth annotations for evaluation', {}

        from nuscenes.eval.detection.config import config_factory
        from nuscenes.eval.detection.evaluate import NuScenesEval
        eval_set_map = {'v1.0-mini': 'mini_val', 'v1.0-trainval': 'val',
                        'v1.0-test': 'test'}
        eval_config = config_factory('detection_cvpr_2019')
        nusc_eval = NuScenesEval(
            nusc, config=eval_config, result_path=res_path,
            eval_set=eval_set_map[self.dataset_cfg['VERSION']],
            output_dir=str(output_path), verbose=True)
        nusc_eval.main(plot_examples=0, render_curves=False)
        with open(output_path / 'metrics_summary.json', 'r') as f:
            metrics = json.load(f)
        return nuscenes_utils.format_nuscene_results(
            metrics, self.class_names, version='detection_cvpr_2019')

    def create_groundtruth_database(self, rng, used_classes=None,
                                    max_sweeps=10):
        """(nuscenes_dataset.py:252-290); the sweeps drawn from `rng`."""
        database_save_path = self.root_path / \
            f'gt_database_{max_sweeps}sweeps_withvelo'
        db_info_save_path = self.root_path / \
            f'nuscenes_dbinfos_{max_sweeps}sweeps_withvelo.pkl'
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        for idx in range(len(self.infos)):
            print(f'gt_database sample: {idx + 1}/{len(self.infos)}')
            info = self.infos[idx]
            points = self.get_lidar_with_sweeps(idx, rng, max_sweeps=max_sweeps)
            gt_boxes = info['gt_boxes']
            gt_names = info['gt_names']
            inside = npg.points_in_boxes(points[:, 0:3], gt_boxes[:, :7])
            for i in range(gt_boxes.shape[0]):
                filename = f"{Path(info['lidar_path']).stem}_{gt_names[i]}_{i}.bin"
                filepath = database_save_path / filename
                gt_points = points[inside[:, i]]
                gt_points[:, :3] -= gt_boxes[i, :3]
                with open(filepath, 'w') as f:
                    gt_points.tofile(f)
                if used_classes is None or gt_names[i] in used_classes:
                    db_info = {
                        'name': gt_names[i],
                        'path': str(filepath.relative_to(self.root_path)),
                        'image_idx': idx, 'gt_idx': i,
                        'box3d_lidar': gt_boxes[i],
                        'num_points_in_gt': gt_points.shape[0],
                    }
                    all_db_infos.setdefault(gt_names[i], []).append(db_info)
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)
