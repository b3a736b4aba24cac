"""NuScenes info generation and the bridge to the official evaluation
(copy of lidardetection_tpu/datasets/nuscenes/nuscenes_utils.py, itself
pcdet/datasets/nuscenes/nuscenes_utils.py). Every nuscenes-devkit and
pyquaternion import is made inside the function that needs it, as in the
JAX package: the devkit is needed only to create infos from raw NuScenes
(``create_nuscenes_info``) and for the official NDS / mAP evaluation
(``NuScenesDataset._nuscenes_official_eval``).
"""

from functools import reduce
from pathlib import Path

import numpy as np

map_name_from_general_to_detection = {
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.wheelchair': 'ignore',
    'human.pedestrian.stroller': 'ignore',
    'human.pedestrian.personal_mobility': 'ignore',
    'human.pedestrian.police_officer': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'animal': 'ignore',
    'vehicle.car': 'car',
    'vehicle.motorcycle': 'motorcycle',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.truck': 'truck',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.emergency.ambulance': 'ignore',
    'vehicle.emergency.police': 'ignore',
    'vehicle.trailer': 'trailer',
    'movable_object.barrier': 'barrier',
    'movable_object.trafficcone': 'traffic_cone',
    'movable_object.pushable_pullable': 'ignore',
    'movable_object.debris': 'ignore',
    'static_object.bicycle_rack': 'ignore',
}

# most-frequent attribute per class (nuscenes_utils.py:43-155), used as the
# fallback attribute for detections
cls_default_attr = {
    'car': 'vehicle.parked',
    'truck': 'vehicle.parked',
    'construction_vehicle': 'vehicle.parked',
    'bus': 'vehicle.stopped',
    'trailer': 'vehicle.parked',
    'barrier': '',
    'motorcycle': 'cycle.without_rider',
    'bicycle': 'cycle.without_rider',
    'pedestrian': 'pedestrian.standing',
    'traffic_cone': '',
}


def quaternion_yaw(q):
    """(nuscenes_utils.py:234-249)."""
    v = np.dot(q.rotation_matrix, np.array([1, 0, 0]))
    return np.arctan2(v[1], v[0])


def get_available_scenes(nusc):
    """(nuscenes_utils.py:157-182)."""
    available = []
    for scene in nusc.scene:
        sample_rec = nusc.get('sample', scene['first_sample_token'])
        sd_rec = nusc.get('sample_data', sample_rec['data']['LIDAR_TOP'])
        lidar_path, _, _ = nusc.get_sample_data(sd_rec['token'])
        if Path(lidar_path).exists():
            available.append(scene)
    return available


def get_sample_data(nusc, sample_data_token, selected_anntokens=None):
    """Sensor-frame boxes for a sample_data (nuscenes_utils.py:185-231)."""
    from pyquaternion import Quaternion

    sd_record = nusc.get('sample_data', sample_data_token)
    cs_record = nusc.get('calibrated_sensor', sd_record['calibrated_sensor_token'])
    pose_record = nusc.get('ego_pose', sd_record['ego_pose_token'])
    data_path = nusc.get_sample_data_path(sample_data_token)
    boxes = (list(map(nusc.get_box, selected_anntokens))
             if selected_anntokens is not None
             else nusc.get_boxes(sample_data_token))
    box_list = []
    for box in boxes:
        box.velocity = nusc.box_velocity(box.token)
        box.translate(-np.array(pose_record['translation']))
        box.rotate(Quaternion(pose_record['rotation']).inverse)
        box.translate(-np.array(cs_record['translation']))
        box.rotate(Quaternion(cs_record['rotation']).inverse)
        box_list.append(box)
    return data_path, box_list, None


def fill_trainval_infos(data_path, nusc, train_scenes, val_scenes, test=False,
                        max_sweeps=10):
    """Per-sample info dicts incl. sweep transform chains
    (nuscenes_utils.py:252-380)."""
    from nuscenes.utils.geometry_utils import transform_matrix
    from pyquaternion import Quaternion

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        ref_sd_token = sample['data']['LIDAR_TOP']
        ref_sd_rec = nusc.get('sample_data', ref_sd_token)
        ref_cs_rec = nusc.get('calibrated_sensor',
                              ref_sd_rec['calibrated_sensor_token'])
        ref_pose_rec = nusc.get('ego_pose', ref_sd_rec['ego_pose_token'])
        ref_time = 1e-6 * ref_sd_rec['timestamp']
        ref_lidar_path, ref_boxes, _ = get_sample_data(nusc, ref_sd_token)

        ref_from_car = transform_matrix(
            ref_cs_rec['translation'], Quaternion(ref_cs_rec['rotation']),
            inverse=True)
        car_from_global = transform_matrix(
            ref_pose_rec['translation'], Quaternion(ref_pose_rec['rotation']),
            inverse=True)

        info = {
            'lidar_path': str(Path(ref_lidar_path).relative_to(data_path)),
            'token': sample['token'],
            'sweeps': [],
            'ref_from_car': ref_from_car,
            'car_from_global': car_from_global,
            'timestamp': ref_time,
        }

        curr_sd_rec = nusc.get('sample_data', sample['data']['LIDAR_TOP'])
        sweeps = []
        while len(sweeps) < max_sweeps - 1:
            if curr_sd_rec['prev'] == '':
                if len(sweeps) == 0:
                    sweeps.append({
                        'lidar_path': info['lidar_path'],
                        'sample_data_token': curr_sd_rec['token'],
                        'transform_matrix': None,
                        'time_lag': 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr_sd_rec = nusc.get('sample_data', curr_sd_rec['prev'])
                current_pose_rec = nusc.get('ego_pose',
                                            curr_sd_rec['ego_pose_token'])
                global_from_car = transform_matrix(
                    current_pose_rec['translation'],
                    Quaternion(current_pose_rec['rotation']), inverse=False)
                current_cs_rec = nusc.get(
                    'calibrated_sensor', curr_sd_rec['calibrated_sensor_token'])
                car_from_current = transform_matrix(
                    current_cs_rec['translation'],
                    Quaternion(current_cs_rec['rotation']), inverse=False)
                tm = reduce(np.dot, [ref_from_car, car_from_global,
                                     global_from_car, car_from_current])
                lidar_path = nusc.get_sample_data_path(curr_sd_rec['token'])
                sweeps.append({
                    'lidar_path': str(Path(lidar_path).relative_to(data_path)),
                    'sample_data_token': curr_sd_rec['token'],
                    'transform_matrix': tm,
                    'time_lag': ref_time - 1e-6 * curr_sd_rec['timestamp'],
                })
        info['sweeps'] = sweeps

        if not test:
            annotations = [nusc.get('sample_annotation', token)
                           for token in sample['anns']]
            num_lidar_pts = np.array([a['num_lidar_pts'] for a in annotations])
            num_radar_pts = np.array([a['num_radar_pts'] for a in annotations])
            mask = num_lidar_pts + num_radar_pts > 0
            locs = np.array([b.center for b in ref_boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in ref_boxes]).reshape(-1, 3)[:, [1, 0, 2]]
            velocity = np.array([b.velocity for b in ref_boxes]).reshape(-1, 3)
            rots = np.array([quaternion_yaw(b.orientation)
                             for b in ref_boxes]).reshape(-1, 1)
            names = np.array([b.name for b in ref_boxes])
            tokens = np.array([b.token for b in ref_boxes])
            gt_boxes = np.concatenate([locs, dims, rots, velocity[:, :2]], axis=1)
            info['gt_boxes'] = gt_boxes[mask]
            info['gt_boxes_velocity'] = velocity[mask]
            info['gt_names'] = np.array(
                [map_name_from_general_to_detection[n] for n in names])[mask]
            info['gt_boxes_token'] = tokens[mask]
            info['num_lidar_pts'] = num_lidar_pts[mask]
            info['num_radar_pts'] = num_radar_pts[mask]

        if sample['scene_token'] in train_scenes:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def boxes_lidar_to_nusenes(det_info):
    """(nuscenes_utils.py:383-399)."""
    from nuscenes.utils.data_classes import Box
    from pyquaternion import Quaternion

    boxes3d = det_info['boxes_lidar']
    scores = det_info['score']
    labels = det_info['pred_labels']
    box_list = []
    for k in range(boxes3d.shape[0]):
        quat = Quaternion(axis=[0, 0, 1], radians=boxes3d[k, 6])
        velocity = (*boxes3d[k, 7:9], 0.0) if boxes3d.shape[1] == 9 \
            else (0.0, 0.0, 0.0)
        box_list.append(Box(boxes3d[k, :3], boxes3d[k, [4, 3, 5]], quat,
                            label=labels[k], score=scores[k],
                            velocity=velocity))
    return box_list


def lidar_nusc_box_to_global(nusc, boxes, sample_token):
    """(nuscenes_utils.py:401-420)."""
    from pyquaternion import Quaternion

    s_record = nusc.get('sample', sample_token)
    sd_record = nusc.get('sample_data', s_record['data']['LIDAR_TOP'])
    cs_record = nusc.get('calibrated_sensor',
                         sd_record['calibrated_sensor_token'])
    pose_record = nusc.get('ego_pose', sd_record['ego_pose_token'])
    box_list = []
    for box in boxes:
        box.rotate(Quaternion(cs_record['rotation']))
        box.translate(np.array(cs_record['translation']))
        box.rotate(Quaternion(pose_record['rotation']))
        box.translate(np.array(pose_record['translation']))
        box_list.append(box)
    return box_list


def transform_det_annos_to_nusc_annos(det_annos, nusc):
    """(nuscenes_utils.py:423-468)."""
    nusc_annos = {'results': {}, 'meta': None}
    for det in det_annos:
        annos = []
        box_list = lidar_nusc_box_to_global(
            nusc, boxes_lidar_to_nusenes(det),
            sample_token=det['metadata']['token'])
        for k, box in enumerate(box_list):
            name = det['name'][k]
            if np.sqrt(box.velocity[0] ** 2 + box.velocity[1] ** 2) > 0.2:
                if name in ['car', 'construction_vehicle', 'bus', 'truck',
                            'trailer']:
                    attr = 'vehicle.moving'
                elif name in ['bicycle', 'motorcycle']:
                    attr = 'cycle.with_rider'
                else:
                    attr = None
            else:
                if name == 'pedestrian':
                    attr = 'pedestrian.standing'
                elif name == 'bus':
                    attr = 'vehicle.stopped'
                else:
                    attr = None
            attr = attr if attr is not None else cls_default_attr[name]
            annos.append({
                'sample_token': det['metadata']['token'],
                'translation': box.center.tolist(),
                'size': box.wlh.tolist(),
                'rotation': box.orientation.elements.tolist(),
                'velocity': box.velocity[:2].tolist(),
                'detection_name': name,
                'detection_score': box.score,
                'attribute_name': attr,
            })
        nusc_annos['results'][det['metadata']['token']] = annos
    return nusc_annos


def format_nuscene_results(metrics, class_names, version='default'):
    """(nuscenes_utils.py:471-520)."""
    result = f'----------------Nuscene {version} results-----------------\n'
    for name in class_names:
        threshs = ', '.join(metrics['label_aps'][name].keys())
        ap_list = list(metrics['label_aps'][name].values())
        err_name = ', '.join(x.split('_')[0]
                             for x in metrics['label_tp_errors'][name].keys())
        error_list = list(metrics['label_tp_errors'][name].values())
        result += f'***{name} error@{err_name} | AP@{threshs}\n'
        result += ', '.join('%.2f' % x for x in error_list) + ' | '
        result += ', '.join('%.2f' % (x * 100) for x in ap_list)
        result += f" | mean AP: {metrics['mean_dist_aps'][name]}\n"
    result += '--------------average performance-------------\n'
    details = {}
    for key, val in metrics['tp_errors'].items():
        result += '%s:\t %.4f\n' % (key, val)
        details[key] = val
    result += 'mAP:\t %.4f\n' % metrics['mean_ap']
    result += 'NDS:\t %.4f\n' % metrics['nd_score']
    details.update({'mAP': metrics['mean_ap'], 'NDS': metrics['nd_score']})
    return result, details


def create_nuscenes_info(version, data_path, save_path, max_sweeps=10):
    """Info pkl creation entry point (nuscenes_dataset.py:293-330)."""
    import pickle

    from nuscenes.nuscenes import NuScenes
    from nuscenes.utils import splits

    assert version in ('v1.0-trainval', 'v1.0-test', 'v1.0-mini')
    if version == 'v1.0-trainval':
        train_scenes, val_scenes = splits.train, splits.val
    elif version == 'v1.0-test':
        train_scenes, val_scenes = splits.test, []
    else:
        train_scenes, val_scenes = splits.mini_train, splits.mini_val

    nusc = NuScenes(version=version, dataroot=str(data_path / version),
                    verbose=True)
    available_scenes = get_available_scenes(nusc)
    names = [s['name'] for s in available_scenes]
    train_scenes = set(s['token'] for s in available_scenes
                       if s['name'] in train_scenes)
    val_scenes = set(s['token'] for s in available_scenes
                     if s['name'] in val_scenes)
    del names

    train_infos, val_infos = fill_trainval_infos(
        data_path=data_path / version, nusc=nusc, train_scenes=train_scenes,
        val_scenes=val_scenes, test=(version == 'v1.0-test'),
        max_sweeps=max_sweeps)
    if version == 'v1.0-test':
        with open(save_path / f'nuscenes_infos_{max_sweeps}sweeps_test.pkl', 'wb') as f:
            pickle.dump(train_infos, f)
    else:
        with open(save_path / f'nuscenes_infos_{max_sweeps}sweeps_train.pkl', 'wb') as f:
            pickle.dump(train_infos, f)
        with open(save_path / f'nuscenes_infos_{max_sweeps}sweeps_val.pkl', 'wb') as f:
            pickle.dump(val_infos, f)
