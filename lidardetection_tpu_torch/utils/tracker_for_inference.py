"""Inference-time multi-object tracker (copy of
lidardetection_tpu/utils/tracker_for_inference.py, numpy float64).

A constant-velocity Kalman filter on (x, y) a track (F the CV model, Q =
0.03 I, R = I), median length and width smoothing beyond 8 m, greedy
association by lateral distance, and an age / lose-tracking lifecycle.

``TrackingManager.update_tracking`` takes the port's prediction dict of
sample 0 (``models/detectors/post_processing.py``, as numpy or tensors):
it reads the rows that ``pred_mask`` marks, where the JAX package reads
the first ``num_preds`` (the multi-class NMS leaves gaps between the kept
rows).
"""

import copy

import numpy as np


class SimpleKalmanFilter:
    """Constant-velocity [x, y, vx, vy] filter: pykalman's KalmanFilter with
    transition_covariance = 0.03 I and its default observation
    covariance."""

    F = np.array([[1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0], [0, 0, 0, 1]],
                 dtype=np.float64)
    H = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], dtype=np.float64)
    Q = 0.03 * np.eye(4)
    R = np.eye(2)

    def filter_update(self, mean, cov, observation):
        mean = self.F @ mean
        cov = self.F @ cov @ self.F.T + self.Q
        innov = np.asarray(observation, np.float64) - self.H @ mean
        s = self.H @ cov @ self.H.T + self.R
        k = cov @ self.H.T @ np.linalg.inv(s)
        mean = mean + k @ innov
        cov = (np.eye(4) - k @ self.H) @ cov
        return mean, cov


class DetectedObject:
    def __init__(self, pred_box, name, score):
        self.loc = np.array(pred_box[:3], np.float64)
        self.dims = np.array(pred_box[3:6], np.float64)
        self.rotz = np.float64(pred_box[6])
        self.type = name
        self.score = score

    def __repr__(self):
        return (f'[Detected Object] location: {self.loc} | size: {self.dims} '
                f'| rotz: {self.rotz} | score: {self.score}')


class ObjectTracker:
    """One object's track."""

    def __init__(self, det_object, track_id):
        self.loc = det_object.loc.copy()
        self.dims = det_object.dims.copy()
        self.rotz = det_object.rotz
        self.type = det_object.type
        self.reliability = det_object.score
        self.velo = [0.0, 0.0]
        self.real_path = [self.loc[:2].copy()]
        self.predicted_path = [self.loc[:2].copy()]
        self.dims_history = [det_object.dims.copy()]
        self.track_id = track_id
        self.new_object = True
        self.updated = False
        self.predicted = False
        self.age = 1
        self.lose_tracking = 0
        self.kf = SimpleKalmanFilter()
        self.filtered_state_means = np.zeros(4)
        self.filtered_state_covariances = np.eye(4)
        self.delta_t = 0.1
        self.max_dims_track_range = 7
        self.length_diff_ratio_thres = 0.2
        self.no_dims_filter_range = 8

    def update(self, det_object):
        if abs(det_object.dims[0] - self.dims[0]) / self.dims[0] > \
                self.length_diff_ratio_thres \
                and self.loc[0] > self.no_dims_filter_range:
            # keep the smoothed length: move the centre so the rear face stays
            self.loc[0] = det_object.loc[0] - det_object.dims[0] / 2 + self.dims[0] / 2
            self.loc[1:3] = det_object.loc[1:3]
        else:
            self.loc = det_object.loc.copy()
        self.rotz = det_object.rotz
        self.type = det_object.type
        self.reliability = det_object.score
        self.velo = [(self.loc[0] - self.real_path[-1][0]) / self.delta_t,
                     (self.loc[1] - self.real_path[-1][1]) / self.delta_t]
        self.real_path.append(det_object.loc[:2].copy())
        self.dims_history.append(det_object.dims.copy())
        self.dimension_filter()
        self.new_object = False
        self.updated = True
        self.predicted = False
        self.age += 1
        self.lose_tracking = 0
        self.filtered_state_means, self.filtered_state_covariances = \
            self.kf.filter_update(self.filtered_state_means,
                                  self.filtered_state_covariances,
                                  self.loc[:2])

    def update_with_prediction(self):
        self.age += 1
        self.new_object = False
        self.updated = False
        self.predicted = True
        self.loc[0] += self.velo[0] * self.delta_t
        self.loc[1] += self.velo[1] * self.delta_t
        self.filtered_state_means, self.filtered_state_covariances = \
            self.kf.filter_update(self.filtered_state_means,
                                  self.filtered_state_covariances,
                                  self.loc[:2])
        self.real_path.append(self.loc[:2].copy())
        self.predicted_path.append(self.loc[:2].copy())

    def dimension_filter(self):
        """Median length and width over the recent detections, beyond
        no_dims_filter_range."""
        self.dims = copy.deepcopy(self.dims_history[-1])
        if self.loc[0] <= self.no_dims_filter_range:
            return
        l_range = min(len(self.dims_history), 2 * self.max_dims_track_range)
        w_range = min(len(self.dims_history), self.max_dims_track_range)
        if len(self.dims_history) >= 3:
            median_l = np.median([d[0] for d in self.dims_history[-l_range:]])
            median_w = np.median([d[1] for d in self.dims_history[-w_range:]])
            if abs(median_l - self.dims[0]) / self.dims[0] > \
                    self.length_diff_ratio_thres:
                self.dims[0] = median_l
                self.dims[1] = median_w

    def __repr__(self):
        status = 'Updated' if self.updated else \
            'Predicted' if self.predicted else 'Unknown'
        return (f'[Object {self.track_id}] location: {self.loc} | '
                f'size: {self.dims} | status: {status} | age: {self.age} | '
                f'lose tracking: {self.lose_tracking}')


def kept_detections(pred_dicts, index=0):
    """(boxes, scores, labels) of sample `index`'s kept rows, those that
    ``pred_mask`` marks, as numpy."""
    def host(key):
        value = pred_dicts[key][index]
        return value.cpu().numpy() if hasattr(value, 'cpu') else np.asarray(value)

    kept = host('pred_mask').astype(bool)
    return host('pred_boxes')[kept], host('pred_scores')[kept], \
        host('pred_labels')[kept]


class TrackingManager:
    """Greedy lateral association over the tracks of a stream of frames."""

    def __init__(self, config):
        self.tracker_list = []
        self.detected_object_list = []
        self.class_names = config['CLASS_NAMES']
        self.track_id = 0
        self.dist_thres_longitudinal = 5
        self.dist_thres_lateral = 0.8
        self.start_tracking_score_thres = 0.5
        self.lose_tracking_thres = 3
        self.age_thres_of_object = 3
        self.age_thres_for_prediction = 2
        self.side_range_limit = 8
        self.filter_missdetection_thres = 2

    def create_det_object_list(self, pred_dicts):
        """The kept detections of sample 0 within the side range."""
        det_boxes, det_scores, det_labels = kept_detections(pred_dicts)
        self.detected_object_list = []
        for i in range(len(det_boxes)):
            if abs(det_boxes[i, 1]) > self.side_range_limit:
                continue
            self.detected_object_list.append(
                DetectedObject(det_boxes[i], det_labels[i], det_scores[i]))

    def get_tracked_objects(self):
        info = {'object_ids': [], 'object_types': [], 'pred_boxes': []}
        for t in self.tracker_list:
            if t.age < self.age_thres_of_object:
                continue
            box = np.concatenate((t.loc, t.dims, np.atleast_1d(t.rotz)))
            info['pred_boxes'].append(box)
            info['object_ids'].append(t.track_id)
            info['object_types'].append(t.type)
        info['pred_boxes'] = np.array(info['pred_boxes'], np.float64) \
            if info['pred_boxes'] else np.zeros((0, 7))
        info['object_ids'] = np.array(info['object_ids'], np.int64)
        return info

    def update_tracking(self, pred_dicts):
        self.create_det_object_list(pred_dicts)

        for tracked in self.tracker_list:
            tracked.updated = False
            min_lat = 10
            closest = None
            for det in self.detected_object_list[:]:
                lat = abs(tracked.loc[1] - det.loc[1])
                if lat < min_lat:
                    min_lat = lat
                    closest = det
            if closest is None:
                continue
            if abs(tracked.loc[0] - closest.loc[0]) <= self.dist_thres_longitudinal:
                tracked.update(closest)
                self.detected_object_list.remove(closest)

        for tracked in self.tracker_list:
            if tracked.updated:
                continue
            if tracked.age >= self.age_thres_for_prediction:
                tracked.update_with_prediction()
            tracked.lose_tracking += 1

        for det in self.detected_object_list:
            if det.score >= self.start_tracking_score_thres:
                self.tracker_list.append(ObjectTracker(det, self.track_id))
                self.track_id += 1

        for tracked in self.tracker_list[:]:
            if tracked.updated or tracked.new_object:
                continue
            if tracked.lose_tracking >= self.lose_tracking_thres or \
                    tracked.age - tracked.lose_tracking <= \
                    self.filter_missdetection_thres:
                self.tracker_list.remove(tracked)

        return self.get_tracked_objects()
