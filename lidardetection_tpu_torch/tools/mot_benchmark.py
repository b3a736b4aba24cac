"""The MOT benchmark (the counterpart of tools/mot_benchmark.py): over a run
of synthetic frames, the true positives, valid detections, valid gt boxes
and the front faces' longitudinal distance error, by BEV IoU threshold
(0.3, 0.5, 0.7) and range (20, 40, 60, 80 m), of the detections or, with
``--with_tracking``, of the tracker's boxes.

    python -m lidardetection_tpu_torch.tools.mot_benchmark --num_scenes 8 \\
        --with_tracking [--save_video output/mot.avi]

``get_metrics`` scores one frame (rotated BEV IoU by the KITTI protocol's
``bev_box_overlap``); ``run(args)`` returns the table (``table``: one row a
(IoU, range) pair with recall, precision and the mean distance error) and
the records of ``inference.detect_and_track``; ``main`` prints the table
and with ``--save_video`` writes a ``plot_multiframe_boxes`` canvas a frame
(cv2).
"""

import numpy as np

from ..datasets.kitti.kitti_object_eval.eval import bev_box_overlap
from ..utils.common import create_logger
from ..utils.data_viz import plot_multiframe_boxes, require
from . import common
from .inference import detect_and_track
from .inference_video import write_video

IOUS = (0.3, 0.5, 0.7)
DIST_RANGES = (20, 40, 60, 80)  # range bins, m


def get_metrics(gt_boxes, det_boxes, range_thres, iou_thres):
    """One frame's (true positives, valid detections, valid gt boxes, summed
    x-axis front-face distance error of the matched detections)."""
    num_valid_det = int((det_boxes[:, 0] <= range_thres).sum()) \
        if det_boxes.shape[0] else 0
    invalid_gt = gt_boxes[:, 0] > range_thres if gt_boxes.shape[0] else \
        np.zeros(0, bool)
    num_valid_gt = int((~invalid_gt).sum())
    tp, dist_err = 0, 0.0
    if not (gt_boxes.shape[0] and det_boxes.shape[0]):
        return tp, num_valid_det, num_valid_gt, dist_err

    gt_bev = gt_boxes[:, [0, 1, 3, 4, 6]]
    det_bev = det_boxes[:, [0, 1, 3, 4, 6]]
    overlaps = bev_box_overlap(gt_bev, det_bev)  # (G, D)
    if overlaps.shape[1]:
        reduced = overlaps.max(axis=1)
        reduced[invalid_gt] = 0
        tp = int((reduced >= iou_thres).sum())
        for idx in range(overlaps.shape[1]):
            if overlaps[:, idx].max() < iou_thres or \
                    det_boxes[idx, 0] > range_thres:
                continue
            det_front = det_boxes[idx, 0] - det_boxes[idx, 3] / 2
            g = overlaps[:, idx].argmax()
            gt_front = gt_boxes[g, 0] - gt_boxes[g, 3] / 2
            dist_err += abs(det_front - gt_front)
    return tp, num_valid_det, num_valid_gt, dist_err


def score_frames(records, with_tracking):
    """The benchmark's table over `records` (see the module docstring)."""
    shape = (len(IOUS), len(DIST_RANGES))
    totals = {k: np.zeros(shape) for k in ('tp', 'det', 'gt', 'err')}
    for r in records:
        det_boxes = r['tracked']['pred_boxes'] if with_tracking else r['boxes']
        for i, iou in enumerate(IOUS):
            for j, rng in enumerate(DIST_RANGES):
                tp, nd, ng, err = get_metrics(r['frame'].gt_boxes,
                                              np.asarray(det_boxes), rng, iou)
                totals['tp'][i, j] += tp
                totals['det'][i, j] += nd
                totals['gt'][i, j] += ng
                totals['err'][i, j] += err
    table = []
    for i, iou in enumerate(IOUS):
        for j, rng in enumerate(DIST_RANGES):
            tp = totals['tp'][i, j]
            table.append({'iou': iou, 'range': rng,
                          'recall': tp / max(totals['gt'][i, j], 1),
                          'precision': tp / max(totals['det'][i, j], 1),
                          'dist_err': totals['err'][i, j] / max(tp, 1),
                          'tp': int(tp), 'det': int(totals['det'][i, j]),
                          'gt': int(totals['gt'][i, j])})
    return table


def parse_args(argv=None):
    parser = common.base_parser('MOT metrics over synthetic frames')
    parser.add_argument('--num_scenes', type=int, default=8)
    parser.add_argument('--with_tracking', action='store_true')
    parser.add_argument('--save_video', type=str, default=None,
                        help='write a BEV canvas a frame to this .avi')
    return parser.parse_args(argv)


def run(args, logger):
    cfg, model = common.config_and_detector(args, logger)
    records = detect_and_track(cfg, model,
                               common.synthetic_frames(cfg, args.num_scenes),
                               args.with_tracking)
    return score_frames(records, args.with_tracking), records


def main(argv=None):
    args = parse_args(argv)
    if args.save_video:
        require('cv2', 'the MOT video')
    logger = create_logger()
    bev_range = common.load_config(args.cfg_file)['DATA_CONFIG']['POINT_CLOUD_RANGE']
    table, records = run(args, logger)
    for row in table:
        logger.info('iou %.1f range <%dm: recall %.3f precision %.3f '
                    'dist_err %.3fm', row['iou'], row['range'], row['recall'],
                    row['precision'], row['dist_err'])
    if args.save_video and records:
        canvases = [plot_multiframe_boxes(
            r['frame'].points,
            (r['tracked']['pred_boxes'] if args.with_tracking
             else r['boxes'])[:, :7],
            bev_range, gt_boxes=r['frame'].gt_boxes,
            scores=np.round(r['scores'], 2), labels=r['labels'])
            for r in records]
        write_video(canvases, args.save_video, 5)
        logger.info('video written: %s (%d frames)', args.save_video,
                    len(canvases))
    return table


if __name__ == '__main__':
    main()
