"""Detection over a run of frames with the Kalman tracker and BEV PNGs (the
counterpart of tools/inference.py).

    python -m lidardetection_tpu_torch.tools.inference --num_scenes 8 \\
        --with_tracking --output_dir output/inference
    python -m lidardetection_tpu_torch.tools.inference \\
        --data_path <folder of .bin> --ckpt <checkpoint_epoch_<n>.pth>

``run(args)`` returns a record a frame: the frame (cloud and gt boxes), its
kept ``boxes``, ``scores`` and ``labels``, the eval step's ``ms``, and with
``--with_tracking`` the tracker's output (``tracked``: ``object_ids``,
``object_types``, ``pred_boxes``) and its host ``tracker_ms``. ``main``
writes a PNG a frame, gt boxes against detections
(``utils/data_viz.py::plot_gt_det_cmp``, matplotlib).
"""

import time

from ..utils.common import create_logger
from ..utils.data_viz import plot_gt_det_cmp, require
from ..utils.tracker_for_inference import TrackingManager, kept_detections
from . import common


def parse_args(argv=None):
    parser = common.base_parser('detect and track over frames, BEV PNGs')
    parser.add_argument('--data_path', type=str, default=None,
                        help='a folder of .bin clouds; omit for synthetic '
                        'scenes')
    parser.add_argument('--num_scenes', type=int, default=4)
    parser.add_argument('--output_dir', type=str, default='output/inference')
    parser.add_argument('--with_tracking', action='store_true')
    return parser.parse_args(argv)


def detect_and_track(cfg, model, frames, with_tracking):
    """A record a frame (see the module docstring)."""
    predictor = common.Predictor(model, cfg)
    tracker = TrackingManager({'CLASS_NAMES': cfg['CLASS_NAMES']}) \
        if with_tracking else None
    records = []
    for frame in frames:
        preds, ms = common.timed(predictor.predict, frame.batch)
        boxes, scores, labels = kept_detections(preds)
        record = {'frame': frame, 'boxes': boxes, 'scores': scores,
                  'labels': labels, 'ms': ms}
        if tracker is not None:
            t0 = time.perf_counter()
            record['tracked'] = tracker.update_tracking(preds)
            record['tracker_ms'] = (time.perf_counter() - t0) * 1e3
        records.append(record)
    return records


def run(args, logger):
    cfg, model = common.config_and_detector(args, logger)
    return detect_and_track(
        cfg, model, common.frames(cfg, args.data_path, args.num_scenes,
                                  logger=logger), args.with_tracking)


def main(argv=None):
    args = parse_args(argv)
    require('matplotlib', 'the BEV PNGs')
    logger = create_logger()
    bev_range = common.load_config(args.cfg_file)['DATA_CONFIG']['POINT_CLOUD_RANGE']
    records = run(args, logger)
    for i, r in enumerate(records):
        logger.info('frame %d: %d detections (%.1f ms)', i, len(r['boxes']),
                    r['ms'])
        if 'tracked' in r:
            logger.info('  %d active tracks (tracker %.2f ms)',
                        len(r['tracked']['object_ids']), r['tracker_ms'])
        path = plot_gt_det_cmp(
            r['frame'].points[:, :3], r['frame'].gt_boxes, r['boxes'],
            bev_range, name=f'inference_{i:04d}', save_dir=args.output_dir,
            det_scores=r['scores'])
        logger.info('  BEV plot: %s', path)
    return records


if __name__ == '__main__':
    main()
