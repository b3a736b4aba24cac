"""Detection over a folder of clouds, or over synthetic scenes (the
counterpart of tools/demo.py): each scene's kept detections and its
milliseconds (host clock, the batch to the card, the eval step and the
predictions back on the host) are logged.

    python -m lidardetection_tpu_torch.tools.demo \\
        --cfg_file tools/cfgs/kitti_models/pointpillar.yaml \\
        --data_path <folder of .bin> --ckpt <checkpoint_epoch_<n>.pth>
    python -m lidardetection_tpu_torch.tools.demo --synthetic --num_scenes 4

``run(args)`` returns a record a scene: its index, the kept ``boxes``,
``scores`` and ``labels``, ``ms`` and ``num_gt``.
"""

from ..utils.common import create_logger
from ..utils.tracker_for_inference import kept_detections
from . import common


def parse_args(argv=None):
    parser = common.base_parser('detect objects in a folder of clouds')
    parser.add_argument('--data_path', type=str, default=None,
                        help='a cloud file or a folder of .bin / .npy')
    parser.add_argument('--synthetic', action='store_true',
                        help='run on synthetic scenes')
    parser.add_argument('--num_scenes', type=int, default=4)
    parser.add_argument('--ext', type=str, default='.bin')
    return parser.parse_args(argv)


def run(args, logger):
    cfg, model = common.config_and_detector(args, logger)
    data_path = None if args.synthetic else args.data_path
    predictor = common.Predictor(model, cfg)
    records = []
    for i, frame in enumerate(common.frames(cfg, data_path, args.num_scenes,
                                            args.ext, logger)):
        preds, ms = common.timed(predictor.predict, frame.batch)
        boxes, scores, labels = kept_detections(preds)
        records.append({'scene': i, 'boxes': boxes, 'scores': scores,
                        'labels': labels, 'ms': ms,
                        'num_gt': None if frame.gt_boxes is None
                        else len(frame.gt_boxes)})
    return records


def main(argv=None):
    args = parse_args(argv)
    logger = create_logger()
    classes = common.load_config(args.cfg_file)['CLASS_NAMES']
    records = run(args, logger)
    for r in records:
        logger.info('scene %d: %d detections (%.1f ms)', r['scene'],
                    len(r['boxes']), r['ms'])
        for b, s, label in list(zip(r['boxes'], r['scores'], r['labels']))[:10]:
            logger.info('  %-10s score=%.3f xyz=(%.1f, %.1f, %.1f) '
                        'lwh=(%.1f, %.1f, %.1f) ry=%.2f',
                        classes[int(label) - 1], s, *b[:6], b[6])
        if r['num_gt'] is not None:
            logger.info('  (scene has %d gt boxes)', r['num_gt'])
    logger.info('demo done.')
    return records


if __name__ == '__main__':
    main()
