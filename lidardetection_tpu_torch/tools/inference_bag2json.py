"""Detection and tracking over a folder of clouds, or synthetic scenes,
written as JSON (the counterpart of tools/inference_bag2json.py): a record
a frame with its time stamp (0.1 s apart), its kept detections (box,
score, label) and the tracker's objects (id, type, box).

    python -m lidardetection_tpu_torch.tools.inference_bag2json \\
        --data_path <folder of .bin> --ckpt <checkpoint_epoch_<n>.pth> \\
        --output output/detections.json

``--bag_file`` raises: reading a ROS bag needs rosbag and sensor_msgs,
which the port does not carry (ROADMAP.md section 1, "Not queued").
``run(args)`` returns the records; ``main`` writes them.
"""

import json
from pathlib import Path

from ..datasets.plusai.plusai_bag_dataset import ROS_NEEDED
from ..utils.common import create_logger
from . import common
from .inference import detect_and_track


def parse_args(argv=None):
    parser = common.base_parser('detections and tracks of frames as JSON')
    parser.add_argument('--bag_file', type=str, default=None)
    parser.add_argument('--data_path', type=str, default=None)
    parser.add_argument('--num_scenes', type=int, default=8)
    parser.add_argument('--output', type=str, default='output/detections.json')
    return parser.parse_args(argv)


def json_records(records):
    """The JSON records of ``detect_and_track``'s (tracked) records."""
    out = []
    for r in records:
        tracked = r['tracked']
        out.append({
            'timestamp': r['frame'].timestamp,
            'detections': [{'box': b.tolist(), 'score': float(s),
                            'label': int(label)}
                           for b, s, label in zip(r['boxes'], r['scores'],
                                                  r['labels'])],
            'tracked_objects': [
                {'id': int(tracked['object_ids'][k]),
                 'type': int(tracked['object_types'][k]),
                 'box': tracked['pred_boxes'][k].tolist()}
                for k in range(len(tracked['object_ids']))],
        })
    return out


def run(args, logger):
    if args.bag_file:
        raise ImportError(f'--bag_file: {ROS_NEEDED}')
    cfg, model = common.config_and_detector(args, logger)
    return json_records(detect_and_track(
        cfg, model, common.frames(cfg, args.data_path, args.num_scenes,
                                  logger=logger), with_tracking=True))


def main(argv=None):
    args = parse_args(argv)
    logger = create_logger()
    results = run(args, logger)
    for r in results:
        logger.info('t=%.2f: %d detections, %d tracks', r['timestamp'],
                    len(r['detections']), len(r['tracked_objects']))
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    with open(args.output, 'w') as f:
        json.dump(results, f, indent=1)
    logger.info('wrote %s (%d frames)', args.output, len(results))
    return results


if __name__ == '__main__':
    main()
