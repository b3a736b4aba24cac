"""3D pictures of detections over a folder of clouds, or synthetic scenes
(the counterpart of tools/demo_3d.py's ``--offscreen`` path): a PNG a scene
of the cloud and the detections above ``--score_thresh`` as wireframes
(``LaserDetVis.render_offscreen``, matplotlib).

    python -m lidardetection_tpu_torch.tools.demo_3d --offscreen \\
        --cfg_file tools/cfgs/kitti_models/second.yaml --synthetic \\
        --save_dir demo_3d_out

Without ``--offscreen`` it raises: the interactive viewer needs vispy
(``visual_utils/laserdetvis.py``). ``run(args)`` returns a record a scene:
its cloud and the kept ``boxes``, ``scores`` and ``labels`` above the
threshold, and ``detections``, the count before it.
"""

from pathlib import Path

from ..utils.common import create_logger
from ..utils.data_viz import require
from ..utils.tracker_for_inference import kept_detections
from . import common
from .visual_utils.laserdetvis import LaserDetVis


def parse_args(argv=None):
    parser = common.base_parser('3D pictures of detections',
                                cfg_file='tools/cfgs/kitti_models/second.yaml')
    parser.add_argument('--data_path', type=str, default=None,
                        help='a cloud file or a folder of .bin / .npy')
    parser.add_argument('--ext', type=str, default='.bin')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--num_scenes', type=int, default=8)
    parser.add_argument('--offscreen', action='store_true',
                        help='write PNGs (the only path of the port)')
    parser.add_argument('--save_dir', type=str, default='demo_3d_out')
    parser.add_argument('--score_thresh', type=float, default=0.3)
    return parser.parse_args(argv)


def run(args, logger):
    cfg, model = common.config_and_detector(args, logger)
    data_path = None if args.synthetic else args.data_path
    predictor = common.Predictor(model, cfg)
    records = []
    for frame in common.frames(cfg, data_path, args.num_scenes, args.ext,
                               logger):
        boxes, scores, labels = kept_detections(predictor.predict(frame.batch))
        keep = scores >= args.score_thresh
        records.append({'points': frame.points, 'boxes': boxes[keep],
                        'scores': scores[keep], 'labels': labels[keep],
                        'detections': len(boxes)})
    if not records:
        raise SystemExit('no input scenes')
    return records


def main(argv=None):
    args = parse_args(argv)
    if not args.offscreen:
        LaserDetVis()  # raises: the viewer needs vispy
    require('matplotlib', 'the 3D PNGs')
    logger = create_logger()
    records = run(args, logger)
    out = Path(args.save_dir)
    out.mkdir(parents=True, exist_ok=True)
    plt = require('matplotlib.pyplot', 'the 3D PNGs')
    for i, r in enumerate(records):
        logger.info('scene %d: %d/%d detections above %.2f', i,
                    len(r['boxes']), r['detections'], args.score_thresh)
        fig = LaserDetVis.render_offscreen(
            r['points'], boxes=r['boxes'], scores=r['scores'],
            labels=r['labels'], save_path=str(out / f'scene_{i:04d}.png'))
        plt.close(fig)
    logger.info('wrote %d PNGs to %s', len(records), out)
    return records


if __name__ == '__main__':
    main()
