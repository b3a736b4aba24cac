"""Detection over a run of frames written as a BEV video (the counterpart of
tools/inference_video.py): a ``bev_canvas`` a frame (cv2), written as an
``.avi`` (cv2's MJPG writer) or, for an ``--output`` ending in ``.gif``,
an animated GIF (PIL).

    python -m lidardetection_tpu_torch.tools.inference_video \\
        --num_scenes 8 --output output/inference_video.avi

``run(args)`` returns ``inference.detect_and_track``'s records; ``main``
draws and writes them.
"""

from pathlib import Path

from ..utils.common import create_logger
from ..utils.data_viz import bev_canvas, require
from . import common
from .inference import detect_and_track


def parse_args(argv=None):
    parser = common.base_parser('detect over frames, write a BEV video')
    parser.add_argument('--data_path', type=str, default=None,
                        help='a folder of .bin clouds; omit for synthetic '
                        'scenes')
    parser.add_argument('--num_scenes', type=int, default=8)
    parser.add_argument('--output', type=str,
                        default='output/inference_video.avi')
    parser.add_argument('--fps', type=int, default=5)
    return parser.parse_args(argv)


def run(args, logger):
    cfg, model = common.config_and_detector(args, logger)
    return detect_and_track(
        cfg, model, common.frames(cfg, args.data_path, args.num_scenes,
                                  logger=logger), with_tracking=False)


def write_video(frames, path, fps):
    """uint8 BGR canvases -> `path`: an animated GIF (PIL) for ``.gif``,
    else an MJPG ``.avi`` (cv2)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    h, w = frames[0].shape[:2]
    if str(path).endswith('.gif'):
        image = require('PIL.Image', 'a GIF')
        imgs = [image.fromarray(f[..., ::-1]).convert('P') for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return
    cv2 = require('cv2', 'an .avi')
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'MJPG'), fps,
                             (w, h))
    for f in frames:
        writer.write(f)
    writer.release()


def main(argv=None):
    args = parse_args(argv)
    require('cv2', 'the BEV canvases')
    if args.output.endswith('.gif'):
        require('PIL', 'a GIF')
    logger = create_logger()
    bev_range = common.load_config(args.cfg_file)['DATA_CONFIG']['POINT_CLOUD_RANGE']
    records = run(args, logger)
    canvases = []
    for i, r in enumerate(records):
        canvases.append(bev_canvas(r['frame'].points, r['boxes'], bev_range,
                                   scores=r['scores'], labels=r['labels'],
                                   info=f'frame {i}'))
        logger.info('frame %d: %d detections', i, len(r['boxes']))
    write_video(canvases, args.output, args.fps)
    logger.info('video written: %s (%d frames)', args.output, len(canvases))
    return records


if __name__ == '__main__':
    main()
