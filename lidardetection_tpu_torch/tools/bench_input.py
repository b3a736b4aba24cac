"""The host input pipeline's rate (counterpart of tools/bench_input.py:
1-76): scans/s of ``datasets/__init__.py::build_dataloader``'s loader
with the whole train-time host path (the augmentor but its gt sampling,
which needs a database on disk; the voxelizer; collate) on the
config's synthetic set, for each worker count of ``--workers`` (0: the
loader's own process; more: that many forked workers).

Each setting takes one batch to warm up (the workers' fork, page-in),
then times up to ``--batches`` batches of the epoch on the host clock
and prints one JSON line (the JAX tool's keys, and the device line).

    python -m lidardetection_tpu_torch.tools.bench_input --batch_size 32 \\
        --workers 0 4 8

It launches no kernel; where CUDA is up the loader copies each batch into
page-locked memory, as in training. Without ``--cpu`` it needs the card.
"""

import argparse
import json
import time

from ..config import cfg_from_yaml_file
from ..datasets import DataLoader, build_dataloader
from . import measure
from .common import tool_device


def loader_config(cfg_file, augment=True):
    """The JAX tool's edits (:44-53): the synthetic set; the augmentor
    without gt sampling, or none."""
    cfg = cfg_from_yaml_file(cfg_file)
    data = cfg['DATA_CONFIG']
    data['DATASET'] = 'SyntheticDataset'
    if not augment:
        data.pop('DATA_AUGMENTOR', None)
    if 'DATA_AUGMENTOR' in data:
        data['DATA_AUGMENTOR']['AUG_CONFIG_LIST'] = [
            a for a in data['DATA_AUGMENTOR']['AUG_CONFIG_LIST']
            if a['NAME'] != 'gt_sampling']
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg_file',
                    default='tools/cfgs/kitti_models/pointpillar.yaml')
    ap.add_argument('--batch_size', type=int, default=32)
    ap.add_argument('--num_scenes', type=int, default=64)
    ap.add_argument('--batches', type=int, default=16)
    ap.add_argument('--workers', type=int, nargs='+', default=[0, 4])
    ap.add_argument('--augment', action='store_true', default=True)
    ap.add_argument('--no_augment', dest='augment', action='store_false')
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f'# device: {measure.device_line(device)}', flush=True)
    cfg = loader_config(args.cfg_file, args.augment)
    dataset, _ = build_dataloader(
        cfg['DATA_CONFIG'], cfg['CLASS_NAMES'], batch_size=args.batch_size,
        training=True, workers=0, num_scenes=args.num_scenes)
    rows = []
    for nw in args.workers:
        loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                            num_workers=nw)
        it = iter(loader)
        next(it)  # warm: the workers' fork, page-in
        n, t0 = 0, time.perf_counter()
        for _ in it:
            n += 1
            if n >= args.batches:
                break
        dt = time.perf_counter() - t0
        it.close()
        row = {'metric': 'input_scans_per_sec', 'workers': nw,
               'value': round(n * args.batch_size / dt, 2) if n else None,
               'batches_per_sec': round(n / dt, 3) if n else None,
               'batches': n, 'batch_size': args.batch_size,
               'augment': bool(args.augment
                               and 'DATA_AUGMENTOR' in cfg['DATA_CONFIG']),
               'device': measure.device_line(device)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == '__main__':
    main()
