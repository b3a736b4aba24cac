"""Evaluation of a checkpoint, or of every checkpoint of a directory as a
run writes them (the counterpart of tools/test.py), through
``engine/evaluator.py::eval_one_epoch`` and the dataset's protocol.

    python -m lidardetection_tpu_torch.tools.test \\
        --cfg_file tools/cfgs/kitti_models/pointpillar.yaml \\
        --ckpt output/pointpillar/ckpt/checkpoint_epoch_80.pth
    python -m lidardetection_tpu_torch.tools.test --cfg_file <yaml> \\
        --eval_all --ckpt_dir output/pointpillar/ckpt --max_waiting_mins 30

``--eval_all`` evaluates the ``checkpoint_epoch_<n>.pth`` of ``--ckpt_dir``
(default ``<output_dir>/ckpt``) in epoch order, then waits for new ones,
looking every 30 s, and stops once ``--max_waiting_mins`` pass with none.
The test split comes from the config's dataset (``--data_path`` for its
root), or with ``--synthetic`` from ``--num_scenes`` scenes of the
registered SyntheticDataset, the scenes that the training CLI's
``--synthetic`` evaluates.
Results go under ``<output_dir>/eval/<single | epoch_<n>>`` (``--output_dir``
defaults to ``output/<cfg folder>/<cfg name>/<extra_tag>``, as the JAX
tool's). Under ``torchrun`` each rank evaluates its shard of the split and
the main process scores the merged results
(``parallel/dist.py::merge_results_dist``):

    torchrun --nproc_per_node 2 -m lidardetection_tpu_torch.tools.test \\
        --cfg_file <yaml> --eval_all --ckpt_dir <dir> --max_waiting_mins 0

``evaluate(args)`` returns ``[(checkpoint, tag, result dict)]`` in the
order evaluated (empty result dicts on the other ranks).
"""

import argparse
import datetime
import time
from pathlib import Path

import torch

from ..datasets import build_dataloader
from ..engine.evaluator import eval_one_epoch
from ..parallel.dist import (
    get_rank, get_world_size, in_group, init_distributed, main_process_value,
)
from ..utils.checkpoint import checkpoint_epoch, checkpoints
from ..utils.common import create_logger
from . import common

POLL_S = 30


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='evaluate a detector')
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--batch_size', type=int, default=None,
                        help='a rank\'s; default BATCH_SIZE_PER_GPU')
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--eval_all', action='store_true')
    parser.add_argument('--ckpt_dir', type=str, default=None)
    parser.add_argument('--max_waiting_mins', type=float, default=30)
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--num_scenes', type=int, default=16)
    parser.add_argument('--data_path', type=str, default=None,
                        help='the dataset root (default: DATA_PATH)')
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--output_dir', type=str, default=None)
    parser.add_argument('--cpu', action='store_true')
    return parser.parse_args(argv)


def test_loader(args, cfg, batch_size, logger):
    """The test split's loader (this rank's shard in a process group):
    the config's dataset, or with ``--synthetic`` ``--num_scenes``
    scenes of the registered SyntheticDataset (its augmentor removed, as
    the JAX tool and the training CLI's ``--synthetic`` do), so that train
    and test evaluate the same scenes."""
    extra = {}
    if args.synthetic:
        cfg['DATA_CONFIG']['DATASET'] = 'SyntheticDataset'
        cfg['DATA_CONFIG'].pop('DATA_AUGMENTOR', None)
        extra = {'num_scenes': args.num_scenes}
    _, loader = build_dataloader(
        cfg['DATA_CONFIG'], list(cfg['CLASS_NAMES']), batch_size,
        training=False, root_path=args.data_path, workers=args.workers,
        logger=logger, model_cfg=cfg['MODEL'], num_shards=get_world_size(),
        shard_id=get_rank(), **extra)
    return loader


def output_dir(args):
    if args.output_dir:
        return Path(args.output_dir)
    cfg_path = Path(args.cfg_file).resolve()
    return Path('output') / cfg_path.parent.name / cfg_path.stem / args.extra_tag


def evaluate(args, logger=None):
    device = common.tool_device(args.cpu)
    rank, world = init_distributed('gloo' if args.cpu else None)
    if world > 1 and device.type == 'cuda':
        device = torch.device(f'cuda:{torch.cuda.current_device()}')
    cfg = common.load_config(args.cfg_file, args.set_cfgs)
    out_dir = output_dir(args)
    eval_dir = out_dir / 'eval'
    eval_dir.mkdir(parents=True, exist_ok=True)
    logger = logger or create_logger(
        eval_dir / f'log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt',
        rank=rank)
    batch_size = args.batch_size or int(cfg['OPTIMIZATION']['BATCH_SIZE_PER_GPU'])
    loader = test_loader(args, cfg, batch_size, logger)
    classes = list(cfg['CLASS_NAMES'])
    results = []

    def eval_ckpt(ckpt, tag):
        model = common.build_detector(cfg, device, ckpt, logger)
        logger.info('==> evaluating %s', ckpt or 'weights from the seed')
        result, _ = eval_one_epoch(model, loader, cfg['MODEL']['POST_PROCESSING'],
                                   classes, logger,
                                   result_dir=eval_dir / tag)
        results.append((ckpt, tag, result))

    if not args.eval_all:
        eval_ckpt(args.ckpt, 'single')
        return results

    ckpt_dir = args.ckpt_dir or str(out_dir / 'ckpt')
    evaluated = set()
    wait_start = time.time()
    while True:
        new = main_process_value(
            [c for c in checkpoints(ckpt_dir) if c not in evaluated])
        if not new:
            if main_process_value(
                    time.time() - wait_start >= args.max_waiting_mins * 60):
                break
            time.sleep(POLL_S)
            continue
        for c in new:
            eval_ckpt(c, f'epoch_{checkpoint_epoch(c)}')
            evaluated.add(c)
        wait_start = time.time()
    return results


def main(argv=None):
    args = parse_args(argv)
    results = evaluate(args)
    if in_group():
        torch.distributed.destroy_process_group()
    return results


if __name__ == '__main__':
    main()
