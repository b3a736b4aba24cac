"""Training (PointPillar, SECOND, PV-RCNN, Part-A², PointRCNN and their
variants, every model config under tools/cfgs/): the port's entry point,
the counterpart of tools/train.py -> engine/trainer.py ->
parallel/train_step.py.

``Trainer(cfg_file, device="cuda", seed=0, state_dict=None, total_steps=...)``
builds the detector of a YAML config (or of a loaded config) in train mode
on the card with the config's optimizer; parameters are drawn from ``seed``
unless a ``state_dict`` is given. ``make_batch(scenes)`` voxelizes
``(points, gt_boxes)`` scenes on the host with the config's ``train`` voxel
cap and, for a sparse 3D backbone, builds the host plan's rulebooks
(``ops/sparse_plan.py``) with each strided layer's transposed table; a
point-based config (PointRCNN) samples, shuffles and pads each cloud
instead (``ops/voxelize.py::build_point_batch``, the train split's
processors); ``step(batch)`` takes one optimizer step of a run of ``total_steps``
and returns the loss terms; ``fit(loader, ckpt_dir)`` runs epochs with
checkpoints and resume.

The CPU is used only when asked (``device="cpu"``); the default device
raises when CUDA is absent. Random numbers come from the ``torch.Generator``
that initializes the parameters, an ``np.random.RandomState`` that
shuffles (and for a point config samples) each cloud's points, and a generator made each step from
(``seed``, step) for the random layers (the two-stage detectors' RoI
sampling and dropout, ``parallel/train_step.py::step_draw``), all from ``seed``.

CLI (the flags of tools/train.py but its JAX process flags: torchrun's
environment takes the place of ``--multihost`` and ``--dist_*``, and
``--device cpu`` that of ``--cpu``). A run writes under ``--output_dir``,
by default ``output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>`` (the YAML's
folder and stem: where ``tools/test.py --eval_all`` looks): the log
``log_train_<%Y%m%d-%H%M%S>.txt`` with the config dumped into it,
``ckpt/checkpoint_epoch_<n>.pth`` (every ``--ckpt_save_interval`` epochs
and the last, at most ``--max_ckpt_save_num`` kept; a run on a directory
that holds one resumes), ``tensorboard/`` (``train/<loss term>`` and
``meta_data/learning_rate`` every 20 steps, ``eval/<key>`` after
training; where ``torch.utils.tensorboard`` imports), ``eval/`` (the
final state's evaluation) and ``eval/epoch_<n>/`` (the checkpoints of the
``--num_epochs_to_eval`` - 1 epochs before the last, unless
``--no_eval``), and with ``--profile`` ``profile/``, a Chrome trace of
steps 10-15 (clamped into a shorter run; open it in chrome://tracing or
Perfetto). ``--set KEY VALUE ...`` (last) overrides the config.

With ``--data_path`` it trains from a dataset tree on disk (a KITTI,
NuScenes, PlusAI, Livox or Mix layout with its infos, ``datasets/``);
with ``--synthetic`` on ``--num_scenes`` synthetic scenes (the config's
DATASET set to SyntheticDataset, its augmentor removed, as the JAX tool
does); both through ``datasets.build_dataloader`` (``--workers`` forked
processes build the batches ahead of the step), ``Trainer.fit`` and
``engine/evaluator.py::eval_one_epoch`` on the test split:

    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/second.yaml --data_path <root> \\
        --workers 8 --epochs 1
    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/second.yaml --synthetic \\
        --num_scenes 32 --epochs 2 --profile

Under ``torchrun`` it joins the process group (``parallel/dist.py``: NCCL,
a card a process; gloo with ``--device cpu``), each rank training and
evaluating on its shard, the step the single-process step over the
global batch. ``--batch_size`` is the global batch, as in the JAX tool:
by default BATCH_SIZE_PER_GPU times the processes, and a process loads
``batch_size // processes`` (a batch that the processes do not divide
raises). The main process writes the log, the checkpoints and the
TensorBoard scalars, and scores the merged eval; the output directory
must be one that every process sees. ``tools/scripts/train.sh`` launches
a host's cards, ``tools/scripts/train_multinode.sh`` several hosts:

    torchrun --nproc_per_node 2 -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/mix_data_models/pointpillars_xy.yaml \\
        --data_path <root> --epochs 1

With neither, it takes ``--num_steps`` steps on in-memory synthetic
scenes made from ``--seed`` (no epochs, checkpoints or eval; one
process), each logged:

    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/second.yaml --num_steps 4 --batch_size 4
    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/pv_rcnn.yaml --num_steps 4
    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/PartA2.yaml --num_steps 4
    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/pointrcnn.yaml --num_steps 4
    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml \\
        --num_steps 4
"""

import argparse
import datetime
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .config import (
    cfg_from_list, cfg_from_yaml_file, dataset_info, log_config_to_file,
    raw_point_capacity, voxel_processor_cfg,
)
from .datasets import build_dataloader
from .datasets.synthetic import (
    SyntheticScenes, SyntheticLoader, scene_options,
)
from .engine.evaluator import eval_one_epoch
from .engine.trainer import train_model
from .models import build_network
from .ops.sparse_plan import config_plan
from .ops.voxelize import build_batch, build_point_batch
from .parallel.dist import (
    get_rank, get_world_size, in_group, init_distributed, is_main_process,
    main_process_value,
)
from .parallel.train_step import TrainState, device_batch, make_train_step
from .utils.checkpoint import checkpoint_epoch, checkpoints, restore_model
from .utils.common import create_logger
from .utils.optimization import build_optimizer


class Trainer:
    def __init__(self, cfg_file, device='cuda', seed=0, state_dict=None,
                 total_steps=None):
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('CUDA is not available; pass device="cpu" to '
                               'run on the CPU')
        self.cfg = cfg_file if isinstance(cfg_file, dict) \
            else cfg_from_yaml_file(cfg_file)
        self.device = device
        data_cfg = self.cfg['DATA_CONFIG']
        self.info = dataset_info(data_cfg)
        self.vox = voxel_processor_cfg(data_cfg)
        if self.vox is not None:
            self.max_points_per_voxel = int(self.vox['MAX_POINTS_PER_VOXEL'])
            self.max_voxels = int(self.vox['MAX_NUMBER_OF_VOXELS']['train'])
        self.shuffle_points = any(
            p['NAME'] == 'shuffle_points' and p['SHUFFLE_ENABLED']['train']
            for p in data_cfg['DATA_PROCESSOR'])
        self.max_gt_boxes = int(data_cfg.get('MAX_GT_BOXES', 64))
        self.max_points = raw_point_capacity(self.cfg)
        # the training plan: host rulebooks with each strided layer's
        # transposed table, so its input gradient runs on K3
        self.plan = config_plan(self.cfg, training=True)
        self.class_names = tuple(self.cfg['CLASS_NAMES'])
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.model = build_network(self.cfg['MODEL'], len(self.class_names),
                                   self.info, seed=seed,
                                   class_names=self.class_names)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(device).train()
        self.state = None  # built once the schedule's length is known
        if total_steps:
            self._build_state(total_steps, 1)

    def _build_state(self, iters_per_epoch, epochs):
        optimizer, self.lr_fn = build_optimizer(
            list(self.model.named_parameters()), self.cfg['OPTIMIZATION'],
            iters_per_epoch, epochs)
        self.state = TrainState(self.model, optimizer, self.seed)
        self._step = make_train_step(self.state)

    def make_batch(self, scenes):
        """Voxelize ``(points, gt_boxes (G, D + 1))`` scenes on the host,
        with the raw points padded to MAX_POINTS when the model reads them
        and the training plan's ``rb_*`` tables for a sparse 3D backbone (a
        point config's clouds masked, sampled, shuffled and padded); a
        multiframe scene's third entry, its frame poses (``locations``,
        ``rotations_y``), is stacked beside. The batch tensors on the
        device."""
        clouds = [scene[0] for scene in scenes]
        if self.vox is None:
            arrays = build_point_batch(
                clouds, self.cfg['DATA_CONFIG']['DATA_PROCESSOR'],
                self.info['point_cloud_range'], self.max_points,
                training=True, rng=self.rng)
        else:
            if self.shuffle_points:
                clouds = [points[self.rng.permutation(len(points))]
                          for points in clouds]
            arrays = build_batch(clouds, self.info['point_cloud_range'],
                                 self.info['voxel_size'],
                                 self.max_points_per_voxel, self.max_voxels,
                                 max_points=self.max_points, plan=self.plan)
        arrays['gt_boxes'] = np.stack([scene[1] for scene in scenes])
        if len(scenes[0]) > 2:
            for key in scenes[0][2]:
                arrays[key] = np.stack([scene[2][key] for scene in scenes])
        return device_batch(arrays, self.device)

    def dataset(self, num_scenes, seed=0):
        """The config's synthetic training set (its point width, velocity
        and frame poses)."""
        return SyntheticScenes(
            self.class_names, self.info['point_cloud_range'],
            num_scenes=num_scenes, seed=seed, max_gt_boxes=self.max_gt_boxes,
            **scene_options(self.cfg['DATA_CONFIG'],
                            self.info['num_point_features']))

    def step(self, batch):
        """One optimizer step; returns the loss terms as 0-d tensors."""
        if self.state is None:
            raise RuntimeError('the schedule needs the run\'s length: pass '
                               'total_steps to Trainer, or call fit()')
        return self._step(batch)

    def fit(self, loader, ckpt_dir=None, logger=None, total_epochs=None,
            **kwargs):
        """Train for `total_epochs` (default: the config's NUM_EPOCHS) over
        `loader` (batches from ``make_batch``), resuming from `ckpt_dir`
        when it holds a checkpoint. The schedule spans len(loader) *
        total_epochs steps. Returns the TrainState."""
        epochs = int(total_epochs or self.cfg['OPTIMIZATION']['NUM_EPOCHS'])
        self._build_state(len(loader), epochs)
        return train_model(
            self.state, loader, epochs, ckpt_dir,
            logger or logging.getLogger(__name__), self.device,
            lr_fn=self.lr_fn, **kwargs)


def tensorboard_writer(output_dir, logger):
    """A SummaryWriter into `output_dir`/tensorboard, or None (a line in
    the log) where ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logger.info('tensorboard writer unavailable; scalars not logged')
        return None
    return SummaryWriter(log_dir=str(Path(output_dir) / 'tensorboard'))


def train_and_evaluate(args, trainer, batch_size, output_dir, logger,
                       dataset_kwargs):
    """Train through ``build_dataloader`` (this rank's shard, `batch_size`
    a rank), then, unless ``--no_eval``, evaluate the final state into
    `output_dir`/eval and the checkpoints of the ``--num_epochs_to_eval``
    - 1 epochs before it into eval/epoch_<n> (tools/train.py:127-176).
    Returns the final state's eval result (empty on a rank other than the
    main process, or without eval)."""
    cfg = trainer.cfg
    rank, world = get_rank(), get_world_size()
    classes = list(cfg['CLASS_NAMES'])
    loader_kwargs = dict(
        root_path=args.data_path, workers=args.workers, logger=logger,
        model_cfg=cfg['MODEL'], seed=args.seed, num_shards=world,
        shard_id=rank, **dataset_kwargs)
    _, loader = build_dataloader(cfg['DATA_CONFIG'], classes, batch_size,
                                 training=True, **loader_kwargs)
    logger.info('%d training batches of %d a epoch, %d loader workers, '
                'rank %d of %d', len(loader), batch_size, loader.num_workers,
                rank, world)
    tb_writer = tensorboard_writer(output_dir, logger) \
        if is_main_process() else None
    ckpt_dir = output_dir / 'ckpt'
    trainer.fit(loader, ckpt_dir, logger, total_epochs=args.epochs,
                max_ckpt_save_num=args.max_ckpt_save_num,
                ckpt_save_interval=args.ckpt_save_interval,
                tb_writer=tb_writer,
                profile_dir=output_dir / 'profile' if args.profile else None)
    result = {}
    if not args.no_eval:
        _, test_loader = build_dataloader(cfg['DATA_CONFIG'], classes,
                                          batch_size, training=False,
                                          **loader_kwargs)
        post = cfg['MODEL']['POST_PROCESSING']
        result, _ = eval_one_epoch(trainer.model, test_loader, post, classes,
                                   logger, result_dir=output_dir / 'eval')
        if tb_writer is not None:
            for k, v in result.items():
                if isinstance(v, (int, float)):
                    tb_writer.add_scalar(f'eval/{k}', v, trainer.state.step)
        # the checkpoints of earlier epochs too (the final state was just
        # evaluated), the main process's list on every rank
        earlier = main_process_value(checkpoints(ckpt_dir)) \
            if args.num_epochs_to_eval > 1 else []
        for ckpt in earlier[-args.num_epochs_to_eval:-1]:
            logger.info('repeat-eval: %s', ckpt)
            restore_model(ckpt, trainer.model, logger)
            eval_one_epoch(trainer.model, test_loader, post, classes, logger,
                           result_dir=output_dir / 'eval'
                           / f'epoch_{checkpoint_epoch(ckpt)}')
    if tb_writer is not None:
        tb_writer.close()
    return result


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cfg_file', default='tools/cfgs/kitti_models/pointpillar.yaml')
    parser.add_argument('--batch_size', type=int, default=None,
                        help='the global batch (default: BATCH_SIZE_PER_GPU '
                        'x the processes); a process loads batch_size // '
                        'processes')
    parser.add_argument('--epochs', type=int, default=None,
                        help='default: OPTIMIZATION.NUM_EPOCHS')
    parser.add_argument('--extra_tag', default='default')
    parser.add_argument('--max_ckpt_save_num', type=int, default=30)
    parser.add_argument('--ckpt_save_interval', type=int, default=1,
                        help='a checkpoint every N epochs (the last epoch '
                        'always saves)')
    parser.add_argument('--workers', type=int, default=4,
                        help='loader worker processes (0 or 1: none)')
    parser.add_argument('--synthetic', action='store_true',
                        help='train on synthetic scenes (no dataset on disk)')
    parser.add_argument('--num_scenes', type=int, default=64)
    parser.add_argument('--no_eval', action='store_true')
    parser.add_argument('--num_epochs_to_eval', type=int, default=10,
                        help='after training, also evaluate the checkpoints '
                        'of the N - 1 epochs before the last')
    parser.add_argument('--profile', action='store_true',
                        help='torch.profiler trace of steps 10-15 into '
                        '<output_dir>/profile')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--data_path', default=None,
                        help='train and evaluate from the dataset tree here')
    parser.add_argument('--num_steps', type=int, default=4,
                        help='without --data_path or --synthetic: the steps '
                        'to take on in-memory synthetic scenes')
    parser.add_argument('--output_dir', default=None,
                        help='default: output/<cfg folder>/<cfg name>/'
                        '<extra_tag>')
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER,
                        help='config overrides KEY VALUE ...')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass --device cpu to run '
                           'on the CPU')
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    rank, world = init_distributed('gloo' if device.type == 'cpu' else None)
    if world > 1 and device.type == 'cuda':
        device = torch.device(f'cuda:{torch.cuda.current_device()}')
    batch_size = args.batch_size or \
        int(cfg['OPTIMIZATION']['BATCH_SIZE_PER_GPU']) * world
    if batch_size % world:
        raise ValueError(f'--batch_size {batch_size} is the global batch: '
                         f'the {world} processes do not divide it')
    output_dir = Path(args.output_dir) if args.output_dir else \
        Path('output') / cfg['EXP_GROUP_PATH'] / cfg['TAG'] / args.extra_tag
    output_dir.mkdir(parents=True, exist_ok=True)
    log_file = output_dir / \
        f'log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt'
    logger = create_logger(log_file if rank == 0 else None, rank=rank)
    logger.info('device %s, global batch %d, %d processes', device,
                batch_size, world)
    dataset_kwargs = {}
    if args.synthetic:  # tools/train.py:97-101
        cfg['DATA_CONFIG']['DATASET'] = 'SyntheticDataset'
        cfg['DATA_CONFIG'].pop('DATA_AUGMENTOR', None)
        dataset_kwargs = {'num_scenes': args.num_scenes}
    log_config_to_file(cfg, logger=logger)

    if args.data_path is not None or args.synthetic:
        trainer = Trainer(cfg, device=device, seed=args.seed)
        result = train_and_evaluate(args, trainer, batch_size // world,
                                    output_dir, logger, dataset_kwargs)
        if in_group():
            torch.distributed.destroy_process_group()
        return result

    if world > 1:
        raise SystemExit('a process group trains through the loader: pass '
                         '--data_path or --synthetic')
    trainer = Trainer(cfg, device=device, seed=args.seed,
                      total_steps=args.num_steps)
    dataset = trainer.dataset(args.num_steps * batch_size, seed=args.seed)
    loader = SyntheticLoader(dataset, batch_size, lambda scenes: scenes,
                             seed=args.seed)
    for i, scenes in enumerate(loader):
        t0 = time.perf_counter()
        tb = trainer.step(trainer.make_batch(scenes))
        terms = ' '.join(f'{k} {float(v):.4f}' for k, v in tb.items())
        ms = (time.perf_counter() - t0) * 1e3
        logger.info('step %d: %s lr %.2e in %.1f ms (%s)', i, terms,
                    trainer.lr_fn(i), ms, device)


if __name__ == '__main__':
    main()
