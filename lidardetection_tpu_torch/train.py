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

CLI: with ``--data_path`` it trains from a dataset tree on disk (a KITTI,
NuScenes, PlusAI, Livox or Mix layout with its infos, ``datasets/``)
through ``datasets.build_dataloader`` (``--workers`` forked processes
build the batches ahead of the step) and ``Trainer.fit``, with a
checkpoint each epoch under ``--output_dir`` (a run on a directory that
holds one resumes), then evaluates the test split through
``engine/evaluator.py::eval_one_epoch``, the counterpart of
tools/train.py:105-147:

    python -m lidardetection_tpu_torch.train \
        --cfg_file tools/cfgs/kitti_models/second.yaml --data_path <root> \
        --workers 8 --epochs 1

Under ``torchrun`` it joins the process group (``parallel/dist.py``: NCCL,
a card a process; gloo with ``--device cpu``), each rank training and
evaluating on its shard of the tree, the step the single-process step over
the global batch (the batch size is a rank's); the main process writes
the checkpoints and scores the merged eval:

    torchrun --nproc_per_node 2 -m lidardetection_tpu_torch.train \
        --cfg_file tools/cfgs/mix_data_models/pointpillars_xy.yaml \
        --data_path <root> --epochs 1

Without it, it trains on synthetic scenes made from ``--seed``:

    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/second.yaml --num_steps 4 --batch_size 4
    python -m lidardetection_tpu_torch.train \
        --cfg_file tools/cfgs/kitti_models/pv_rcnn.yaml --num_steps 4
    python -m lidardetection_tpu_torch.train \
        --cfg_file tools/cfgs/kitti_models/PartA2.yaml --num_steps 4
    python -m lidardetection_tpu_torch.train \
        --cfg_file tools/cfgs/kitti_models/pointrcnn.yaml --num_steps 4
    python -m lidardetection_tpu_torch.train \\
        --cfg_file tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml \\
        --num_steps 4
"""

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .config import (
    cfg_from_yaml_file, dataset_info, raw_point_capacity, voxel_processor_cfg,
)
from .datasets import build_dataloader
from .datasets.synthetic import (
    SyntheticDataset, SyntheticLoader, scene_options,
)
from .engine.evaluator import eval_one_epoch
from .engine.trainer import train_model
from .models import build_network
from .ops.sparse_plan import config_plan
from .parallel.dist import get_rank, get_world_size, init_distributed
from .ops.voxelize import build_batch, build_point_batch
from .parallel.train_step import TrainState, device_batch, make_train_step
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
        return SyntheticDataset(
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


def train_from_files(args, trainer, batch_size):
    """Train on the tree at ``args.data_path``, then evaluate its test
    split (in a process group, each rank on its shard); returns the eval's
    result dict (empty on a rank other than the main process)."""
    cfg = trainer.cfg
    rank, world = get_rank(), get_world_size()
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(output_dir / 'log_train.txt', rank=rank)
    classes = list(cfg['CLASS_NAMES'])
    shard = {'num_shards': world, 'shard_id': rank}
    _, loader = build_dataloader(
        cfg['DATA_CONFIG'], classes, batch_size, training=True,
        root_path=args.data_path, workers=args.workers, logger=logger,
        model_cfg=cfg['MODEL'], seed=args.seed, **shard)
    logger.info('%d training batches of %d a epoch, %d loader workers, '
                'rank %d of %d', len(loader), batch_size, loader.num_workers,
                rank, world)
    trainer.fit(loader, output_dir / 'ckpt', logger, total_epochs=args.epochs)
    _, test_loader = build_dataloader(
        cfg['DATA_CONFIG'], classes, batch_size, training=False,
        root_path=args.data_path, workers=args.workers, logger=logger,
        model_cfg=cfg['MODEL'], seed=args.seed, **shard)
    result, _ = eval_one_epoch(trainer.model, test_loader,
                               cfg['MODEL']['POST_PROCESSING'], classes, logger,
                               result_dir=output_dir / 'eval')
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cfg_file', default='tools/cfgs/kitti_models/pointpillar.yaml')
    parser.add_argument('--num_steps', type=int, default=4,
                        help='synthetic scenes: the steps to take')
    parser.add_argument('--batch_size', type=int, default=None,
                        help='default: OPTIMIZATION.BATCH_SIZE_PER_GPU')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--data_path', default=None,
                        help='train and evaluate from the dataset tree here')
    parser.add_argument('--workers', type=int, default=4,
                        help='loader worker processes (0 or 1: none)')
    parser.add_argument('--epochs', type=int, default=None,
                        help='default: OPTIMIZATION.NUM_EPOCHS')
    parser.add_argument('--output_dir', default=None,
                        help='checkpoints, log and eval (default: '
                        'output/<cfg name>)')
    args = parser.parse_args(argv)

    _, world = init_distributed('gloo' if args.device == 'cpu' else None)
    if world > 1 and args.device == 'cuda':
        args.device = f'cuda:{torch.cuda.current_device()}'
    if args.data_path is not None:
        trainer = Trainer(args.cfg_file, device=args.device, seed=args.seed)
        if args.output_dir is None:
            args.output_dir = str(Path('output') / Path(args.cfg_file).stem)
        return train_from_files(args, trainer, args.batch_size or int(
            trainer.cfg['OPTIMIZATION']['BATCH_SIZE_PER_GPU']))

    if world > 1:
        raise SystemExit('a process group trains from a dataset tree: pass '
                         '--data_path')
    trainer = Trainer(args.cfg_file, device=args.device, seed=args.seed,
                      total_steps=args.num_steps)
    batch_size = args.batch_size or int(
        trainer.cfg['OPTIMIZATION']['BATCH_SIZE_PER_GPU'])
    dataset = trainer.dataset(args.num_steps * batch_size, seed=args.seed)
    loader = SyntheticLoader(dataset, batch_size, lambda scenes: scenes,
                             seed=args.seed)
    for i, scenes in enumerate(loader):
        t0 = time.perf_counter()
        tb = trainer.step(trainer.make_batch(scenes))
        terms = ' '.join(f'{k} {float(v):.4f}' for k, v in tb.items())
        ms = (time.perf_counter() - t0) * 1e3
        print(f'step {i}: {terms} lr {trainer.lr_fn(i):.2e} in {ms:.1f} ms '
              f'({args.device})', flush=True)


if __name__ == '__main__':
    main()
