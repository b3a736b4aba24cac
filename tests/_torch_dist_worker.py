"""A rank of tests/test_torch_distributed.py's gloo group, and the pieces
the test shares with it: the reduced configs, the global batch, one step's
results.

Run as ``python tests/_torch_dist_worker.py step-<config> <out.pkl>`` with
torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) set: it
takes one training step of the port on this rank's rows of the global
batch in the group and pickles its loss terms, gradients and BatchNorm
statistics. ``cli-<config.yaml>`` runs the training CLI instead
(``cli_step``), the YAML beside ``out.pkl``.
"""

import os
import pickle
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

GLOBAL_BATCH = 4
SEED = 7


def reduced_cfg(name):
    """PointPillar at test_torch_train_step.py's size, or PV-RCNN (a point
    head and an RoI head, the batch-wide loss normalisers) at
    test_torch_pvrcnn_train.py's with half its keypoints and RoIs, both in
    float32 on synthetic scenes."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(f'tools/cfgs/kitti_models/{name}.yaml')
    data, m = cfg.DATA_CONFIG, cfg.MODEL
    data.DATASET = 'SyntheticDataset'
    del data.DATA_AUGMENTOR
    vox = [p for p in data.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    m.COMPUTE_DTYPE = 'float32'
    if name == 'pointpillar':
        data.POINT_CLOUD_RANGE = [0, -40.96, -3, 71.68, 40.96, 1]
        data.MAX_POINTS = 24000
        vox.VOXEL_SIZE = [0.64, 0.64, 4]
        vox.MAX_NUMBER_OF_VOXELS = {'train': 6000, 'test': 6000}
        m.VFE.NUM_FILTERS = [32]
        m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
        m.BACKBONE_2D.LAYER_NUMS = [1, 1, 1]
        m.BACKBONE_2D.NUM_FILTERS = [32, 32, 64]
        m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [32, 32, 32]
    else:
        data.MAX_POINTS = 4000
        vox.VOXEL_SIZE = [0.2, 0.2, 0.1]
        vox.MAX_NUMBER_OF_VOXELS = {'train': 1500, 'test': 1500}
        m.BACKBONE_2D.LAYER_NUMS = [1, 1]
        m.PFE.NUM_KEYPOINTS = 128
        m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 256
        m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 32
        m.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16
        # random-weight proposals miss the gt boxes (IoU 0): below 0 every
        # valid RoI is foreground, and the box loss has RoIs to count
        m.ROI_HEAD.TARGET_CONFIG.REG_FG_THRESH = -0.5
    return cfg


def trainer_and_batch(name):
    """A CPU trainer of the reduced config and the global batch of
    GLOBAL_BATCH synthetic scenes, both from SEED."""
    from lidardetection_tpu_torch.train import Trainer

    trainer = Trainer(reduced_cfg(name), device='cpu', seed=SEED,
                      total_steps=10)
    scenes = [trainer.dataset(GLOBAL_BATCH, seed=SEED)[i]
              for i in range(GLOBAL_BATCH)]
    return trainer, trainer.make_batch(scenes)


def rank_rows(batch, rank, world):
    """A rank's rows of the global batch: its samples, in rank order."""
    n = GLOBAL_BATCH // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def step_results(trainer, batch):
    """One step on `batch`: its loss terms, every parameter's gradient and
    every BatchNorm statistic after it, as numpy."""
    tb = trainer.step(batch)
    return ({k: float(v) for k, v in tb.items()},
            {k: p.grad.numpy().copy()
             for k, p in trainer.model.named_parameters()},
            {k: v.numpy().copy() for k, v in trainer.model.named_buffers()})


def cli_step(cfg_file, out_dir):
    """``train.main`` on this rank of the group: ``--synthetic`` with
    GLOBAL_BATCH scenes, the global ``--batch_size`` GLOBAL_BATCH, one
    epoch, no eval. Returns the rows of the batch that the first step
    took and the step's results (``step_results``'s), read by wrapping the
    loop's train step."""
    from lidardetection_tpu_torch import train
    from lidardetection_tpu_torch.engine import trainer as loop

    seen = []
    make = loop.make_train_step

    def recording(state):
        step = make(state)

        def run(batch):
            tb = step(batch)
            if not seen:
                seen.append((int(batch['gt_boxes'].shape[0]), (
                    {k: float(v) for k, v in tb.items()},
                    {k: p.grad.numpy().copy()
                     for k, p in state.model.named_parameters()},
                    {k: v.numpy().copy()
                     for k, v in state.model.named_buffers()})))
            return tb

        return run

    loop.make_train_step = recording
    train.main(['--cfg_file', str(cfg_file), '--device', 'cpu', '--synthetic',
                '--num_scenes', str(GLOBAL_BATCH), '--batch_size',
                str(GLOBAL_BATCH), '--epochs', '1', '--no_eval', '--workers',
                '0', '--seed', str(SEED), '--output_dir', str(out_dir)])
    return seen[0]


def bn_rows(rank):
    """A train-mode MaskedBatchNorm on rows of the same shape on every rank,
    then on a rank-dependent number of rows with no mask: the group's
    statistics of the first, and the error the second raises."""
    from lidardetection_tpu_torch.models.layers import MaskedBatchNorm

    x = torch.from_numpy(np.random.RandomState(7).randn(2 * 6, 4)
                         .astype(np.float32))
    bn = MaskedBatchNorm(4, axis=-1, momentum=0.0)
    bn.train()
    bn(x[rank * 6:(rank + 1) * 6])
    stats = (bn.mean.numpy().copy(), bn.var.numpy().copy())
    try:
        bn(x[:rank + 2])
        error = None
    except RuntimeError as e:
        error = str(e)
    return stats, error


def main():
    case, out = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    os.chdir(ROOT)  # the configs' _BASE_CONFIG_ paths
    from lidardetection_tpu_torch.parallel.dist import init_distributed

    rank, world = init_distributed('gloo')
    assert world == int(os.environ['WORLD_SIZE']) > 1
    if case == 'bn-rows':
        result = bn_rows(rank)
    elif case.startswith('cli-'):  # the CLI leaves the group at its end
        result = cli_step(out.with_name(case[len('cli-'):]), out.parent / 'run')
    else:
        trainer, batch = trainer_and_batch(case[len('step-'):])
        result = step_results(trainer, rank_rows(batch, rank, world))
    with open(out.with_name(f'{out.stem}.rank{rank}.pkl'), 'wb') as f:
        pickle.dump(result, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
