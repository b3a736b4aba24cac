"""The port's process group, on the CPU with gloo: a two-rank group's step
is the single-process step over the global batch, its eval the
single-process eval, and ``merge_results_dist`` the JAX package's.

* The step: two ranks (spawned processes, ``tests/_torch_dist_worker.py``,
  a timeout of their own) each take one step of the reduced config on
  their half of a global batch of four synthetic scenes; the test takes
  the same step in this process on the whole batch. The loss within 1e-6
  (relative), every gradient leaf and every BatchNorm statistic within
  2e-5 of the leaf's largest entry. PointPillar exercises BatchNorm's
  group sums (the PFN's and the 2D backbone's); PV-RCNN adds the point
  head's and the RoI head's batch-wide loss normalisers and the RoI
  sampler's draws.
* The CLI: ``torchrun`` of ``lidardetection_tpu_torch.train`` on a Livox
  tree with two gloo ranks trains a step on each shard, writes one
  checkpoint, and evaluates the val split (three frames, so the shards
  are padded) on both ranks; the merged annos equal the single-process
  eval's with the checkpoint's weights, frame by frame, and so does the
  protocol's result.
* BatchNorm's group sums on rows the ranks split, and the error where
  the ranks' unmasked row counts differ.
* ``merge_results_dist`` against the JAX package's, on the same parts, in
  one process (a group of one reads back its own part).
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_dist_worker as worker  # noqa: E402
from torch_threads import two_torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run_group(case, tmp_path, timeout=240):
    """The worker's `case` on WORLD gloo ranks; each rank's result."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(MASTER_ADDR='localhost', MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(WORLD), OMP_NUM_THREADS='1',
               PYTHONPATH=str(ROOT))
    out = tmp_path / 'result.pkl'
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / 'tests' / '_torch_dist_worker.py'), case,
         str(out)], env={**env, 'RANK': str(r), 'LOCAL_RANK': str(r)},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    results = []
    for r in range(WORLD):
        with open(tmp_path / f'result.rank{r}.pkl', 'rb') as f:
            results.append(pickle.load(f))
    return results


def largest_share(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize('name', ['pointpillar', 'pv_rcnn'])
def test_group_step_is_the_global_batch_step(name, tmp_path):
    ranks = run_group(f'step-{name}', tmp_path)
    trainer, batch = worker.trainer_and_batch(name)
    want_tb, want_grads, want_buffers = worker.step_results(trainer, batch)
    for tb, grads, buffers in ranks:
        assert set(tb) == set(want_tb)
        got, want = tb['loss'], want_tb['loss']
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)
        assert set(grads) == set(want_grads)
        shares = {k: largest_share(grads[k], v) for k, v in want_grads.items()}
        worst = max(shares, key=shares.get)
        assert shares[worst] <= 2e-5, (worst, shares[worst])
        stats = {k: largest_share(buffers[k], v)
                 for k, v in want_buffers.items() if v.dtype.kind == 'f'}
        worst = max(stats, key=stats.get)
        assert stats[worst] <= 2e-5, (worst, stats[worst])
    # every rank holds the same averaged gradient
    for k in want_grads:
        np.testing.assert_array_equal(ranks[0][1][k], ranks[1][1][k], err_msg=k)
    if name == 'pv_rcnn':  # the batch-wide normalisers had counts to sum
        assert want_tb['point_loss_cls'] > 0 and want_tb['rcnn_loss_reg'] > 0


def test_group_batchnorm_sums_rows_and_checks_their_count(tmp_path):
    """BatchNorm in a two-rank group: the statistics of the ranks' rows
    together (momentum 0: the running buffers are the batch's), and an
    error, not a wrong count, where the ranks' unmasked shapes differ."""
    from lidardetection_tpu_torch.models.layers import MaskedBatchNorm

    ranks = run_group('bn-rows', tmp_path)
    x = torch.from_numpy(np.random.RandomState(7).randn(2 * 6, 4)
                         .astype(np.float32))
    bn = MaskedBatchNorm(4, axis=-1, momentum=0.0)
    bn.train()
    bn(x)
    for (mean, var), error in ranks:
        np.testing.assert_allclose(mean, bn.mean.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(var, bn.var.numpy(), rtol=1e-5, atol=1e-6)
        assert error is not None and 'BatchNorm rows differ' in error, error


def livox_cfg():
    """livox_models/pointpillar.yaml at a 0.2 m pillar and narrow widths,
    a score threshold under the random weights' scores (live detections)
    and 256 NMS candidates."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file('tools/cfgs/livox_models/pointpillar.yaml')
    vox = cfg.DATA_CONFIG.DATA_PROCESSOR[-1]
    vox.VOXEL_SIZE = [0.2, 0.2, 8]
    vox.MAX_NUMBER_OF_VOXELS = {'train': 16000, 'test': 16000}
    m = cfg.MODEL
    m.COMPUTE_DTYPE = 'float32'
    m.VFE.NUM_FILTERS = [32]
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.LAYER_NUMS = [1, 1, 1]
    m.BACKBONE_2D.NUM_FILTERS = [32, 32, 64]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [32, 32, 32]
    m.POST_PROCESSING.SCORE_THRESH = 0.001
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 32
    return cfg


def plain_tree(value):
    if isinstance(value, dict):
        return {k: plain_tree(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain_tree(v) for v in value]
    return value


def test_torchrun_trains_and_evaluates_as_one_process(tmp_path):
    """``torchrun --nproc_per_node 2 -m lidardetection_tpu_torch.train
    --data_path <Livox tree> --device cpu``: each rank steps on its shard,
    the main process writes the one checkpoint and scores the merged eval
    (three val frames: the shards are padded); the annos it wrote equal
    the single-process eval's with the checkpoint's weights, and so does
    the protocol's result on them."""
    import logging

    import yaml

    from lidardetection_tpu_torch.config import dataset_info
    from lidardetection_tpu_torch.datasets import (
        build_dataloader, synthetic_trees,
    )
    from lidardetection_tpu_torch.datasets.livox.livox_dataset import (
        create_livox_infos,
    )
    from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
    from lidardetection_tpu_torch.models import build_network

    root = tmp_path / 'livox'
    sensor = {**synthetic_trees.LIVOX, 'beams': 32, 'azimuth_steps': 500}
    synthetic_trees.write_livox_tree(root, 7, 3, seed=2, sensor=sensor)
    cfg = livox_cfg()
    classes = list(cfg.CLASS_NAMES)
    create_livox_infos(cfg.DATA_CONFIG, classes, root, workers=1)
    cfg_file = tmp_path / 'livox_small.yaml'
    cfg_file.write_text(yaml.safe_dump(plain_tree(cfg)))
    out = tmp_path / 'run'
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(OMP_NUM_THREADS='1', PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
         str(WORLD), '--master_port', str(free_port()), '-m',
         'lidardetection_tpu_torch.train', '--cfg_file', str(cfg_file),
         '--data_path', str(root), '--device', 'cpu', '--epochs', '1',
         '--workers', '0', '--output_dir', str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    log = ''.join(p.read_text() for p in sorted(out.glob('log_train_*.txt')))
    assert '1 training batches of 2 a epoch, 0 loader workers, rank 0 of 2' \
        in log
    assert [p.name for p in (out / 'ckpt').iterdir()] == \
        ['checkpoint_epoch_1.pth']
    assert sorted(p.name for p in (out / 'eval').iterdir()) == ['result.pkl']
    with open(out / 'eval' / 'result.pkl', 'rb') as f:
        got = pickle.load(f)

    ckpt = torch.load(out / 'ckpt' / 'checkpoint_epoch_1.pth')
    assert ckpt['step'] == 1
    model = build_network(cfg.MODEL, len(classes), dataset_info(cfg.DATA_CONFIG),
                          class_names=classes)
    model.load_state_dict(ckpt['model'])
    dataset, loader = build_dataloader(
        cfg.DATA_CONFIG, classes, 2, training=False, root_path=root,
        workers=0, model_cfg=cfg.MODEL)
    _, want = eval_one_epoch(model, loader, cfg.MODEL.POST_PROCESSING,
                             classes, logging.getLogger('eval'))
    want = want[:len(dataset)]  # the single process keeps the fill
    assert [a['frame_id'] for a in got] == [a['frame_id'] for a in want] == \
        ['000004', '000005', '000006']
    assert sum(len(a['name']) for a in want) > 0
    for g, w in zip(got, want):
        assert list(g['name']) == list(w['name'])
        for key in ('boxes_lidar', 'score', 'location', 'dimensions'):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-5,
                                       err_msg=key)
    got_str, got_dict = dataset.evaluation(got, classes)
    want_str, want_dict = dataset.evaluation(want, classes)
    assert got_str == want_str and got_dict == want_dict


def test_merge_results_dist_equals_jax(tmp_path):
    """Three ranks' parts on disk, merged by the main process: the port's
    merge equals the JAX package's (the interleave, the cut to `size`, the
    part files removed), each told that the group has three ranks; a gloo
    group of one reads back its own part."""
    import jax

    from lidardetection_tpu.parallel import dist as jax_dist
    from lidardetection_tpu_torch.parallel import dist

    parts = [[{'frame_id': f'{i:06d}', 'rank': r} for i in range(4)]
             for r in range(3)]
    merged = {}
    for name, module, patches in (
            ('jax', jax_dist, (('process_count', jax, lambda: 3),
                               ('barrier', jax_dist, lambda name='': None))),
            ('port', dist, (('get_world_size', dist, lambda: 3),))):
        tmpdir = tmp_path / name
        tmpdir.mkdir()
        for r in (1, 2):  # the other ranks' parts
            with open(tmpdir / f'result_part_{r}.pkl', 'wb') as f:
                pickle.dump(parts[r], f)
        with pytest.MonkeyPatch.context() as mp:
            for attr, owner, value in patches:
                mp.setattr(owner, attr, value)
            merged[name] = module.merge_results_dist(parts[0], 10, tmpdir)
        assert not tmpdir.exists(), name
    assert merged['port'] == merged['jax']
    assert [(a['rank'], a['frame_id']) for a in merged['port'][:4]] == \
        [(0, '000000'), (1, '000000'), (2, '000000'), (0, '000001')]
    assert len(merged['port']) == 10

    torch.distributed.init_process_group(
        'gloo', init_method=f'tcp://localhost:{free_port()}', world_size=1,
        rank=0)
    try:
        assert dist.in_group() and dist.get_world_size() == 1
        assert dist.merge_results_dist(parts[0], 3, tmp_path / 'one') == \
            parts[0][:3]
        assert not (tmp_path / 'one').exists()
    finally:
        torch.distributed.destroy_process_group()
    assert not dist.in_group()
