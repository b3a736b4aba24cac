"""The training CLI (``lidardetection_tpu_torch/train.py``) at the JAX tool's
parity (tools/train.py), on the CPU.

* The config: for every model YAML, ``TAG``, ``EXP_GROUP_PATH`` and the
  lines of ``log_config_to_file`` equal the JAX package's; a ``--set``
  list gives the same config in both.
* The registered SyntheticDataset: ``build_dataloader`` at B = 4 over 8
  scenes gives the JAX package's batches, no workers on either side, bit
  for bit (points, voxels, coordinates, voxel counts, gt boxes, frame
  ids), two epochs. In training the point shuffle draws from the loader's
  generator: the port's in-process loader takes the first worker's seed
  (``worker_seed(seed, epoch, 0)``), and the JAX loader, whose samples
  draw from numpy's global generator, runs after ``np.random.seed`` of
  the same seed, so the draws match by construction. Two port workers
  give the batches of none (the point shuffle off: a worker draws from
  its own seed).
* The CLI: ``main`` with ``--synthetic --profile`` and the epochs, the
  checkpoint interval and rotation and the repeat-eval of the JAX tool,
  from a working directory of its own, on a reduced PointPillar (a
  score threshold and NMS sizes that leave live detections at random
  weights): the checkpoints of epochs 2 and 3 under
  ``output/<folder>/<stem>/default/ckpt``, eval results in ``eval/`` and
  ``eval/epoch_2/``, the log ``log_train_<stamp>.txt`` with the config
  dumped, a Chrome trace of the window that the JAX tool's arithmetic
  gives (engine/trainer.py:36-45 of the JAX package), TensorBoard tags
  ``train/<the JAX step's tb keys>``, ``meta_data/learning_rate`` and
  ``eval/<key>``; then the port's ``tools.test --eval_all`` finds both
  checkpoints with no ``--ckpt_dir`` and reads the recall and the
  detections that the training run's own evaluation read.
* The global batch: two gloo ranks of the CLI with ``--batch_size 4``
  load 2 a step, and the group's first step equals the single-process
  step on the two ranks' batches stacked, within
  test_torch_distributed.py's bounds. Both compute in float64
  (``MODEL.COMPUTE_DTYPE``; the BatchNorm statistics stay float32): in
  float32 one leaf of these scenes, a deblock's transposed-conv weight,
  reads 3.3e-5 of its largest entry, where the group's float64 step is
  within 1e-6 of the single process's. That is the float32 statistics'
  ``s2 / cnt - mean^2`` cancelling over a mostly empty BEV map (ROADMAP
  section 3), summed in two parts in the group; test_torch_distributed.py
  holds the float32 group step on its scenes.
* The multi-node launch: ``train_multinode.sh`` as two node launches of
  one process each on 127.0.0.1 (gloo): both exit 0, node 1's process has
  rank 1 and local rank 0, and one set of checkpoints is written.

TensorFlow, where it is installed, is hidden from the CLI's processes:
``torch.utils.tensorboard`` then takes tensorboard's own stub, which
writes the same event files, instead of importing TensorFlow (about 20 s
a process here).
"""

import json
import logging
import os
import pickle
import re
import socket
import struct
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from lidardetection_tpu.config import (
    cfg_from_list as jax_cfg_from_list,
    cfg_from_yaml_file as jax_cfg_from_yaml,
    log_config_to_file as jax_log_config_to_file,
)
from lidardetection_tpu.datasets import build_dataloader as jax_build_dataloader
from lidardetection_tpu_torch import train
from lidardetection_tpu_torch.config import (
    cfg_from_list, cfg_from_yaml_file, log_config_to_file,
)
from lidardetection_tpu_torch.datasets import build_dataloader, worker_seed
from lidardetection_tpu_torch.engine.trainer import profile_window
from lidardetection_tpu_torch.parallel.train_step import device_batch
from lidardetection_tpu_torch.tools import test as test_tool
from lidardetection_tpu_torch.train import Trainer
import _torch_dist_worker as worker
from test_torch_pointpillar import _reduce
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
MODEL_CFGS = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / 'tools' / 'cfgs').glob('*_models/*.yaml'))
BATCH_KEYS = ('points', 'voxels', 'voxel_coords', 'voxel_num_points',
              'num_voxels', 'gt_boxes', 'frame_id')
SCENES = 8
LAUNCH_TIMEOUT_S = 240


def plain(tree):
    """A config as plain dicts and lists, for yaml."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    return tree


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def dumped(log_config, cfg):
    """The lines that `log_config` writes of `cfg`."""
    logger = logging.getLogger(f'{__name__}.dump')
    logger.propagate = False
    logger.setLevel(logging.INFO)
    lines = Lines()
    logger.addHandler(lines)
    try:
        log_config(cfg, logger=logger)
    finally:
        logger.removeHandler(lines)
    return lines.lines


@pytest.mark.parametrize('path', MODEL_CFGS)
def test_config_tags_and_dump_equal_jax(path):
    got, want = cfg_from_yaml_file(path), jax_cfg_from_yaml(path)
    assert (got.TAG, got.EXP_GROUP_PATH) == (want.TAG, want.EXP_GROUP_PATH) \
        == (Path(path).stem, Path(path).parent.name)
    lines = dumped(log_config_to_file, got)
    assert lines == dumped(jax_log_config_to_file, want)
    assert f'cfg.TAG: {want.TAG}' in lines


def test_set_list_gives_the_config_of_jax():
    path = 'tools/cfgs/kitti_models/second.yaml'
    overrides = ['OPTIMIZATION.LR', '0.001', 'OPTIMIZATION.NUM_EPOCHS', '3',
                 'MODEL.POST_PROCESSING.SCORE_THRESH', '0.25',
                 'DATA_CONFIG.POINT_CLOUD_RANGE', '[0, -40, -3, 70.4, 40, 1]',
                 'MODEL.POST_PROCESSING.NMS_CONFIG', "{'NMS_PRE_MAXSIZE': 128}"]
    args = train.parse_args(['--cfg_file', path, '--set', *overrides])
    assert args.set_cfgs == overrides
    got = cfg_from_list(args.set_cfgs, cfg_from_yaml_file(path))
    want = jax_cfg_from_list(overrides, jax_cfg_from_yaml(path))
    assert dumped(log_config_to_file, got) == dumped(jax_log_config_to_file, want)
    assert got.OPTIMIZATION.NUM_EPOCHS == 3
    assert got.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE == 128


def reduced(cfg):
    """test_torch_pointpillar.py's reduced PointPillar with a score
    threshold and NMS sizes that leave a random-weight model live
    detections, few enough for a quick eval."""
    cfg = _reduce(cfg)
    post = cfg.MODEL.POST_PROCESSING
    post.SCORE_THRESH = 0.001
    post.NMS_CONFIG.NMS_PRE_MAXSIZE = 128
    post.NMS_CONFIG.NMS_POST_MAXSIZE = 16
    return cfg


def write_small_cfg(path):
    cfg = reduced(cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml'))
    path.write_text(yaml.safe_dump(plain(cfg)))
    return path


def assert_batches_equal(got, want, keys=BATCH_KEYS):
    assert len(got) == len(want) == SCENES // 4
    for g, w in zip(got, want):
        for key in keys:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_synthetic_loader_gives_the_batches_of_jax(training):
    path = 'tools/cfgs/kitti_models/pointpillar.yaml'
    cfg, jcfg = _reduce(cfg_from_yaml_file(path)), _reduce(jax_cfg_from_yaml(path))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES),
                                       4, training=training, workers=0,
                                       num_scenes=SCENES)
    _, want_loader = jax_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, 4,
                                          training=training, workers=0,
                                          num_scenes=SCENES)
    assert type(dataset).__name__ == 'SyntheticDataset'
    assert (len(dataset), loader.num_workers) == (SCENES, 0)
    order = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        np.random.seed(worker_seed(0, epoch, 0))
        want = list(want_loader)
        got = list(loader)
        assert_batches_equal(got, want)
        order.append([int(i) for b in got for i in b['frame_id']])
    assert (order[0] != order[1]) == training
    assert sorted(order[0]) == list(range(SCENES))


def test_two_workers_give_the_batches_of_none():
    cfg = _reduce(cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml'))
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'shuffle_points':
            proc.SHUFFLE_ENABLED.train = False
    for training in (True, False):
        got, want = ([batch for batch in build_dataloader(
            cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), 4, training=training,
            workers=workers, num_scenes=SCENES, model_cfg=cfg.MODEL)[1]]
            for workers in (2, 0))
        keys = sorted(k for k in want[0] if isinstance(want[0][k], np.ndarray))
        assert set(BATCH_KEYS) - {'points'} <= set(keys)
        assert_batches_equal(got, want, keys)


def jax_tb_keys(cfg_file):
    """The loss terms of the JAX package's training step on `cfg_file`,
    read from the step's abstract evaluation (nothing is compiled)."""
    import jax

    from lidardetection_tpu.models import build_network
    from lidardetection_tpu.parallel.train_step import (
        device_batch as jax_device_batch,
    )

    cfg = jax_cfg_from_yaml(cfg_file)
    dataset, loader = jax_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 4,
                                           training=True, workers=0,
                                           num_scenes=4)
    batch = jax_device_batch(next(iter(loader)))
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                          dataset.dataset_info)
    variables = jax.eval_shape(partial(model.init, training=False),
                               jax.random.PRNGKey(0), batch)

    def terms(variables):
        out, _ = model.apply(variables, batch, training=True,
                             mutable=['batch_stats'])
        return model.apply(variables, out, method=model.loss)[1]

    return set(jax.eval_shape(terms, variables))


def scalar_events(event_dir):
    """{tag: [steps]} of the scalars in a TensorBoard directory's event
    files (TFRecords of ``Event`` protos)."""
    from tensorboard.compat.proto import event_pb2

    events = {}
    for path in sorted(Path(event_dir).glob('events.out.tfevents.*')):
        data, at = path.read_bytes(), 0
        while at < len(data):
            n = struct.unpack('<Q', data[at:at + 8])[0]
            event = event_pb2.Event.FromString(data[at + 12:at + 12 + n])
            at += 12 + n + 4
            for value in event.summary.value:
                events.setdefault(value.tag, []).append(event.step)
    return events


def test_cli_writes_the_layout_that_test_eval_all_reads(tmp_path, monkeypatch):
    cfg_file = write_small_cfg(tmp_path / 'pointpillar_small.yaml')
    want_keys = jax_tb_keys(str(cfg_file))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, 'tensorflow', None)
    evals = []
    real_eval = train.eval_one_epoch

    def recorded_eval(*args, **kwargs):
        evals.append(real_eval(*args, **kwargs))
        return evals[-1]

    monkeypatch.setattr(train, 'eval_one_epoch', recorded_eval)
    result = train.main([
        '--cfg_file', cfg_file.name, '--device', 'cpu', '--synthetic',
        '--num_scenes', str(SCENES), '--batch_size', '4', '--epochs', '3',
        '--ckpt_save_interval', '2', '--max_ckpt_save_num', '2',
        '--num_epochs_to_eval', '3', '--profile'])
    out = Path('output') / tmp_path.name / 'pointpillar_small' / 'default'

    ckpts = sorted((out / 'ckpt').iterdir())
    assert [p.name for p in ckpts] == ['checkpoint_epoch_2.pth',
                                       'checkpoint_epoch_3.pth']
    assert [torch.load(p, weights_only=True)['step'] for p in ckpts] == [4, 6]
    assert sorted(p.name for p in (out / 'eval').iterdir()) == \
        ['epoch_2', 'result.pkl']
    assert [p.name for p in (out / 'eval' / 'epoch_2').iterdir()] == \
        ['result.pkl']
    (final, annos), (earlier, earlier_annos) = evals
    assert final is result and 'Car_3d/moderate_R40' in result
    assert sum(len(a['name']) for a in annos + earlier_annos) > 0

    logs = list(out.glob('log_train_*.txt'))
    assert len(logs) == 1 and re.fullmatch(r'log_train_\d{8}-\d{6}\.txt',
                                           logs[0].name)
    log = logs[0].read_text()
    for line in dumped(log_config_to_file, cfg_from_yaml_file(str(cfg_file))):
        assert line in log, line

    # JAX's arithmetic (its engine/trainer.py:36-45) on 3 epochs of 2 steps
    total = 3 * (SCENES // 4)
    stop = min(15, total)
    start = min(10, max(stop - 2, 0))
    assert profile_window(total) == (start, stop) == (4, 6)
    assert f'profiler: tracing steps {start}-{stop}' in log
    traces = list((out / 'profile').iterdir())
    assert len(traces) == 1
    spans = {e['name'] for e in json.loads(traces[0].read_text())['traceEvents']
             if e.get('name', '').startswith('train_step ')}
    assert spans == {f'train_step {i}' for i in range(start, stop)}

    events = scalar_events(out / 'tensorboard')
    numeric = {k for k, v in result.items() if isinstance(v, (int, float))}
    assert set(events) == {f'train/{k}' for k in want_keys} | \
        {'meta_data/learning_rate'} | {f'eval/{k}' for k in numeric}
    assert events['meta_data/learning_rate'] == [1, 3, 5]
    assert events['eval/recall/rcnn_0.3'] == [6]

    results = test_tool.main([
        '--cfg_file', cfg_file.name, '--cpu', '--synthetic', '--num_scenes',
        str(SCENES), '--eval_all', '--max_waiting_mins', '0'])
    assert [(Path(c).resolve(), tag) for c, tag, _ in results] == \
        [(p.resolve(), f'epoch_{e}') for p, e in zip(ckpts, (2, 3))]
    for (_, tag, got), want, want_annos in zip(
            results, (earlier, final), (earlier_annos, annos)):
        recall = {k: v for k, v in want.items() if k.startswith('recall/')}
        assert recall and all(got[k] == v for k, v in recall.items()), tag
        with open(out / 'eval' / tag / 'result.pkl', 'rb') as f:
            read = pickle.load(f)
        assert [a['frame_id'] for a in read] == list(range(SCENES))
        for g, w in zip(read, want_annos):
            np.testing.assert_array_equal(g['boxes_lidar'], w['boxes_lidar'])
            np.testing.assert_array_equal(g['score'], w['score'])


def hidden_tensorflow(directory):
    """A directory for PYTHONPATH whose ``tensorflow`` does not import."""
    (directory / 'tensorflow').mkdir(parents=True)
    (directory / 'tensorflow' / '__init__.py').write_text(
        "raise ImportError('hidden')\n")
    return directory


def largest_share(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def test_batch_size_is_the_global_batch(tmp_path):
    cfg = worker.reduced_cfg('pointpillar')
    cfg.MODEL.COMPUTE_DTYPE = 'float64'
    (tmp_path / 'small.yaml').write_text(yaml.safe_dump(plain(cfg)))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(MASTER_ADDR='localhost', MASTER_PORT=str(free_port()),
               WORLD_SIZE='2', OMP_NUM_THREADS='1',
               PYTHONPATH=f'{hidden_tensorflow(tmp_path / "site")}:{ROOT}')
    out = tmp_path / 'result.pkl'
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / 'tests' / '_torch_dist_worker.py'),
         'cli-small.yaml', str(out)],
        env={**env, 'RANK': str(r), 'LOCAL_RANK': str(r)}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for r in range(2):
        with open(tmp_path / f'result.rank{r}.pkl', 'rb') as f:
            ranks.append(pickle.load(f))
    log = next((tmp_path / 'run').glob('log_train_*.txt')).read_text()
    assert 'global batch 4, 2 processes' in log
    assert '1 training batches of 2 a epoch' in log

    # the single process on the global batch: the ranks' batches stacked
    cfg.DATA_CONFIG.DATASET = 'SyntheticDataset'
    classes = list(cfg.CLASS_NAMES)
    shards = [next(iter(build_dataloader(
        cfg.DATA_CONFIG, classes, 2, training=True, workers=0,
        model_cfg=cfg.MODEL, seed=worker.SEED, num_shards=2, shard_id=r,
        num_scenes=worker.GLOBAL_BATCH)[1])) for r in range(2)]
    batch = device_batch({k: np.concatenate([s[k] for s in shards])
                          for k in shards[0]
                          if isinstance(shards[0][k], np.ndarray)}, 'cpu')
    trainer = Trainer(cfg, device='cpu', seed=worker.SEED, total_steps=1)
    want_tb, want_grads, want_buffers = worker.step_results(trainer, batch)
    for rows, (tb, grads, buffers) in ranks:
        assert rows == 2
        assert set(tb) == set(want_tb)
        assert abs(tb['loss'] - want_tb['loss']) <= 1e-6 * abs(want_tb['loss'])
        shares = {k: largest_share(grads[k], v) for k, v in want_grads.items()}
        worst = max(shares, key=shares.get)
        assert shares[worst] <= 2e-5, (worst, shares[worst])
        stats = {k: largest_share(buffers[k], v)
                 for k, v in want_buffers.items() if v.dtype.kind == 'f'}
        worst = max(stats, key=stats.get)
        assert stats[worst] <= 2e-5, (worst, stats[worst])


_SEEN = '''
import json, os
if 'RANK' in os.environ and 'GROUP_RANK' in os.environ:
    with open(os.path.join(os.environ['SEEN_DIR'], f'{os.getpid()}.json'),
              'w') as f:
        json.dump({k: os.environ[k] for k in
                   ('RANK', 'LOCAL_RANK', 'GROUP_RANK', 'WORLD_SIZE')}, f)
'''


def test_multinode_launcher_trains_once_over_two_nodes(tmp_path):
    """Two node launches of train_multinode.sh on this host; a
    ``sitecustomize`` on the launches' PYTHONPATH records the rank
    variables of each process that torchrun starts."""
    cfg_file = write_small_cfg(tmp_path / 'small.yaml')
    site = hidden_tensorflow(tmp_path / 'site')
    (site / 'sitecustomize.py').write_text(_SEEN)
    seen = tmp_path / 'seen'
    seen.mkdir()
    out = tmp_path / 'run'
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(NNODES='2', NGPUS='1', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(free_port()), OMP_NUM_THREADS='1',
               PYTHONPATH=f'{site}:{ROOT}', SEEN_DIR=str(seen),
               PATH=f'{Path(sys.executable).parent}:{env.get("PATH", "")}')
    script = ROOT / 'lidardetection_tpu_torch' / 'tools' / 'scripts' / \
        'train_multinode.sh'
    procs = [subprocess.Popen(
        ['bash', str(script), str(cfg_file), '--device', 'cpu', '--synthetic',
         '--num_scenes', '4', '--batch_size', '4', '--epochs', '1',
         '--workers', '0', '--no_eval', '--output_dir', str(out)],
        env={**env, 'NODE_RANK': str(node)}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for node in (0, 1)]
    try:
        logs = [p.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = sorted((d['GROUP_RANK'], d['RANK'], d['LOCAL_RANK'], d['WORLD_SIZE'])
                   for d in (json.loads(p.read_text()) for p in seen.iterdir()))
    assert ranks == [('0', '0', '0', '2'), ('1', '1', '0', '2')]
    assert [p.name for p in (out / 'ckpt').iterdir()] == \
        ['checkpoint_epoch_1.pth']
    logs = list(out.glob('log_train_*.txt'))
    assert len(logs) == 1
    log = logs[0].read_text()
    assert log.count('checkpoint saved') == 1
    assert '1 training batches of 2 a epoch, 0 loader workers, rank 0 of 2' in log
    assert torch.load(out / 'ckpt' / 'checkpoint_epoch_1.pth',
                      weights_only=True)['step'] == 1
