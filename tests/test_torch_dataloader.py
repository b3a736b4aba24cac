"""The port's loader (``datasets/__init__.py``) against the JAX package's.

* Batch composition: ``BatchIndices`` yields the JAX ``DataLoader``'s
  batches for shuffled and ordered epochs, drop_last or filled, one shard
  or three, two epochs each.
* Forked workers against the loader's own process on the KITTI tree of
  test_torch_kitti_dataset.py: the same frame ids in every batch of two
  epochs; with the augmentor and the point shuffle off (their draws
  differ between processes), every array equal bit for bit, numpy arrays
  on the loader's side.
* Test-mode batches of second.yaml's host plan, bucketed, against the JAX
  package's ``build_dataloader``: every array equal (the ``rb_*`` tables
  cut and their values clamped), but the raw points, which the port leaves
  out for a model that does not read them.
* A worker killed mid-epoch raises in the loader's process within 30 s.
* A worker runs numpy's BLAS (OpenBLAS here) at one thread, the loader's
  process at its own count.
* ``SharedSlots``: a slot is reused once its batch is copied out, another
  is made while it is busy or when a batch outgrows it; batches that the
  consumer keeps stay intact while the workers reuse their slots.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import DataLoader as JaxDataLoader
from lidardetection_tpu.datasets import build_dataloader as jax_build_dataloader
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.datasets import (
    BatchIndices, DataLoader, DatasetTemplate, SharedSlots,
    blas_thread_setters, build_dataloader,
)
from lidardetection_tpu_torch.datasets.kitti import kitti_dataset
from test_torch_kitti_dataset import CLASSES, write_tree


class Frames:
    """A dataset of `n` frames whose samples are their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        return {'frame_id': index}

    @staticmethod
    def collate_batch(items):
        return {'frame_id': np.array([s['frame_id'] for s in items])}


@pytest.mark.parametrize('shards', [1, 3])
@pytest.mark.parametrize('shuffle,drop_last', [(True, True), (False, False),
                                               (True, False)])
def test_batch_indices_equal_jax(shuffle, drop_last, shards):
    for shard_id in range(shards):
        want = JaxDataLoader(Frames(11), 3, shuffle=shuffle, seed=4,
                             drop_last=drop_last, num_shards=shards,
                             shard_id=shard_id, prefetch=0)
        got = BatchIndices(Frames(11), 3, shuffle=shuffle, seed=4,
                           drop_last=drop_last, num_shards=shards,
                           shard_id=shard_id)
        epochs = []
        for epoch in (0, 1):
            want.set_epoch(epoch)
            got.epoch = epoch
            batches = [b['frame_id'].tolist() for b in want]
            assert list(got) == batches and len(got) == len(want)
            epochs.append(batches)
        assert (epochs[0] != epochs[1]) == shuffle


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti_loader')
    write_tree(root)
    cfg = cfg_from_yaml_file('tools/cfgs/dataset_configs/kitti_dataset.yaml')
    kitti_dataset.create_kitti_infos(cfg, CLASSES, root, root, workers=1)
    return root


@pytest.mark.parametrize('augment', [True, False], ids=['augmented', 'plain'])
def test_worker_batches_equal_serial(tree, augment):
    cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml')
    data = cfg.DATA_CONFIG
    if not augment:
        del data.DATA_AUGMENTOR
        data.DATA_PROCESSOR = [p for p in data.DATA_PROCESSOR
                               if p.NAME != 'shuffle_points']
    batches = {}
    for workers in (0, 2):
        _, loader = build_dataloader(data, CLASSES, 1, training=True,
                                     root_path=tree, workers=workers,
                                     model_cfg=cfg.MODEL, seed=2)
        assert loader.num_workers == workers
        batches[workers] = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            batches[workers] += list(loader)
    serial, pooled = batches[0], batches[2]
    assert len(serial) == len(pooled) == 6
    ids = [b['frame_id'].tolist() for b in serial]
    assert ids[:3] != ids[3:] and sorted(ids[:3]) == sorted(ids[3:])
    for a, b in zip(serial, pooled):
        assert set(a) == set(b) and 'points' not in a
        np.testing.assert_array_equal(a['frame_id'], b['frame_id'])
        for key, value in b.items():
            assert not torch.is_tensor(value), key
        if not augment:
            for key in a:
                if key != 'calib':
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_bucketed_test_batches_equal_jax(tree):
    jcfg = jax_cfg_from_yaml('tools/cfgs/kitti_models/second.yaml')
    pcfg = cfg_from_yaml_file('tools/cfgs/kitti_models/second.yaml')
    _, want_loader = jax_build_dataloader(
        jcfg.DATA_CONFIG, CLASSES, 2, training=False, root_path=tree,
        model_cfg=jcfg.MODEL)
    _, got_loader = build_dataloader(pcfg.DATA_CONFIG, CLASSES, 2,
                                     training=False, root_path=tree,
                                     model_cfg=pcfg.MODEL, workers=0)
    (want,), (got,) = list(want_loader), list(got_loader)
    # one val frame, filled up to the batch with itself
    assert got['frame_id'].tolist() == want['frame_id'].tolist() == ['000003'] * 2
    assert set(got) == set(want) - {'points', 'num_points'}
    assert got['voxels'].shape[1] < 40000  # cut to the occupancy
    rulebooks = [k for k in got if k.startswith('rb_')]
    assert len(rulebooks) > 8
    for key in got:
        if key == 'calib':
            continue
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


class Dying:
    """Eight frames; a worker process that reaches frame 5 is killed."""

    rng = None
    sparse_plan = None
    collate_batch = staticmethod(DatasetTemplate.collate_batch)

    def __len__(self):
        return 8

    def __getitem__(self, index):
        if index == 5 and torch.utils.data.get_worker_info() is not None:
            os.kill(os.getpid(), signal.SIGKILL)
        return {'x': np.full(3, index, np.float32)}


def test_a_dead_worker_raises():
    loader = DataLoader(Dying(), 2, num_workers=2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='worker'):
        list(loader)
    assert time.monotonic() - t0 < 30
    # in the loader's own process nothing dies
    assert len(list(DataLoader(Dying(), 2, num_workers=0))) == 4


def blas_threads():
    """The thread count of each OpenBLAS build loaded in this process."""
    import ctypes

    with open('/proc/self/maps') as f:
        paths = sorted({line.split()[-1] for line in f
                        if 'openblas' in line.lower() and '.so' in line})
    counts = []
    for path in paths:
        lib = ctypes.CDLL(path)
        for name in ('openblas_get_num_threads', 'openblas_get_num_threads64_',
                     'scipy_openblas_get_num_threads',
                     'scipy_openblas_get_num_threads64_'):
            getter = getattr(lib, name, None)
            if getter is not None:
                counts.append(getter())
                break
    return counts


class BlasThreads(Frames):
    def __getitem__(self, index):
        return {'frame_id': index, 'threads': np.array(blas_threads())}

    @staticmethod
    def collate_batch(items):
        return {'frame_id': np.array([s['frame_id'] for s in items]),
                'threads': np.stack([s['threads'] for s in items])}


def test_workers_run_blas_at_one_thread():
    assert blas_thread_setters(), 'numpy links OpenBLAS here'
    own = blas_threads()
    batches = list(DataLoader(BlasThreads(8), 2, num_workers=2))
    assert [b['frame_id'].tolist() for b in batches] == [[0, 1], [2, 3],
                                                         [4, 5], [6, 7]]
    assert all((b['threads'] == 1).all() for b in batches)
    assert blas_threads() == own


def slot_batch(index, rows):
    return {'x': np.arange(rows * 3, dtype=np.float32).reshape(rows, 3) + index,
            'mask': np.arange(rows) % 2 == 0, 'frame_id': np.array([f'{index:06d}'])}


def test_shared_slots_reuse_and_grow():
    slots = SharedSlots(workers=1)
    kept = []
    for index, rows in enumerate((4, 4, 9, 3)):
        sent = slots.put(0, slot_batch(index, rows))
        worker, k, new, _ = sent[SharedSlots.SLOT]
        kept.append((k, new is not None))
        got = slots.take(sent, pinned=False)
        want = slot_batch(index, rows)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    # the first batch makes slot 0, the second reuses it, the third
    # outgrows it and makes it anew, the fourth fits
    assert kept == [(0, True), (0, False), (0, True), (0, False)]
    # while a batch is not taken its slot is busy: the next takes another
    first, second = slots.put(0, slot_batch(7, 2)), slots.put(0, slot_batch(8, 2))
    assert first[SharedSlots.SLOT][1] != second[SharedSlots.SLOT][1]
    np.testing.assert_array_equal(slots.take(second, False)['x'],
                                  slot_batch(8, 2)['x'])
    np.testing.assert_array_equal(slots.take(first, False)['x'],
                                  slot_batch(7, 2)['x'])


class Arrays(Frames):
    def __getitem__(self, index):
        return slot_batch(index, 5)

    @staticmethod
    def collate_batch(items):
        return {key: np.stack([s[key] for s in items]) for key in items[0]}


def test_kept_batches_stay_intact():
    loader = DataLoader(Arrays(40), 2, num_workers=2)
    batches = list(loader)  # every batch kept while the workers go on
    assert len(batches) == 20
    for i, batch in enumerate(batches):
        want = Arrays.collate_batch([slot_batch(2 * i + j, 5) for j in (0, 1)])
        for key in want:
            np.testing.assert_array_equal(batch[key], want[key])
