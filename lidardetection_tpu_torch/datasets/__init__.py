"""The dataset registry and the loader (the JAX package's
lidardetection_tpu/datasets/__init__.py): ``build_dataloader`` makes a
config's dataset from its tree on disk and a ``DataLoader`` over it.

The loader is ``torch.utils.data.DataLoader``. Its batch sampler
(`BatchIndices`) yields the JAX package's batches: the order shuffled from
``RandomState(seed + epoch)`` in training, padded so that every shard sees
as many samples, cut into batches (training drops the last partial one,
test fills it with the first samples again). A batch is a dict of numpy
arrays: ``collate_batch``, then in test mode the voxel tables cut to the
batch's occupancy (``synthetic.bucket_voxels``).

With ``workers`` > 1, forked worker processes build whole batches ahead of
the step, two a worker; they touch numpy and the host library only, never
the card. A worker's samples draw from ``RandomState((seed + 1) * 1000003
+ epoch * 97 + worker_id)``, the JAX package's seeds; in the loader's own
process the draws come from the first worker's seed. A worker writes a batch's arrays into one of its
shared-memory slots (``SharedSlots``), made once and reused, and sends
their layout; the loader's process copies them out (into page-locked
memory where a card is present, so the step's copy to it is a DMA) and
frees the slot. A worker that dies raises in the loader's process. gt
sampling's pointers are state of each process, so worker batches equal
serial ones in their frames, and bit for bit only without augmentation.
"""

import importlib
import os

import numpy as np
import torch

from .. import native
from .dataset import DatasetTemplate

PREFETCH = 2  # batches each worker builds ahead (the JAX loader's prefetch)

DATASETS = {
    'SyntheticDataset': 'synthetic',
    'KittiDataset': 'kitti.kitti_dataset',
    'NuScenesDataset': 'nuscenes.nuscenes_dataset',
    'PlusAIDataset': 'plusai.plusai_dataset',
    'PlusAIMultiframeDataset': 'plusai.plusai_dataset',
    'LivoxDataset': 'livox.livox_dataset',
    'LivoxMultiFrameDataset': 'livox.livox_dataset',
    'MixDataset': 'mix_data.mix_dataset',
}


def dataset_class(name):
    """The dataset class a DATA_CONFIG's DATASET names."""
    if name not in DATASETS:
        raise NotImplementedError(f'no dataset {name}: the datasets are '
                                  f'{sorted(DATASETS)}')
    module = importlib.import_module(f'.{DATASETS[name]}', __name__)
    return getattr(module, name)


def blas_thread_setters():
    """The thread-count setters of the OpenBLAS builds loaded in this
    process (numpy's, scipy's), found by name in its memory map; empty
    where numpy links another BLAS."""
    import ctypes

    with open('/proc/self/maps') as f:
        paths = sorted({line.split()[-1] for line in f
                        if 'openblas' in line.lower() and '.so' in line})
    setters = []
    for path in paths:
        lib = ctypes.CDLL(path)
        for name in ('openblas_set_num_threads', 'openblas_set_num_threads64_',
                     'scipy_openblas_set_num_threads',
                     'scipy_openblas_set_num_threads64_'):
            setter = getattr(lib, name, None)
            if setter is not None:
                setters.append(setter)
                break
    return setters


def worker_seed(seed, epoch, worker_id):
    """The seed of a loader worker's generator (datasets/__init__.py:174)."""
    return (seed + 1) * 1000003 + epoch * 97 + worker_id


class BatchIndices(torch.utils.data.Sampler):
    """The sample indices of each batch of an epoch, as the JAX package's
    ``DataLoader._indices`` and ``__iter__`` cut them."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 drop_last=True, num_shards=1, shard_id=0):
        self.dataset, self.batch_size = dataset, batch_size
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.num_shards, self.shard_id = num_shards, shard_id
        self.epoch = 0

    def indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        per_shard = -(-n // self.num_shards)
        total = per_shard * self.num_shards
        idx = np.concatenate([idx, idx[:total - n]])
        return idx[self.shard_id::self.num_shards]

    def __len__(self):
        n = len(self.indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        idx = self.indices()
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    return
                chunk = np.concatenate([chunk, idx[:self.batch_size - len(chunk)]])
            yield [int(j) for j in chunk]


class SharedSlots:
    """Each worker's shared-memory slots for the arrays of its batches,
    made by the worker at first need (or when a batch outgrows one) and
    sent to the loader's process once; after that a batch crosses as its
    slot and layout only. Fresh shared memory for every batch, PyTorch's
    default, costs page faults on both sides each time (on a host where
    faults are dear, more than a worker takes to build a SECOND batch),
    and the loader's process pays its share on one thread. A slot is busy
    from the worker's write to the copy-out in the loader's process; a
    worker takes a free one or makes another."""

    SLOT = '_slot'
    MOST = 64  # slots a worker may hold: far above the batches it has out

    def __init__(self, workers):
        self.busy = torch.zeros((workers, self.MOST), dtype=torch.int32)
        self.busy.share_memory_()  # made before the fork: the workers share it
        self.owned = []   # a worker's own slots
        self.mapped = {}  # the loader's process: (worker, slot) -> slot

    def put(self, worker, batch):
        """In a worker: `batch` with its numeric arrays written into a free
        slot, replaced by the slot's key and their layout."""
        arrays = {k: v for k, v in batch.items()
                  if isinstance(v, np.ndarray) and v.dtype.kind in 'biuf'}
        layout, size = [], 0
        for key, v in arrays.items():
            layout.append((key, v.dtype.str, v.shape, size))
            size += -(-v.nbytes // 64) * 64
        busy = self.busy[worker].numpy()
        free = [k for k, slot in enumerate(self.owned) if not busy[k]]
        k = next((k for k in free if self.owned[k].numel() >= size),
                 free[0] if free else len(self.owned))
        if k == busy.size:
            raise RuntimeError(f'loader worker {worker}: all {k} slots busy')
        if k == len(self.owned):
            self.owned.append(None)
        sent = None
        if self.owned[k] is None or self.owned[k].numel() < size:
            sent = self.owned[k] = torch.empty(size + size // 4,
                                               dtype=torch.uint8)
            sent.share_memory_()
        buf = self.owned[k].numpy()
        for key, dtype, shape, offset in layout:
            v = arrays[key]
            buf[offset:offset + v.nbytes].view(dtype).reshape(shape)[...] = v
        busy[k] = 1
        rest = {key: v for key, v in batch.items() if key not in arrays}
        return {**rest, self.SLOT: (worker, k, sent, layout)}

    def take(self, batch, pinned):
        """In the loader's process: the arrays copied out of the batch's
        slot (into page-locked memory with `pinned`), the slot freed."""
        worker, k, sent, layout = batch.pop(self.SLOT)
        if sent is not None:
            self.mapped[worker, k] = sent
        buf = self.mapped[worker, k].numpy()
        for key, dtype, shape, offset in layout:
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            v = buf[offset:offset + n].view(dtype).reshape(shape)
            batch[key] = torch.from_numpy(v).pin_memory().numpy() if pinned \
                else v.copy()
        self.busy[worker, k] = 0
        return batch


class DataLoader:
    """Batches of `dataset` (see the module's docstring); ``set_epoch``
    before each epoch, as the JAX package's loader."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 drop_last=True, num_shards=1, shard_id=0, num_workers=0,
                 bucket_voxels=False):
        self.dataset = dataset
        self.sampler = BatchIndices(dataset, batch_size, shuffle, seed,
                                    drop_last, num_shards, shard_id)
        self.seed, self.num_workers = seed, num_workers
        self.bucket_voxels = bucket_voxels
        self._slots = None  # the SharedSlots of the latest iteration

    @property
    def epoch(self):
        return self.sampler.epoch

    def set_epoch(self, epoch):
        self.sampler.epoch = epoch

    def __len__(self):
        return len(self.sampler)

    def collate(self, items):
        """A batch of samples: stacked, and bucketed in test mode."""
        batch = self.dataset.collate_batch(items)
        if self.bucket_voxels and 'voxels' in batch:
            from .synthetic import bucket_voxels
            bucket_voxels(batch, self.dataset.sparse_plan)
        return batch

    def _worker_collate(self, items):
        batch = self.collate(items)
        worker = torch.utils.data.get_worker_info()
        if worker is not None:
            batch = self._slots.put(worker.id, batch)
        return batch

    def _worker_init(self, worker_id):
        # one thread of torch and of numpy's BLAS a worker: with a BLAS
        # thread a core in each, W workers oversubscribe the host's cores
        # (the variables hold for a BLAS the worker loads later, as scipy's)
        torch.set_num_threads(1)
        for setter in blas_thread_setters():
            setter(1)
        for name in ('OPENBLAS_NUM_THREADS', 'OMP_NUM_THREADS'):
            os.environ[name] = '1'
        dataset = torch.utils.data.get_worker_info().dataset
        dataset.rng = np.random.RandomState(
            worker_seed(self.seed, self.epoch, worker_id))

    def __iter__(self):
        if self.num_workers > 0:
            # built here, not by the workers at once: the library's lock
            # holds within one process only
            if not native.plain_requested():
                native.load()
            # the workers inherit it in their copy of this loader
            slots = self._slots = SharedSlots(self.num_workers)
            workers = {'num_workers': self.num_workers,
                       'worker_init_fn': self._worker_init,
                       'multiprocessing_context': 'fork',
                       'prefetch_factor': PREFETCH}
        else:
            self.dataset.rng = np.random.RandomState(
                worker_seed(self.seed, self.epoch, 0))
            slots, workers = None, {}
        pinned = torch.cuda.is_available()
        batches = iter(torch.utils.data.DataLoader(
            self.dataset, batch_sampler=self.sampler,
            collate_fn=self._worker_collate, **workers))
        try:
            for batch in batches:
                yield slots.take(batch, pinned) if slots else batch
        finally:
            del batches  # the workers end with their iterator


def build_dataloader(dataset_cfg, class_names, batch_size, training=True,
                     root_path=None, workers=4, logger=None, model_cfg=None,
                     num_shards=1, shard_id=0,
                     merge_all_iters_to_one_epoch=False, total_epochs=0,
                     seed=0, **dataset_kwargs):
    """(dataset, loader) of a DATA_CONFIG's dataset at `root_path` (default
    its DATA_PATH), `dataset_kwargs` passed to the dataset (the synthetic
    set's ``num_scenes``). With `model_cfg` the samples carry the model's host
    plan and only the raw points it reads (``DatasetTemplate.set_model``).
    `workers` > 1 forks that many worker processes (at most the host's
    cores); training shuffles and drops the last partial batch, test
    buckets the voxel tables unless DATA_CONFIG.VOXEL_BUCKETING is false."""
    dataset = dataset_class(dataset_cfg['DATASET'])(
        dataset_cfg=dataset_cfg, class_names=class_names, training=training,
        root_path=root_path, logger=logger, seed=seed, **dataset_kwargs)
    if model_cfg is not None:
        dataset.set_model(model_cfg)
    if merge_all_iters_to_one_epoch:
        dataset.merge_all_iters_to_one_epoch(merge=True, epochs=total_epochs)
    cores = os.cpu_count() or 1
    loader = DataLoader(
        dataset, batch_size=batch_size, shuffle=training, seed=seed,
        drop_last=training, num_shards=num_shards, shard_id=shard_id,
        num_workers=min(workers, cores) if workers > 1 and cores > 1 else 0,
        bucket_voxels=not training and bool(
            dataset_cfg.get('VOXEL_BUCKETING', True)))
    return dataset, loader


__all__ = ['DatasetTemplate', 'DataLoader', 'BatchIndices', 'SharedSlots',
           'blas_thread_setters', 'build_dataloader', 'dataset_class',
           'worker_seed']
