"""The process group (the counterpart of lidardetection_tpu/parallel/dist.py),
on ``torch.distributed``: one process a card, joined from ``torchrun``'s
environment, NCCL on the card and gloo on the CPU.

The group's training step is the single-process step over the global
batch, the ranks' batches stacked in rank order, as the JAX package's
sharded step is its single-device step (GSPMD):

* BatchNorm's sums (count, sum, sum of squares) are summed over the ranks
  before the mean and variance (``batch_moments``, JAX's ``psum``), with
  an all-reduce that autograd differentiates (``all_reduce_sum``);
* a loss normalised by a count over the batch (the point heads'
  foreground points, the RoI heads' valid RoIs) takes the group's count
  (``batch_normalizer``), so that each rank's loss is its share of the
  global loss times the group's size; a loss over the batch size is
  already so;
* the gradients are averaged over the ranks before the optimizer step
  (``average_gradients``): the global step's gradient;
* the random layers draw the global batch's numbers and take the rank's
  rows (``parallel/train_step.py::step_draw``).

In one process with no group each of these is the identity, bit for bit;
in a group of one they run their collectives, whose results are again the
single process's bits. The loader's shard of a rank is ``BatchIndices(
num_shards=world, shard_id=rank)`` (``datasets/__init__.py``), the
counterpart of JAX's ``shard_batch_multihost``; ``merge_results_dist``
gathers the ranks' eval results through the file system, as the JAX
package's (and the reference's) does.
"""

import os
import pickle
import shutil
from pathlib import Path

import torch
import torch.distributed as dist


def in_group():
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def get_rank():
    return dist.get_rank() if in_group() else 0


def get_world_size():
    return dist.get_world_size() if in_group() else 1


def init_distributed(backend=None):
    """Join the group that ``torchrun``'s environment describes (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): NCCL where CUDA is
    available, on the card LOCAL_RANK, else gloo. Returns (rank, world);
    (0, 1) and no group without that environment."""
    if 'WORLD_SIZE' not in os.environ:
        return 0, 1
    if not in_group():
        backend = backend or ('nccl' if torch.cuda.is_available() else 'gloo')
        if backend == 'nccl':
            torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
        dist.init_process_group(backend)
    return get_rank(), get_world_size()


def is_main_process():
    return get_rank() == 0


def main_process_value(value):
    """`value` as the main process has it, on every rank of a process
    group (the ranks then agree on what to evaluate and when to stop)."""
    if not in_group():
        return value
    shared = [value]
    dist.broadcast_object_list(shared, src=0)
    return shared[0]


def barrier():
    """Every rank waits for the others (the reference's dist.barrier())."""
    if in_group():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients
    of the result, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x):
    """`x` summed over the ranks, under autograd; `x` itself with no
    group."""
    return _AllReduceSum.apply(x) if in_group() else x


def batch_moments(cnt, s1, s2):
    """BatchNorm's (mean, biased variance) from the count `cnt` (a tensor,
    or a Python number counted from the shape), the sums `s1` and `s2`
    (C,) of the entries and of their squares, all three summed over the
    ranks in a group (one all-reduce): ``cnt = max(cnt, 1)``,
    ``var = max(s2 / cnt - mean^2, 0)``.

    A count from the shape stays a Python number, the rank's times the
    group's size, so that the division keeps its form, and its bits, in a
    group of one; the group's summed count is asserted on the device (no
    host sync) to equal it, which holds while every rank's tensor has the
    same shape."""
    if in_group():
        own = cnt.detach().reshape(1) if torch.is_tensor(cnt) else \
            torch.full((1,), float(cnt), device=s1.device)
        s1, s2, total = all_reduce_sum(torch.cat([s1, s2, own.to(s1.dtype)])) \
            .split([len(s1), len(s2), 1])
        total = total.detach()[0]
        if torch.is_tensor(cnt):
            cnt = total
        else:
            cnt = cnt * get_world_size()
            torch._assert_async(total == cnt,
                                'BatchNorm rows differ between the ranks')
    cnt = cnt.clamp(min=1.0) if torch.is_tensor(cnt) else max(cnt, 1.0)
    mean = s1 / cnt
    var = (s2 / cnt - mean * mean).clamp(min=0.0)
    return mean, var


def batch_normalizer(count):
    """The normaliser of a loss summed over the batch's counted entries:
    ``max(count, 1)``; in a group, ``max(the group's count, 1) / world``,
    so that the ranks' mean loss, the one the gradient average follows, is
    the global batch's loss. `count` is a float tensor with no gradient."""
    if not in_group():
        return count.clamp(min=1.0)
    total = count.detach().clone()
    dist.all_reduce(total)
    return total.clamp(min=1.0) / get_world_size()


def average_gradients(params):
    """Each parameter's gradient replaced by its mean over the ranks (one
    all-reduce of the gradients laid end to end)."""
    if not in_group():
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= get_world_size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def average_terms(tb):
    """The loss terms (0-d tensors) averaged over the ranks: the global
    batch's loss terms."""
    if not in_group() or not tb:
        return tb
    keys = sorted(tb)
    flat = torch.stack([tb[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    flat /= get_world_size()
    return dict(zip(keys, flat.unbind()))


def merge_results_dist(result_part, size, tmpdir):
    """The ranks' lists of Python objects gathered through a file system
    that every rank sees (common_utils.py:206-227): each rank pickles its
    part to `tmpdir`, the main process reads them all and interleaves them
    (a rank's loader shard is every world-th sample), cuts the list to
    `size` and removes the part files. Returns the merged list on the main
    process, None on the others."""
    tmpdir = Path(tmpdir)
    if is_main_process():
        tmpdir.mkdir(parents=True, exist_ok=True)
    barrier()
    rank, world = get_rank(), get_world_size()
    with open(tmpdir / f'result_part_{rank}.pkl', 'wb') as f:
        pickle.dump(result_part, f)
    barrier()
    if not is_main_process():
        barrier()  # the main process has read the parts
        return None
    part_list = []
    for r in range(world):
        with open(tmpdir / f'result_part_{r}.pkl', 'rb') as f:
            part_list.append(pickle.load(f))
    ordered = []
    for res in zip(*part_list):
        ordered.extend(res)
    # a later run with fewer ranks must not read stale parts
    shutil.rmtree(tmpdir, ignore_errors=True)
    barrier()
    return ordered[:size]
