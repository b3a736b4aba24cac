"""K5 ``ball_select``: per center and radius, the first ``nsample``
in-radius candidates of its row runs by ascending original index (kernel
in csrc/ball_select.cu).

Replaces the TPU kernel ``lidardetection_tpu/ops/select_tpu.py::
ball_select`` (Pallas ``_select_kernel``), which
``ops/pointnet2.py::grid_ball_query_multi`` calls once per MSG group with
all its radii. For center ``r`` of sample ``b`` and radius ``i``:

    out_i[b, r, s] = -orig[b, p] of the s-th hit by ascending orig, over
                     the rows p in [start[b, r, j], end[b, r, j]), j < n_row,
                     whose d2 to the center is below radius_i^2; -inf past
                     the last hit

with ``d2 = ((x - cx)^2 + (y - cy)^2) + (z - cz)^2`` in float32, each
product and sum rounded on its own, and ``radius_i^2`` squared in float32,
as the TPU kernel squares it. The table is the sample's cell-sorted source
table (xyz and original row index); runs are at most ``max_run`` rows long
(the prep cuts them) and disjoint, so orig is unique per center.

The TPU kernel reads packed field-major candidate windows, a workaround for
XLA:TPU's per-index gather billing; the Hopper kernel reads the sorted
table directly. Bound on the H100: see the csrc note (latency of dependent
steps at one request's shapes; bytes and FLOP are both small). The kernel
packs a hit into 4 bytes (orig << 4 and one bit a radius), so the table
holds fewer than 2^28 rows; ``select_launch_plan`` sizes a block's
shared memory from the shape.

``ball_select`` takes the plain PyTorch version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; ``ball_select.launches``
counts the launches.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build

MAX_RADII = 4  # csrc/ball_select.cu
MAX_ROWS = 1 << 28  # orig << 4 fits 32 bits
HIT_CAP = 1024  # hits a center keeps in shared memory; a center with more
                # reads its runs again for each pass (exact, slower)
HIST_BINS = 256  # the radix select's histogram
SMEM_LIMIT = 227 * 1024 - 256  # a block's shared memory on the H100, less
                               # the kernel's static block-wide values


class SelectPlan(NamedTuple):
    cap: int  # hits a center (a block) keeps in shared memory
    list_cap: int  # taken hits of a radius: the largest nsample
    smem_bytes: int  # dynamic shared memory a block


def select_launch_plan(n_row, max_run, nsamples):
    """K5's launch plan from the shape alone: one block of two warps a
    center, holding in shared memory up to ``min(n_row * max_run,
    HIT_CAP)`` 4-byte hits, a ``HIST_BINS`` histogram, a taken list of
    ``max(nsamples)`` entries, and its runs' starts and offsets. Raises
    ValueError for a shape no block can hold."""
    cap = min(n_row * max_run, HIT_CAP)
    list_cap = max(nsamples)
    smem = 4 * (cap + HIST_BINS + list_cap + 2 * n_row + 1)
    if smem > SMEM_LIMIT:
        raise ValueError(f'ball_select cannot hold n_row {n_row} and nsample '
                         f'{list_cap} in one block\'s shared memory')
    return SelectPlan(cap, list_cap, smem)


def squared_radii(radii):
    """float32(radius) squared in float32, as the TPU kernel squares it."""
    return [float(np.float32(r) * np.float32(r)) for r in radii]


def ball_select_plain(xyz, orig, start, end, centers, radii, nsamples,
                      max_run):
    """Plain PyTorch version: gather ``[start, start + max_run)`` of every
    run, mask with ``[start, end)``, then the top-k of ``-orig`` per radius.

    Args:
        xyz (B, N, 3) f32 and orig (B, N) int32: the cell-sorted table;
        start, end (B, M, n_row) int32 row runs;
        centers (B, M, 3) f32; radii, nsamples: static tuples;
        max_run: static run length cap.
    Returns a list of (B, M, nsample_i) f32 score tensors.
    """
    b, n = orig.shape
    m, n_row = start.shape[1:]
    pos = start[..., None].long() + torch.arange(max_run, device=xyz.device)
    live = pos < end[..., None].long()
    flat = pos.clamp(max=n - 1).reshape(b, -1)
    cand = torch.gather(xyz, 1, flat[..., None].expand(-1, -1, 3))
    cand = cand.reshape(b, m, n_row, max_run, 3)
    neg_orig = -torch.gather(orig, 1, flat).float().reshape(b, m, n_row, max_run)
    c = centers[:, :, None, None, :]
    dx, dy, dz = (cand[..., i] - c[..., i] for i in range(3))
    d2 = (dx * dx + dy * dy) + dz * dz
    outs = []
    for r2, ns in zip(squared_radii(radii), nsamples):
        hit = live & (d2 < r2)
        score = torch.where(hit, neg_orig, torch.full_like(neg_orig, -np.inf))
        score = score.reshape(b, m, n_row * max_run)
        k = min(ns, score.shape[-1])
        top = torch.topk(score, k, dim=-1).values
        if k < ns:
            top = torch.cat([top, top.new_full((b, m, ns - k), -np.inf)], -1)
        outs.append(top)
    return outs


@functools.cache  # one ctypes binding per process
def _launcher():
    fn = _build.load('ball_select').ball_select_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(xyz, orig, start, end, centers, radii, nsamples, max_run):
    b, n, _ = xyz.shape
    m, n_row = start.shape[1:]
    want = {
        'xyz': (xyz, (b, n, 3), torch.float32),
        'orig': (orig, (b, n), torch.int32),
        'start': (start, (b, m, n_row), torch.int32),
        'end': (end, (b, m, n_row), torch.int32),
        'centers': (centers, (b, m, 3), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if t.device != xyz.device:
            raise ValueError(f'{name} is on {t.device}, xyz on {xyz.device}')
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, want {shape}')
        if t.dtype != dtype:
            raise ValueError(f'{name} has dtype {t.dtype}, want {dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if not 1 <= len(radii) == len(nsamples) <= MAX_RADII:
        raise ValueError(f'want 1 to {MAX_RADII} radii, one nsample each')
    if min(nsamples) < 1 or max_run < 1 or n < 1:
        raise ValueError('nsamples, max_run and the table must be positive')
    if b * max(m, n) >= 2 ** 31 or b * m * n_row >= 2 ** 31:
        raise ValueError('sizes out of int32 range')
    if n >= MAX_ROWS:
        raise ValueError(f'a table of {n} rows: the kernel takes fewer than '
                         f'{MAX_ROWS}')


def ball_select(xyz, orig, start, end, centers, radii, nsamples, max_run):
    """K5: the (B, M, nsample_i) -orig scores of each radius (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    if xyz.device.type == 'cpu':
        return ball_select_plain(xyz, orig, start, end, centers, radii,
                                 nsamples, max_run)
    if xyz.device.type != 'cuda':
        raise ValueError(f'ball_select runs on cpu or cuda, not {xyz.device}')
    _check(xyz, orig, start, end, centers, radii, nsamples, max_run)
    b, n = orig.shape
    m, n_row = start.shape[1:]
    outs = [torch.empty((b, m, int(ns)), dtype=torch.float32,
                        device=xyz.device) for ns in nsamples]
    k = len(radii)
    r2 = (ctypes.c_float * k)(*squared_radii(radii))
    ns = (ctypes.c_int * k)(*(int(s) for s in nsamples))
    ptrs = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
    plan = select_launch_plan(n_row, int(max_run), nsamples)
    if b * m == 0:
        return outs
    with torch.cuda.device(xyz.device):
        rc = _launcher()(
            xyz.data_ptr(), orig.data_ptr(), start.data_ptr(), end.data_ptr(),
            centers.data_ptr(), b * m, m, n, n_row, int(max_run), k, r2, ns,
            ptrs, plan.cap, plan.list_cap,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'ball_select kernel launch failed: CUDA error {rc}')
    ball_select.launches += 1
    return outs


ball_select.launches = 0
