"""Hard voxelization and the request batch: on the host (numpy), and on
the device of its input (``voxelize_device``).

Same semantics as the JAX package's ``ops/voxelize.py::voxelize_np``
(itself mirroring spconv's VoxelGenerator):

  * each in-range point maps to an integer (x, y, z) cell;
  * voxel slots are taken first-come, at most ``max_voxels`` of them;
  * each voxel keeps its first ``max_points_per_voxel`` points, in order;
  * the table is then sorted by linear key ``(z*gy + y)*gx + x``;
  * coords are (z, y, x), padded with -1.

``voxelize_np`` runs the host library's ``voxelize_f32``
(``native/voxelizer.cpp``, a copy of the JAX package's); its plain version,
vectorized with ``np.unique`` and a stable sort, is taken only when asked
for (``native.plain_host()`` or ``LIDARDET_TORCH_PLAIN_HOST=1``). Both give
the same arrays bit for bit. The TPU scatter's tile histogram
(``bev_tile_starts``) has no place here: the CUDA scatter writes each row
straight to its key.

``voxelize_device`` is the JAX package's ``voxelize_jax``: the same
contract on a cloud already on the device, in plain torch (a stable sort
and segment ranks), with voxel slots taken in key order. It is a library
function, as ``voxelize_jax`` is: neither package's server or loader calls
it.

A point-based config (PointRCNN) has no voxelizer: `build_point_batch`
samples and pads its raw points instead.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..config import grid_size_from_range
from ..datasets.processor.data_processor import (
    mask_points_by_range, pad_clouds, process_points,
)
from .sparse_plan import build_host_rulebooks


def voxelize_np(points, point_cloud_range, voxel_size, max_points_per_voxel,
                max_voxels):
    """Hard voxelizer.

    Args:
        points: (N, C) float array, C >= 3 (x, y, z, features...).
    Returns:
        voxels (max_voxels, max_points_per_voxel, C) float32, zero-padded;
        coords (max_voxels, 3) int32 (z, y, x), padded with -1;
        num_points_per_voxel (max_voxels,) int32;
        num_voxels int.
    """
    points = np.asarray(points, dtype=np.float32)
    if not native.plain_requested():
        return native.voxelize(points, point_cloud_range, voxel_size,
                               max_points_per_voxel, max_voxels)
    return voxelize_plain(points, point_cloud_range, voxel_size,
                          max_points_per_voxel, max_voxels)


def voxelize_plain(points, point_cloud_range, voxel_size,
                   max_points_per_voxel, max_voxels):
    """The numpy plain version of `voxelize_np`."""
    points = np.asarray(points, dtype=np.float32)
    pc_range = np.asarray(point_cloud_range, dtype=np.float32)
    vsz = np.asarray(voxel_size, dtype=np.float32)
    gx, gy, gz = (int(g) for g in grid_size_from_range(pc_range, vsz))

    voxels = np.zeros((max_voxels, max_points_per_voxel, points.shape[1]),
                      np.float32)
    coords = np.full((max_voxels, 3), -1, np.int32)
    num_points = np.zeros((max_voxels,), np.int32)

    # float32 arithmetic, as the reference voxelizer does it
    cell = np.floor((points[:, 0:3] - pc_range[0:3]) / vsz).astype(np.int64)
    in_range = np.all((cell >= 0) & (cell < np.array([gx, gy, gz])), axis=1)
    src = np.nonzero(in_range)[0]
    if src.size == 0:
        return voxels, coords, num_points, 0
    cell = cell[src]
    key = (cell[:, 2] * gy + cell[:, 1]) * gx + cell[:, 0]

    # uniq ascends by key; voxel u arrived as the arrival[u]-th new voxel
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    arrival = np.empty(uniq.size, np.int64)
    arrival[np.argsort(first, kind='stable')] = np.arange(uniq.size)
    kept = arrival < max_voxels
    row_of = np.cumsum(kept) - 1  # output row of each kept voxel
    n_vox = int(kept.sum())

    # rank of each point inside its voxel, in arrival order
    order = np.argsort(inv, kind='stable')
    inv_sorted = inv[order]
    rank = np.empty(order.size, np.int64)
    rank[order] = (np.arange(order.size)
                   - np.searchsorted(inv_sorted, inv_sorted, side='left'))

    take = kept[inv] & (rank < max_points_per_voxel)
    rows = row_of[inv[take]]
    voxels[rows, rank[take]] = points[src[take]]
    num_points[:n_vox] = np.bincount(rows, minlength=n_vox)
    k = uniq[kept]
    coords[:n_vox, 0] = k // (gx * gy)
    coords[:n_vox, 1] = (k // gx) % gy
    coords[:n_vox, 2] = k % gx
    return voxels, coords, num_points, n_vox


def voxelize_device(points, num_valid_points, point_cloud_range, voxel_size,
                    max_points_per_voxel, max_voxels):
    """Hard voxelizer on the device of `points`, with static shapes
    (lidardetection_tpu/ops/voxelize.py:109-190, ``voxelize_jax``).

    Each of the first `num_valid_points` points with an in-range cell
    (``floor((p - range_min) / voxel_size)`` in the points' dtype) gets the
    linear key ``(z*gy + y)*gx + x``; a stable sort by key groups a voxel's
    points in arrival order. Voxel slots go in key order, at most
    `max_voxels` of them (so past the cap the kept set is the lowest keys,
    not the first to arrive), each keeping its first
    `max_points_per_voxel` points. Below the cap the table equals
    `voxelize_np`'s, which is sorted by key too.

    Args: points (N, C) padded cloud, C >= 3; num_valid_points an int or a
    0-dim tensor, the leading valid count; point_cloud_range (6,),
    voxel_size (3,): sequences of numbers.
    Returns voxels (max_voxels, P, C) in the points' dtype, zero-padded;
    coords (max_voxels, 3) int32 (z, y, x), padded with -1;
    num_points_per_voxel (max_voxels,) int32; num_voxels a 0-dim int32
    tensor. Nothing is copied to the host.
    """
    n, c = points.shape
    device = points.device
    pc_range = torch.tensor(point_cloud_range, dtype=points.dtype,
                            device=device)
    vsz = torch.tensor(voxel_size, dtype=points.dtype, device=device)
    gx, gy, gz = (int(g) for g in grid_size_from_range(point_cloud_range,
                                                        voxel_size))
    cell = torch.floor((points[:, 0:3] - pc_range[0:3]) / vsz).long()
    arange = torch.arange(n, device=device)
    valid = (arange < num_valid_points) & (cell >= 0).all(1) \
        & (cell < torch.tensor([gx, gy, gz], device=device)).all(1)
    sentinel = gx * gy * gz  # sorts after every real key
    key = (cell[:, 2] * gy + cell[:, 1]) * gx + cell[:, 0]
    skey, order = torch.sort(torch.where(valid, key, sentinel), stable=True)
    svalid = skey < sentinel
    is_new = svalid & torch.cat([svalid.new_ones(1), skey[1:] != skey[:-1]])
    voxel_id = torch.cumsum(is_new, 0) - 1
    # rank of each point inside its voxel: its distance from the segment start
    rank = arange - torch.cummax(torch.where(is_new, arange, 0), 0).values
    keep = svalid & (voxel_id < max_voxels) & (rank < max_points_per_voxel)
    # dropped points go to a spill row, cut off at the end
    vid = torch.where(keep, voxel_id, max_voxels)
    rid = torch.where(keep, rank, 0)
    voxels = points.new_zeros((max_voxels + 1, max_points_per_voxel, c))
    voxels[vid, rid] = torch.where(keep[:, None], points[order], 0.0)
    counts = torch.zeros(max_voxels + 1, dtype=torch.int32, device=device)
    counts.index_put_((vid,), keep.int(), accumulate=True)
    first = torch.where(keep & (rank == 0), voxel_id, max_voxels)
    coords = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32,
                        device=device)
    coords[first] = cell[order].flip(1).int()
    num_voxels = torch.clamp(is_new.sum(), max=max_voxels).int()
    return voxels[:max_voxels], coords[:max_voxels], counts[:max_voxels], \
        num_voxels


def build_batch(points_list, point_cloud_range, voxel_size,
                max_points_per_voxel, max_voxels, max_points=None, plan=None):
    """Filter, voxelize and stack clouds at fixed capacity.

    Returns a dict of numpy arrays: voxels (B, V, P, C) float32,
    voxel_coords (B, V, 3) int32, voxel_num_points (B, V) int32 and
    num_voxels (B,) int32, with V = max_voxels. With `max_points` (for the
    detectors that read raw points) also points (B, max_points, C)
    float32, each cloud's in-range points in their order, zero-padded
    (cut at max_points), and num_points (B,) int32, as the JAX package's
    data processor pads them (data_processor.py:122-133). With a host
    `plan` (``ops/sparse_plan.py``) also its ``rb_*`` tables, built per
    scan from the voxel table before the batch is stacked, as the JAX
    package's ``DatasetTemplate.prepare_data`` builds them.

    The scans are voxelized (and their tables built) in a thread each,
    up to the host's core count: the host library's calls release the
    GIL, as the JAX package's data workers build scans in parallel.
    """
    pc_range = np.asarray(point_cloud_range, np.float32)

    def scan(points):
        points = np.asarray(points, np.float32)
        points = points[mask_points_by_range(points, pc_range)]
        table = voxelize_np(points, pc_range, voxel_size,
                            max_points_per_voxel, max_voxels)
        rulebooks = None if plan is None \
            else build_host_rulebooks(plan, table[1], table[3])
        return points, table, rulebooks

    workers = max(1, min(len(points_list), os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        clouds, tables, scans = zip(*pool.map(scan, points_list))
    voxels, coords, counts, n_vox = zip(*tables)
    batch = {
        'voxels': np.stack(voxels),
        'voxel_coords': np.stack(coords),
        'voxel_num_points': np.stack(counts),
        'num_voxels': np.asarray(n_vox, np.int32),
    }
    if plan is not None:
        batch.update({key: np.stack([rb[key] for rb in scans])
                      for key in scans[0]})
    if max_points is not None:
        batch.update(stack_points(clouds, max_points))
    return batch


def stack_points(clouds, max_points):
    """points (B, max_points, C) float32, each cloud's first max_points
    zero-padded (max_points 0: padded to the largest cloud,
    ``data_processor.pad_clouds``), and num_points (B,) int32."""
    points, num = pad_clouds(clouds, max_points)
    return {'points': points, 'num_points': num}


def build_point_batch(points_list, processor_cfgs, point_cloud_range,
                      max_points, training, rng):
    """The batch of a point-based config (PointRCNN): each cloud through
    the config's DATA_PROCESSOR chain (`data_processor.process_points`:
    the range mask, the near/far-aware sample, the shuffle where the
    split enables it, with `rng`'s draws in cloud order), then padded to
    `max_points`. Returns numpy points (B, max_points, C) float32 and
    num_points (B,) int32; no voxels."""
    pc_range = np.asarray(point_cloud_range, np.float32)
    clouds = [process_points(np.asarray(points, np.float32), processor_cfgs,
                             pc_range, training, rng)
              for points in points_list]
    return stack_points(clouds, max_points)
