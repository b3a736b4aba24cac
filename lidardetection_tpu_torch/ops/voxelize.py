"""Host-side hard voxelization and the request batch (numpy).

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

A point-based config (PointRCNN) has no voxelizer: `build_point_batch`
samples and pads its raw points instead.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

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
