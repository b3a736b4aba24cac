"""Host-side hard voxelization and the request batch (numpy).

Same semantics as the JAX package's ``ops/voxelize.py::voxelize_np``
(itself mirroring spconv's VoxelGenerator):

  * each in-range point maps to an integer (x, y, z) cell;
  * voxel slots are taken first-come, at most ``max_voxels`` of them;
  * each voxel keeps its first ``max_points_per_voxel`` points, in order;
  * the table is then sorted by linear key ``(z*gy + y)*gx + x``;
  * coords are (z, y, x), padded with -1.

Vectorized with ``np.unique`` and a stable sort instead of a per-point
loop. The TPU scatter's tile histogram (``bev_tile_starts``) has no place
here: the CUDA scatter writes each row straight to its key.
"""

import numpy as np

from ..config import grid_size_from_range


def mask_points_by_range(points, limit_range):
    """(N,) bool: x and y inside the range, bounds included (the
    ``mask_points_and_boxes_outside_range`` processor's point filter)."""
    return ((points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
            & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4]))


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
                max_points_per_voxel, max_voxels):
    """Filter, voxelize and stack clouds at fixed capacity.

    Returns a dict of numpy arrays: voxels (B, V, P, C) float32,
    voxel_coords (B, V, 3) int32, voxel_num_points (B, V) int32 and
    num_voxels (B,) int32, with V = max_voxels.
    """
    pc_range = np.asarray(point_cloud_range, np.float32)
    tables = []
    for points in points_list:
        points = np.asarray(points, np.float32)
        points = points[mask_points_by_range(points, pc_range)]
        tables.append(voxelize_np(points, pc_range, voxel_size,
                                  max_points_per_voxel, max_voxels))
    voxels, coords, counts, n_vox = zip(*tables)
    return {
        'voxels': np.stack(voxels),
        'voxel_coords': np.stack(coords),
        'voxel_num_points': np.stack(counts),
        'num_voxels': np.asarray(n_vox, np.int32),
    }
