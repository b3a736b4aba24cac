"""Dense anchor grid generation, host-side numpy (copy of
lidardetection_tpu/models/dense_heads/anchor_generator.py:19-96).

Layout contract (must match the conv-head channel order):
  per class: (nz=1, ny, nx, num_sizes, num_rots, 7+)
  flat:      classes concatenated per location -> order (y, x, class, size, rot)
"""

import numpy as np


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range,
                     anchor_ndim=7):
    """Build per-class dense anchors.

    Args:
        anchor_generator_cfg: list of per-class dicts with keys
            anchor_sizes, anchor_rotations, anchor_bottom_heights,
            align_center, feature_map_stride.
        grid_size: (nx, ny, nz) voxel grid.
        point_cloud_range: (x1, y1, z1, x2, y2, z2).
        anchor_ndim: pad anchors with zeros up to this size.
    Returns:
        anchors_list: list of (1, ny_f, nx_f, S, R, anchor_ndim) float32
        num_anchors_per_location: list of S*R*H per class
    """
    anchor_range = np.asarray(point_cloud_range, dtype=np.float32)
    all_anchors = []
    num_per_loc = []
    for cfg in anchor_generator_cfg:
        stride = cfg['feature_map_stride']
        gx, gy = int(grid_size[0]) // stride, int(grid_size[1]) // stride
        sizes = np.asarray(cfg['anchor_sizes'], dtype=np.float32)  # (S, 3)
        rotations = np.asarray(cfg['anchor_rotations'], dtype=np.float32)
        heights = np.asarray(cfg['anchor_bottom_heights'], dtype=np.float32)
        align_center = cfg.get('align_center', False)

        num_per_loc.append(len(rotations) * len(sizes) * len(heights))

        if align_center:
            x_stride = (anchor_range[3] - anchor_range[0]) / gx
            y_stride = (anchor_range[4] - anchor_range[1]) / gy
            x_offset, y_offset = x_stride / 2, y_stride / 2
        else:
            x_stride = (anchor_range[3] - anchor_range[0]) / (gx - 1)
            y_stride = (anchor_range[4] - anchor_range[1]) / (gy - 1)
            x_offset, y_offset = 0.0, 0.0

        x_shifts = anchor_range[0] + x_offset + x_stride * np.arange(
            gx, dtype=np.float32)
        y_shifts = anchor_range[1] + y_offset + y_stride * np.arange(
            gy, dtype=np.float32)
        z_shifts = heights

        # meshgrid order (x, y, z), then transposed to (z, y, x)
        xx, yy, zz = np.meshgrid(x_shifts, y_shifts, z_shifts, indexing='ij')
        centers = np.stack([xx, yy, zz], axis=-1)  # (gx, gy, H, 3)
        n_h = len(heights)
        n_s, n_r = len(sizes), len(rotations)
        anchors = np.empty((gx, gy, n_h, n_s, n_r, 7), dtype=np.float32)
        anchors[..., 0:3] = centers[:, :, :, None, None, :]
        anchors[..., 3:6] = sizes[None, None, None, :, None, :]
        anchors[..., 6] = rotations[None, None, None, None, :]
        anchors = anchors.transpose(2, 1, 0, 3, 4, 5)  # (H(z), gy, gx, S, R, 7)
        anchors[..., 2] += anchors[..., 5] / 2  # bottom -> center z
        if anchor_ndim != 7:
            pad = np.zeros((*anchors.shape[:-1], anchor_ndim - 7),
                           dtype=np.float32)
            anchors = np.concatenate([anchors, pad], axis=-1)
        all_anchors.append(anchors)
    return all_anchors, num_per_loc


def flatten_anchors(anchors_list):
    """Concatenate per-class anchors to the flat (A, D) prediction order.

    Returns flat_anchors (A, D) float32 and anchor_class_idx (A,) int32
    (0-based position in the anchor config list).
    """
    cat = np.concatenate(anchors_list, axis=-3)  # (nz, ny, nx, sum_S, R, D)
    flat = cat.reshape(-1, cat.shape[-1])
    class_ids = [np.full(a.shape[-3] * a.shape[-2], i, dtype=np.int32)
                 for i, a in enumerate(anchors_list)]
    per_loc = np.concatenate(class_ids)  # (sum_S * R,)
    n_loc = cat.shape[0] * cat.shape[1] * cat.shape[2]
    return flat, np.tile(per_loc, n_loc)
