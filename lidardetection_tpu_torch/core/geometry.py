"""Box geometry (lidardetection_tpu/core/geometry.py:30, :80, :95, :101,
:112, :136).

Rotations are written out elementwise in float32, never as a matrix
product, so no TF32 or reduced-precision dot can reach them.
"""

import math

import torch

# bottom face of box_utils.boxes_to_corners_3d in BEV:
# (+x+y, +x-y, -x-y, -x+y) in the box frame, times (dx, dy)
BEV_CORNER_TEMPLATE = ((0.5, 0.5), (0.5, -0.5), (-0.5, -0.5), (-0.5, 0.5))


def limit_period(val, offset=0.5, period=math.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def corners_bev(boxes):
    """(..., 7) [x, y, z, dx, dy, dz, heading] -> (..., 4, 2) BEV corners."""
    template = torch.tensor(BEV_CORNER_TEMPLATE, dtype=boxes.dtype,
                            device=boxes.device)
    dxy = boxes[..., None, 3:5] * template  # (..., 4, 2)
    cosa = torch.cos(boxes[..., 6])[..., None]
    sina = torch.sin(boxes[..., 6])[..., None]
    x = dxy[..., 0] * cosa - dxy[..., 1] * sina
    y = dxy[..., 0] * sina + dxy[..., 1] * cosa
    return torch.stack([x, y], dim=-1) + boxes[..., None, 0:2]


# corner order of box_utils.boxes_to_corners_3d: bottom face 0-3
# (z = -dz/2), top face 4-7; corner k+4 is above corner k
CORNER_TEMPLATE = tuple(
    (x, y, z) for z in (-0.5, 0.5) for x, y in BEV_CORNER_TEMPLATE)


def rotate_points_along_z(points, angle):
    """Rotate (B, N, 3 + C) points about +z by angle (B,), counter-clockwise
    (geometry.py:47), elementwise."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xyz = torch.stack([x * c - y * s, x * s + y * c, points[..., 2]], dim=-1)
    return torch.cat([xyz, points[..., 3:]], dim=-1)


def boxes_to_corners_3d(boxes3d):
    """(N, 7) [x, y, z, dx, dy, dz, heading] -> (N, 8, 3) corners
    (geometry.py:69)."""
    template = torch.tensor(CORNER_TEMPLATE, dtype=boxes3d.dtype,
                            device=boxes3d.device)
    corners = boxes3d[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def get_voxel_centers(voxel_coords, downsample_times, voxel_size,
                      point_cloud_range):
    """(..., 3) integer (z, y, x) voxel coords -> (..., 3) metric (x, y, z)
    centres ``(c + 0.5) * voxel_size * downsample + range`` in float32
    (geometry.py:101)."""
    dev = voxel_coords.device
    coords = voxel_coords.flip(-1).float()
    size = torch.tensor(voxel_size, dtype=torch.float32, device=dev) \
        * downsample_times
    lo = torch.tensor(point_cloud_range[0:3], dtype=torch.float32, device=dev)
    return (coords + 0.5) * size + lo


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    """Grow (dx, dy, dz) of (..., 7+) boxes by `extra_width`, the centre
    fixed (geometry.py:95)."""
    extra = torch.as_tensor(extra_width, dtype=boxes3d.dtype,
                            device=boxes3d.device)
    return torch.cat([boxes3d[..., 0:3], boxes3d[..., 3:6] + extra,
                      boxes3d[..., 6:]], dim=-1)


def points_in_boxes_3d(points, boxes):
    """(..., N, 3) points, (..., M, 7) boxes -> (..., N, M) bool, point n
    inside box m: |local x| < dx/2, |local y| < dy/2, |dz| <= dz/2 after
    rotating by -heading (geometry.py:112), elementwise float32."""
    shift = points[..., :, None, :] - boxes[..., None, :, 0:3]  # (..., N, M, 3)
    cosa = torch.cos(-boxes[..., 6])[..., None, :]
    sina = torch.sin(-boxes[..., 6])[..., None, :]
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    in_x = local_x.abs() < boxes[..., None, :, 3] / 2
    in_y = local_y.abs() < boxes[..., None, :, 4] / 2
    in_z = shift[..., 2].abs() <= boxes[..., None, :, 5] / 2
    return in_x & in_y & in_z


def points_in_boxes_id(points, boxes, box_valid_mask=None):
    """For each point the index of the first (valid) box holding it, else
    -1: (..., N) int64 (geometry.py:136)."""
    inside = points_in_boxes_3d(points, boxes[..., :7])
    if box_valid_mask is not None:
        inside = inside & box_valid_mask[..., None, :]
    first = inside.to(torch.uint8).argmax(dim=-1)
    return torch.where(inside.any(dim=-1), first, torch.full_like(first, -1))
