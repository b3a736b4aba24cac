"""Box geometry (lidardetection_tpu/core/geometry.py:30, :80).

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
