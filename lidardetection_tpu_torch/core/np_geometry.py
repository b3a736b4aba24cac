"""Host (numpy) box geometry for the KITTI protocol and the synthetic
annotations: a copy of what they need of
lidardetection_tpu/core/np_geometry.py (``limit_period``,
``boxes_to_corners_3d``, ``corners_bev``, ``boxes_bev_iou_cpu`` with
``_polygon_intersection_area``, the lidar / KITTI-camera / image box
conversions), and what the data layer needs of it (``points_in_boxes``,
``remove_points_in_boxes``, ``in_hull``, ``mask_points_in_fov``). The range
masks of points and boxes are in ``datasets/processor/data_processor.py``.

``boxes_bev_iou_cpu`` runs the native library (``native/``); its numpy
polygon clipping is the plain version, taken only when the caller asks for
it (``native.plain_host()`` or ``LIDARDET_TORCH_PLAIN_HOST=1``).
"""

import numpy as np

from .. import native

# box_utils.boxes_to_corners_3d's corner order, in units of (dx, dy, dz)
CORNER_TEMPLATE = np.array(
    [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
     [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], dtype=np.float32) / 2.0


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (B, N, 3+C), angle (B,)."""
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones],
                   axis=1).reshape(-1, 3, 3)
    xyz = np.einsum('bnj,bjk->bnk', points[:, :, 0:3], rot)
    return np.concatenate([xyz, points[:, :, 3:]], axis=-1)


def boxes_to_corners_3d(boxes3d):
    """(N, 7) -> (N, 8, 3), ordering of box_utils.boxes_to_corners_3d."""
    template = CORNER_TEMPLATE.astype(boxes3d.dtype)
    corners = boxes3d[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def points_in_boxes(points, boxes):
    """(N, 3), (M, 7) -> (N, M) bool: each point inside each box (x and y
    strictly, z up to the faces)."""
    if boxes.shape[0] == 0:
        return np.zeros((points.shape[0], 0), dtype=bool)
    shift = points[:, None, :3] - boxes[None, :, 0:3]
    cosa, sina = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    local_x = shift[..., 0] * cosa[None] - shift[..., 1] * sina[None]
    local_y = shift[..., 0] * sina[None] + shift[..., 1] * cosa[None]
    return ((np.abs(local_x) < boxes[None, :, 3] / 2)
            & (np.abs(local_y) < boxes[None, :, 4] / 2)
            & (np.abs(shift[..., 2]) <= boxes[None, :, 5] / 2))


def remove_points_in_boxes(points, boxes):
    """The points inside no box (box_utils.remove_points_in_boxes3d:74)."""
    inside = points_in_boxes(points[:, 0:3], boxes[:, 0:7])
    return points[~inside.any(axis=1)]


def in_hull(p, hull):
    """(N,) bool: the (N, K) points inside the convex hull of the (M, K)
    corners (box_utils.in_hull:10); none for a flat hull, which scipy's
    Delaunay refuses."""
    from scipy.spatial import Delaunay, QhullError

    try:
        if not isinstance(hull, Delaunay):
            hull = Delaunay(hull)
        return hull.find_simplex(p) >= 0
    except QhullError:
        return np.zeros(p.shape[0], dtype=bool)


def mask_points_in_fov(pts_rect, img_shape, calib):
    """(N,) bool: rect-frame points that project into the image, in front
    of the camera (kitti_dataset.get_fov_flag:100-117)."""
    pts_img, pts_depth = calib.rect_to_img(pts_rect)
    flag = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
            & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]))
    return flag & (pts_depth >= 0)


def corners_bev(boxes):
    """(N, 7) -> (N, 4, 2) BEV footprint corners."""
    return boxes_to_corners_3d(boxes[:, :7])[:, :4, :2]


def boxes_bev_iou_cpu(boxes_a, boxes_b):
    """Rotated BEV IoU of all pairs of (N, 7) and (M, 7) boxes, (N, M)
    float32: the native library, or the numpy polygon clipping when the
    plain version is asked for."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), dtype=np.float32)
    if not native.plain_requested():
        bev_a = np.asarray(boxes_a, np.float32)[:, [0, 1, 3, 4, 6]]
        bev_b = np.asarray(boxes_b, np.float32)[:, [0, 1, 3, 4, 6]]
        return native.rotated_iou_bev(bev_a, bev_b)
    ca = corners_bev(boxes_a)  # (N, 4, 2)
    cb = corners_bev(boxes_b)  # (M, 4, 2)
    inter = _polygon_intersection_area(ca, cb)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    union = np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-6, None)
    return (inter / union).astype(np.float32)


def _polygon_intersection_area(ca, cb):
    """All-pairs convex-quad intersection area. ca (N,4,2), cb (M,4,2)."""
    eps = 1e-8
    n, m = ca.shape[0], cb.shape[0]
    a1 = ca[:, None, :, None, :]          # (N,1,4,1,2) edge starts
    a2 = np.roll(ca, -1, axis=1)[:, None, :, None, :]
    b1 = cb[None, :, None, :, :]          # (1,M,1,4,2)
    b2 = np.roll(cb, -1, axis=1)[None, :, None, :, :]
    da, db = a2 - a1, b2 - b1
    w = a1 - b1
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    t_num = db[..., 0] * w[..., 1] - db[..., 1] * w[..., 0]
    u_num = da[..., 0] * w[..., 1] - da[..., 1] * w[..., 0]
    safe = np.where(np.abs(denom) > eps, denom, 1.0)
    t, u = t_num / safe, u_num / safe
    hit = (np.abs(denom) > eps) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    ipts = a1 + t[..., None] * da  # (N,M,4,4,2)

    def inside(pts, poly):
        # pts (N,M,4,2) vs poly (N,M,4,2) — same-side test
        p1 = poly
        p2 = np.roll(poly, -1, axis=-2)
        edge = p2 - p1
        rel = pts[..., :, None, :] - p1[..., None, :, :]
        cross = edge[..., None, :, 0] * rel[..., 1] - edge[..., None, :, 1] * rel[..., 0]
        return np.all(cross >= -eps, axis=-1) | np.all(cross <= eps, axis=-1)

    ca_b = np.broadcast_to(ca[:, None], (n, m, 4, 2))
    cb_b = np.broadcast_to(cb[None, :], (n, m, 4, 2))
    a_in_b = inside(ca_b, cb_b)
    b_in_a = inside(cb_b, ca_b)

    pts = np.concatenate([ipts.reshape(n, m, 16, 2), ca_b, cb_b], axis=2)  # (N,M,24,2)
    valid = np.concatenate([hit.reshape(n, m, 16), a_in_b, b_in_a], axis=2)

    nv = valid.sum(axis=2)  # (N, M)
    cnt = np.maximum(nv, 1)[..., None]
    center = (pts * valid[..., None]).sum(axis=2) / cnt  # (N,M,2)
    ang = np.arctan2(pts[..., 1] - center[..., None, 1],
                     pts[..., 0] - center[..., None, 0])
    ang = np.where(valid, ang, np.inf)
    order = np.argsort(ang, axis=2)
    spts = np.take_along_axis(pts, order[..., None], axis=2)
    idx = np.arange(24)
    nxt = np.where(idx[None, None, :] + 1 < nv[..., None], idx + 1, 0)
    pj = np.take_along_axis(spts, nxt[..., None], axis=2)
    cross = spts[..., 0] * pj[..., 1] - spts[..., 1] * pj[..., 0]
    contrib = np.where(idx[None, None, :] < nv[..., None], cross, 0.0)
    area = 0.5 * np.abs(contrib.sum(axis=2))
    return np.where(nv >= 3, area, 0.0)


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) [x,y,z,l,h,w,r] rect -> unified lidar boxes (box_utils.py:91)."""
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w, r = (boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5],
                  boxes3d_camera[:, 5:6], boxes3d_camera[:, 6:7])
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib=None):
    """Unified lidar boxes -> (N, 7) [x,y,z,l,h,w,r] rect.

    With calib: upstream OpenPCDet semantics (bottom-center, rect frame);
    calib=None skips the frame transform, as the fork's one-argument
    variant does.
    """
    boxes3d_lidar = boxes3d_lidar.copy()
    xyz_lidar = boxes3d_lidar[:, 0:3]
    l, w, h, r = (boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5],
                  boxes3d_lidar[:, 5:6], boxes3d_lidar[:, 6:7])
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar) if calib is not None else xyz_lidar
    r = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) camera boxes -> (N, 8, 3) corners (box_utils.py:167-212)."""
    num = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2], axis=1)
    z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], axis=1)
    if bottom_center:
        y_c = np.zeros((num, 8), dtype=np.float32)
        y_c[:, 4:8] = -h[:, None]
    else:
        y_c = np.stack([h / 2] * 4 + [-h / 2] * 4, axis=1)
    ry = boxes3d[:, 6]
    zeros, ones = np.zeros_like(ry), np.ones_like(ry)
    rot = np.stack([
        np.stack([np.cos(ry), zeros, -np.sin(ry)], axis=-1),
        np.stack([zeros, ones, zeros], axis=-1),
        np.stack([np.sin(ry), zeros, np.cos(ry)], axis=-1),
    ], axis=1)  # (N, 3, 3)
    corners = np.stack([x_c, y_c, z_c], axis=2) @ rot  # (N, 8, 3)
    return (corners + boxes3d[:, None, 0:3]).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """Camera boxes -> clipped 2D image boxes (box_utils.py:214-238)."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], 0, image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], 0, image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], 0, image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], 0, image_shape[0] - 1)
    return boxes2d
