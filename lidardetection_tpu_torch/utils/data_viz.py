"""BEV pictures of clouds and boxes (copy of lidardetection_tpu/utils/
data_viz.py):

- matplotlib figures (``plot_gt_boxes``, ``plot_gt_det_cmp``) written as
  PNGs, for inspection;
- uint8 BGR canvases drawn with cv2 (``bev_canvas``,
  ``plot_multiframe_boxes``) for the video writers: a canvas row is
  (x_max - x) / resolution and a column (y_max - y) / resolution, so the
  ego's +x points up; a multiframe model's boxes get a colour per stacked
  frame, and points with a frame-index column (column 4) likewise;
- ``plot_feature_map``: a (C, H, W) or (H, W, C) map, one channel or
  their mean, as an image.

matplotlib and cv2 are imported by the functions that draw, so importing
this module needs neither; a function whose package is missing raises
ImportError naming it (``require``).
"""

import importlib
from pathlib import Path

import numpy as np

from ..core.np_geometry import corners_bev


def require(package, what='this drawing'):
    """Import `package` (a module name such as ``cv2`` or
    ``matplotlib.pyplot``), or raise ImportError naming it."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f'{what} needs {package.split(".")[0]}, which is '
                          f'not installed here') from e


def _pyplot():
    matplotlib = require('matplotlib', 'a BEV figure')
    matplotlib.use('Agg')
    return matplotlib, require('matplotlib.pyplot', 'a BEV figure')


def _draw_boxes(matplotlib, ax, boxes, color, labels=None, scores=None):
    for i, box in enumerate(np.asarray(boxes)):
        corners = corners_bev(box[None, :7])[0]  # (4, 2)
        poly = matplotlib.patches.Polygon(
            corners, closed=True, fill=False, edgecolor=color, linewidth=0.8)
        ax.add_patch(poly)
        # heading tick from the centre to the front face's midpoint
        front_mid = (corners[0] + corners[1]) / 2
        ax.plot([box[0], front_mid[0]], [box[1], front_mid[1]],
                color=color, linewidth=0.6)
        if scores is not None:
            ax.annotate(f'{scores[i]:.2f}', (box[0], box[1]), color=color,
                        fontsize=4)
        if labels is not None:
            ax.annotate(str(labels[i]), (box[0], box[1] + 0.8), color=color,
                        fontsize=4)


def plot_gt_boxes(points, gt_boxes, bev_range, name='bev', save_dir='.'):
    """Points and one box set -> <save_dir>/<name>.png."""
    return plot_gt_det_cmp(points, gt_boxes, None, bev_range, name=name,
                           save_dir=save_dir)


def plot_gt_det_cmp(points, gt_boxes, det_boxes, bev_range, name='bev_cmp',
                    save_dir='.', det_scores=None, det_labels=None):
    """gt boxes (green) against detections (red) over the cloud ->
    <save_dir>/<name>.png; returns its path."""
    matplotlib, plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 12), dpi=150)
    pts = np.asarray(points)
    ax.scatter(pts[:, 0], pts[:, 1], s=0.05, c='0.6', linewidths=0)
    if gt_boxes is not None and len(gt_boxes):
        _draw_boxes(matplotlib, ax, gt_boxes, 'lime')
    if det_boxes is not None and len(det_boxes):
        _draw_boxes(matplotlib, ax, det_boxes, 'red', labels=det_labels,
                    scores=det_scores)
    ax.set_xlim(bev_range[0], bev_range[3])
    ax.set_ylim(bev_range[1], bev_range[4])
    ax.set_aspect('equal')
    ax.set_facecolor('black')
    out = Path(save_dir) / f'{name}.png'
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, bbox_inches='tight', facecolor='black')
    plt.close(fig)
    return str(out)


def _canvas_setup(points, bev_range, resolution):
    """The points in range and a black canvas with their rows and
    columns."""
    pts = np.asarray(points)
    keep = ((pts[:, 0] > bev_range[0]) & (pts[:, 0] < bev_range[3])
            & (pts[:, 1] > bev_range[1]) & (pts[:, 1] < bev_range[4])
            & (pts[:, 2] > bev_range[2]) & (pts[:, 2] < bev_range[5]))
    pts = pts[keep]
    h = int((bev_range[3] - bev_range[0]) / resolution + 1)
    w = int((bev_range[4] - bev_range[1]) / resolution + 1)
    canvas = np.zeros((h, w, 3), np.uint8)
    row = ((bev_range[3] - pts[:, 0]) / resolution).astype(int)
    col = ((bev_range[4] - pts[:, 1]) / resolution).astype(int)
    return pts, canvas, row, col


def _draw_box_canvas(cv2, canvas, box, bev_range, resolution, color,
                     thickness=1, text=None):
    corners = corners_bev(np.asarray(box)[None, :7])[0]  # (4, 2) world xy
    px = ((bev_range[3] - corners[:, 0]) / resolution).astype(int)  # rows
    py = ((bev_range[4] - corners[:, 1]) / resolution).astype(int)  # cols
    for a in range(4):
        b = (a + 1) % 4
        cv2.line(canvas, (py[a], px[a]), (py[b], px[b]), color, thickness)
    # heading tick, thicker: the front face's midpoint to the centre
    fx, fy = (px[0] + px[1]) // 2, (py[0] + py[1]) // 2
    cx, cy = int(px.mean()), int(py.mean())
    cv2.line(canvas, (fy, fx), (cy, cx), color, thickness + 1)
    if text:
        cv2.putText(canvas, text, (py[0], px[0]),
                    fontFace=cv2.FONT_HERSHEY_SIMPLEX, fontScale=0.5,
                    color=color, thickness=2)


def plot_multiframe_boxes(points, boxes, bev_range, gt_boxes=None,
                          resolution=0.1, scores=None, labels=None,
                          info=None):
    """A multiframe model's boxes on a uint8 BGR canvas: `boxes` (N, T, 7),
    one pose a stacked frame, a colour a frame (detections bright, gt
    dark); (N, 7) is one frame. Points with a frame-index column (column
    4) take their frame's colour. Returns the canvas."""
    cv2 = require('cv2', 'a BEV canvas')
    boxes = np.asarray(boxes)
    if boxes.ndim == 2:
        boxes = boxes[:, None, :]
    t_frames = boxes.shape[1]
    pts, canvas, row, col = _canvas_setup(points, bev_range, resolution)

    if pts.shape[1] >= 5:
        color = np.full((pts.shape[0], 3), 32, np.uint8)
        frame_idx = pts[:, 4].astype(int)
        frame_colors = [(180, 0, 0), (0, 180, 0), (0, 0, 180)]
        for t, c in enumerate(frame_colors[:max(t_frames, 1)]):
            color[frame_idx == t] = c
        canvas[row, col] = color
    else:
        canvas[row, col] = (0, 255, 255)

    gt_colors = [(128, 0, 0), (0, 128, 0), (0, 0, 128)]
    det_colors = [(255, 100, 100), (100, 255, 100), (100, 100, 255)]
    if gt_boxes is not None and len(gt_boxes):
        g = np.asarray(gt_boxes)
        if g.ndim == 2:
            g = g[:, None, :]
        for t in range(g.shape[1]):
            for b in g[:, t]:
                _draw_box_canvas(cv2, canvas, b, bev_range, resolution,
                                 gt_colors[t % len(gt_colors)])
    mid = t_frames // 2
    for t in range(t_frames):
        for i, b in enumerate(boxes[:, t]):
            text = None
            if scores is not None and labels is not None and t == mid:
                text = f'{scores[i]}, {labels[i]}'
            _draw_box_canvas(cv2, canvas, b, bev_range, resolution,
                             det_colors[t % len(det_colors)], text=text)
    if info is not None:
        cv2.putText(canvas, str(info), (10, 35),
                    fontFace=cv2.FONT_HERSHEY_SIMPLEX, fontScale=0.6,
                    color=(0, 128, 0), thickness=1)
    return canvas


def bev_canvas(points, det_boxes, bev_range, gt_boxes=None, resolution=0.1,
               scores=None, labels=None, info=None):
    """One frame's uint8 BGR canvas: detections red, gt boxes green, the
    points yellow."""
    cv2 = require('cv2', 'a BEV canvas')
    pts, canvas, row, col = _canvas_setup(points, bev_range, resolution)
    canvas[row, col] = (0, 255, 255)
    if gt_boxes is not None:
        for b in np.asarray(gt_boxes):
            _draw_box_canvas(cv2, canvas, b, bev_range, resolution,
                             (0, 255, 0), thickness=2)
    if det_boxes is not None:
        for i, b in enumerate(np.asarray(det_boxes)):
            text = None
            if scores is not None:
                text = f'{float(scores[i]):.2f}' + (
                    f', {int(labels[i])}' if labels is not None else '')
            _draw_box_canvas(cv2, canvas, b, bev_range, resolution,
                             (0, 0, 255), thickness=2, text=text)
    if info is not None:
        cv2.putText(canvas, str(info), (10, 35),
                    fontFace=cv2.FONT_HERSHEY_SIMPLEX, fontScale=0.6,
                    color=(0, 255, 0), thickness=1)
    return canvas


def plot_feature_map(features, channel=None, path='feature_map.jpg'):
    """A (C, H, W) or (H, W, C) feature map written as an image at `path`
    (one channel, or their mean when `channel` is None); returns the
    path."""
    cv2 = require('cv2', 'a feature-map image')
    f = np.asarray(features)
    if f.ndim != 3:
        raise ValueError(f'want a (C, H, W) or (H, W, C) map, got {f.shape}')
    if f.shape[0] <= f.shape[-1]:  # (C, H, W)
        fmap = f.mean(axis=0) if channel is None else f[channel]
    else:  # (H, W, C)
        fmap = f.mean(axis=-1) if channel is None else f[..., channel]
    lo, hi = float(fmap.min()), float(fmap.max())
    img = np.zeros_like(fmap) if hi == lo else (fmap - lo) / (hi - lo) * 255
    cv2.imwrite(path, img.astype(np.uint8))
    return path
