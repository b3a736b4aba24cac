"""3D scene pictures (copy of tools/visual_utils/visualize_utils.py): the
cloud, a 20 m ground grid and wireframe boxes drawn on matplotlib's 3D axes
(Agg, no window); ``draw_scenes`` returns the figure and writes a PNG when
given a path. matplotlib is imported when a figure is drawn.
"""

import numpy as np

from ...core.np_geometry import boxes_to_corners_3d
from ...utils.data_viz import require

BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]


def _fig3d(bgcolor=(0, 0, 0), size=(8, 8)):
    matplotlib = require('matplotlib', 'a 3D scene')
    matplotlib.use('Agg')
    plt = require('matplotlib.pyplot', 'a 3D scene')
    fig = plt.figure(figsize=size, facecolor=bgcolor)
    ax = fig.add_subplot(111, projection='3d', facecolor=bgcolor)
    ax.set_axis_off()
    return fig, ax


def visualize_pts(pts, fig=None, bgcolor=(0, 0, 0), fgcolor=(1.0, 1.0, 1.0),
                  show_intensity=False, size=(8, 8), draw_origin=True):
    """The cloud on a 3D axis, with the origin's axes."""
    if fig is None:
        fig, ax = _fig3d(bgcolor, size)
    else:
        ax = fig.axes[0]
    if show_intensity and pts.shape[1] >= 4:
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=pts[:, 3],
                   cmap='viridis', s=0.3)
    else:
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color=fgcolor, s=0.3)
    if draw_origin:
        ax.scatter([0], [0], [0], color=(0, 1, 1), s=40, marker='o')
        for v, c in (((2, 0, 0), 'r'), ((0, 2, 0), 'g'), ((0, 0, 2), 'b')):
            ax.plot([0, v[0]], [0, v[1]], [0, v[2]], c=c, linewidth=2)
    return fig


def draw_grid(x1, y1, x2, y2, fig, color=(0.5, 0.5, 0.5)):
    ax = fig.axes[0]
    for x in (x1, x2):
        ax.plot([x, x], [y1, y2], [0, 0], c=color, linewidth=0.3)
    for y in (y1, y2):
        ax.plot([x1, x2], [y, y], [0, 0], c=color, linewidth=0.3)
    return fig


def draw_multi_grid_range(fig, grid_size=20, bv_range=(-60, -60, 60, 60)):
    """A ground grid of `grid_size` m squares over `bv_range`."""
    for x in range(bv_range[0], bv_range[2], grid_size):
        for y in range(bv_range[1], bv_range[3], grid_size):
            fig = draw_grid(x, y, x + grid_size, y + grid_size, fig)
    return fig


def draw_corners3d(corners3d, fig, color=(1, 1, 1), line_width=2, cls=None,
                   max_num=500):
    """Wireframes of (N, 8, 3) corners, each labelled by `cls`."""
    ax = fig.axes[0]
    for n in range(min(max_num, len(corners3d))):
        b = corners3d[n]
        for i, j in BOX_EDGES:
            ax.plot([b[i, 0], b[j, 0]], [b[i, 1], b[j, 1]],
                    [b[i, 2], b[j, 2]], c=color, linewidth=line_width * 0.5)
        if cls is not None:
            label = cls[n] if not isinstance(cls, str) else cls
            ax.text(b[4, 0], b[4, 1], b[4, 2], f'{label}', color=color,
                    fontsize=7)
    return fig


def draw_scenes(points, gt_boxes=None, ref_boxes=None, ref_scores=None,
                ref_labels=None, save_path=None):
    """The cloud, blue gt wireframes and the detections in a colour a
    class, labelled by score; written to `save_path` when given. Returns
    the figure."""
    points = np.asarray(points)
    fig = visualize_pts(points)
    fig = draw_multi_grid_range(fig, bv_range=(0, -40, 80, 40))
    if gt_boxes is not None and len(gt_boxes) > 0:
        corners = boxes_to_corners_3d(np.asarray(gt_boxes)[:, :7])
        fig = draw_corners3d(corners, fig=fig, color=(0, 0, 1), max_num=100)
    if ref_boxes is not None and len(ref_boxes) > 0:
        ref_boxes = np.asarray(ref_boxes)
        corners = boxes_to_corners_3d(ref_boxes[:, :7])
        if ref_labels is None:
            fig = draw_corners3d(corners, fig=fig, color=(0, 1, 0),
                                 cls=ref_scores, max_num=100)
        else:
            palette = [(0, 1, 0), (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 0, 0)]
            ref_labels = np.asarray(ref_labels)
            for k in np.unique(ref_labels):
                mask = ref_labels == k
                scores = ref_scores[mask] if ref_scores is not None else None
                fig = draw_corners3d(
                    corners[mask], fig=fig,
                    color=palette[int(k) % len(palette)], cls=scores,
                    max_num=100)
    ax = fig.axes[0]
    ax.view_init(elev=35, azim=-170)
    rng = points[:, :3].max(axis=0) - points[:, :3].min(axis=0)
    ax.set_box_aspect(tuple(np.maximum(rng, 1e-3)))
    if save_path is not None:
        fig.savefig(save_path, dpi=120, facecolor=fig.get_facecolor())
    return fig
