"""The point-cloud and detection viewer (copy of the parts of
tools/visual_utils/laserdetvis.py that need no window).

The interactive ``LaserDetVis`` (a vispy canvas stepped with n / b, i for
intensity colours, q to quit) needs vispy, which neither machine has: its
constructor raises, naming it (ROADMAP.md section 1, "Not queued").
``LaserDetVis.render_offscreen`` draws the same data into a PNG through
matplotlib (``visualize_utils.draw_scenes``); ``box_wire_segments`` and
``_intensity_colors`` are the viewer's geometry and colours.
"""

import numpy as np

from ...core.np_geometry import boxes_to_corners_3d
from ...utils.data_viz import require
from .visualize_utils import BOX_EDGES, draw_scenes

VISPY_NEEDED = ('the interactive viewer needs vispy, which the port does not '
                'carry: render PNGs with LaserDetVis.render_offscreen '
                '(demo_3d --offscreen)')


class LaserDetVis:
    """The vispy viewer: not ported (``VISPY_NEEDED``)."""

    def __init__(self, show_img=False):
        raise ImportError(VISPY_NEEDED)

    @staticmethod
    def render_offscreen(points, boxes=None, scores=None, labels=None,
                         save_path=None):
        """The viewer's data as a matplotlib figure, written to
        `save_path` when given."""
        return draw_scenes(points, ref_boxes=boxes, ref_scores=scores,
                           ref_labels=labels, save_path=save_path)


def _intensity_colors(points):
    """(N, 4) RGBA viridis colours of the intensities (column 3), spread
    over their range."""
    intensity = points[:, 3]
    lo, hi = intensity.min(), intensity.max()
    t = (intensity - lo) / max(hi - lo, 1e-6)
    return require('matplotlib', 'intensity colours').colormaps['viridis'](t)


def box_wire_segments(boxes, labels=None):
    """(N, 7) boxes -> (N * 24, 3) wireframe segment ends and their (N *
    24, 4) RGBA colours, a colour a label."""
    palette = np.array([(0, 1, 0, 1), (1, 1, 0, 1), (0, 1, 1, 1),
                        (1, 0, 1, 1), (1, 0, 0, 1)], np.float32)
    corners = boxes_to_corners_3d(np.asarray(boxes)[:, :7])  # (N, 8, 3)
    segs, cols = [], []
    for n, c in enumerate(corners):
        color = palette[int(labels[n]) % len(palette)] if labels is not None \
            else palette[0]
        for i, j in BOX_EDGES:
            segs.append(c[i])
            segs.append(c[j])
            cols.append(color)
            cols.append(color)
    return np.asarray(segs, np.float32), np.asarray(cols, np.float32)
