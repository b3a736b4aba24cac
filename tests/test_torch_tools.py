"""The port's tracker, MOT metrics and visualiser against the JAX package's,
and the tools' refusal to start without a card, on the CPU.

* The tracker: one seeded run of 60 frames (objects moving at their own
  speeds, dropouts, low scores that start no track, detections beyond the
  side range, length jitter for the median filter, false positives) goes
  through both ``TrackingManager``s. JAX reads the packed form (the first
  ``num_preds`` rows); the port reads the same rows placed among empty
  slots and marked by ``pred_mask``. Track ids, types and float64 boxes are
  equal at every frame.
* ``get_metrics`` of both MOT benchmarks on seeded gt and detection sets,
  empty ones among them, at every (IoU, range) cell: equal.
* The canvases (``bev_canvas``, ``plot_multiframe_boxes``) and
  ``plot_feature_map``'s image equal JAX's pixel for pixel;
  ``plot_gt_det_cmp`` and ``draw_scenes`` write PNGs of JAX's size;
  ``box_wire_segments`` and ``_intensity_colors`` equal JAX's.
* Without CUDA every tool raises unless given ``--cpu``, and
  ``verify_cuda`` raises on the CPU; its reference checks pass on the
  plain versions; ``--bag_file`` names rosbag.
* A log file given after the console logger was made gets the log.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lidardetection_tpu.utils import data_viz as jax_viz
from lidardetection_tpu.utils.tracker_for_inference import (
    TrackingManager as JaxTrackingManager,
)
from lidardetection_tpu_torch.tools import (
    demo, demo_3d, inference, inference_bag2json, inference_video,
    mot_benchmark, test as test_tool, verify_cuda,
)
from lidardetection_tpu_torch.tools.visual_utils import laserdetvis
from lidardetection_tpu_torch.tools.visual_utils.visualize_utils import (
    draw_scenes,
)
from lidardetection_tpu_torch.utils import data_viz
from lidardetection_tpu_torch.utils.tracker_for_inference import TrackingManager

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))
from mot_benchmark import get_metrics as jax_get_metrics  # noqa: E402
from visual_utils import laserdetvis as jax_laserdetvis  # noqa: E402
from visual_utils.visualize_utils import draw_scenes as jax_draw_scenes  # noqa: E402

BEV = [0, -40, -3, 70.4, 40, 1]
FRAMES = 60
SLOTS = 40


def tracker_sequence(seed=0):
    """FRAMES frames of detections (boxes (n, 7) float32, scores, labels)
    of 9 objects: a few beyond the side range, dropouts, low scores, a
    jittered length, and a false positive now and then."""
    rng = np.random.RandomState(seed)
    n_obj = 9
    start = np.c_[rng.uniform(5, 60, n_obj), rng.uniform(-10, 10, n_obj)]
    speed = rng.uniform(-1.0, 1.0, n_obj)  # m a frame along x
    dims = np.c_[rng.uniform(3.5, 4.5, n_obj), rng.uniform(1.6, 2.0, n_obj),
                 rng.uniform(1.4, 1.7, n_obj)]
    labels = rng.randint(1, 4, n_obj)
    frames = []
    for t in range(FRAMES):
        rows, scores, labs = [], [], []
        for k in range(n_obj):
            if rng.rand() < 0.2:  # dropout
                continue
            length = dims[k, 0] * (1.4 if rng.rand() < 0.15 else 1.0)
            rows.append([start[k, 0] + speed[k] * t + rng.randn() * 0.1,
                         start[k, 1] + rng.randn() * 0.1, -0.8, length,
                         dims[k, 1], dims[k, 2], rng.uniform(-0.1, 0.1)])
            scores.append(rng.uniform(0.3, 1.0))
            labs.append(labels[k])
        if rng.rand() < 0.3:  # a false positive
            rows.append([rng.uniform(5, 60), rng.uniform(-12, 12), -0.8,
                         4.0, 1.8, 1.5, 0.0])
            scores.append(rng.uniform(0.3, 1.0))
            labs.append(1)
        order = np.argsort(-np.asarray(scores))  # NMS output order
        frames.append((np.asarray(rows, np.float32).reshape(-1, 7)[order],
                       np.asarray(scores, np.float32)[order],
                       np.asarray(labs, np.int64)[order]))
    return frames


def packed(boxes, scores, labels):
    """The JAX package's form: the first num_preds rows of SLOTS."""
    n = len(boxes)
    out = {'pred_boxes': np.zeros((1, SLOTS, 7), np.float32),
           'pred_scores': np.zeros((1, SLOTS), np.float32),
           'pred_labels': np.zeros((1, SLOTS), np.int64),
           'num_preds': np.array([n])}
    out['pred_boxes'][0, :n] = boxes
    out['pred_scores'][0, :n] = scores
    out['pred_labels'][0, :n] = labels
    return out


def masked(boxes, scores, labels, rng):
    """The port's form: the same rows, in order, at slots spread over
    SLOTS with gaps, marked by pred_mask (garbage in the gaps)."""
    n = len(boxes)
    slots = np.sort(rng.choice(SLOTS, n, replace=False))
    out = {'pred_boxes': rng.uniform(-50, 50, (1, SLOTS, 7)).astype(np.float32),
           'pred_scores': rng.uniform(0, 1, (1, SLOTS)).astype(np.float32),
           'pred_labels': rng.randint(1, 4, (1, SLOTS)),
           'pred_mask': np.zeros((1, SLOTS), bool)}
    out['pred_boxes'][0, slots] = boxes
    out['pred_scores'][0, slots] = scores
    out['pred_labels'][0, slots] = labels
    out['pred_mask'][0, slots] = True
    return {k: torch.from_numpy(v) for k, v in out.items()}


def test_tracker_equals_jax_at_every_frame():
    classes = ['Car', 'Pedestrian', 'Cyclist']
    want_tm = JaxTrackingManager({'CLASS_NAMES': classes})
    got_tm = TrackingManager({'CLASS_NAMES': classes})
    rng = np.random.RandomState(1)
    seen_ids, dropped, predicted = set(), 0, 0
    for boxes, scores, labels in tracker_sequence():
        want = want_tm.update_tracking(packed(boxes, scores, labels))
        got = got_tm.update_tracking(masked(boxes, scores, labels, rng))
        np.testing.assert_array_equal(got['object_ids'], want['object_ids'])
        assert [int(t) for t in got['object_types']] == \
            [int(t) for t in want['object_types']]
        assert got['pred_boxes'].dtype == np.float64
        np.testing.assert_array_equal(got['pred_boxes'], want['pred_boxes'])
        dropped += len(seen_ids - set(want['object_ids'].tolist()))
        seen_ids |= set(want['object_ids'].tolist())
        predicted += sum(t.predicted for t in got_tm.tracker_list)
    # the run exercised the lifecycle: many tracks born, some lost, some
    # carried through dropouts by prediction
    assert len(seen_ids) >= 8 and dropped > 0 and predicted > 0
    assert got_tm.track_id == want_tm.track_id


def test_get_metrics_equals_jax():
    rng = np.random.RandomState(3)

    def boxes(n):
        return np.c_[rng.uniform(0, 90, n), rng.uniform(-20, 20, n),
                     rng.uniform(-2, 0, n), rng.uniform(3, 5, n),
                     rng.uniform(1.5, 2, n), rng.uniform(1.4, 1.7, n),
                     rng.uniform(-np.pi, np.pi, n)]

    cases = [(boxes(0), boxes(0)), (boxes(5), boxes(0)), (boxes(0), boxes(4))]
    for _ in range(8):
        gt = boxes(rng.randint(1, 12))
        near = gt[rng.rand(len(gt)) < 0.7] + np.r_[rng.randn(2) * 0.3,
                                                    np.zeros(5)]
        cases.append((gt, np.concatenate([near, boxes(rng.randint(0, 4))])))
    cells = 0
    for gt, det in cases:
        for rng_m in mot_benchmark.DIST_RANGES:
            for iou in mot_benchmark.IOUS:
                got = mot_benchmark.get_metrics(gt, det, rng_m, iou)
                want = jax_get_metrics(gt, det, rng_m, iou)
                assert got == want, (got, want)
                cells += got[0] > 0
    assert cells > 10  # true positives in many cells


def _points(n=500, frame_col=False, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.c_[rng.uniform(1, 69, n), rng.uniform(-39, 39, n),
                rng.uniform(-2, 0.5, n), rng.uniform(0, 1, n)]
    if frame_col:
        pts = np.c_[pts, rng.randint(0, 3, n)]
    return pts


def test_canvases_equal_jax_pixel_for_pixel(tmp_path):
    pytest.importorskip('cv2')
    pts = _points()
    boxes = np.array([[20.0, 5.0, 0.0, 4.0, 1.8, 1.5, 0.3],
                      [45.0, -12.0, 0.0, 0.8, 0.6, 1.7, -1.2]])
    kwargs = dict(gt_boxes=boxes[:1], scores=[0.9, 0.4], labels=[1, 3],
                  info='frame 0')
    got = data_viz.bev_canvas(pts, boxes, BEV, **kwargs)
    np.testing.assert_array_equal(got, jax_viz.bev_canvas(pts, boxes, BEV,
                                                          **kwargs))
    assert (got[..., 2] == 255).any() and (got == (0, 255, 255)).all(-1).sum() > 100

    stacked = np.stack([
        np.array([[20 + t, 0, 0, 4, 1.8, 1.5, 0.0] for t in range(3)]),
        np.array([[40 + t, -10, 0, 4, 1.8, 1.5, 1.2] for t in range(3)])])
    for points, b, extra in (
            (_points(frame_col=True), stacked,
             dict(scores=np.array([0.8, 0.7]), labels=np.array([1, 2]),
                  gt_boxes=stacked[:1] - 1, info='t')),
            (pts, boxes, {})):
        got = data_viz.plot_multiframe_boxes(points, b, BEV, **extra)
        np.testing.assert_array_equal(
            got, jax_viz.plot_multiframe_boxes(points, b, BEV, **extra))
        assert (got == (255, 100, 100)).all(-1).any()

    import cv2
    fmap = np.random.RandomState(0).randn(8, 32, 48).astype(np.float32)
    for arr, channel in ((fmap, None), (fmap.transpose(1, 2, 0), 3)):
        got = data_viz.plot_feature_map(arr, channel, str(tmp_path / 'a.png'))
        want = jax_viz.plot_feature_map(arr, channel, str(tmp_path / 'b.png'))
        np.testing.assert_array_equal(cv2.imread(got), cv2.imread(want))
        assert cv2.imread(got).shape[:2] == (32, 48)


def test_figures_have_jax_size(tmp_path):
    pytest.importorskip('matplotlib')
    from PIL import Image

    pts = _points(2000)
    gt = np.array([[20.0, 5.0, -1.0, 4.0, 1.8, 1.5, 0.3]])
    det = gt + np.r_[0.3, 0.2, 0, 0, 0, 0, 0.05]
    got = data_viz.plot_gt_det_cmp(pts, gt, det, BEV, name='got',
                                   save_dir=tmp_path, det_scores=[0.7])
    want = jax_viz.plot_gt_det_cmp(pts, gt, det, BEV, name='want',
                                   save_dir=tmp_path, det_scores=[0.7])
    assert Image.open(got).size == Image.open(want).size
    import matplotlib.pyplot as plt
    for fn, name in ((draw_scenes, 'got3d'), (jax_draw_scenes, 'want3d')):
        fig = fn(pts, gt_boxes=gt, ref_boxes=det, ref_scores=np.array([0.7]),
                 ref_labels=np.array([2]), save_path=str(tmp_path / f'{name}.png'))
        plt.close(fig)
    assert Image.open(tmp_path / 'got3d.png').size == \
        Image.open(tmp_path / 'want3d.png').size
    fig = laserdetvis.LaserDetVis.render_offscreen(
        pts, boxes=det, scores=np.array([0.7]), labels=np.array([1]),
        save_path=str(tmp_path / 'off.png'))
    plt.close(fig)
    assert Image.open(tmp_path / 'off.png').size == \
        Image.open(tmp_path / 'got3d.png').size

    segs, cols = laserdetvis.box_wire_segments(np.r_[gt, det], [1, 2])
    want_segs, want_cols = jax_laserdetvis.box_wire_segments(np.r_[gt, det],
                                                             [1, 2])
    assert segs.shape == (48, 3)
    np.testing.assert_array_equal(segs, want_segs)
    np.testing.assert_array_equal(cols, want_cols)
    np.testing.assert_array_equal(laserdetvis._intensity_colors(pts),
                                  jax_laserdetvis._intensity_colors(pts))
    with pytest.raises(ImportError, match='vispy'):
        laserdetvis.LaserDetVis()


@pytest.mark.parametrize('tool,argv', [
    (demo, ['--synthetic']),
    (inference, ['--with_tracking']),
    (inference_video, ['--output', 'x.gif']),
    (mot_benchmark, ['--with_tracking']),
    (inference_bag2json, []),
    (demo_3d, ['--offscreen', '--synthetic']),
    (test_tool, ['--cfg_file', 'tools/cfgs/kitti_models/pointpillar.yaml']),
], ids=['demo', 'inference', 'inference_video', 'mot_benchmark',
        'inference_bag2json', 'demo_3d', 'test'])
def test_tools_refuse_to_start_without_cuda(tool, argv):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available; pass --cpu'):
        tool.main(argv)


def test_verify_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='verify_cuda checks the kernels on '
                       'a card'):
        verify_cuda.main([])
    with pytest.raises(RuntimeError, match='on a card'):
        verify_cuda.verify(('conv',), device='cpu')


def test_bag_file_names_rosbag():
    with pytest.raises(ImportError, match='rosbag'):
        inference_bag2json.main(['--bag_file', 'drive.bag', '--cpu'])


def test_verifier_rulebook_is_the_microbench_one():
    """The copied rulebook maker equals tools/microbench_rbconv.py's."""
    from microbench_rbconv import make_rulebook

    got = verify_cuda.make_rulebook(np.random.RandomState(0), 2, 512, 512)
    want = make_rulebook(np.random.RandomState(0), 2, 512, 512)
    np.testing.assert_array_equal(got, want)
    assert ((got < 512).mean() > 0.3)


def test_verifier_cases_pass_on_the_plain_versions():
    """The verifier's reference algebra, held on the CPU where each wrapper
    takes its plain version: K3 / K4 (plain against plain and autograd),
    K1 against the numpy algebra of its contract, the rank select against
    brute force, and the rotated IoU against the exact polygon IoU (pairs
    apart, the near-identical cluster within its documented bound,
    self-IoU 1). K2's and K5's full-size cases need the card's memory."""
    cases = []
    for fn in (verify_cuda.verify_conv, verify_cuda.verify_vfe,
               verify_cuda.verify_rank, verify_cuda.verify_iou):
        cases += fn(torch.device('cpu'))
    assert len(cases) == 8
    for c in cases:
        assert c['ok'], c
    near = [c for c in cases if 'near-identical' in c['case']][0]
    # the misread the bound is there for: both packages read a jittered
    # pair 0.072 low on the CPU
    assert 0.01 < near['max_abs_err'] < verify_cuda.NEAR_IDENTICAL_IOU


def test_a_later_log_file_gets_the_log(tmp_path):
    """A tool's console logger made first (no file) does not stop a later
    run's log file from being written (train.py's log_train.txt)."""
    from lidardetection_tpu_torch.utils.common import create_logger

    create_logger().info('console only')
    for name in ('a.txt', 'b.txt'):
        logger = create_logger(tmp_path / name)
        logger.info(f'to {name}')
        for h in logger.handlers:
            h.flush()
    assert 'to a.txt' in (tmp_path / 'a.txt').read_text()
    assert (tmp_path / 'b.txt').read_text().strip().endswith('to b.txt')
    assert 'to b.txt' not in (tmp_path / 'a.txt').read_text()
