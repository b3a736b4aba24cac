"""The evaluation slice, port against the JAX package, on the CPU.

* The KITTI protocol (``get_official_eval_result``) on three fixed
  prediction sets over 48 synthetic scenes: result string and dict equal to
  the JAX package's, key for key and float for float, once with the port's
  native host library against the JAX package's (built as its own tests
  build it) and once with the port's numpy plain version against the JAX
  package's Python loops.
* The synthetic annotations (``kitti_anno_from_lidar``, ``SyntheticCalib``):
  arrays equal for 8 scenes.
* The rotated BEV IoU, native and numpy, within 1e-6 of the JAX package's.
* ``compute_recall``: the same counts, with and without RoIs.
* ``eval_one_epoch`` on the reduced PointPillar of test_torch_train_step.py
  with weights carried across, 4 scenes at B = 2, against the JAX
  package's: detections per frame equal, boxes within 1e-4 and scores
  within 1e-5 (test_torch_pointpillar.py's tolerances), recall counters and
  result keys equal.
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from lidardetection_tpu import native as jax_native
from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.core import np_geometry as jax_npg
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.datasets import synthetic as jax_synthetic
from lidardetection_tpu.datasets.kitti.kitti_object_eval import eval as jax_eval
from lidardetection_tpu.engine.evaluator import eval_one_epoch as jax_eval_one_epoch
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.models.detectors.post_processing import (
    compute_recall as jax_compute_recall,
)
from lidardetection_tpu.parallel.train_step import device_batch, jit_init
from lidardetection_tpu_torch import native
from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
from lidardetection_tpu_torch.convert import flax_to_state_dict
from lidardetection_tpu_torch.core import np_geometry as npg
from lidardetection_tpu_torch.datasets import synthetic
from lidardetection_tpu_torch.datasets.kitti.kitti_object_eval import eval as port_eval
from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
from lidardetection_tpu_torch.models import build_network
from lidardetection_tpu_torch.models.detectors.post_processing import (
    compute_recall,
)
from test_torch_train_step import _reduce

CLASSES = ['Car', 'Pedestrian', 'Cyclist']
PC_RANGE = np.array([0, -39.68, -3, 69.12, 39.68, 1], np.float32)
N_SCENES = 48


def _scenes(n=N_SCENES, seed=0):
    """(gt_boxes (M, 7), gt_names (M,)) of n synthetic scenes."""
    out = []
    for i in range(n):
        _, boxes, names = jax_synthetic.make_scene(
            np.random.RandomState(seed * 100003 + i), PC_RANGE,
            class_names=tuple(CLASSES))
        out.append((boxes, names))
    return out


def _prediction_sets():
    """{set name: [(det boxes, det names, det scores, gt relabels, small
    image boxes)] per scene}, from a fixed numpy seed."""
    rng = np.random.RandomState(7)
    scenes = _scenes()
    perfect = [(b, n, np.ones(len(b)), {}, ()) for b, n in scenes]
    jitter = []
    for b, n in scenes:
        keep = rng.rand(len(b)) > 0.15  # some gt missed
        boxes = b[keep].astype(np.float64).copy()
        boxes[:, 0:2] += rng.randn(len(boxes), 2) * 0.15
        boxes[:, 6] += rng.randn(len(boxes)) * 0.1
        names = list(n[keep])
        n_false = rng.randint(0, 3)  # some false boxes
        for _ in range(n_false):
            name = CLASSES[rng.randint(3)]
            size = jax_synthetic.CLASS_SIZE[name]
            boxes = np.concatenate([boxes, [[
                rng.uniform(5, 65), rng.uniform(-35, 35),
                jax_synthetic.CLASS_Z[name], *size,
                rng.uniform(-np.pi, np.pi)]]])
            names.append(name)
        jitter.append((boxes, np.array(names), rng.uniform(0.2, 1.0, len(boxes)),
                       {}, ()))
    hard = []
    for i, (b, n) in enumerate(scenes):
        relabel = {}
        cars = np.flatnonzero(n == 'Car')
        if i % 3 == 0 and len(cars):  # a Van gt under a Car detection
            relabel[int(cars[0])] = 'Van'
        small = (len(b) - 1,) if i % 4 == 0 else ()  # a 30-px-high box
        hard.append((b, n, rng.uniform(0.2, 1.0, len(b)), relabel, small))
    return {'perfect': perfect, 'jitter': jitter, 'van_and_small': hard}


def _annos(anno_fn, scenes, preds):
    gt_annos, dt_annos = [], []
    for (gt_boxes, gt_names), (boxes, names, scores, relabel, small) in zip(
            scenes, preds):
        gt_names = gt_names.copy().astype(object)
        for j, name in relabel.items():
            gt_names[j] = name
        gt = anno_fn(gt_boxes, gt_names.astype(str))
        dt = anno_fn(boxes, names, scores)
        for j in small:
            for anno in (gt, dt):
                anno['bbox'][j, 3] = anno['bbox'][j, 1] + 30.0
        gt_annos.append(gt)
        dt_annos.append(dt)
    return gt_annos, dt_annos


@pytest.fixture(scope='module')
def prediction_sets():
    return _scenes(), _prediction_sets()


@pytest.mark.parametrize('which', ['perfect', 'jitter', 'van_and_small'])
@pytest.mark.parametrize('path', ['native', 'plain'])
def test_official_eval_equals_jax(prediction_sets, which, path, monkeypatch):
    scenes, sets = prediction_sets
    gt_j, dt_j = _annos(jax_synthetic.kitti_anno_from_lidar, scenes, sets[which])
    gt_p, dt_p = _annos(synthetic.kitti_anno_from_lidar, scenes, sets[which])
    if path == 'native':
        assert jax_native.load() is not None
        monkeypatch.delenv(native.PLAIN_ENV, raising=False)
    else:  # the JAX package's Python loops and numpy IoU
        monkeypatch.setattr(jax_native, '_lib', None)
        monkeypatch.setattr(jax_native, '_tried', True)
        monkeypatch.setenv(native.PLAIN_ENV, '1')
    want_str, want = jax_eval.get_official_eval_result(gt_j, dt_j, CLASSES)
    got_str, got = port_eval.get_official_eval_result(gt_p, dt_p, CLASSES)
    assert got_str == want_str
    assert list(got) == list(want)
    for key, value in want.items():
        assert float(got[key]) == float(value), key
    if which == 'perfect':
        assert all(want[f'{c}_3d/moderate_R40'] == 100.0 for c in CLASSES)
    elif which == 'jitter':
        assert 0.0 < want['Car_3d/moderate_R40'] < 100.0


def test_native_library_builds_into_build_and_raises_with_the_compiler_error(
        tmp_path, monkeypatch):
    lib = native.load()
    assert native.library_path().parent.name == 'build'
    assert native.library_path().exists() and lib is native.load()
    bad = tmp_path / 'broken.cpp'
    bad.write_text('int f( {\n')
    monkeypatch.setattr(native, 'SOURCES', (bad,))
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, '_lib', None)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed.*broken.cpp'):
        native.load()
    assert not list((tmp_path / 'build').iterdir())


def test_plain_host_is_taken_only_when_asked(monkeypatch):
    monkeypatch.delenv(native.PLAIN_ENV, raising=False)
    assert not native.plain_requested()
    with native.plain_host():
        assert native.plain_requested()
        with native.plain_host(False):
            assert not native.plain_requested()
        assert native.plain_requested()
    assert native.PLAIN_ENV not in os.environ


def test_synthetic_annos_equal_jax():
    for boxes, names in _scenes(8, seed=3):
        want = jax_synthetic.kitti_anno_from_lidar(boxes, names)
        got = synthetic.kitti_anno_from_lidar(boxes, names)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        scores = np.linspace(0.1, 1.0, len(boxes))
        got = synthetic.kitti_anno_from_lidar(boxes, names, scores)
        np.testing.assert_array_equal(got['score'], scores)
    empty = synthetic.kitti_anno_from_lidar(np.zeros((0, 7)), [])
    assert empty['bbox'].shape == (0, 4) and empty['location'].shape == (0, 3)
    calib, jcalib = synthetic.SyntheticCalib(), jax_synthetic.SyntheticCalib()
    pts = np.random.RandomState(0).randn(50, 3) * 20
    np.testing.assert_array_equal(calib.lidar_to_rect(pts),
                                  jcalib.lidar_to_rect(pts))
    for got, want in zip(calib.rect_to_img(pts), jcalib.rect_to_img(pts)):
        np.testing.assert_array_equal(got, want)
    assert calib.IMAGE_SHAPE == jcalib.IMAGE_SHAPE


def _iou_boxes(rng):
    """40 random boxes, and 30 of which half are near-copies of the first
    (mm jitter) and half random."""
    def rand(n):
        return np.concatenate([rng.uniform(-5, 5, (n, 3)),
                               rng.uniform(0.5, 4, (n, 3)),
                               rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    a = rand(40)
    b = np.concatenate([a[:15], rand(15)])
    b[:15, 0:2] += rng.randn(15, 2) * 1e-3
    return a.astype(np.float32), b.astype(np.float32)


def test_rotated_bev_iou_matches_jax(monkeypatch):
    rng = np.random.RandomState(1)
    a, b = _iou_boxes(rng)
    for criterion in (-1, 0, 1):
        want = jax_native.rotated_iou_bev_native(a[:, [0, 1, 3, 4, 6]],
                                                 b[:, [0, 1, 3, 4, 6]],
                                                 criterion)
        got = native.rotated_iou_bev(a[:, [0, 1, 3, 4, 6]],
                                     b[:, [0, 1, 3, 4, 6]], criterion)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    monkeypatch.delenv(native.PLAIN_ENV, raising=False)
    got = npg.boxes_bev_iou_cpu(a, b)
    np.testing.assert_allclose(got, jax_npg.boxes_bev_iou_cpu(a, b), rtol=0,
                               atol=1e-6)
    assert (got > 0.9).sum() >= 15
    monkeypatch.setenv(native.PLAIN_ENV, '1')
    monkeypatch.setattr(jax_native, '_lib', None)
    monkeypatch.setattr(jax_native, '_tried', True)
    np.testing.assert_allclose(npg.boxes_bev_iou_cpu(a, b),
                               jax_npg.boxes_bev_iou_cpu(a, b), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('with_rois', [False, True])
def test_compute_recall_matches_jax(with_rois):
    rng = np.random.RandomState(2)
    bsz, n, g = 2, 12, 6
    gt = np.zeros((bsz, g, 8), np.float32)
    gt[..., :7] = np.concatenate([rng.uniform(0, 40, (bsz, g, 3)),
                                  rng.uniform(1, 4, (bsz, g, 3)),
                                  rng.uniform(-3, 3, (bsz, g, 1))], -1)
    gt[..., 7] = rng.randint(1, 4, (bsz, g))
    gt[1, 4:, 7] = 0  # padding
    preds = np.concatenate([gt[:, :, :7], gt[:, :, :7]], 1)
    preds[:, :g, 0:2] += rng.randn(bsz, g, 2) * 0.4
    preds[:, g:, 0:2] += 30.0
    preds = preds.astype(np.float32)
    mask = rng.rand(bsz, n) > 0.2
    rois = preds[:, ::-1].copy() if with_rois else None
    roi_mask = mask[:, ::-1].copy() if with_rois else None
    thresh = (0.1, 0.3, 0.5, 0.7)
    want = jax.device_get(jax_compute_recall(
        preds, mask, gt, thresh, rois=rois, roi_mask=roi_mask))
    got = compute_recall(torch.from_numpy(preds), torch.from_numpy(mask),
                         torch.from_numpy(gt), thresh,
                         rois=None if rois is None else torch.from_numpy(rois),
                         roi_mask=None if rois is None
                         else torch.from_numpy(roi_mask))
    assert set(got) == set(want)
    assert len(got) == 1 + len(thresh) * (2 if with_rois else 1)
    for key, value in want.items():
        assert int(got[key]) == int(value), key
    assert 0 < int(got['rcnn_0.1']) < int(got['gt'])


def _randomize(tree, rng):
    """Random BN affines and statistics; class bias 0 so NMS sees live
    candidates."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, 'items'):
            out[key] = _randomize(value, rng)
        elif key in ('scale', 'var'):
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ('bias', 'mean'):
            out[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
        elif key == 'conv_cls_bias':
            out[key] = np.zeros(value.shape, np.float32)
        else:
            out[key] = np.asarray(value)
    return out


def _eval_cfg(cfg):
    cfg = _reduce(cfg, 'pointpillar')
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 40
    return cfg


def test_eval_one_epoch_matches_jax(tmp_path):
    logger = logging.getLogger('test_torch_eval')
    cfg = _eval_cfg(jax_cfg_from_yaml('tools/cfgs/kitti_models/pointpillar.yaml'))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=False,
                                       num_scenes=4, seed=5)
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    variables = jax.device_get(jit_init(model, device_batch(next(iter(loader)))))
    rng = np.random.RandomState(0)
    variables = {'params': _randomize(variables['params'], rng),
                 'batch_stats': _randomize(variables['batch_stats'], rng)}
    want, want_annos = jax_eval_one_epoch(
        model, variables, loader, cfg.MODEL.POST_PROCESSING, cfg.CLASS_NAMES,
        logger)

    pcfg = _eval_cfg(cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml'))
    pmodel = build_network(pcfg.MODEL, 3, dataset_info(pcfg.DATA_CONFIG))
    pmodel.load_state_dict(flax_to_state_dict(variables['params'],
                                              variables['batch_stats']))
    pdataset, ploader = synthetic.build_test_loader(pcfg, 2, 4, seed=5)
    assert len(ploader) == 2
    got, annos = eval_one_epoch(pmodel, ploader, pcfg.MODEL.POST_PROCESSING,
                                list(pcfg.CLASS_NAMES), logger,
                                result_dir=str(tmp_path))
    assert (tmp_path / 'result.pkl').exists()

    assert set(got) == set(want)
    recall = [k for k in want if k.startswith('recall/')]
    assert len(recall) == 3
    for key in recall:
        assert got[key] == want[key], key
    assert got['sec_per_example'] > 0
    assert len(annos) == len(want_annos) == 4
    n_dets = 0
    for a, w in zip(annos, want_annos):
        assert int(a['frame_id']) == int(w['frame_id'])
        assert len(a['name']) == len(w['name'])
        np.testing.assert_array_equal(a['name'], w['name'])
        np.testing.assert_allclose(a['score'], w['score'], rtol=0, atol=1e-5)
        np.testing.assert_allclose(a['boxes_lidar'], w['boxes_lidar'], rtol=0,
                                   atol=1e-4)
        assert a['num_candidates'] > 0
        n_dets += len(a['name'])
    assert n_dets > 4
