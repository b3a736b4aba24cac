"""The multiframe and anchor-free pieces, port against the JAX package, on
the CPU in f32: what livox_models/pv_rcnn_multiframe.yaml
(STACK_FRAME_SIZE 3) and kitti_models/PartA2_free.yaml add.

  * ``compute_multiframe_enlarged_gt``: the swept boxes within 1e-5;
  * ``PointHeadSimpleMultiFrame``: its logits within 1e-5, each frame's
    point labels equal, the shared-normaliser focal loss within 1e-5
    relative, every gradient leaf within 1e-4 relative L2;
  * REG_TRACKING_INFO: the RoIs sampled against the enlarged boxes on
    JAX's own draws (indices equal), the targets with their tracking
    columns within 1e-5, the RCNN losses over the 15 code weights within
    1e-5 relative and their gradients within 2e-3 of the largest value;
  * the PartA2FCHead with DISABLE_PART (the raw point coordinates where
    the part offsets go) on proposals around the points: RoIs, class
    logits and boxes within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lidardetection_tpu.core.box_coders import ResidualCoder as JaxCoder
from lidardetection_tpu.models.dense_heads.anchor_head import (
    compute_multiframe_enlarged_gt as jax_enlarged_gt,
)
from lidardetection_tpu.models.dense_heads.point_head import (
    PointHeadSimpleMultiFrame as JaxPointHead,
)
from lidardetection_tpu.models.roi_heads import roi_head_utils as jax_roi
from lidardetection_tpu.models.roi_heads.parta2_head import (
    PartA2FCHead as JaxPartA2FCHead,
)
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.core.box_coders import ResidualCoder
from lidardetection_tpu_torch.models.dense_heads.anchor_head import (
    compute_multiframe_enlarged_gt,
)
from lidardetection_tpu_torch.models.dense_heads.point_head import (
    PointHeadSimpleMultiFrame,
)
from lidardetection_tpu_torch.models.roi_heads import roi_head_utils
from lidardetection_tpu_torch.models.roi_heads.parta2_head import PartA2FCHead

MULTIFRAME = 'tools/cfgs/livox_models/pv_rcnn_multiframe.yaml'
FREE = 'tools/cfgs/kitti_models/PartA2_free.yaml'


def _leaves(tree, prefix=''):
    for key, value in tree.items():
        if hasattr(value, 'items'):
            yield from _leaves(value, f'{prefix}{key}/')
        else:
            yield prefix + key, np.asarray(value)


def _scene(rng, b=2, g=8, t=3):
    """gt boxes (B, G, 8) of Car and Truck (class last, the last two rows
    padding) and their frame poses, as the synthetic multiframe scenes
    make them: the box moved back by a velocity a frame."""
    gt = np.zeros((b, g, 8), np.float32)
    for s in range(b):
        n = g - 2
        cls = rng.randint(1, 3, n)
        size = np.where(cls[:, None] == 1, [4.7, 1.9, 2.6], [10.7, 2.75, 4.2])
        gt[s, :n, 0] = rng.uniform(10, 150, n)
        gt[s, :n, 1] = rng.uniform(-14, 14, n)
        gt[s, :n, 2] = 0.5
        gt[s, :n, 3:6] = size * rng.uniform(0.9, 1.1, (n, 1))
        gt[s, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[s, :n, 7] = cls
    vel = rng.randn(b, g, 2)
    loc = np.repeat(gt[:, :, None, 0:3], t, axis=2)
    for i in range(t):
        loc[:, :, i, 0:2] -= vel * (t - 1 - i)
    roty = np.repeat(gt[:, :, None, 6], t, axis=2)
    roty[..., 0] += rng.uniform(-0.2, 0.2, (b, g))  # a turn between frames
    return gt, loc.astype(np.float32), roty.astype(np.float32)


def test_multiframe_enlarged_gt_matches_jax():
    gt, loc, roty = _scene(np.random.RandomState(0))
    want = np.asarray(jax_enlarged_gt(jnp.asarray(gt), jnp.asarray(loc),
                                      jnp.asarray(roty)))
    got = compute_multiframe_enlarged_gt(
        torch.from_numpy(gt), torch.from_numpy(loc), torch.from_numpy(roty))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    live = gt[..., -1] > 0
    assert (got.numpy()[..., 3][live] > gt[..., 3][live] + 0.1).mean() > 0.5
    np.testing.assert_array_equal(got.numpy()[..., [0, 1, 2, 5, 6, 7]],
                                  gt[..., [0, 1, 2, 5, 6, 7]])


def _points(rng, gt, n=3000):
    """Points on and around the boxes of every frame pose, and clutter."""
    b = len(gt)
    pts = np.zeros((b, n, 3), np.float32)
    for s in range(b):
        live = gt[s][gt[s, :, -1] > 0]
        k = n // 2
        src = live[rng.randint(len(live), size=k)]
        pts[s, :k] = src[:, 0:3] + rng.randn(k, 3) * src[:, 3:6] * 0.3
        pts[s, k:, 0] = rng.uniform(2, 162, n - k)
        pts[s, k:, 1] = rng.uniform(-16, 16, n - k)
        pts[s, k:, 2] = rng.uniform(-2, 4, n - k)
    return pts


def test_point_head_multiframe_matches_jax():
    rng = np.random.RandomState(1)
    cfg = cfg_from_yaml_file(MULTIFRAME).MODEL.POINT_HEAD
    cfg.USE_POINT_FEATURES_BEFORE_FUSION = False
    gt, loc, roty = _scene(rng)
    coords = _points(rng, gt)
    valid = rng.rand(*coords.shape[:2]) > 0.05
    feats = rng.randn(*coords.shape[:2], 32).astype(np.float32)
    batch = {'point_features': feats, 'point_coords': coords,
             'point_valid': valid, 'gt_boxes': gt, 'locations': loc,
             'rotations_y': roty}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxPointHead(model_cfg=cfg, num_class=1, input_channels=32,
                         stack_frame_size=3)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), jb,
                                          training=False))

    def loss_fn(p):
        out, mutated = model.apply({'params': p,
                                    'batch_stats': variables['batch_stats']},
                                   jb, training=True, mutable=['batch_stats'])
        fwd = out['point_head_fwd']
        loss, tb = model.apply({'params': p}, fwd, method=model.loss)
        return loss, (out['point_cls_scores'], fwd, tb)

    (_, (scores, fwd, tb)), grads = jax.device_get(jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params']))

    head = PointHeadSimpleMultiFrame(cfg, 1, 32, 3).train()
    head.load_state_dict(flax_to_state_dict(variables['params'],
                                            variables['batch_stats']))
    out = head({k: torch.from_numpy(v) for k, v in batch.items()})
    got = out['point_head_fwd']
    np.testing.assert_allclose(got['point_cls_preds'].detach().numpy(),
                               fwd['point_cls_preds'], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out['point_cls_scores'].detach().numpy(),
                               scores, rtol=0, atol=1e-5)
    assert len(got['point_cls_labels_list']) == 3
    for g, w in zip(got['point_cls_labels_list'], fwd['point_cls_labels_list']):
        np.testing.assert_array_equal(g.numpy(), w)
    first, last = (l.numpy() for l in got['point_cls_labels_list'][::2])
    assert (first > 0).sum() > 100 and (first != last).sum() > 50
    loss, got_tb = head.loss(got)
    loss.backward()
    for key, want in tb.items():
        np.testing.assert_allclose(float(got_tb[key].detach()), float(want),
                                   rtol=1e-5, err_msg=key)
    named = {k: p.grad for k, p in head.named_parameters()}
    got_grads, = state_dict_to_flax(named, grads)
    for (key, g), (_, w) in zip(_leaves(got_grads), _leaves(grads)):
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), key


def _jax_draws(rng, n_rois, roi_per_image, batch_size):
    """The uniforms JAX's ``sample_rois_for_rcnn`` draws from `rng`, by the
    port's names (as tests/test_torch_pvrcnn_train.py takes them)."""
    def one(key):
        r_fg, r_fgr, r_hard, r_easy = jax.random.split(key, 4)
        return {'roi_fg_perm': jax.random.uniform(r_fg, (n_rois,)),
                'roi_fg_rep': jax.random.uniform(r_fgr, (roi_per_image,)),
                'roi_hard': jax.random.uniform(r_hard, (roi_per_image,)),
                'roi_easy': jax.random.uniform(r_easy, (roi_per_image,))}
    return jax.vmap(one)(jax.random.split(rng, batch_size))


def _proposals(rng, gt, n=64):
    """Half jittered copies of the gt boxes (headings moved by 0.02-0.15
    rad, off the clipping IoU's parallel-edge tolerance), half spread."""
    b = len(gt)
    boxes = np.zeros((b, n, 7), np.float32)
    labels = np.zeros((b, n), np.int32)
    for s in range(b):
        live = gt[s][gt[s, :, -1] > 0]
        k = n // 2
        src = live[np.arange(k) % len(live)]
        boxes[s, :k, 0:3] = src[:, 0:3] + rng.randn(k, 3) * 0.15
        boxes[s, :k, 3:6] = src[:, 3:6] * np.exp(rng.randn(k, 3) * 0.05)
        boxes[s, :k, 6] = src[:, 6] + rng.choice([-1, 1], k) \
            * rng.uniform(0.02, 0.15, k)
        labels[s, :k] = src[:, 7]
        boxes[s, k:] = live[rng.randint(len(live), size=n - k), :7]
        boxes[s, k:, 0:2] += rng.uniform(-6, 6, (n - k, 2))
        boxes[s, k:, 6] += rng.uniform(0.05, 1.5, n - k)
        labels[s, k:] = rng.randint(1, 3, n - k)
    return boxes, labels


def test_tracking_targets_and_losses_match_jax():
    rng = np.random.RandomState(2)
    cfg = cfg_from_yaml_file(MULTIFRAME).MODEL.ROI_HEAD
    tc, loss_cfg = dict(cfg.TARGET_CONFIG), cfg.LOSS_CONFIG
    tc['ROI_PER_IMAGE'] = 32
    gt, loc, roty = _scene(rng)
    rois, labels = _proposals(rng, gt)
    valid = rng.rand(*labels.shape) > 0.1
    enlarged = np.asarray(jax_enlarged_gt(jnp.asarray(gt), jnp.asarray(loc),
                                          jnp.asarray(roty)))
    batch = {'rois': rois * valid[..., None], 'roi_labels': labels * valid,
             'roi_scores': rng.randn(*labels.shape).astype(np.float32) * valid,
             'roi_valid': valid, 'gt_boxes': gt, 'locations': loc,
             'rotations_y': roty, 'gt_boxes_enlarged': enlarged}
    key = jax.random.PRNGKey(3)
    rcnn_cls = rng.randn(64, 1).astype(np.float32)
    rcnn_reg = (rng.randn(64, 15) * 0.2).astype(np.float32)
    assert len(loss_cfg.LOSS_WEIGHTS.code_weights) == 15

    def jax_losses(cls, reg):
        t = jax_roi.assign_roi_targets(
            key, {k: jnp.asarray(v) for k, v in batch.items()}, tc)
        fwd = {**t, 'rcnn_cls': cls, 'rcnn_reg': reg,
               'reg_tracking_info': True}
        box, tb_box = jax_roi.roi_box_loss(fwd, JaxCoder(), loss_cfg)
        cls_loss, tb_cls = jax_roi.roi_cls_loss(fwd, loss_cfg)
        return box + cls_loss, (t, {**tb_box, **tb_cls})

    (_, (want_t, want_tb)), want_g = jax.device_get(jax.jit(jax.value_and_grad(
        jax_losses, argnums=(0, 1), has_aux=True))(jnp.asarray(rcnn_cls),
                                                   jnp.asarray(rcnn_reg)))
    draws = jax.device_get(_jax_draws(key, 64, 32, 2))
    t = roi_head_utils.assign_roi_targets(
        {k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
        {k: torch.from_numpy(v.copy()) for k, v in batch.items()}, tc)
    assert t['gt_of_rois'].shape == (2, 32, 16)  # box, class, tracking
    np.testing.assert_array_equal(t['roi_labels'].numpy(), want_t['roi_labels'])
    np.testing.assert_array_equal(t['reg_valid_mask'].numpy(),
                                  want_t['reg_valid_mask'])
    assert want_t['reg_valid_mask'].sum() > 4
    for k, tol in (('rois', 1e-5), ('gt_of_rois', 1e-5),
                   ('gt_of_rois_src', 1e-5), ('gt_iou_of_rois', 1e-4),
                   ('rcnn_cls_labels', 1e-4)):
        np.testing.assert_allclose(t[k].numpy(), want_t[k], rtol=0, atol=tol,
                                   err_msg=k)
    args = [torch.from_numpy(x).requires_grad_(True) for x in (rcnn_cls, rcnn_reg)]
    fwd = {**t, 'rcnn_cls': args[0], 'rcnn_reg': args[1],
           'reg_tracking_info': True}
    box, tb_box = roi_head_utils.roi_box_loss(fwd, ResidualCoder(), loss_cfg)
    cls_loss, tb_cls = roi_head_utils.roi_cls_loss(fwd, loss_cfg)
    (box + cls_loss).backward()
    got_tb = {**tb_box, **tb_cls}
    assert set(got_tb) == set(want_tb)
    for k, got in got_tb.items():
        np.testing.assert_allclose(float(got.detach()), float(want_tb[k]),
                                   rtol=1e-5, err_msg=k)
    for arg, want in zip(args, want_g):
        np.testing.assert_allclose(arg.grad.numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max())
    # the tracking columns carry loss: their gradient is not zero
    assert np.abs(args[1].grad.numpy()[:, 7:]).max() > 0


def test_disable_part_roi_head_matches_jax():
    rng = np.random.RandomState(4)
    cfg = cfg_from_yaml_file(FREE).MODEL.ROI_HEAD
    cfg.ROI_AWARE_POOL.POOL_SIZE = 4
    cfg.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 256
    cfg.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 24
    b, n, c = 2, 2000, 16
    centres = rng.uniform([5, -15, -1.5], [45, 15, 0], (b, 12, 3))
    coords = (centres[:, rng.randint(12, size=n)]
              + rng.randn(b, n, 3) * [1.5, 1.0, 0.5]).astype(np.float32)
    boxes = np.zeros((b, 400, 7), np.float32)
    boxes[..., 0:3] = centres[:, rng.randint(12, size=400)] \
        + rng.randn(b, 400, 3) * 0.3
    boxes[..., 3:6] = np.array([3.9, 1.6, 1.56]) * rng.uniform(0.5, 1.2,
                                                               (b, 400, 1))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, 400))
    batch = {'point_coords': coords,
             'point_valid': rng.rand(b, n) > 0.05,
             'point_features': rng.randn(b, n, c).astype(np.float32),
             'point_cls_scores': rng.rand(b, n).astype(np.float32),
             'point_part_offset': rng.rand(b, n, 3).astype(np.float32),
             'batch_box_preds': boxes,
             'batch_cls_preds': rng.randn(b, 400, 3).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxPartA2FCHead(model_cfg=cfg, input_channels=c, num_class=1)
    variables = jax.device_get(jax.jit(lambda x: model.init(
        jax.random.PRNGKey(0), x, training=False))(jb))
    want = jax.device_get(jax.jit(lambda x: model.apply(
        variables, x, training=False))(jb))
    head = PartA2FCHead(cfg, c, 1).eval()
    state = flax_to_state_dict({'roi_head': variables['params']},
                               {'roi_head': variables['batch_stats']})
    head.load_state_dict({k.split('.', 1)[1]: v for k, v in state.items()})
    with torch.inference_mode():
        got = head({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got['roi_valid'].numpy(), want['roi_valid'])
    assert want['roi_valid'].sum() > 20
    for key in ('rois', 'batch_cls_preds', 'batch_box_preds'):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=1e-4, err_msg=key)
    # the part offsets are not read: other offsets give the same outputs
    with torch.inference_mode():
        again = head({**{k: torch.from_numpy(v) for k, v in batch.items()},
                      'point_part_offset': torch.zeros(b, n, 3)})
    assert torch.equal(again['batch_cls_preds'], got['batch_cls_preds'])
