"""The multi-head dense head and the multi-class NMS, port against the JAX
package, on the CPU in f32.

``AnchorHeadMulti`` at the size of tests/test_multihead_e2e.py (two head
groups over three classes, separate per-term regression convs) with the
NuScenes code (9 dims: velocity, heading by sine and cosine), on a 32 x 32
map, with the flax variables converted by ``flax_to_state_dict``:

  * eval: each head's class logits within 1e-5 and every anchor's decoded
    box within 1e-5 relative (and absolute); the label mapping equal;
  * training: the forward outputs within 1e-5 of their largest value
    (batch statistics, summed in another order), the assigned targets
    (labels equal, regression targets within 1e-5), the loss terms within
    1e-5 relative,
    the BatchNorm statistics within 1e-5 and every gradient leaf within
    2e-3 relative L2.

Multi-class post-processing against ``_multi_class_post_processing``:
kept labels and mask equal, boxes equal, scores within 1e-6, on heads
whose two classes have equal logits and whose scores repeat; and the
port's one walk over every (sample, class) pair against the JAX
package's per-pair ``class_agnostic_nms``. ``NMS_TYPE`` nms_normal
(``nms_normal_bev``) and the two legacy decoders, against the JAX
package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.core import box_coders as jax_coders
from lidardetection_tpu.core import iou3d as jax_iou3d
from lidardetection_tpu.models.dense_heads.anchor_head_multi import (
    AnchorHeadMulti as JaxAnchorHeadMulti,
)
from lidardetection_tpu.models.detectors import post_processing as jax_post
from lidardetection_tpu.models.model_utils import nms_utils as jax_nms_utils
from lidardetection_tpu_torch.config import CfgNode
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.core.box_coders import build_box_coder
from lidardetection_tpu_torch.models.dense_heads.anchor_head_multi import (
    AnchorHeadMulti,
)
from lidardetection_tpu_torch.models.detectors.post_processing import (
    post_processing,
)
from lidardetection_tpu_torch.models.model_utils.nms_utils import (
    class_agnostic_nms,
)

CLASS_NAMES = ('Car', 'Pedestrian', 'Cyclist')
PC_RANGE = (0.0, -25.6, -3.0, 51.2, 25.6, 1.0)
GRID = (64, 64, 1)  # the 32 x 32 map at feature_map_stride 2
C_IN = 16


def _anchor(name, sizes, height, matched, unmatched):
    return {
        'class_name': name, 'anchor_sizes': [sizes],
        'anchor_rotations': [0, 1.57], 'anchor_bottom_heights': [height],
        'align_center': False, 'feature_map_stride': 2,
        'matched_threshold': matched, 'unmatched_threshold': unmatched,
    }


def head_cfg(direction=True):
    return CfgNode({
        'NAME': 'AnchorHeadMulti', 'CLASS_AGNOSTIC': False,
        'DIR_OFFSET': 0.78539, 'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
        **({'USE_DIRECTION_CLASSIFIER': True} if direction else {}),
        'USE_MULTIHEAD': True, 'SEPARATE_MULTIHEAD': True,
        'ANCHOR_GENERATOR_CONFIG': [
            _anchor('Car', [3.9, 1.6, 1.56], -1.78, 0.6, 0.45),
            _anchor('Pedestrian', [0.8, 0.6, 1.73], -0.6, 0.5, 0.35),
            _anchor('Cyclist', [1.76, 0.6, 1.73], -0.6, 0.5, 0.35),
        ],
        'SHARED_CONV_NUM_FILTER': 16,
        'RPN_HEAD_CFGS': [{'HEAD_CLS_NAME': ['Car']},
                          {'HEAD_CLS_NAME': ['Pedestrian', 'Cyclist']}],
        'SEPARATE_REG_CONFIG': {
            'NUM_MIDDLE_CONV': 1, 'NUM_MIDDLE_FILTER': 16,
            'REG_LIST': ['reg:2', 'height:1', 'size:3', 'angle:2', 'velo:2'],
        },
        'TARGET_ASSIGNER_CONFIG': {
            'NAME': 'AxisAlignedTargetAssigner', 'POS_FRACTION': -1.0,
            'SAMPLE_SIZE': 512, 'NORM_BY_NUM_EXAMPLES': False,
            'MATCH_HEIGHT': False, 'BOX_CODER': 'ResidualCoder',
            'BOX_CODER_CONFIG': {'code_size': 9,
                                 'encode_angle_by_sincos': True},
        },
        'LOSS_CONFIG': {
            'REG_LOSS_TYPE': 'WeightedL1Loss',
            'LOSS_WEIGHTS': {
                'pos_cls_weight': 1.0, 'neg_cls_weight': 2.0,
                'cls_weight': 1.0, 'loc_weight': 0.25, 'dir_weight': 0.2,
                'code_weights': [1.0] * 8 + [0.2, 0.2],
            },
        },
    })


def _leaves(tree, prefix=''):
    for key, value in tree.items():
        if hasattr(value, 'items'):
            yield from _leaves(value, f'{prefix}{key}/')
        else:
            yield prefix + key, np.asarray(value)


def _randomize(tree, rng):
    out = {}
    for key, value in tree.items():
        if hasattr(value, 'items'):
            out[key] = _randomize(value, rng)
        elif key in ('scale', 'var'):
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ('bias', 'mean'):
            out[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
        else:
            out[key] = np.asarray(value)
    return out


def _gt(rng, b=2, g=6):
    """(B, G, 10) gt boxes, the velocity and the class before the pad."""
    sizes = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}
    gt = np.zeros((b, g, 10), np.float32)
    for s in range(b):
        for j in range(g - 1):  # the last row of each sample pads
            cls = 1 + (j % 3)
            dx, dy, dz = sizes[cls]
            gt[s, j] = [rng.uniform(4, 47), rng.uniform(-21, 21), -1.0,
                        dx, dy, dz, rng.uniform(-np.pi, np.pi),
                        rng.randn() * 2, rng.randn() * 2, cls]
    return gt


@pytest.fixture(scope='module')
def jax_head():
    cfg = head_cfg()
    model = JaxAnchorHeadMulti(
        model_cfg=cfg, input_channels=C_IN, num_class=3,
        class_names=CLASS_NAMES, grid_size=GRID, point_cloud_range=PC_RANGE)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, C_IN).astype(np.float32)
    gt = _gt(rng)
    batch = {'spatial_features_2d': jnp.asarray(x), 'gt_boxes': jnp.asarray(gt)}
    variables = jax.device_get(jax.jit(lambda b: model.init(
        jax.random.PRNGKey(0), b, training=False))(batch))
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)

    @jax.jit
    def evaluate(p, s, b):
        out = model.apply({'params': p, 'batch_stats': s}, b, training=False)
        return out['batch_cls_preds'], out['batch_box_preds']

    def loss_fn(p, b):
        out, mutated = model.apply({'params': p, 'batch_stats': stats}, b,
                                   training=True, mutable=['batch_stats'])
        fwd = out['anchor_head_fwd']
        loss, tb = model.apply({'params': p, 'batch_stats': stats}, fwd,
                               method=model.loss)
        return loss, (tb, fwd, mutated['batch_stats'])

    (_, (tb, fwd, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    return {'cfg': cfg, 'x': x, 'gt': gt, 'params': params, 'stats': stats,
            'eval': jax.device_get(evaluate(params, stats, batch)),
            'train': jax.device_get((tb, fwd, new_stats, grads))}


def _port_head(jax_head):
    head = AnchorHeadMulti(jax_head['cfg'], C_IN, 3, CLASS_NAMES, GRID,
                           PC_RANGE)
    head.load_state_dict(flax_to_state_dict(jax_head['params'],
                                            jax_head['stats']))
    return head


def test_eval_outputs_and_decoded_boxes_match_jax(jax_head):
    head = _port_head(jax_head).eval()
    with torch.no_grad():
        out = head({'spatial_features_2d': torch.from_numpy(jax_head['x'])})
    want_cls, want_box = jax_head['eval']
    assert len(out['batch_cls_preds']) == 2
    assert out['multihead_label_mapping'] == ((1,), (2, 3))
    for got, want in zip(out['batch_cls_preds'], want_cls):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # 3 classes x 2 rotations x 32 x 32 anchors, 9-dim boxes
    assert out['batch_box_preds'].shape == want_box.shape == (2, 6144, 9)
    # relative: the sizes are exp of the residuals, which scales the
    # convolutions' float32 rounding by the size (up to 40 m here)
    np.testing.assert_allclose(out['batch_box_preds'].numpy(), want_box,
                               rtol=1e-5, atol=1e-5)


def test_training_targets_loss_and_gradients_match_jax(jax_head):
    tb, fwd, new_stats, grads = jax_head['train']
    head = _port_head(jax_head).train()
    out = head({'spatial_features_2d': torch.from_numpy(jax_head['x']),
                'gt_boxes': torch.from_numpy(jax_head['gt'])})
    got = out['anchor_head_fwd']
    for key in ('cls_preds', 'box_preds', 'dir_cls_preds'):
        for g, w in zip(got[key], fwd[key]):
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=key)
    labels = got['box_cls_labels'].numpy()
    np.testing.assert_array_equal(labels, fwd['box_cls_labels'])
    assert (labels > 0).sum() > 8 and set(np.unique(labels)) >= {-1, 0, 1, 2, 3}
    np.testing.assert_allclose(got['box_reg_targets'].numpy(),
                               fwd['box_reg_targets'], rtol=0, atol=1e-5)

    loss, got_tb = head.loss(got)
    loss.backward()
    assert set(got_tb) == set(tb)
    for key, want in tb.items():
        np.testing.assert_allclose(float(got_tb[key].detach()), float(want),
                                   rtol=1e-5, err_msg=key)
    got_stats, = state_dict_to_flax(head.state_dict(), new_stats)
    for (key, g), (_, w) in zip(_leaves(got_stats), _leaves(new_stats)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=key)
    named = {k: p.grad for k, p in head.named_parameters()}
    got_grads, = state_dict_to_flax(named, grads)
    n = 0
    for (key, g), (_, w) in zip(_leaves(got_grads), _leaves(grads)):
        assert g.shape == w.shape, key
        assert np.linalg.norm(w) > 0, key
        assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w), key
        n += 1
    assert n == len(named)


def _nms_inputs(rng, b=2, n=400):
    """Two heads' logits over n and 2n anchors and their boxes: head 1's
    two classes equal, and a run of repeated scores in each."""
    def boxes(m):
        out = np.zeros((b, m, 9), np.float32)
        out[..., 0] = rng.uniform(0, 16, (b, m))  # dense: NMS suppresses
        out[..., 1] = rng.uniform(-8, 8, (b, m))
        out[..., 2] = -1.0
        out[..., 3:6] = rng.uniform(0.5, 4.5, (b, m, 3))
        out[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
        out[..., 7:9] = rng.randn(b, m, 2)
        return out

    cls0 = rng.randn(b, n, 1).astype(np.float32)
    cls1 = np.repeat(rng.randn(b, 2 * n, 1).astype(np.float32), 2, axis=-1)
    cls0[:, 10:30] = 0.5  # ties in score order
    cls1[:, 40:80] = 0.25
    return [cls0, cls1], np.concatenate([boxes(n), boxes(2 * n)], axis=1)


@pytest.mark.parametrize('nms_type', ['nms_gpu', 'nms_normal'])
def test_multi_class_post_processing_matches_jax(nms_type):
    rng = np.random.RandomState(1)
    cls, boxes = _nms_inputs(rng)
    post_cfg = {'SCORE_THRESH': 0.3, 'RECALL_THRESH_LIST': [0.3],
                'NMS_CONFIG': {'MULTI_CLASSES_NMS': True, 'NMS_TYPE': nms_type,
                               'NMS_THRESH': 0.2, 'NMS_PRE_MAXSIZE': 300,
                               'NMS_POST_MAXSIZE': 150}}
    mapping = ((1,), (2, 3))
    want = jax.device_get(jax.jit(lambda c, b: jax_post.post_processing(
        {'batch_cls_preds': c, 'batch_box_preds': b,
         'multihead_label_mapping': mapping}, post_cfg, 3))(
             [jnp.asarray(c) for c in cls], jnp.asarray(boxes)))
    got = post_processing(
        {'batch_cls_preds': [torch.from_numpy(c) for c in cls],
         'batch_box_preds': torch.from_numpy(boxes),
         'multihead_label_mapping': mapping}, post_cfg, 3)
    assert got['pred_boxes'].shape == (2, 3 * 150, 9)
    np.testing.assert_array_equal(got['pred_mask'].numpy(), want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'].numpy(),
                                  want['pred_labels'])
    np.testing.assert_array_equal(got['num_preds'].numpy(), want['num_preds'])
    np.testing.assert_array_equal(got['pred_boxes'].numpy(), want['pred_boxes'])
    np.testing.assert_allclose(got['pred_scores'].numpy(), want['pred_scores'],
                               rtol=0, atol=1e-6)
    # classes 2 and 3 have equal scores, so equal keep lists
    mask = got['pred_mask'].numpy()
    np.testing.assert_array_equal(mask[:, 150:300], mask[:, 300:450])
    assert mask.sum(1).min() > 30 and (~mask).sum() > 30
    assert got['rows_read'].shape == (2, 3)


@pytest.mark.parametrize('nms_type', ['nms_gpu', 'nms_normal'])
def test_batched_walk_equals_jax_per_pair_keep_lists(nms_type):
    """Every (sample, class) pair as a row of one walk: each row's keep
    list is the JAX package's ``class_agnostic_nms`` of that pair."""
    rng = np.random.RandomState(2)
    cls, boxes = _nms_inputs(rng, n=300)
    scores = 1 / (1 + np.exp(-cls[1]))  # (2, 600, 2)
    head_boxes = boxes[:, 300:]
    nms_cfg = {'NMS_TYPE': nms_type, 'NMS_THRESH': 0.1,
               'NMS_PRE_MAXSIZE': 500, 'NMS_POST_MAXSIZE': 60}
    rows = torch.from_numpy(scores).permute(0, 2, 1).reshape(4, -1)
    idx, mask, num, read = class_agnostic_nms(
        rows, torch.from_numpy(head_boxes).repeat_interleave(2, 0), nms_cfg,
        score_thresh=0.2)
    jax_nms = jax.jit(lambda sc, bx: jax_nms_utils.class_agnostic_nms(
        sc, bx, nms_cfg, score_thresh=0.2))
    for r in range(4):
        s, k = divmod(r, 2)
        w_idx, w_mask, w_num = jax.device_get(jax_nms(
            jnp.asarray(scores[s, :, k]), jnp.asarray(head_boxes[s])))
        assert int(num[r]) == int(w_num) > 5
        np.testing.assert_array_equal(mask[r].numpy(), w_mask)
        np.testing.assert_array_equal(idx[r].numpy()[w_mask], w_idx[w_mask])
        assert read[r] >= int(w_num)


def test_nms_normal_bev_keep_lists_match_jax():
    """The axis-aligned NMS alone, one sample a row, against the JAX
    package's ``nms_normal_bev``; headings near the 45 degree swap."""
    rng = np.random.RandomState(3)
    boxes = np.zeros((3, 500, 7), np.float32)
    boxes[..., 0:2] = rng.uniform(0, 30, (3, 500, 2))
    boxes[..., 3:6] = rng.uniform(0.5, 5, (3, 500, 3))
    boxes[..., 6] = rng.choice([0.0, np.pi / 4 - 1e-3, np.pi / 4 + 1e-3,
                                np.pi / 2, -2.0], (3, 500))
    scores = rng.rand(3, 500).astype(np.float32)
    valid = rng.rand(3, 500) > 0.1
    nms_cfg = {'NMS_TYPE': 'nms_normal', 'NMS_THRESH': 0.3,
               'NMS_PRE_MAXSIZE': 400, 'NMS_POST_MAXSIZE': 80}
    idx, mask, num, _ = class_agnostic_nms(
        torch.from_numpy(scores), torch.from_numpy(boxes), nms_cfg,
        valid_mask=torch.from_numpy(valid))
    jax_nms = jax.jit(lambda b, sc, v: jax_iou3d.nms_normal_bev(
        b, sc, 0.3, 400, 80, v))
    for s in range(3):
        w_idx, w_mask, w_num = jax.device_get(jax_nms(
            jnp.asarray(boxes[s]), jnp.asarray(scores[s]),
            jnp.asarray(valid[s])))
        assert int(num[s]) == int(w_num) > 10
        np.testing.assert_array_equal(idx[s].numpy(), w_idx)


@pytest.mark.parametrize('name', ['PreviousResidualDecoder',
                                  'PreviousResidualRoIDecoder'])
def test_previous_decoders_match_jax(name):
    rng = np.random.RandomState(4)
    enc = rng.randn(50, 9).astype(np.float32) * 0.3
    anchors = np.concatenate([
        rng.uniform(-20, 20, (50, 3)), rng.uniform(0.5, 4, (50, 3)),
        rng.uniform(-np.pi, np.pi, (50, 1)), rng.randn(50, 2)],
        axis=1).astype(np.float32)
    coder = build_box_coder(name)
    got = coder.decode(torch.from_numpy(enc), torch.from_numpy(anchors))
    want = jax_coders.build_box_coder(name).decode(jnp.asarray(enc),
                                                   jnp.asarray(anchors))
    assert coder.code_size == coder.full_code_size == 7
    assert got.shape == (50, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
