"""The PV-RCNN training slice, port against the JAX package, on the CPU in f32.

At tests/test_pvrcnn_e2e.py's reduced size (0.2 m voxels, 1500-voxel cap,
4000 raw points, 256 keypoints, proposal NMS 512 -> 64 in training,
ROI_PER_IMAGE 32) with one layer a 2D backbone block, B = 2, in float32,
on the JAX package's own training batch
(``build_dataloader(training=True)``, no augmentor) with converted random
weights:

  * the parts against their JAX counterparts: ``points_in_boxes_id`` and
    ``enlarge_box3d``; the point targets and their focal loss;
    ``subsample_rois`` and ``assign_roi_targets`` given the JAX draws (the
    sampled indices equal, the targets within 1e-5); the RCNN losses and
    their gradients; dropout against ``flax.linen.Dropout`` on the same
    uniforms;
  * the RoI head's training step on the input of the step's RoI head with
    proposals around the gt boxes: sampling, targets, both losses, and
    every gradient within 2e-3 of its largest value, of its parameters and
    of the dense head's boxes (the RCNN losses reach the dense head through
    the RoIs, as in the JAX package) and the keypoint features;
  * one whole step against the pieces of ``make_train_step`` with DP_RATIO
    0: the RoI sampling is handed JAX's own draws, taken by a wrapper of
    ``roi_head_utils.assign_roi_targets`` installed for the JAX forward
    (no JAX file changes). Every loss term within 1e-4 relative, every
    gradient leaf within 2e-3 of its largest value, the dense head's
    included, but the VSA's and the point head's within 3 times the port's
    own move under one float32 ulp of the input points, at least 2e-3 and
    at most 1e-2 of the leaf (and 5e-3 in relative L2 norm), the whole
    gradient within 1e-3 in relative L2 norm; BatchNorm statistics as in
    test_torch_train_step.py. Those leaves are ill-conditioned at random
    weights: with the raw points and the voxel table moved by one ulp, one
    column at a time, the port's own gradient moves by more than 1e-2 of
    most of them (``test_point_leaves_move_with_one_ulp_of_input``; by
    under 1e-2 of every other leaf), so two float32 programs part there;
  * two steps with dropout move the parameters, and a resumed run ends
    bit for bit where the uninterrupted one ends (the per-step generator);
  * the raw points of a test batch (``build_test_loader``) and of a
    training batch (``Trainer.make_batch``) equal the JAX loader's.
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.core import geometry as jax_geometry
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.models.dense_heads import point_head as jax_point_head
from lidardetection_tpu.models.roi_heads import roi_head_utils as jax_roi
from lidardetection_tpu.parallel.train_step import device_batch
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.core import geometry
from lidardetection_tpu_torch.core.box_coders import ResidualCoder
from lidardetection_tpu_torch.datasets.synthetic import build_test_loader
from lidardetection_tpu_torch.models.dense_heads import point_head
from lidardetection_tpu_torch.models.layers import dropout
from lidardetection_tpu_torch.models.roi_heads import pvrcnn_head, roi_head_utils
from lidardetection_tpu_torch.ops.select_cuda import ball_select
from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
    rulebook_conv, rulebook_conv_dw,
)
from lidardetection_tpu_torch.parallel import train_step
from lidardetection_tpu_torch.train import Trainer
from test_torch_pvrcnn import _random_variables
from test_torch_train_step import _leaves, _ListLoader
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CFG = 'tools/cfgs/kitti_models/pv_rcnn.yaml'
KEYS = ('voxels', 'voxel_coords', 'voxel_num_points', 'num_voxels', 'points',
        'num_points', 'gt_boxes')
# the VSA and the point head: leaves of the whole step held to 3 x the
# port's one-ulp move, within [2e-3, 1e-2] of their largest entry (the
# module docstring says why)
POINT_MODULES = ('pfe/', 'point_head/')
# what the RoI head reads of the batch
ROI_HEAD_KEYS = ('batch_box_preds', 'batch_cls_preds', 'gt_boxes',
                 'point_coords', 'point_features', 'point_cls_scores',
                 'num_keypoints', 'point_valid')


def _reduce(cfg, dp_ratio=0.0):
    """tests/test_pvrcnn_e2e.py's size, in f32, with DP_RATIO `dp_ratio`
    and a shallower 2D backbone, as test_torch_train_step.py cuts SECOND's:
    with random weights the gradient through ten BatchNorm'd 3x3 layers
    moves by per cents of a leaf when the input moves by float32
    rounding, so two float32 programs (the JAX package eager and jitted
    among them) part there."""
    data = cfg.DATA_CONFIG
    data.DATASET = 'SyntheticDataset'
    data.MAX_POINTS = 4000
    if 'DATA_AUGMENTOR' in data:
        del data.DATA_AUGMENTOR
    vox = [p for p in data.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    vox.VOXEL_SIZE = [0.2, 0.2, 0.1]
    vox.MAX_NUMBER_OF_VOXELS = {'train': 1500, 'test': 1500}
    m = cfg.MODEL
    m.COMPUTE_DTYPE = 'float32'
    m.BACKBONE_2D.LAYER_NUMS = [1, 1]
    m.PFE.NUM_KEYPOINTS = 256
    m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 512
    m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 64
    m.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 32
    m.ROI_HEAD.DP_RATIO = dp_ratio
    return cfg


def _jax_draws(rng, n_rois, roi_per_image, batch_size):
    """The uniforms JAX's ``sample_rois_for_rcnn`` draws from `rng`, by the
    port's names: a key a sample, split in four (roi_head_utils.py:91,
    :170)."""
    def one(key):
        r_fg, r_fgr, r_hard, r_easy = jax.random.split(key, 4)
        return {'roi_fg_perm': jax.random.uniform(r_fg, (n_rois,)),
                'roi_fg_rep': jax.random.uniform(r_fgr, (roi_per_image,)),
                'roi_hard': jax.random.uniform(r_hard, (roi_per_image,)),
                'roi_easy': jax.random.uniform(r_easy, (roi_per_image,))}
    return jax.vmap(one)(jax.random.split(rng, batch_size))


def _jax_sampled_inds(rng, batch, cfg):
    """The indices JAX's ``sample_rois_for_rcnn`` samples from `rng`."""
    def one(key, rois, labels, valid, gts):
        gt_labels = gts[:, -1].astype(jnp.int32)
        if cfg.get('SAMPLE_ROI_BY_EACH_CLASS', False):
            max_ov, _ = jax_roi.get_max_iou_with_same_class(
                rois, labels, gts, gt_labels, gt_labels > 0)
        else:
            iou = jax_roi.boxes_iou3d(rois[:, 0:7], gts[:, 0:7])
            max_ov = jnp.where((gt_labels > 0)[None, :], iou, 0.0).max(axis=1)
        return jax_roi.subsample_rois(key, max_ov, valid, cfg)
    return jax.vmap(one)(jax.random.split(rng, batch['rois'].shape[0]),
                         batch['rois'], batch['roi_labels'], batch['roi_valid'],
                         batch['gt_boxes'])


@contextlib.contextmanager
def _recording_jax_targets():
    """While open, JAX's ``assign_roi_targets`` also returns its draws, its
    sampled indices and the proposals it sampled from, under ``test_*``."""
    real = jax_roi.assign_roi_targets

    def recording(rng, batch, cfg):
        t = dict(real(rng, batch, cfg))
        b, n = batch['rois'].shape[:2]
        t['test_draws'] = _jax_draws(rng, n, int(cfg['ROI_PER_IMAGE']), b)
        t['test_sampled_inds'] = _jax_sampled_inds(rng, batch, cfg)
        t['test_proposals'] = batch['rois']
        t['test_proposal_valid'] = batch['roi_valid']
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_roi, 'assign_roi_targets', recording)
        yield


def _replay(draws):
    """A port `draw` that hands out JAX's draws by name."""
    def draw(name, shape):
        value = torch.from_numpy(np.array(draws[name]))
        assert tuple(value.shape) == tuple(shape), name
        return value
    return draw


def _first_worker_batch(loader):
    """The JAX training loader's first batch as its first worker builds it,
    built in this process: numpy's global generator seeded as that worker
    seeds it (the points' shuffle and the cut to MAX_POINTS draw from it),
    its state put back after.

    The loader forks its workers and the first free one takes the batch,
    each worker drawing from a seed of its own: under the suite's ``-n 6``
    load another worker sometimes took it. At worker 1's batch the JAX
    package's float32 gradient of the RoI grid pool is 4.8e-3 of a leaf off
    the port's float64 one (the port's float32 is within 2.5e-6 of it), and
    ``test_roi_head_training_matches_jax`` read 5 of 4096 entries of
    ``RoIGridPool_0/SharedMLP_0/Dense_0/kernel`` up to 0.00668 against
    0.00276 (ROADMAP.md section 3, closed)."""
    workers, prefetch = loader.num_workers, loader.prefetch
    state = np.random.get_state()
    np.random.seed((loader.seed + 1) * 1000003 + loader.epoch * 97)
    loader.num_workers, loader.prefetch = 0, 0
    try:
        return next(iter(loader))
    finally:
        loader.num_workers, loader.prefetch = workers, prefetch
        np.random.set_state(state)


@pytest.fixture(scope='module')
def jax_step():
    """One training step's pieces in the JAX package, with DP_RATIO 0, and
    what its RoI sampling drew."""
    cfg = _reduce(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=True,
                                       num_scenes=2, seed=3)
    batch = device_batch(_first_worker_batch(loader))
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    params, stats = _random_variables(model, batch, seed=0)
    # class scores that grow with the BEV features, so the top proposals lie
    # on occupied cells and their RoI grids find keypoints: with RoIs in
    # empty space the grid pooling's BatchNorm sees mostly empty groups,
    # and the gradient of the RoI and dense heads turns as ill-conditioned
    # as the VSA's
    head = params['dense_head']
    head['conv_cls_kernel'] = np.abs(head['conv_cls_kernel'])
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    rngs = {'proposal': jax.random.fold_in(rng, 1),
            'dropout': jax.random.fold_in(rng, 2)}

    def loss_fn(p):
        out, mutated = model.apply(
            {'params': p, 'batch_stats': stats}, batch, training=True,
            mutable=['batch_stats', 'intermediates'], rngs=rngs,
            capture_intermediates=lambda m, method: (
                method == '__call__' and m.name == 'point_head'))
        loss, tb = model.apply({'params': p, 'batch_stats': stats}, out,
                               method=model.loss)
        roi_in = mutated['intermediates']['point_head']['__call__'][0]
        return loss, (tb, mutated['batch_stats'], {
            'box_cls_labels': out['anchor_head_fwd']['box_cls_labels'],
            'point_cls_labels': out['point_head_fwd']['point_cls_labels'],
            **{k: v for k, v in out['roi_head_fwd'].items()
               if k != 'reg_tracking_info'}},
            {k: roi_in[k] for k in ROI_HEAD_KEYS})

    with _recording_jax_targets():
        (_, (tb, new_stats, fwd, roi_in)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    host = {k: np.asarray(batch[k]) for k in KEYS}
    return {'host': host, 'params': params, 'stats': stats, 'model': model,
            'cfg': cfg, 'roi_in': jax.device_get(roi_in),
            'step': jax.device_get((tb, new_stats, fwd, grads))}


def _trainer(params, stats, dp_ratio=0.0, **kwargs):
    cfg = _reduce(cfg_from_yaml_file(CFG), dp_ratio)
    return Trainer(cfg, device='cpu',
                   state_dict=flax_to_state_dict(params, stats), **kwargs)


def _port_gradient(jax_step, host):
    """{flax path: gradient} of the port's whole step on `host` with JAX's
    draws."""
    fwd, grads = jax_step['step'][2], jax_step['step'][3]
    model = _trainer(jax_step['params'], jax_step['stats'],
                     total_steps=4).model
    out = model(train_step.device_batch(host, 'cpu'),
                _replay(fwd['test_draws']))
    model.loss(out)[0].backward()
    named = dict(model.named_parameters())
    got, = state_dict_to_flax({k: p.grad for k, p in named.items()}, grads)
    return dict(_leaves(got))


@pytest.fixture(scope='module')
def nudged_steps(jax_step):
    """The port's step gradient with the input points moved by one float32
    ulp, one column (x, y, z, intensity) at a time: the raw points and the
    voxel table's live entries alike."""
    out = []
    for col in range(4):
        host = {k: v.copy() for k, v in jax_step['host'].items()}
        for key in ('points', 'voxels'):
            v = host[key][..., col]
            host[key][..., col] = np.where(
                v != 0, np.nextafter(v, np.float32(np.inf)), v)
        out.append(_port_gradient(jax_step, host))
    return out


def test_point_leaves_move_with_one_ulp_of_input(jax_step, nudged_steps):
    """The port's own step gradient, with the points one ulp away, moves by
    more than 1e-2 of most VSA and point-head leaves (the bound that the
    step test holds them to) and by under 1e-2 of every other leaf: the
    VSA's keypoints and neighbourhoods are where the step is
    ill-conditioned at random weights."""
    base = _port_gradient(jax_step, jax_step['host'])
    moves = {}
    for key, want in _leaves(jax_step['step'][3]):
        top = np.abs(want).max()
        if top > 0:
            moves[key] = max(np.abs(base[key] - g[key]).max()
                             for g in nudged_steps) / top
    point = [m for k, m in moves.items() if k.startswith(POINT_MODULES)]
    assert sum(m > 1e-2 for m in point) > len(point) // 2
    assert all(m < 1e-2 for k, m in moves.items()
               if not k.startswith(POINT_MODULES))


def test_one_step_matches_make_train_step_pieces(jax_step, nudged_steps):
    host, params, stats = (jax_step[k] for k in ('host', 'params', 'stats'))
    tb, new_stats, fwd, grads = jax_step['step']
    trainer = _trainer(params, stats, total_steps=4)
    model = trainer.model
    assert model.training
    batch = train_step.device_batch(host, 'cpu')
    counters = (rulebook_conv, rulebook_conv_dw, ball_select)
    before = [k.launches for k in counters]
    out = model(batch, _replay(fwd['test_draws']))
    loss, got_tb = model.loss(out)
    loss.backward()
    # CPU tensors: every wrapper took its plain version
    assert [k.launches for k in counters] == before

    np.testing.assert_array_equal(
        out['anchor_head_fwd']['box_cls_labels'].numpy(), fwd['box_cls_labels'])
    labels = out['point_head_fwd']['point_cls_labels'].numpy()
    np.testing.assert_array_equal(labels, fwd['point_cls_labels'])
    assert (labels > 0).sum() > 4 and (labels == -1).sum() > 0
    got = out['roi_head_fwd']
    np.testing.assert_array_equal(got['sampled_inds'].numpy(),
                                  fwd['test_sampled_inds'])
    np.testing.assert_array_equal(got['reg_valid_mask'].numpy(),
                                  fwd['reg_valid_mask'])
    for key in ('rois', 'gt_iou_of_rois', 'rcnn_cls_labels', 'gt_of_rois',
                'gt_of_rois_src', 'rcnn_cls', 'rcnn_reg'):
        np.testing.assert_allclose(got[key].detach().numpy(), fwd[key],
                                   rtol=0, atol=1e-4, err_msg=key)

    assert set(got_tb) == set(tb) == {
        'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir', 'rpn_loss',
        'point_loss_cls', 'point_pos_num', 'rcnn_loss_cls', 'rcnn_loss_reg',
        'rcnn_loss_corner', 'rcnn_loss', 'loss'}
    # random weights propose no RoI near a gt box here: the box and corner
    # losses are 0 in both (test_roi_head_training_matches_jax covers them)
    assert float(tb['rcnn_loss_reg']) == float(tb['rcnn_loss_corner']) == 0
    assert float(tb['rcnn_loss_cls']) > 0 and float(tb['point_loss_cls']) > 0
    for key, want in tb.items():
        np.testing.assert_allclose(float(got_tb[key].detach()), float(want),
                                   rtol=1e-4, err_msg=key)

    got_stats, = state_dict_to_flax(model.state_dict(), new_stats)
    moved = 0
    for (key, got_leaf), (_, want), (_, old) in zip(
            _leaves(got_stats), _leaves(new_stats), _leaves(stats)):
        np.testing.assert_allclose(got_leaf, want, rtol=1e-4, atol=1e-5,
                                   err_msg=key)
        moved += int(not np.array_equal(got_leaf, old))
    assert moved == len(list(_leaves(stats)))  # every statistic moved, once

    named = dict(model.named_parameters())
    assert all(p.grad is not None for p in named.values())
    got_grads, = state_dict_to_flax({k: p.grad for k, p in named.items()}, grads)
    err2, norm2, n_leaves = 0.0, 0.0, 0
    for (key, got_leaf), (_, want) in zip(_leaves(got_grads), _leaves(grads)):
        assert got_leaf.shape == want.shape, key
        top = np.abs(want).max()
        n_leaves += 1
        if top == 0:  # the box branch, with no RoI to regress
            assert key.startswith('roi_head/FCHead_1/'), key
            assert not got_leaf.any(), key
            continue
        diff = got_leaf - want
        atol = 2e-3 * top
        if key.startswith(POINT_MODULES):
            assert np.linalg.norm(diff) <= 5e-3 * np.linalg.norm(want), key
            move = max(np.abs(got_leaf - g[key]).max() for g in nudged_steps)
            atol = min(1e-2 * top, max(atol, 3 * move))
        np.testing.assert_allclose(got_leaf, want, rtol=0, atol=atol,
                                   err_msg=key)
        err2 += float((diff ** 2).sum())
        norm2 += float((want ** 2).sum())
    assert n_leaves == len(named)
    assert (err2 / norm2) ** 0.5 < 1e-3  # the whole gradient


def _proposals(gt_boxes, n, rng, near=None):
    """(B, n, 7) dense-head boxes and (B, n, 3) class logits around a
    batch's gt boxes (those within `near` m of the origin in x and y when
    given): half the rows jittered copies of the gt boxes (centres by up to
    0.3 m, sizes by up to 10%, headings by up to 0.3 rad, the scale drawn
    a row), the rest boxes of gt-like sizes spread over the gt boxes' span,
    so the sampler sees foreground, hard and easy background. No two
    headings are within 0.01 rad of parallel: there the clipping IoU of
    both packages is discontinuous (edges within its parallel tolerance,
    ROADMAP.md section 3), and two float32 programs can fall on either
    side."""
    boxes = np.zeros((len(gt_boxes), n, 7), np.float32)
    logits = rng.randn(len(gt_boxes), n, 3).astype(np.float32) * 2
    for s, gt in enumerate(gt_boxes):
        gt = gt[gt[:, -1] > 0]
        if near is not None:
            gt = gt[(np.abs(gt[:, 0:2]) < near).all(1)]
        k = n // 2
        src = gt[np.arange(k) % len(gt)]
        logits[s, np.arange(k), src[:, 7].astype(int) - 1] += 4  # its class
        scale = rng.uniform(0.05, 1.0, (k, 1))
        boxes[s, :k, 0:3] = src[:, 0:3] + rng.randn(k, 3) * 0.3 * scale
        boxes[s, :k, 3:6] = src[:, 3:6] * np.exp(rng.randn(k, 3) * 0.1 * scale)
        turn = rng.randn(k) * 0.3 * scale[:, 0]
        boxes[s, :k, 6] = src[:, 6] + np.sign(turn) * np.maximum(
            np.abs(turn), 0.01)
        gt = gt[:, :7]
        lo, hi = gt[:, 0:3].min(0) - 3, gt[:, 0:3].max(0) + 3
        boxes[s, k:, 0:3] = rng.uniform(lo, hi, (n - k, 3))
        boxes[s, k:, 3:6] = gt[rng.randint(len(gt), size=n - k), 3:6]
        boxes[s, k:, 6] = rng.uniform(-np.pi, np.pi, n - k)
        # off parallel to every gt box (modulo pi / 2)
        rel = (boxes[s, k:, 6, None] - gt[None, :, 6]) % (np.pi / 2)
        parallel = ((rel < 0.01) | (rel > np.pi / 2 - 0.01)).any(1)
        boxes[s, k:, 6][parallel] += 0.02
    return boxes, logits


@pytest.fixture(scope='module')
def roi_head_case(jax_step):
    """The RoI head's training forward, loss and gradients in the JAX
    package on the input of the step's RoI head, with the dense head's
    boxes replaced by proposals around the gt boxes: gradients of the
    head's parameters and of the boxes and keypoint features it reads.

    Each sample is first moved so that its first gt box sits at the origin
    (the head is equivariant to it), and the proposals keep within 15 m
    of it: the clipping IoU of both packages sums cross products of
    absolute coordinates, and for small boxes far out two float32 programs
    round it apart, by up to 0.03 for near-identical pedestrian-sized
    pairs (test_clipping_iou_of_small_boxes_matches_jax_far_out)."""
    model, params, stats = (jax_step[k] for k in ('model', 'params', 'stats'))
    inp = {k: np.array(v) for k, v in jax_step['roi_in'].items()}
    shift = inp['gt_boxes'][:, 0, 0:3].copy()
    inp['point_coords'] -= shift[:, None, :]
    inp['gt_boxes'][..., 0:3] -= shift[:, None, :]
    boxes, logits = _proposals(inp['gt_boxes'], 600, np.random.RandomState(7),
                               near=15.0)
    inp.update(batch_box_preds=boxes, batch_cls_preds=logits)
    key = jax.random.PRNGKey(11)
    pool_in = {}

    def run(m, b):
        out = m.roi_head(b, training=True)
        return m.roi_head.loss(out['roi_head_fwd']), out['roi_head_fwd']

    def grab(next_fun, args, kwargs, context):
        # the RoI grid pool's grid points, as JAX's step computes them
        if context.method_name == '__call__' and \
                type(context.module).__name__ == 'RoIGridPool':
            pool_in['grid_pts'] = args[5]
        return next_fun(*args, **kwargs)

    def loss_fn(p_roi, box_preds, feats):
        b = {**inp, 'batch_box_preds': box_preds, 'point_features': feats}
        with fnn.intercept_methods(grab):
            ((loss, tb), fwd), _ = model.apply(
                {'params': {**params, 'roi_head': p_roi},
                 'batch_stats': stats},
                b, method=run, mutable=['batch_stats'],
                rngs={'proposal': key})
        return loss, (tb, {**{k: v for k, v in fwd.items()
                              if k != 'reg_tracking_info'},
                           'pool_grid_pts': pool_in['grid_pts']})

    with _recording_jax_targets():
        (_, (tb, fwd)), grads = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2), has_aux=True))(
                params['roi_head'], jnp.asarray(boxes),
                jnp.asarray(inp['point_features']))
    return inp, jax.device_get((tb, fwd, grads))


def test_roi_head_training_matches_jax(jax_step, roi_head_case):
    """Sampling, targets, both losses and every gradient of the RoI head's
    training step, the gradient into the dense head's boxes included."""
    inp, (tb, fwd, (g_params, g_boxes, g_feats)) = roi_head_case
    trainer = _trainer(jax_step['params'], jax_step['stats'])
    head = trainer.model.roi_head
    assert head.training
    batch = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    for key in ('batch_box_preds', 'point_features'):
        batch[key].requires_grad_(True)
    selections = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pvrcnn_head.p2, 'candidate_rank_select', _recording(
            pvrcnn_head.p2.candidate_rank_select, selections))
        out = head(batch, _replay(fwd['test_draws']))
    loss, got_tb = head.loss(out['roi_head_fwd'])
    loss.backward()
    got = out['roi_head_fwd']

    np.testing.assert_array_equal(got['sampled_inds'].numpy(),
                                  fwd['test_sampled_inds'])
    valid = fwd['reg_valid_mask']
    np.testing.assert_array_equal(got['reg_valid_mask'].numpy(), valid)
    assert valid.sum() > 4 and (valid == 0).sum() > 4
    labels = fwd['rcnn_cls_labels']
    assert ((labels > 0) & (labels < 1)).sum() > 4  # soft roi_iou targets
    # the IoUs within 2e-4 and the roi_iou targets, twice them, within 4e-4:
    # shoelace sums of f32 coordinates out to 15 m for boxes of 0.5 m^2
    for key, tol in (('rois', 1e-5), ('gt_of_rois', 1e-5),
                     ('gt_of_rois_src', 1e-5), ('gt_iou_of_rois', 2e-4),
                     ('rcnn_cls_labels', 4e-4)):
        np.testing.assert_allclose(got[key].detach().numpy(), fwd[key],
                                   rtol=0, atol=tol, err_msg=key)
    _assert_same_neighbours(selections, fwd['pool_grid_pts'])
    for key in ('rcnn_cls', 'rcnn_reg'):
        np.testing.assert_allclose(got[key].detach().numpy(), fwd[key],
                                   rtol=0, atol=1e-4, err_msg=key)
    assert set(got_tb) == set(tb)
    for key, want in tb.items():
        assert float(want) > 0, key
        np.testing.assert_allclose(float(got_tb[key].detach()), float(want),
                                   rtol=1e-4, err_msg=key)

    named = {f'roi_head.{k}': p.grad for k, p in head.named_parameters()}
    got_grads, = state_dict_to_flax(named, {'roi_head': g_params})
    pairs = list(zip(_leaves(got_grads), _leaves({'roi_head': g_params})))
    pairs += [(('batch_box_preds', batch['batch_box_preds'].grad.numpy()),
               ('batch_box_preds', g_boxes)),
              (('point_features', batch['point_features'].grad.numpy()),
               ('point_features', g_feats))]
    assert len(pairs) == len(named) + 2
    for (key, got_leaf), (_, want) in pairs:
        top = np.abs(want).max()
        assert top > 0, key
        np.testing.assert_allclose(got_leaf, want, rtol=0, atol=2e-3 * top,
                                   err_msg=key)


def _recording(fn, calls):
    def run(cand_xyz, cand_live, grid, radius, nsample):
        calls.append((cand_xyz, cand_live, grid, radius))
        return fn(cand_xyz, cand_live, grid, radius, nsample)
    return run


def _assert_same_neighbours(selections, jax_grid):
    """The RoI grid pool's discrete input: which candidate keypoints lie
    within each radius of each grid point. Away from the radius, float32
    rounding cannot move a pair across it; a pair that crosses adds or
    drops a whole neighbour and can move a leaf by more than the test's
    2e-3. So before the gradients are compared: the
    port's grid points equal JAX's (taken from inside its step) to 1e-5 m,
    every live (grid point, candidate) pair lies more than 1e-6 of r^2 off
    the radius in float64, and the two packages' grid points put every
    pair on the same side."""
    assert [r for *_, r in selections] == [0.8, 1.6]
    g_jax = np.asarray(jax_grid, np.float64)
    for cand_xyz, cand_live, grid, radius in selections:
        g_port = grid.detach().numpy().astype(np.float64)
        shift = np.abs(g_port - g_jax).max()
        assert shift <= 1e-5, f'grid points differ from JAX\'s by {shift} m'
        c = cand_xyz.detach().numpy().astype(np.float64)[:, :, None]
        live = cand_live.numpy()[:, :, None, :]
        r2 = float(np.float32(radius * radius))
        d2 = {}
        for name, g in (('port', g_port), ('jax', g_jax)):
            d2[name] = ((g[:, :, :, None, :] - c) ** 2).sum(-1)
        near = live & (np.abs(d2['port'] - r2) <= 1e-6 * r2)
        assert not near.any(), (
            f'{int(near.sum())} (grid point, keypoint) pairs lie within '
            f'1e-6 of radius {radius}: float32 rounding decides them')
        crossed = live & ((d2['port'] < r2) != (d2['jax'] < r2))
        assert not crossed.any(), (
            f'{int(crossed.sum())} (grid point, keypoint) pairs fall on '
            f'different sides of radius {radius} for the two packages\' '
            f'grid points (largest shift {shift} m)')


def _random_boxes(rng, n, spread=20.0):
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    boxes[:, 2] = rng.uniform(-2, 0, n)
    boxes[:, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return boxes


def test_points_in_boxes_and_enlarge_match_jax():
    rng = np.random.RandomState(0)
    boxes = _random_boxes(rng, 12, spread=6.0)
    points = rng.uniform(-8, 8, (3000, 3)).astype(np.float32)
    points[:, 2] = rng.uniform(-3, 1, 3000)
    points[:500] = boxes[rng.randint(12, size=500), 0:3]  # on the centres
    valid = rng.rand(12) > 0.25
    want_big = np.asarray(jax_geometry.enlarge_box3d(jnp.asarray(boxes),
                                                     (0.2, 0.3, 0.4)))
    got_big = geometry.enlarge_box3d(torch.from_numpy(boxes), (0.2, 0.3, 0.4))
    np.testing.assert_array_equal(got_big.numpy(), want_big)
    for b, v in ((boxes, None), (want_big, valid)):
        want = np.asarray(jax_geometry.points_in_boxes_id(
            jnp.asarray(points), jnp.asarray(b),
            None if v is None else jnp.asarray(v)))
        got = geometry.points_in_boxes_id(
            torch.from_numpy(points), torch.from_numpy(b),
            None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want >= 0).sum() > 500 and (want == -1).sum() > 500
    inside = geometry.points_in_boxes_3d(torch.from_numpy(points)[None],
                                         torch.from_numpy(boxes)[None])[0]
    np.testing.assert_array_equal(inside.numpy(), np.asarray(
        jax_geometry.points_in_boxes_3d(jnp.asarray(points), jnp.asarray(boxes))))


@pytest.mark.parametrize('num_class', [1, 3])
def test_point_targets_and_focal_loss_match_jax(num_class):
    rng = np.random.RandomState(num_class)
    gt = np.zeros((2, 10, 8), np.float32)
    for s in range(2):
        gt[s, :7 - 2 * s, :7] = _random_boxes(rng, 7 - 2 * s, spread=5.0)
        gt[s, :7 - 2 * s, 7] = rng.randint(1, 4, 7 - 2 * s)
    coords = rng.uniform(-6, 6, (2, 800, 3)).astype(np.float32)
    coords[..., 2] = rng.uniform(-3, 1, (2, 800))
    coords[:, :300] = gt[:, rng.randint(5, size=300), 0:3] \
        + rng.randn(2, 300, 3).astype(np.float32) * 0.8
    valid = np.arange(800)[None] < np.array([[800], [650]])
    want = jax_point_head.assign_point_targets(
        jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(gt),
        extra_width=(0.2, 0.2, 0.2), set_ignore_flag=True, num_class=num_class)
    got = point_head.assign_point_targets(
        torch.from_numpy(coords), torch.from_numpy(valid), torch.from_numpy(gt),
        (0.2, 0.2, 0.2), num_class)
    labels = np.asarray(want['point_cls_labels'])
    np.testing.assert_array_equal(got['point_cls_labels'].numpy(), labels)
    for value in (-1, 0, 1):
        assert (labels == value).sum() > 10, value
    preds = rng.randn(2, 800, num_class).astype(np.float32) * 2

    def jax_loss(p):
        return jax_point_head.point_cls_loss(p, labels, num_class, 1.5)

    (want_loss, want_pos), want_grad = jax.value_and_grad(
        jax_loss, has_aux=True)(jnp.asarray(preds))
    p = torch.from_numpy(preds).requires_grad_(True)
    loss, pos = point_head.point_cls_loss(p, got['point_cls_labels'],
                                          num_class, 1.5)
    loss.backward()
    assert float(pos) == float(want_pos) > 1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


SAMPLER = {'ROI_PER_IMAGE': 32, 'FG_RATIO': 0.5, 'SAMPLE_ROI_BY_EACH_CLASS': True,
           'CLS_SCORE_TYPE': 'roi_iou', 'CLS_FG_THRESH': 0.75,
           'CLS_BG_THRESH': 0.25, 'CLS_BG_THRESH_LO': 0.1,
           'HARD_BG_RATIO': 0.8, 'REG_FG_THRESH': 0.55}


@pytest.mark.parametrize('case', ['mixed', 'few fg', 'fg only', 'hard only',
                                  'easy only', 'bg only', 'none valid'])
def test_subsample_rois_matches_jax(case):
    """Every branch of the sampler, given the JAX draws."""
    rng = np.random.RandomState(len(case))
    n = 64
    ranges = {'mixed': (0.0, 1.0), 'few fg': (0.0, 0.6), 'fg only': (0.6, 1.0),
              'hard only': (0.15, 0.5), 'easy only': (0.0, 0.09),
              'bg only': (0.0, 0.5), 'none valid': (0.0, 1.0)}[case]
    ov = rng.uniform(*ranges, (2, n)).astype(np.float32)
    if case == 'few fg':
        ov[:, :3] = 0.9
    valid = rng.rand(2, n) > (1.0 if case == 'none valid' else 0.2)
    key = jax.random.PRNGKey(len(case))
    keys = jax.random.split(key, 2)
    want = np.stack([np.asarray(jax_roi.subsample_rois(
        keys[s], jnp.asarray(ov[s]), jnp.asarray(valid[s]), SAMPLER))
        for s in range(2)])
    draws = jax.device_get(_jax_draws(key, n, 32, 2))
    got = roi_head_utils.subsample_rois(
        {k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
        torch.from_numpy(ov), torch.from_numpy(valid), SAMPLER)
    np.testing.assert_array_equal(got.numpy(), want)


def _roi_targets_case(rng, score_type):
    gt = np.zeros((2, 8, 8), np.float32)
    for s in range(2):
        gt[s, :6, :7] = _random_boxes(rng, 6, spread=15.0)
        gt[s, :6, 3:6] = rng.uniform(1.5, 4.5, (6, 3))
        gt[s, :6, 7] = rng.randint(1, 4, 6)
    boxes, logits = _proposals(gt, 64, rng)
    labels = np.asarray(logits.argmax(-1) + 1, np.int32)
    labels[:, :32] = gt[:, np.arange(32) % 6, 7]  # the jittered copies' class
    valid = rng.rand(2, 64) > 0.1
    return {'rois': boxes * valid[..., None],
            'roi_scores': logits.max(-1) * valid,
            'roi_labels': labels * valid, 'roi_valid': valid,
            'gt_boxes': gt}, {**SAMPLER, 'CLS_SCORE_TYPE': score_type}


@pytest.mark.parametrize('score_type', ['roi_iou', 'cls'])
def test_assign_roi_targets_and_losses_match_jax(score_type):
    """The sampled RoIs, their targets in the canonical frame, the RCNN box
    (smooth-L1 and corner) and class losses, and the losses' gradients of
    the RCNN outputs and of the proposals."""
    rng = np.random.RandomState(1 + len(score_type))
    batch, cfg = _roi_targets_case(rng, score_type)
    key = jax.random.PRNGKey(5)
    rcnn_cls = rng.randn(2 * 32, 1).astype(np.float32)
    rcnn_reg = (rng.randn(2 * 32, 7) * 0.2).astype(np.float32)
    loss_cfg = {'CLS_LOSS': 'BinaryCrossEntropy', 'REG_LOSS': 'smooth-l1',
                'CORNER_LOSS_REGULARIZATION': True, 'LOSS_WEIGHTS': {
                    'rcnn_cls_weight': 1.0, 'rcnn_reg_weight': 1.3,
                    'rcnn_corner_weight': 0.7, 'code_weights': [1.0] * 7}}
    coder = ResidualCoder()

    def jax_losses(rois, cls, reg):
        t = jax_roi.assign_roi_targets(key, {**batch, 'rois': rois}, cfg)
        fwd = {**t, 'rcnn_cls': cls, 'rcnn_reg': reg}
        from lidardetection_tpu.core.box_coders import ResidualCoder as JaxCoder
        box, tb_box = jax_roi.roi_box_loss(fwd, JaxCoder(), loss_cfg)
        cls_loss, tb_cls = jax_roi.roi_cls_loss(fwd, loss_cfg)
        return box + cls_loss, (t, {**tb_box, **tb_cls})

    (_, (want_t, want_tb)), want_g = jax.value_and_grad(
        jax_losses, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(batch['rois']), jnp.asarray(rcnn_cls),
            jnp.asarray(rcnn_reg))
    want_inds = np.asarray(_jax_sampled_inds(key, batch, cfg))

    tb_in = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    args = [torch.from_numpy(x).requires_grad_(True)
            for x in (batch['rois'], rcnn_cls, rcnn_reg)]
    tb_in['rois'] = args[0]
    draws = jax.device_get(_jax_draws(key, 64, 32, 2))
    t = roi_head_utils.assign_roi_targets(
        {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}, tb_in, cfg)
    np.testing.assert_array_equal(t['sampled_inds'].numpy(), want_inds)
    valid = np.asarray(want_t['reg_valid_mask'])
    np.testing.assert_array_equal(t['reg_valid_mask'].numpy(), valid)
    assert valid.sum() > 4
    # the targets within 1e-5; the IoUs and the roi_iou class targets made
    # from them within 1e-4: shoelace sums of f32 coordinates out to 20 m
    # round differently in another order (test_torch_iou_nms.py)
    for key_, tol in (('rois', 1e-5), ('gt_of_rois', 1e-5),
                      ('gt_of_rois_src', 1e-5), ('roi_scores', 1e-5),
                      ('roi_labels', 0), ('gt_iou_of_rois', 1e-4),
                      ('rcnn_cls_labels', 1e-4)):
        np.testing.assert_allclose(t[key_].detach().numpy(),
                                   np.asarray(want_t[key_]), rtol=0, atol=tol,
                                   err_msg=key_)
    fwd = {**t, 'rcnn_cls': args[1], 'rcnn_reg': args[2]}
    box, tb_box = roi_head_utils.roi_box_loss(fwd, coder, loss_cfg)
    cls_loss, tb_cls = roi_head_utils.roi_cls_loss(fwd, loss_cfg)
    (box + cls_loss).backward()
    got_tb = {**tb_box, **tb_cls}
    assert set(got_tb) == set(want_tb)
    for k, want in want_tb.items():
        assert float(want) > 0, k
        np.testing.assert_allclose(float(got_tb[k]), float(want), rtol=1e-5,
                                   err_msg=k)
    for arg, want, name in zip(args, want_g, ('rois', 'rcnn_cls', 'rcnn_reg')):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(arg.grad.numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max(), err_msg=name)


def test_dropout_matches_flax():
    """flax's Dropout and the port's, on the uniforms flax draws."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 256).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = fnn.Dropout(0.3).apply({}, jnp.asarray(x), deterministic=False,
                                  rng=key)
    u = np.asarray(jax.random.uniform(key, x.shape))
    got = dropout(torch.from_numpy(x), torch.from_numpy(u), 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.6 < float((got != 0).float().mean()) < 0.8


def test_two_steps_with_dropout_run_and_move_parameters(jax_step):
    trainer = _trainer(jax_step['params'], jax_step['stats'], dp_ratio=0.3,
                       total_steps=4)
    batch = train_step.device_batch(jax_step['host'], 'cpu')
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for i in range(2):
        tb = trainer.step(batch)
        assert all(np.isfinite(float(v)) for v in tb.values())
        assert float(tb['rcnn_loss_cls']) > 0 and trainer.state.step == i + 1
    after = trainer.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.isfinite(v).all() for v in after.values())
    # the draws are a function of (seed, step): the step's RoIs sample anew
    draw = train_step.step_draw(0, 0, 'cpu')
    again = train_step.step_draw(0, 0, 'cpu')
    assert torch.equal(draw('a', (3, 5)), again('b', (3, 5)))
    assert not torch.equal(train_step.step_draw(0, 1, 'cpu')('a', (3, 5)),
                           train_step.step_draw(0, 0, 'cpu')('a', (3, 5)))


def test_resume_reproduces_the_uninterrupted_run(jax_step, tmp_path):
    """With dropout and RoI sampling drawn per step, a run cut after its
    second epoch and resumed ends bit for bit where the whole run ends."""
    host = jax_step['host']

    def run(ckpt_dir, crash_epoch=None):
        trainer = _trainer(jax_step['params'], jax_step['stats'], dp_ratio=0.3)
        trainer.fit(_ListLoader([host], crash_epoch), ckpt_dir,
                    total_epochs=3, max_ckpt_save_num=2)
        return trainer.state

    whole = run(tmp_path / 'whole').state_dict()
    assert whole['step'] == 3
    with pytest.raises(KeyboardInterrupt):
        run(tmp_path / 'cut', crash_epoch=2)
    resumed = run(tmp_path / 'cut').state_dict()  # epoch 3 only
    assert resumed['step'] == whole['step']
    for key, want in whole['model'].items():
        assert torch.equal(resumed['model'][key], want), key
    for kind in ('mu', 'nu'):
        for key, want in whole['optimizer'][kind].items():
            assert torch.equal(resumed['optimizer'][kind][key], want), key


def _pvrcnn_data_cfg(load, shuffle):
    """pv_rcnn.yaml's data at full width (MAX_POINTS 131072), the
    synthetic set, no augmentor; point shuffling in training as asked."""
    cfg = load(CFG)
    cfg.DATA_CONFIG.DATASET = 'SyntheticDataset'
    del cfg.DATA_CONFIG.DATA_AUGMENTOR
    for p in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if p.NAME == 'shuffle_points':
            p.SHUFFLE_ENABLED.train = shuffle
    return cfg


def test_test_batch_carries_the_raw_points_of_the_jax_loader():
    cfg = _pvrcnn_data_cfg(jax_cfg_from_yaml, False)
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                 batch_size=2, training=False, num_scenes=2,
                                 seed=4)
    want = next(iter(loader))
    _, port_loader = build_test_loader(
        _pvrcnn_data_cfg(cfg_from_yaml_file, False), 2, 2, seed=4)
    got = next(iter(port_loader))
    assert got['points'].shape == (2, 131072, 4)
    np.testing.assert_array_equal(got['num_points'], want['num_points'])
    np.testing.assert_array_equal(got['points'], want['points'])
    assert (got['num_points'] > 10000).all()


@pytest.mark.parametrize('shuffle', [False, True], ids=['in order', 'shuffled'])
def test_make_batch_carries_the_raw_points_of_the_jax_loader(shuffle):
    """Trainer.make_batch on the scenes of the JAX training loader's batch:
    the same points (in the same order when neither shuffles)."""
    from lidardetection_tpu.datasets.synthetic import make_scene as jax_make_scene

    cfg = _pvrcnn_data_cfg(jax_cfg_from_yaml, shuffle)
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=True,
                                       num_scenes=2, seed=4)
    loader.shuffle = False
    want = next(iter(loader))
    trainer = Trainer(_pvrcnn_data_cfg(cfg_from_yaml_file, shuffle),
                      device='cpu')
    scenes = []
    for i in range(2):
        points, gt, _ = jax_make_scene(
            np.random.RandomState(4 * 100003 + i),
            np.asarray(trainer.info['point_cloud_range'], np.float32))
        scenes.append((points, np.zeros((trainer.max_gt_boxes, 8), np.float32)))
    got = trainer.make_batch(scenes)
    assert tuple(got['points'].shape) == (2, 131072, 4)
    np.testing.assert_array_equal(got['num_points'].numpy(), want['num_points'])
    for s in range(2):
        n = int(want['num_points'][s])
        g, w = got['points'][s].numpy(), want['points'][s]
        assert not g[n:].any() and not w[n:].any()
        if shuffle:  # each shuffles with its own generator
            g, w = (np.unique(x[:n], axis=0) for x in (g, w))
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('x', [0.0, 60.0], ids=['at 0 m', 'at 60 m'])
def test_clipping_iou_of_small_boxes_matches_jax_far_out(x):
    """200 near-identical pedestrian-sized pairs (0.87 x 0.65 m, jittered by
    3 cm, 2% and 0.02 rad) at the origin and 60 m out. The port's clipping
    IoU follows the JAX package's at both: within 2e-4 at the origin, 0.01
    at 60 m (0.0049 measured). Both misread near-identical pairs more the
    farther out they lie (cross products of absolute coordinates in
    float32): at 60 m 15 of the 200 pairs miss the exact polygon IoU by
    more than 0.01, one by 0.469, in both packages alike (ROADMAP.md
    section 3). The last assertion pins that property of the reference: a
    repaired IoU fails it, and the record is to be updated with it."""
    from lidardetection_tpu.core import iou3d as jax_iou3d
    from lidardetection_tpu_torch.core import iou3d
    from lidardetection_tpu_torch.core.np_geometry import boxes_bev_iou_cpu

    rng = np.random.RandomState(0)
    a = np.tile(np.array([x, 0.0, -0.73, 0.8728423, 0.65463173, 1.8875215,
                          -0.41970143], np.float32), (200, 1))
    b = a.copy()
    b[:, 0:2] += rng.randn(200, 2).astype(np.float32) * 0.03
    b[:, 3:5] *= np.exp(rng.randn(200, 2) * 0.02).astype(np.float32)
    b[:, 6] += rng.randn(200).astype(np.float32) * 0.02
    got = np.array([iou3d.boxes_iou_bev(torch.from_numpy(a[i:i + 1]),
                                        torch.from_numpy(b[i:i + 1])).item()
                    for i in range(200)])
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, q: jax_iou3d.boxes_iou_bev(p[None], q[None])[0, 0]))(a, b))
    exact = np.array([boxes_bev_iou_cpu(a[i:i + 1].astype(np.float64),
                                        b[i:i + 1].astype(np.float64))[0, 0]
                      for i in range(200)])
    assert 0.8 < exact.mean() < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 if x == 0 else 0.01)
    if x == 0.0:
        np.testing.assert_allclose(got, exact, rtol=0, atol=2e-4)
    else:
        assert (np.abs(want - exact) > 0.01).sum() >= 10
