"""The Part-A² training slice, port against the JAX package, on the CPU in f32.

At tests/test_parta2_e2e.py's reduced size (0.2 m voxels, 1200-voxel cap,
POOL_SIZE 6, proposal NMS 512 -> 64 in training, ROI_PER_IMAGE 16) with
one layer a 2D backbone block, B = 2, in float32, on the JAX package's
own training batch (``build_dataloader(training=True)`` with the model's
training plan, so the batch carries every ``rb_*`` table, the transposed
ones included; no augmentor) with converted random weights:

  * the part targets and ``point_part_loss`` with its gradient;
  * the inverse convolution's input gradient: the plain version of the K3
    launch the port makes (``rulebook_conv_plain`` over the paired strided
    convolution's forward rulebook ``rb_down<n>``, ``W[k]^T``, no flip),
    ``sparse_conv_apply``'s backward with and without that table, and
    JAX's vjp, against autograd of the plain forward;
  * the RoI head's training step on the input of the step's RoI head
    with proposals around the gt boxes: the sampled RoIs and each RoI's
    point sample equal first, then both losses and every gradient within
    1e-3 of its largest value, of the head's parameters, of the dense
    head's boxes and of the point features and part offsets it pools;
  * one whole step against the pieces of ``make_train_step`` with
    DP_RATIO 0, the RoI sampling handed JAX's own draws (taken by a
    wrapper of ``roi_head_utils.assign_roi_targets`` installed for the
    JAX forward; no JAX file changes): the sampled RoIs and each RoI's
    point sample equal first (a discrete flip is named before any
    gradient bound), then every loss term within 1e-4 relative, the
    BatchNorm statistics, and every gradient leaf within 2e-3 of its
    largest value, but the 2D backbone's within 1e-2 (and 5e-3 in
    relative L2 norm), the whole gradient within 1e-3 in relative L2
    norm. The 2D backbone's gap is the float32 BatchNorm statistics
    (``s2 / cnt - mean^2`` cancels over a mostly empty BEV map, and the two
    CPU libraries round its sums differently): the same backbone alone in
    float64, its statistics included, agrees with JAX's within 1e-6 in
    relative L2 norm (``test_bev_backbone_gradient_in_float64_matches_jax``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.core import iou3d as jax_iou3d
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.models.dense_heads import point_head as jax_point_head
from lidardetection_tpu.models.roi_heads import parta2_head as jax_parta2
from lidardetection_tpu.ops import sparse as jsparse
from lidardetection_tpu.parallel.train_step import device_batch
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.models.dense_heads import point_head
from lidardetection_tpu_torch.models.roi_heads import parta2_head
from lidardetection_tpu_torch.ops import sparse
from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
    rulebook_conv, rulebook_conv_dw, rulebook_conv_plain,
)
from lidardetection_tpu_torch.parallel import train_step
from lidardetection_tpu_torch.train import Trainer
from test_torch_parta2 import CFG, INVERSE, _edge_table
from test_torch_parta2 import _reduce as _reduce_eval
from test_torch_pvrcnn import _random_variables
from test_torch_pvrcnn_train import (
    _proposals, _random_boxes, _recording_jax_targets, _replay,
)
from test_torch_train_step import _leaves
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

KEYS = ('voxels', 'voxel_coords', 'voxel_num_points', 'num_voxels', 'gt_boxes')
# what the RoI head reads of the batch
ROI_HEAD_KEYS = ('batch_box_preds', 'batch_cls_preds', 'gt_boxes',
                 'point_coords', 'point_features', 'point_cls_scores',
                 'point_part_offset', 'point_valid')


def _reduce(cfg, dp_ratio=0.0):
    """The eval test's size with DP_RATIO `dp_ratio` and a shallower 2D
    backbone, as test_torch_pvrcnn_train.py cuts PV-RCNN's: with random
    weights the gradient through ten BatchNorm'd 3x3 layers moves by per
    cents of a leaf when the input moves by float32 rounding."""
    cfg = _reduce_eval(cfg)
    cfg.MODEL.BACKBONE_2D.LAYER_NUMS = [1, 1]
    cfg.MODEL.ROI_HEAD.DP_RATIO = dp_ratio
    return cfg


@contextlib.contextmanager
def _recording_jax_samples(store):
    """While open, JAX's Part-A² head hands its ``roi_point_sample``
    results to `store` (a list; traced values inside a jitted step)."""
    real = jax_parta2.roi_point_sample

    def recording(*args, **kwargs):
        store.append(real(*args, **kwargs))
        return store[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_parta2, 'roi_point_sample', recording)
        yield


@contextlib.contextmanager
def _recording_port_samples(store):
    real = parta2_head.roi_point_sample

    def recording(*args, **kwargs):
        store.append(real(*args, **kwargs))
        return store[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parta2_head, 'roi_point_sample', recording)
        yield


@pytest.fixture(scope='module')
def jax_step():
    """One training step's pieces in the JAX package, with DP_RATIO 0, what
    its RoI sampling drew and the point sample of its RoIs."""
    cfg = _reduce(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=True,
                                       num_scenes=2, seed=3,
                                       model_cfg=cfg.MODEL)
    batch = device_batch(next(iter(loader)))
    assert 'rb_down2_bwd' in batch and 'rb_inv2' in batch
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    params, stats = _random_variables(model, batch, seed=0)
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    rngs = {'proposal': jax.random.fold_in(rng, 1),
            'dropout': jax.random.fold_in(rng, 2)}
    samples = []

    def loss_fn(p):
        out, mutated = model.apply(
            {'params': p, 'batch_stats': stats}, batch, training=True,
            mutable=['batch_stats', 'intermediates'], rngs=rngs,
            capture_intermediates=lambda m, method: (
                method == '__call__' and m.name == 'point_head'))
        loss, tb = model.apply({'params': p, 'batch_stats': stats}, out,
                               method=model.loss)
        roi_in = mutated['intermediates']['point_head']['__call__'][0]
        pf = out['point_head_fwd']
        return loss, (tb, mutated['batch_stats'], {
            'box_cls_labels': out['anchor_head_fwd']['box_cls_labels'],
            'point_cls_labels': pf['point_cls_labels'],
            'point_part_labels': pf['point_part_labels'],
            'test_sample': samples[0],
            **{k: v for k, v in out['roi_head_fwd'].items()
               if k != 'reg_tracking_info'}},
            {k: roi_in[k] for k in ROI_HEAD_KEYS})

    with _recording_jax_targets(), _recording_jax_samples(samples):
        (_, (tb, new_stats, fwd, roi_in)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    host = {k: np.asarray(v) for k, v in batch.items()
            if k in KEYS or k.startswith('rb_')}
    return {'host': host, 'params': params, 'stats': stats, 'model': model,
            'cfg': cfg, 'roi_in': jax.device_get(roi_in),
            'step': jax.device_get((tb, new_stats, fwd, grads))}


def _trainer(params, stats, dp_ratio=0.0, **kwargs):
    cfg = _reduce(cfg_from_yaml_file(CFG), dp_ratio)
    return Trainer(cfg, device='cpu',
                   state_dict=flax_to_state_dict(params, stats), **kwargs)


def _assert_same_samples(got, want):
    """The discrete input of both pools: which points each RoI samples."""
    idx, hit = got
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize('num_class', [1, 3])
def test_part_labels_and_loss_match_jax(num_class):
    """The part targets of the foreground points (0 elsewhere) and the
    part-offset BCE with its gradient."""
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
        extra_width=(0.2, 0.2, 0.2), ret_part_labels=True,
        set_ignore_flag=True, num_class=num_class)
    got = point_head.assign_point_targets(
        torch.from_numpy(coords), torch.from_numpy(valid), torch.from_numpy(gt),
        (0.2, 0.2, 0.2), num_class, ret_part_labels=True)
    labels = np.asarray(want['point_cls_labels'])
    np.testing.assert_array_equal(got['point_cls_labels'].numpy(), labels)
    part = np.asarray(want['point_part_labels'])
    np.testing.assert_allclose(got['point_part_labels'].numpy(), part,
                               rtol=0, atol=1e-6)
    fg = labels > 0
    # background points carry 0 (a padding point inside a box keeps its
    # part label under the ignore label -1, as in JAX)
    assert fg.sum() > 20 and not part[labels == 0].any()
    assert (part[fg] >= 0).all() and (part[fg] <= 1).all()
    preds = rng.randn(2, 800, 3).astype(np.float32) * 2

    def jax_loss(p):
        return jax_point_head.point_part_loss(p, part, labels, 1.5)

    want_loss, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(preds))
    p = torch.from_numpy(preds).requires_grad_(True)
    loss = point_head.point_part_loss(p, got['point_part_labels'],
                                      got['point_cls_labels'], 1.5)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(p.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


@pytest.mark.parametrize('geometry', ['down2/3', 'down4'])
def test_inverse_conv_input_gradient_over_the_down_rulebook(geometry):
    """df of an inverse convolution (coarse table -> fine table): the
    plain version of the K3 launch the port makes in training, over the
    paired strided convolution's forward rulebook with W[k]^T and the
    coarse table's mask; ``sparse_conv_apply``'s backward with that table
    (K3's path) and without (the scatter-add); JAX's vjp; all against
    autograd of the plain forward."""
    kernel, stride, padding = INVERSE[geometry]
    shape = (21, 24, 20)
    coords, num = _edge_table(7, shape)
    up = sparse.SparseTensor(torch.zeros(coords.shape[:2] + (1,)),
                             torch.from_numpy(coords), torch.from_numpy(num),
                             shape)
    d_coords, d_num, d_shape = sparse.build_strided_out_coords(
        up, kernel, stride, padding, 8 * coords.shape[1])
    down = sparse.SparseTensor(torch.zeros(d_coords.shape[:2] + (1,)),
                               d_coords, d_num, d_shape)
    rb_down = sparse.build_strided_rulebook(up, d_coords, d_shape, kernel,
                                            stride, padding)
    rb_inv = sparse.build_inverse_rulebook(down, up.coords, kernel, stride,
                                           padding)
    up_valid, down_valid = up.valid_mask, down.valid_mask
    rng = np.random.RandomState(2)
    f = torch.from_numpy(rng.randn(2, d_coords.shape[1], 12).astype(np.float32))
    f = f * down_valid[..., None]
    w = torch.from_numpy(rng.randn(27, 12, 8).astype(np.float32) * 0.2)
    g = torch.from_numpy(rng.randn(2, coords.shape[1], 8).astype(np.float32))

    a = f.clone().requires_grad_(True)
    (rulebook_conv_plain(a, rb_inv, w, up_valid) * g).sum().backward()
    want = a.grad * down_valid[..., None]
    assert float(want.abs().max()) > 0
    k3_path = rulebook_conv_plain(g * up_valid[..., None], rb_down,
                                  w.transpose(1, 2).contiguous(), down_valid)
    results = {'K3 over rb_down': k3_path}
    for name, rb_bwd in (('apply, rb_bwd', rb_down), ('apply, scatter-add', None)):
        a = f.clone().requires_grad_(True)
        (sparse.sparse_conv_apply(a, up_valid, rb_inv, w, rb_bwd=rb_bwd,
                                  in_valid=down_valid) * g).sum().backward()
        results[name] = a.grad * down_valid[..., None]
    _, vjp = jax.vjp(lambda x: jsparse._conv_apply_xla(
        x, jnp.asarray(up_valid.numpy()), jnp.asarray(rb_inv.numpy()),
        jnp.asarray(w.numpy())), jnp.asarray(f.numpy()))
    results['JAX vjp'] = torch.from_numpy(np.asarray(vjp(jnp.asarray(
        g.numpy()))[0])) * down_valid[..., None]
    top = float(want.abs().max())
    for name, got in results.items():
        err = float((got - want).abs().max())
        assert err <= 1e-5 * top, f'{name}: {err} against max {top}'


@pytest.fixture(scope='module')
def roi_head_case(jax_step):
    """The RoI head's training forward, loss and gradients in the JAX
    package on the input of the step's RoI head, the dense head's boxes
    replaced by proposals around the gt boxes: gradients of the head's
    parameters and of the boxes, point features and part offsets it
    reads. Each sample is moved so its first gt box sits at the origin
    (as test_torch_pvrcnn_train.py's case, for the clipping IoU)."""
    model, params, stats = (jax_step[k] for k in ('model', 'params', 'stats'))
    inp = {k: np.array(v) for k, v in jax_step['roi_in'].items()}
    shift = inp['gt_boxes'][:, 0, 0:3].copy()
    inp['point_coords'] -= shift[:, None, :]
    inp['gt_boxes'][..., 0:3] -= shift[:, None, :]
    boxes, logits = _proposals(inp['gt_boxes'], 400, np.random.RandomState(7),
                               near=15.0)
    inp.update(batch_box_preds=boxes, batch_cls_preds=logits)
    key = jax.random.PRNGKey(11)
    samples = []

    def run(m, b):
        out = m.roi_head(b, training=True)
        return m.roi_head.loss(out['roi_head_fwd']), out['roi_head_fwd']

    def loss_fn(p_roi, box_preds, feats, part):
        b = {**inp, 'batch_box_preds': box_preds, 'point_features': feats,
             'point_part_offset': part}
        ((loss, tb), fwd), _ = model.apply(
            {'params': {**params, 'roi_head': p_roi}, 'batch_stats': stats},
            b, method=run, mutable=['batch_stats'], rngs={'proposal': key})
        return loss, (tb, {**{k: v for k, v in fwd.items()
                              if k != 'reg_tracking_info'},
                           'test_sample': samples[0]})

    with _recording_jax_targets(), _recording_jax_samples(samples):
        (_, (tb, fwd)), grads = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2, 3), has_aux=True))(
                params['roi_head'], jnp.asarray(boxes),
                jnp.asarray(inp['point_features']),
                jnp.asarray(inp['point_part_offset']))
    return inp, jax.device_get((tb, fwd, grads))


def test_roi_head_training_matches_jax(jax_step, roi_head_case):
    inp, (tb, fwd, (g_params, g_boxes, g_feats, g_part)) = roi_head_case
    trainer = _trainer(jax_step['params'], jax_step['stats'])
    head = trainer.model.roi_head
    assert head.training
    batch = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    for key in ('batch_box_preds', 'point_features', 'point_part_offset'):
        batch[key].requires_grad_(True)
    samples = []
    with _recording_port_samples(samples):
        out = head(batch, _replay(fwd['test_draws']))
    loss, got_tb = head.loss(out['roi_head_fwd'])
    loss.backward()
    got = out['roi_head_fwd']

    np.testing.assert_array_equal(got['sampled_inds'].numpy(),
                                  fwd['test_sampled_inds'])
    _assert_same_samples(samples[0], fwd['test_sample'])
    assert int(samples[0][1].sum()) > 50  # the pools see points
    valid = fwd['reg_valid_mask']
    np.testing.assert_array_equal(got['reg_valid_mask'].numpy(), valid)
    assert valid.sum() > 4 and (valid == 0).sum() > 4
    # the IoUs: the port's equal the JAX package's ``boxes_iou3d`` run op by
    # op on the same pairs; the jitted step rounds its clipping IoU
    # otherwise, and for the near-identical pedestrian-sized pair (0, 1)
    # here (0.87 x 0.65 m) the two float32 programs part by 1.6e-3 (exact
    # BEV IoU 0.9157, both read ~0.90: ROADMAP.md section 3). So the IoUs
    # are held within 2e-3 and the roi_iou targets, twice them, within 4e-3
    ious = got['gt_iou_of_rois'].detach().numpy()
    eager = np.stack([np.diagonal(np.asarray(jax_iou3d.boxes_iou3d(
        jnp.asarray(fwd['rois'][s, :, :7]),
        jnp.asarray(fwd['gt_of_rois_src'][s, :, :7])))) for s in range(2)])
    live = fwd['gt_of_rois_src'][..., 3:6].any(-1) & (ious > 0)
    np.testing.assert_allclose(ious[live], eager[live], rtol=0, atol=1e-6)
    for key, tol in (('rois', 1e-5), ('gt_of_rois', 1e-5),
                     ('gt_of_rois_src', 1e-5), ('gt_iou_of_rois', 2e-3),
                     ('rcnn_cls_labels', 4e-3), ('rcnn_cls', 1e-4),
                     ('rcnn_reg', 1e-4)):
        np.testing.assert_allclose(got[key].detach().numpy(), fwd[key],
                                   rtol=0, atol=tol, err_msg=key)
    assert set(got_tb) == set(tb)
    for key, want in tb.items():
        assert float(want) > 0, key
        np.testing.assert_allclose(float(got_tb[key].detach()), float(want),
                                   rtol=1e-4, err_msg=key)

    named = {f'roi_head.{k}': p.grad for k, p in head.named_parameters()}
    got_grads, = state_dict_to_flax(named, {'roi_head': g_params})
    pairs = list(zip(_leaves(got_grads), _leaves({'roi_head': g_params})))
    for key, want in (('batch_box_preds', g_boxes), ('point_features', g_feats),
                      ('point_part_offset', g_part)):
        pairs.append(((key, batch[key].grad.numpy()), (key, want)))
    assert len(pairs) == len(named) + 3
    for (key, got_leaf), (_, want) in pairs:
        top = np.abs(want).max()
        assert top > 0, key
        np.testing.assert_allclose(got_leaf, want, rtol=0, atol=1e-3 * top,
                                   err_msg=key)


def test_one_step_matches_make_train_step_pieces(jax_step):
    host, params, stats = (jax_step[k] for k in ('host', 'params', 'stats'))
    tb, new_stats, fwd, grads = jax_step['step']
    trainer = _trainer(params, stats, total_steps=4)
    model = trainer.model
    assert model.training
    batch = train_step.device_batch(host, 'cpu')
    assert 'rb_inv4' in batch and 'rb_down4_bwd' in batch
    counters = (rulebook_conv, rulebook_conv_dw)
    before = [k.launches for k in counters]
    samples = []
    with _recording_port_samples(samples):
        out = model(batch, _replay(fwd['test_draws']))
    loss, got_tb = model.loss(out)
    loss.backward()
    # CPU tensors: every wrapper took its plain version
    assert [k.launches for k in counters] == before

    # the discrete steps first: anchor and point labels, sampled RoIs and
    # the points each RoI pools
    np.testing.assert_array_equal(
        out['anchor_head_fwd']['box_cls_labels'].numpy(), fwd['box_cls_labels'])
    labels = out['point_head_fwd']['point_cls_labels'].numpy()
    np.testing.assert_array_equal(labels, fwd['point_cls_labels'])
    assert (labels > 0).sum() > 4 and (labels == -1).sum() > 0
    np.testing.assert_allclose(
        out['point_head_fwd']['point_part_labels'].numpy(),
        fwd['point_part_labels'], rtol=0, atol=1e-5)
    got = out['roi_head_fwd']
    np.testing.assert_array_equal(got['sampled_inds'].numpy(),
                                  fwd['test_sampled_inds'])
    _assert_same_samples(samples[0], fwd['test_sample'])
    np.testing.assert_array_equal(got['reg_valid_mask'].numpy(),
                                  fwd['reg_valid_mask'])
    for key in ('rois', 'gt_iou_of_rois', 'rcnn_cls_labels', 'gt_of_rois',
                'gt_of_rois_src', 'rcnn_cls', 'rcnn_reg'):
        np.testing.assert_allclose(got[key].detach().numpy(), fwd[key],
                                   rtol=0, atol=1e-4, err_msg=key)

    assert set(got_tb) == set(tb) == {
        'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir', 'rpn_loss',
        'point_loss_cls', 'point_loss_part', 'point_pos_num', 'rcnn_loss_cls',
        'rcnn_loss_reg', 'rcnn_loss_corner', 'rcnn_loss', 'loss'}
    assert float(tb['point_loss_part']) > 0 and float(tb['rcnn_loss_cls']) > 0
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
        if key.startswith('backbone_2d/'):
            assert np.linalg.norm(diff) <= 5e-3 * np.linalg.norm(want), key
        tol = 1e-2 if key.startswith('backbone_2d/') else 2e-3
        np.testing.assert_allclose(got_leaf, want, rtol=0, atol=tol * top,
                                   err_msg=key)
        err2 += float((diff ** 2).sum())
        norm2 += float((want ** 2).sum())
    assert n_leaves == len(named)
    assert (err2 / norm2) ** 0.5 < 1e-3  # the whole gradient


def _float64_statistics(self, x, mask):
    """MaskedBatchNorm's batch statistics of a float64 x kept in float64
    (the port computes them in float32, as the JAX package does)."""
    assert x.dtype == torch.float64 and mask is None
    dims = [d for d in range(x.dim()) if d != self.axis % x.dim()]
    cnt = float(x.numel() // x.shape[self.axis])
    mean = x.sum(dims) / cnt
    return mean, ((x * x).sum(dims) / cnt - mean * mean).clamp(min=0.0)


def test_bev_backbone_gradient_in_float64_matches_jax():
    """The 2D backbone of the step test alone, in training mode, on a BEV
    map as sparse as the step's (4.5% of cells live, ReLU'd features) and
    one random cotangent, with everything in float64, the BatchNorm
    statistics included (both packages compute those in float32 by
    design, so each is switched to float64 here for the test only): every
    gradient leaf agrees with JAX's within 1e-6 in relative L2 norm. So the
    step test's wider bound on the 2D backbone's leaves is the float32
    statistics' rounding (``s2 / cnt - mean^2`` over a mostly empty map
    cancels), not a formula of the port."""
    from lidardetection_tpu.models import layers as jax_layers
    from lidardetection_tpu.models.backbones_2d.bev_backbone import (
        BaseBEVBackbone as JaxBaseBEVBackbone,
    )
    from lidardetection_tpu_torch.models import layers
    from lidardetection_tpu_torch.models.backbones_2d.bev_backbone import (
        BaseBEVBackbone,
    )

    cfg = _reduce(cfg_from_yaml_file(CFG)).MODEL.BACKBONE_2D
    rng = np.random.RandomState(0)
    b, h, w, c = 2, 50, 44, 256  # the step test's BEV map
    live = rng.rand(b, h, w) < 0.045
    x = np.abs(rng.randn(b, h, w, c)) * live[..., None] \
        * (rng.rand(b, h, w, c) < 0.6)
    f64_jnp = type(jnp)('jnp_float64_statistics')
    f64_jnp.__dict__.update(jnp.__dict__)
    f64_jnp.float32 = jnp.float64
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, 'jnp', f64_jnp)
        mp.setattr(layers.MaskedBatchNorm, '_batch_statistics',
                   _float64_statistics)
        jax_bb = JaxBaseBEVBackbone(model_cfg=dict(cfg), input_channels=c)
        variables = jax.device_get(jax_bb.init(
            jax.random.PRNGKey(0), {'spatial_features': jnp.asarray(x)},
            training=False))
        ct = rng.randn(b, h, w, jax_bb.num_bev_features)

        def loss(params):
            out, _ = jax_bb.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                {'spatial_features': jnp.asarray(x)}, training=True,
                mutable=['batch_stats'])
            return (out['spatial_features_2d'] * ct).sum()

        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        variables['params'])
        want = jax.device_get(jax.jit(jax.grad(loss))(params))
        bb = BaseBEVBackbone(cfg, c).double().train()
        bb.load_state_dict({k: v.double() for k, v in flax_to_state_dict(
            params, variables['batch_stats']).items()})
        out = bb({'spatial_features': torch.from_numpy(x)})
        (out['spatial_features_2d'] * torch.from_numpy(ct)).sum().backward()
    named = {k: p.grad for k, p in bb.named_parameters()}
    got, = state_dict_to_flax(named, want)
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(named)
    for (key, got_leaf), (_, ref) in pairs:
        assert got_leaf.dtype == ref.dtype == np.float64, key
        assert np.linalg.norm(got_leaf - ref) <= 1e-6 * np.linalg.norm(ref), key


def test_two_steps_with_dropout_run_and_move_parameters(jax_step):
    trainer = _trainer(jax_step['params'], jax_step['stats'], dp_ratio=0.3,
                       total_steps=4)
    batch = train_step.device_batch(jax_step['host'], 'cpu')
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for i in range(2):
        tb = trainer.step(batch)
        assert all(np.isfinite(float(v)) for v in tb.values())
        assert float(tb['point_loss_part']) > 0 and trainer.state.step == i + 1
    after = trainer.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.isfinite(v).all() for v in after.values())


def test_make_batch_carries_the_training_plan():
    """Trainer.make_batch builds UNetV2's training tables: the inverse
    convolutions' and every strided layer's transposed one."""
    from lidardetection_tpu_torch.datasets.synthetic import SyntheticScenes

    trainer = Trainer(_reduce(cfg_from_yaml_file(CFG)), device='cpu')
    data = SyntheticScenes(trainer.class_names,
                            trainer.info['point_cloud_range'], num_scenes=2,
                            seed=1, max_gt_boxes=trainer.max_gt_boxes)
    batch = trainer.make_batch([data[0], data[1]])
    assert set(trainer.plan.batch_keys()) <= set(batch)
    for name in ('inv4', 'inv3', 'inv2', 'down2_bwd', 'out_bwd'):
        assert f'rb_{name}' in batch, name
    assert 'points' not in batch  # Part-A² reads no raw points
