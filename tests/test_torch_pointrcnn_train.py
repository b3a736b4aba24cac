"""The PointRCNN training slice, port against the JAX package, on the CPU in
f32.

At tests/test_pointrcnn_e2e.py's reduced size (1024 sampled points, SA
NPOINTS [256, 64, 16, 8], proposal NMS 512 -> 64 in training,
ROI_PER_IMAGE 32, 64 pooled points a RoI), B = 2, in float32, on the JAX
package's own training batch (``build_dataloader(training=True)``, no
augmentor, numpy's global generator seeded for its sample and shuffle)
with converted random weights, both packages' ``_pairwise_d2`` replaced by
the exact formula as in test_torch_pointrcnn.py (whose module docstring
says why), and the JAX package's BatchNorm batch statistics summed as a
pairwise tree (`tree_summed_statistics`): XLA:CPU sums them in float32
in sequence, and over the 32768 rows of a RoI set abstraction
``s2 / cnt - mean^2`` then loses a narrow channel's variance altogether,
where the port's (PyTorch's cascaded sums) stays within 2% of float64
(`test_jax_float32_batch_statistics_part_from_float64`):

  * the point-box targets (PointResidualCoder against the point, the
    class's mean size) and ``point_box_loss`` with its gradient;
  * ``assign_roi_targets`` with pointrcnn.yaml's TARGET_CONFIG
    (``CLS_SCORE_TYPE: cls``: 1 over 0.6 IoU, ignored (-1) between 0.45
    and 0.6, 0 under) given the JAX draws, and the RCNN losses;
  * the RoI head's training step on the input of the step's RoI head with
    proposals around the gt boxes: sampling, targets, pooled points, both
    losses, and every gradient within 2e-3 of its largest value, of its
    parameters and of the point head's boxes (the RCNN losses reach them
    through the RoIs, as in the JAX package);
  * one whole step against the pieces of ``make_train_step``: the RoI
    sampling handed JAX's own draws (a wrapper of
    ``roi_head_utils.assign_roi_targets`` installed for the JAX forward),
    the point labels and the sampled RoIs equal, every loss term within
    1e-4 relative, BatchNorm statistics moved once. At random weights the
    whole step's gradient is ill-conditioned: moving the input points by
    one float32 ulp (x, y, z or the intensity, each in turn) moves the
    port's own gradient by 2% to 10% in relative L2 norm and most leaves
    by more than 2e-3 (`test_step_gradient_moves_with_one_ulp_of_input`),
    so no float32 program can be held to 2e-3 there. Each leaf is held
    within 3 times its own largest one-ulp move (2e-3 at least), in
    relative L2 norm, and the whole gradient within the largest;
  * ``Trainer.make_batch``'s point batch (mask, sample, shuffle, pad) equal
    to the JAX processor chain's under the same seed, two steps that move
    every parameter, and a step of the pointrcnn_iou variant.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.core.box_coders import (
    PointResidualCoder as JaxPointCoder, ResidualCoder as JaxResidualCoder,
)
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.datasets.processor.data_processor import (
    DataProcessor as JaxDataProcessor,
)
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.models import layers as jax_layers
from lidardetection_tpu.models.dense_heads import point_head as jax_point_head
from lidardetection_tpu.models.roi_heads import roi_head_utils as jax_roi
from lidardetection_tpu.parallel.train_step import device_batch
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.core.box_coders import (
    PointResidualCoder, ResidualCoder,
)
from lidardetection_tpu_torch.datasets.synthetic import SyntheticScenes
from lidardetection_tpu_torch.models import layers
from lidardetection_tpu_torch.models.dense_heads import point_head
from lidardetection_tpu_torch.models.roi_heads import roi_head_utils
from lidardetection_tpu_torch.ops.select_cuda import ball_select
from lidardetection_tpu_torch.parallel import train_step
from lidardetection_tpu_torch.train import Trainer
from test_torch_pointrcnn import (  # noqa: F401 (exact_d2: a fixture)
    MEAN_SIZE, _reduce, exact_d2, seeded_numpy,
)
from test_torch_pvrcnn import _random_variables
from test_torch_pvrcnn_train import (
    _jax_draws, _jax_sampled_inds, _proposals, _random_boxes,
    _recording_jax_targets, _replay,
)
from test_torch_train_step import _leaves
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CFG = 'tools/cfgs/kitti_models/pointrcnn.yaml'
KEYS = ('points', 'num_points', 'gt_boxes')
# what the RoI head reads of the batch
ROI_HEAD_KEYS = ('batch_box_preds', 'batch_cls_preds', 'batch_valid_preds',
                 'gt_boxes', 'point_coords', 'point_features',
                 'point_cls_scores', 'num_points')


def _tree_sum(x, axis=None):
    """``jnp.sum`` as a pairwise tree over the summed axes, float32 all the
    way."""
    axis = tuple(range(x.ndim)) if axis is None else \
        (axis,) if isinstance(axis, int) else tuple(axis)
    keep = [d for d in range(x.ndim) if d not in axis]
    x = jnp.transpose(x, list(axis) + keep).reshape(
        (-1,) + tuple(x.shape[d] for d in keep))
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = jnp.concatenate([x, jnp.zeros_like(x[:1])])
        x = x[0::2] + x[1::2]
    return x[0]


@contextlib.contextmanager
def _tree_summed_jax_statistics():
    tree_jnp = types.ModuleType('jnp_tree_sum')
    tree_jnp.__dict__.update(jnp.__dict__)
    tree_jnp.sum = _tree_sum
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, 'jnp', tree_jnp)
        yield


@pytest.fixture(scope='module')
def tree_summed_statistics():
    """The JAX package's BatchNorm statistics summed as a pairwise tree,
    for the rest of the module (the module docstring says why)."""
    with _tree_summed_jax_statistics():
        yield


@pytest.fixture(scope='module')
def jax_step(exact_d2, tree_summed_statistics):
    """One training step's pieces in the JAX package, and what its RoI
    sampling drew."""
    cfg = _reduce(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=True,
                                       num_scenes=2, seed=3)
    with seeded_numpy(3):
        batch = device_batch(next(iter(loader)))
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    params, stats = _random_variables(model, batch, seed=0)
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
        point_fwd = out['point_head_fwd']
        return loss, (tb, mutated['batch_stats'], {
            'point_cls_labels': point_fwd['point_cls_labels'],
            'point_box_labels': point_fwd['point_box_labels'],
            **out['roi_head_fwd']},
            {k: roi_in[k] for k in ROI_HEAD_KEYS})

    with _recording_jax_targets():
        (_, (tb, new_stats, fwd, roi_in)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    host = {k: np.asarray(batch[k]) for k in KEYS}
    return {'host': host, 'params': params, 'stats': stats, 'model': model,
            'cfg': cfg, 'roi_in': jax.device_get(roi_in),
            'step': jax.device_get((tb, new_stats, fwd, grads))}


def _trainer(params, stats, **kwargs):
    return Trainer(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                   state_dict=flax_to_state_dict(params, stats), **kwargs)


def _held_leaves(got_tree, want_tree, tol=2e-3, zero_ok=()):
    """Every leaf within `tol` of its largest magnitude; a leaf whose JAX
    gradient is 0 (under a prefix in `zero_ok`) must be 0 here too.
    Returns the leaf count."""
    n = 0
    for (key, got_leaf), (_, want) in zip(_leaves(got_tree),
                                          _leaves(want_tree)):
        assert got_leaf.shape == want.shape, key
        n += 1
        top = np.abs(want).max()
        if top == 0:
            assert key.startswith(zero_ok), key
            assert not got_leaf.any(), key
            continue
        np.testing.assert_allclose(got_leaf, want, rtol=0, atol=tol * top,
                                   err_msg=key)
    return n


# ---- the parts ----

def test_point_box_targets_and_loss_match_jax():
    """Labels, the encoded boxes of the foreground points (0 elsewhere,
    padding points ignored), and the smooth-L1 box loss with its
    gradient."""
    rng = np.random.RandomState(3)
    gt = np.zeros((2, 10, 8), np.float32)
    for s in range(2):
        gt[s, :7 - 2 * s, :7] = _random_boxes(rng, 7 - 2 * s, spread=5.0)
        gt[s, :7 - 2 * s, 7] = rng.randint(1, 4, 7 - 2 * s)
    coords = rng.uniform(-6, 6, (2, 800, 3)).astype(np.float32)
    coords[..., 2] = rng.uniform(-3, 1, (2, 800))
    coords[:, :300] = gt[:, rng.randint(5, size=300), 0:3] \
        + rng.randn(2, 300, 3).astype(np.float32) * 0.8
    valid = np.arange(800)[None] < np.array([[800], [650]])
    kw = {'use_mean_size': True, 'mean_size': MEAN_SIZE}
    want = jax_point_head.assign_point_targets(
        jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(gt),
        box_coder=JaxPointCoder(**kw), extra_width=(0.2, 0.2, 0.2),
        ret_box_labels=True, set_ignore_flag=True, num_class=3)
    got = point_head.assign_point_targets(
        torch.from_numpy(coords), torch.from_numpy(valid), torch.from_numpy(gt),
        (0.2, 0.2, 0.2), 3, box_coder=PointResidualCoder(**kw),
        ret_box_labels=True)
    labels = np.asarray(want['point_cls_labels'])
    np.testing.assert_array_equal(got['point_cls_labels'].numpy(), labels)
    for value in (-1, 0, 1, 2, 3):
        assert (labels == value).sum() > 3, value
    box_labels = np.asarray(want['point_box_labels'])
    np.testing.assert_allclose(got['point_box_labels'].numpy(), box_labels,
                               rtol=0, atol=1e-5)
    assert not box_labels[labels == 0].any() and box_labels[labels > 0].any()
    preds = rng.randn(2, 800, 8).astype(np.float32)
    weights = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5]

    def jax_loss(p):
        return jax_point_head.point_box_loss(p, box_labels, labels,
                                             code_weights=weights, weight=1.3)

    want_loss, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(preds))
    p = torch.from_numpy(preds).requires_grad_(True)
    loss = point_head.point_box_loss(p, got['point_box_labels'],
                                     got['point_cls_labels'],
                                     code_weights=weights, weight=1.3)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


def _pointrcnn_sampler():
    """pointrcnn.yaml's TARGET_CONFIG at 32 RoIs a sample."""
    cfg = cfg_from_yaml_file(CFG).MODEL.ROI_HEAD.TARGET_CONFIG
    return {**cfg, 'ROI_PER_IMAGE': 32}


def test_assign_roi_targets_with_cls_scores_matches_jax():
    """CLS_SCORE_TYPE ``cls``: the sampled RoIs, their hard labels with the
    ignore band, the canonical targets, the RCNN losses (the class loss
    skips the ignored RoIs) and their gradients of the outputs and the
    proposals."""
    rng = np.random.RandomState(17)
    cfg = _pointrcnn_sampler()
    assert cfg['CLS_SCORE_TYPE'] == 'cls'
    gt = np.zeros((2, 8, 8), np.float32)
    for s in range(2):
        gt[s, :6, :7] = _random_boxes(rng, 6, spread=15.0)
        gt[s, :6, 3:6] = rng.uniform(1.5, 4.5, (6, 3))
        gt[s, :6, 7] = rng.randint(1, 4, 6)
    boxes, logits = _proposals(gt, 64, rng)
    labels = np.asarray(logits.argmax(-1) + 1, np.int32)
    labels[:, :32] = gt[:, np.arange(32) % 6, 7]
    valid = rng.rand(2, 64) > 0.1
    batch = {'rois': boxes * valid[..., None],
             'roi_scores': logits.max(-1) * valid,
             'roi_labels': labels * valid, 'roi_valid': valid, 'gt_boxes': gt}
    key = jax.random.PRNGKey(9)
    rcnn_cls = rng.randn(2 * 32, 1).astype(np.float32)
    rcnn_reg = (rng.randn(2 * 32, 7) * 0.2).astype(np.float32)
    loss_cfg = cfg_from_yaml_file(CFG).MODEL.ROI_HEAD.LOSS_CONFIG

    def jax_losses(rois, cls, reg):
        t = jax_roi.assign_roi_targets(key, {**batch, 'rois': rois}, cfg)
        fwd = {**t, 'rcnn_cls': cls, 'rcnn_reg': reg}
        box, tb_box = jax_roi.roi_box_loss(fwd, JaxResidualCoder(), loss_cfg)
        cls_loss, tb_cls = jax_roi.roi_cls_loss(fwd, loss_cfg)
        return box + cls_loss, (t, {**tb_box, **tb_cls})

    (_, (want_t, want_tb)), want_g = jax.jit(jax.value_and_grad(
        jax_losses, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(batch['rois']), jnp.asarray(rcnn_cls),
            jnp.asarray(rcnn_reg))
    want_inds = np.asarray(_jax_sampled_inds(key, batch, cfg))
    args = [torch.from_numpy(x).requires_grad_(True)
            for x in (batch['rois'], rcnn_cls, rcnn_reg)]
    t_in = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    t_in['rois'] = args[0]
    draws = jax.device_get(_jax_draws(key, 64, 32, 2))
    t = roi_head_utils.assign_roi_targets(
        {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}, t_in, cfg)
    np.testing.assert_array_equal(t['sampled_inds'].numpy(), want_inds)
    cls_labels = np.asarray(want_t['rcnn_cls_labels'])
    np.testing.assert_array_equal(t['rcnn_cls_labels'].detach().numpy(),
                                  cls_labels)
    np.testing.assert_array_equal(t['reg_valid_mask'].numpy(),
                                  np.asarray(want_t['reg_valid_mask']))
    ious = np.asarray(want_t['gt_iou_of_rois'])
    band = (ious > 0.45) & (ious < 0.6)
    assert band.sum() > 2 and (cls_labels[band] == -1).all()
    assert (cls_labels == 1).sum() > 2 and (cls_labels == 0).sum() > 2
    # the IoUs within 4e-4: the clipping IoU's shoelace sums of float32
    # coordinates out to 15 m round apart (ROADMAP.md section 3)
    for key_, tol in (('rois', 1e-5), ('gt_of_rois', 1e-5),
                      ('gt_of_rois_src', 1e-5), ('gt_iou_of_rois', 4e-4)):
        np.testing.assert_allclose(t[key_].detach().numpy(),
                                   np.asarray(want_t[key_]), rtol=0, atol=tol,
                                   err_msg=key_)
    fwd = {**t, 'rcnn_cls': args[1], 'rcnn_reg': args[2]}
    box, tb_box = roi_head_utils.roi_box_loss(fwd, ResidualCoder(), loss_cfg)
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
    # an ignored RoI's class logit gets no gradient
    flat = cls_labels.reshape(-1)
    assert not args[1].grad.numpy()[flat < 0].any()


def test_jax_float32_batch_statistics_part_from_float64():
    """Batch variances over 32768 rows, each channel's spread 0.1% to 25%
    of its mean (as a RoI set abstraction's after its ReLUs), against
    float64: the JAX package's MaskedBatchNorm under jit loses some
    channels' variance altogether (``s2 / cnt - mean^2`` of sequential
    float32 sums), the port's stays within 5%, and so does JAX's with the
    sums as a pairwise tree, which the step tests install."""
    rng = np.random.RandomState(0)
    c = 64
    x = (rng.uniform(2, 20, c) + rng.randn(64, 32, 16, c)
         * rng.uniform(0.02, 0.5, c)).astype(np.float32)
    want = x.astype(np.float64).reshape(-1, c).var(0)

    def jax_var():
        module = jax_layers.MaskedBatchNorm(momentum=0.0, epsilon=1e-5)
        variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
        _, state = jax.jit(lambda v, a: module.apply(
            v, a, mutable=['batch_stats']))(variables, jnp.asarray(x))
        return np.asarray(state['batch_stats']['var'], np.float64)

    bn = layers.MaskedBatchNorm(c, axis=-1, eps=1e-5, momentum=0.0).train()
    bn(torch.from_numpy(x))
    port_err = np.abs(bn.var.double().numpy() / want - 1).max()
    jax_err = np.abs(jax_var() / want - 1).max()
    with _tree_summed_jax_statistics():
        tree_err = np.abs(jax_var() / want - 1).max()
    assert port_err < 0.05 and tree_err < 0.05
    assert jax_err > 0.5


# ---- the RoI head and the whole step ----

@pytest.fixture(scope='module')
def roi_head_case(jax_step):
    """The RoI head's training forward, loss and gradients in the JAX
    package on the input of the step's RoI head, with the point head's
    boxes replaced by proposals around the gt boxes: gradients of the
    head's parameters and of the boxes. Each sample is moved so that its
    first gt box sits at the origin, and the proposals keep within 15 m of
    it, as test_torch_pvrcnn_train.py's case does (the clipping IoU far
    out, ROADMAP.md section 3)."""
    model, params, stats = (jax_step[k] for k in ('model', 'params', 'stats'))
    inp = {k: np.array(v) for k, v in jax_step['roi_in'].items()}
    shift = inp['gt_boxes'][:, 0, 0:3].copy()
    inp['point_coords'] -= shift[:, None, :]
    inp['gt_boxes'][..., 0:3] -= shift[:, None, :]
    boxes, logits = _proposals(inp['gt_boxes'], 600, np.random.RandomState(7),
                               near=15.0)
    inp.update(batch_box_preds=boxes, batch_cls_preds=logits,
               batch_valid_preds=np.ones(boxes.shape[:2], bool))
    key = jax.random.PRNGKey(11)

    def run(m, b):
        out = m.roi_head(b, training=True)
        return m.roi_head.loss(out['roi_head_fwd']), out['roi_head_fwd']

    def loss_fn(p_roi, box_preds):
        ((loss, tb), fwd), _ = model.apply(
            {'params': {**params, 'roi_head': p_roi}, 'batch_stats': stats},
            {**inp, 'batch_box_preds': box_preds}, method=run,
            mutable=['batch_stats'], rngs={'proposal': key})
        return loss, (tb, fwd)

    with _recording_jax_targets():
        (_, (tb, fwd)), grads = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(
                params['roi_head'], jnp.asarray(boxes))
    return inp, jax.device_get((tb, fwd, grads))


def test_roi_head_training_matches_jax(jax_step, roi_head_case):
    """Sampling, targets, both losses and every gradient of the RoI head's
    training step, the gradient into the point head's boxes included."""
    inp, (tb, fwd, (g_params, g_boxes)) = roi_head_case
    trainer = _trainer(jax_step['params'], jax_step['stats'])
    head = trainer.model.roi_head
    assert head.training
    batch = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    batch['batch_box_preds'].requires_grad_(True)
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
    np.testing.assert_array_equal(got['rcnn_cls_labels'].detach().numpy(),
                                  labels)
    for value in (-1, 0, 1):
        assert (labels == value).sum() > 0, value
    for key, tol in (('rois', 1e-5), ('gt_of_rois', 1e-5),
                     ('gt_of_rois_src', 1e-5), ('gt_iou_of_rois', 2e-4),
                     ('rcnn_cls', 1e-4), ('rcnn_reg', 1e-4)):
        np.testing.assert_allclose(got[key].detach().numpy(), fwd[key],
                                   rtol=0, atol=tol, err_msg=key)
    assert set(got_tb) == set(tb)
    for key, want in tb.items():
        assert float(want) > 0, key
        np.testing.assert_allclose(float(got_tb[key].detach()), float(want),
                                   rtol=1e-4, err_msg=key)
    named = {f'roi_head.{k}': p.grad for k, p in head.named_parameters()}
    got_grads, = state_dict_to_flax(named, {'roi_head': g_params})
    n = _held_leaves(got_grads, {'roi_head': g_params})
    assert n == len(named)
    n += _held_leaves({'boxes': batch['batch_box_preds'].grad.numpy()},
                      {'boxes': g_boxes})
    assert np.abs(g_boxes).max() > 0


def _step_gradients(model, grads):
    """{flax path: gradient} of the port's parameters after a backward."""
    named = dict(model.named_parameters())
    assert all(p.grad is not None for p in named.values())
    got, = state_dict_to_flax({k: p.grad for k, p in named.items()}, grads)
    return dict(_leaves(got))


ROI_FLOATS = ('rois', 'gt_iou_of_rois', 'gt_of_rois', 'gt_of_rois_src',
              'rcnn_cls', 'rcnn_reg')


def _port_step(jax_step, host):
    """The port's step on `host` with JAX's draws: its gradient by flax
    path and its RoI head's float outputs."""
    fwd, grads = jax_step['step'][2], jax_step['step'][3]
    model = _trainer(jax_step['params'], jax_step['stats']).model
    out = model(train_step.device_batch(host, 'cpu'),
                _replay(fwd['test_draws']))
    model.loss(out)[0].backward()
    roi = out['roi_head_fwd']
    return _step_gradients(model, grads), {k: roi[k].detach().numpy()
                                           for k in ROI_FLOATS}


@pytest.fixture(scope='module')
def nudged_steps(jax_step):
    """The port's step with the input points moved by one float32 ulp, one
    column (x, y, z, intensity) at a time."""
    out = []
    for col in range(4):
        host = {k: v.copy() for k, v in jax_step['host'].items()}
        host['points'][..., col] = np.nextafter(
            host['points'][..., col], np.float32(np.inf))
        out.append(_port_step(jax_step, host))
    return out


def test_step_gradient_moves_with_one_ulp_of_input(jax_step, nudged_steps):
    """The port's own step gradient, with the points one ulp away, moves
    by more than 2e-3 of most leaves' norms and by per cents of the whole
    gradient's: the step is ill-conditioned at random weights (BatchNorm
    over near-constant channels, ReLU and max-pool kinks under sums that
    cancel), which bounds how closely any float32 program can follow
    another."""
    base, _ = _port_step(jax_step, jax_step['host'])
    leaves = [(k, w) for k, w in _leaves(jax_step['step'][3])
              if np.linalg.norm(w) > 0]
    moved = sum(max(np.linalg.norm(base[k] - g[k]) for g, _ in nudged_steps)
                > 2e-3 * np.linalg.norm(w) for k, w in leaves)
    assert moved > len(leaves) // 2
    total = np.sqrt(sum(float((w ** 2).sum()) for _, w in leaves))
    whole = [np.sqrt(sum(float(((base[k] - g[k]) ** 2).sum())
                         for k, _ in leaves)) / total
             for g, _ in nudged_steps]
    assert max(whole) > 0.01


def test_one_step_matches_make_train_step_pieces(jax_step, nudged_steps):
    host, params, stats = (jax_step[k] for k in ('host', 'params', 'stats'))
    tb, new_stats, fwd, grads = jax_step['step']
    trainer = _trainer(params, stats, total_steps=4)
    model = trainer.model
    assert model.training and model.module_order == (
        'backbone_3d', 'point_head', 'roi_head')
    batch = train_step.device_batch(host, 'cpu')
    before = ball_select.launches
    out = model(batch, _replay(fwd['test_draws']))
    loss, got_tb = model.loss(out)
    loss.backward()
    assert ball_select.launches == before  # CPU tensors: exact paths

    point_fwd = out['point_head_fwd']
    labels = point_fwd['point_cls_labels'].numpy()
    np.testing.assert_array_equal(labels, fwd['point_cls_labels'])
    assert (labels > 0).sum() > 4 and (labels == -1).sum() > 0
    np.testing.assert_allclose(point_fwd['point_box_labels'].numpy(),
                               fwd['point_box_labels'], rtol=0, atol=1e-5)
    got = out['roi_head_fwd']
    np.testing.assert_array_equal(got['sampled_inds'].numpy(),
                                  fwd['test_sampled_inds'])
    np.testing.assert_array_equal(got['reg_valid_mask'].numpy(),
                                  fwd['reg_valid_mask'])
    np.testing.assert_array_equal(got['rcnn_cls_labels'].detach().numpy(),
                                  fwd['rcnn_cls_labels'])
    for key in ROI_FLOATS:  # within 1e-4, or 3 times the one-ulp moves
        value = got[key].detach().numpy()
        move = max(np.abs(value - f[key]).max() for _, f in nudged_steps)
        np.testing.assert_allclose(value, fwd[key], rtol=0,
                                   atol=max(1e-4, 3 * move), err_msg=key)
    assert set(got_tb) == set(tb) == {
        'point_loss_cls', 'point_loss_box', 'point_pos_num', 'rcnn_loss_cls',
        'rcnn_loss_reg', 'rcnn_loss_corner', 'rcnn_loss', 'loss'}
    assert float(tb['point_loss_box']) > 0 and float(tb['rcnn_loss_cls']) > 0
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

    got_grads = _step_gradients(model, grads)
    nudged = [g for g, _ in nudged_steps]
    total, err2, worst2 = 0.0, 0.0, 0.0
    for key, want in _leaves(grads):
        got = got_grads[key]
        norm = np.linalg.norm(want)
        if norm == 0:  # 0 in both: the box branch with no RoI regressed,
            # and the deeper levels' xyz_proj, whose groups at this size
            # hold their centre alone (relative coordinates 0)
            assert not got.any(), key
            continue
        moves = [np.linalg.norm(got - g[key]) / norm for g in nudged]
        assert np.linalg.norm(got - want) / norm <= max(2e-3, 3 * max(moves)), key
        total += norm ** 2
        err2 += float(((got - want) ** 2).sum())
    worst2 = max(sum(float(((got_grads[k] - g[k]) ** 2).sum())
                     for k, _ in _leaves(grads)) for g in nudged)
    assert err2 <= worst2  # the whole gradient


# ---- the batch and the steps ----

def test_make_batch_samples_and_shuffles_as_the_jax_processor():
    """Trainer.make_batch on two scenes: the range mask, the train split's
    sample and shuffle drawn from the trainer's RandomState(seed), equal
    to the JAX processor chain under np.random.seed(seed), then padded."""
    cfg = _reduce(cfg_from_yaml_file(CFG))
    trainer = Trainer(cfg, device='cpu', seed=5)
    dataset = SyntheticScenes(trainer.class_names,
                               trainer.info['point_cloud_range'], num_scenes=2)
    scenes = [dataset[0], dataset[1]]
    got = trainer.make_batch(scenes)
    assert set(got) == {'points', 'num_points', 'gt_boxes'}
    proc = JaxDataProcessor(cfg.DATA_CONFIG.DATA_PROCESSOR,
                            trainer.info['point_cloud_range'], training=True,
                            max_points=1024)
    with seeded_numpy(5):
        want = [proc.forward({'points': p.copy()}) for p, _ in scenes]
    for s, w in enumerate(want):
        np.testing.assert_array_equal(got['points'][s].numpy(), w['points'])
        assert int(got['num_points'][s]) == w['num_points'] == 1024
    np.testing.assert_array_equal(got['gt_boxes'].numpy(),
                                  np.stack([gt for _, gt in scenes]))
    # shuffled: not the sample in the order of the cloud
    order = [np.nonzero((scenes[0][0] == row).all(1))[0][0]
             for row in got['points'][0, :50].numpy()]
    assert not (np.diff(order) > 0).all()


def test_two_steps_run_and_move_parameters(jax_step):
    trainer = _trainer(jax_step['params'], jax_step['stats'], total_steps=4)
    batch = train_step.device_batch(jax_step['host'], 'cpu')
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for i in range(2):
        tb = trainer.step(batch)
        assert all(np.isfinite(float(v)) for v in tb.values())
        assert float(tb['point_loss_box']) > 0 and trainer.state.step == i + 1
    after = trainer.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.isfinite(v).all() for v in after.values())


def test_pointrcnn_iou_variant_takes_a_step():
    """pointrcnn_iou.yaml (PointRCNN with ``CLS_SCORE_TYPE: roi_iou``) at
    the reduced size: its RoI head's soft class targets in [0, 1] on
    proposals around the gt boxes, then a whole training step."""
    cfg = _reduce(cfg_from_yaml_file('tools/cfgs/kitti_models/pointrcnn_iou.yaml'))
    assert cfg.MODEL.ROI_HEAD.TARGET_CONFIG.CLS_SCORE_TYPE == 'roi_iou'
    trainer = Trainer(cfg, device='cpu', total_steps=2)
    dataset = SyntheticScenes(trainer.class_names,
                               trainer.info['point_cloud_range'], num_scenes=2)
    batch = trainer.make_batch([dataset[0], dataset[1]])
    model = trainer.model
    head = model.roi_head
    out = model.point_head(model.backbone_3d(
        {**batch, 'point_valid': torch.arange(1024) < batch['num_points'][:, None]}))
    boxes, logits = _proposals(batch['gt_boxes'].numpy(), 600,
                               np.random.RandomState(2))
    out.update(batch_box_preds=torch.from_numpy(boxes),
               batch_cls_preds=torch.from_numpy(logits),
               batch_valid_preds=torch.ones(boxes.shape[:2], dtype=torch.bool))
    fwd = head(out, train_step.step_draw(0, 0, 'cpu'))['roi_head_fwd']
    labels = fwd['rcnn_cls_labels']
    assert ((labels > 0) & (labels < 1)).any() and (labels >= 0).all()
    loss, tb = head.loss(fwd)
    assert torch.isfinite(loss) and float(tb['rcnn_loss_reg']) > 0
    tb = trainer.step(batch)
    assert all(np.isfinite(float(v)) for v in tb.values())
