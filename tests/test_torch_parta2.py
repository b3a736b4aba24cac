"""The Part-A² serving slice, port against the JAX package, on the CPU.

At tests/test_parta2_e2e.py's reduced size (0.2 m voxels, 1200-voxel cap,
POOL_SIZE 6, RoI NMS 256 -> 32 in eval, final NMS 64 -> 16) in float32,
B = 2, on the JAX package's own eval batch (``build_dataloader`` with the
model's host plan, so the batch carries the ``rb_*`` tables) with
converted random weights. Integer results (rulebooks, point samples, RoI
counts and labels, kept masks) must be equal; float results agree within
1e-4 (the same float32 math in another summation order), the voxel
centres within 1e-5 m (XLA:CPU fuses their multiply-add under jit).

Each module is held against its JAX counterpart on the JAX package's own
input to it (the batch after the modules before it, from one jitted
forward); the UNet also on device-built rulebooks, against the JAX
module run op by op on the batch without its tables. Then the whole eval
forward and post-processing against ``make_eval_step``, the converter's
round trip, and a request through ``serve.Detector`` from a raw cloud.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.models.roi_heads.parta2_head import (
    MaskedDenseSubMConv3d as JaxMaskedConv,
)
from lidardetection_tpu.ops import roi_pool as jax_roi_pool
from lidardetection_tpu.ops import sparse as jsparse
from lidardetection_tpu.parallel.train_step import device_batch, make_eval_step
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.models.backbones_3d.spconv_unet import (
    channel_reduction,
)
from lidardetection_tpu_torch.models.roi_heads.parta2_head import (
    MaskedDenseSubMConv3d,
)
from lidardetection_tpu_torch.ops import roi_pool, sparse
from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
    rulebook_conv, rulebook_conv_dw,
)
from lidardetection_tpu_torch.ops.sparse_plan import PlanOp, _np_inv
from lidardetection_tpu_torch.serve import Detector
from test_torch_pvrcnn import _random_variables, _randomize, _torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CFG = 'tools/cfgs/kitti_models/PartA2.yaml'
ATOL = 1e-4
STAGES = ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')


def _reduce(cfg):
    """The size of tests/test_parta2_e2e.py."""
    data = cfg.DATA_CONFIG
    data.DATASET = 'SyntheticDataset'
    data.MAX_POINTS = 4000
    if 'DATA_AUGMENTOR' in data:
        del data.DATA_AUGMENTOR
    vox = [p for p in data.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    vox.VOXEL_SIZE = [0.2, 0.2, 0.1]
    vox.MAX_NUMBER_OF_VOXELS = {'train': 1200, 'test': 1200}
    m = cfg.MODEL
    m.COMPUTE_DTYPE = 'float32'
    m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 512
    m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 64
    m.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 256
    m.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 32
    m.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16
    m.ROI_HEAD.ROI_AWARE_POOL.POOL_SIZE = 6
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 64
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 16
    return cfg


_CAPTURED = ('vfe', 'backbone_3d', 'backbone_2d', 'dense_head', 'point_head')


@pytest.fixture(scope='module')
def jax_run():
    """The JAX model on a two-scene eval batch with its host plan: the
    batch after each module (one jitted forward, the modules' outputs
    captured), make_eval_step's predictions, and the UNet run op by op on
    the batch without its tables (device-built rulebooks)."""
    cfg = _reduce(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=False,
                                       num_scenes=2, seed=3,
                                       model_cfg=cfg.MODEL)
    batch = device_batch(next(iter(loader)))
    assert 'rb_inv4' in batch
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    params, stats = _random_variables(model, batch, seed=0)

    def forward(p, s, b):
        out, state = model.apply(
            {'params': p, 'batch_stats': s}, b, training=False,
            capture_intermediates=lambda m, method: (
                method == '__call__' and m.name in _CAPTURED),
            mutable=['intermediates'])
        return out, {k: v['__call__'][0]
                     for k, v in state['intermediates'].items()}

    out, after = jax.device_get(jax.jit(forward)(params, stats, batch))
    after['roi_head'] = out
    bound = model.bind({'params': params, 'batch_stats': stats})
    no_plan = {k: v for k, v in after['vfe'].items()
               if not k.startswith('rb_')}
    unet_device = jax.device_get(bound.backbone_3d(no_plan, training=False))
    step = make_eval_step(model, cfg.MODEL.POST_PROCESSING,
                          len(cfg.CLASS_NAMES))
    preds = jax.device_get(step(params, stats, batch))
    # the RoI head on proposals around the voxels (the random dense head
    # proposes boxes where no voxel lies)
    roi_in = _proposals_on_points(after['point_head'], 300,
                                  np.random.RandomState(1))
    roi_out = jax.device_get(jax.jit(lambda b: model.apply(
        {'params': params, 'batch_stats': stats}, b,
        method=lambda m, x: m.roi_head(x, training=False)))(roi_in))
    state = flax_to_state_dict(params, stats)
    return {'batch': jax.device_get(batch), 'params': params, 'stats': stats,
            'state': state, 'after': after, 'unet_device': unet_device,
            'preds': preds, 'roi_case': (roi_in, roi_out)}


def _proposals_on_points(batch, n, rng):
    """`batch` with its dense head's boxes and logits replaced by `n` a
    sample centred on live voxel centres, of car to pedestrian sizes."""
    out = {k: np.array(v) for k, v in batch.items()
           if not isinstance(v, dict) and not hasattr(v, 'spatial_shape')}
    b = len(out['point_coords'])
    boxes = np.zeros((b, n, 7), np.float32)
    for s in range(b):
        live = out['point_coords'][s][out['point_valid'][s]]
        boxes[s, :, 0:3] = live[rng.randint(len(live), size=n)] \
            + rng.randn(n, 3) * 0.3
        boxes[s, :, 3:6] = np.array([3.9, 1.6, 1.56]) * rng.uniform(
            0.2, 1.2, (n, 1))
        boxes[s, :, 6] = rng.uniform(-np.pi, np.pi, n)
    out['batch_box_preds'] = boxes
    out['batch_cls_preds'] = rng.randn(b, n, 3).astype(np.float32)
    out.pop('batch_valid_preds', None)
    return out


@pytest.fixture(scope='module')
def port(jax_run):
    return Detector(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                    state_dict=jax_run['state'])


def _before(jax_run, name):
    """The JAX batch entering module `name`, as the port holds it."""
    order = ('vfe', 'backbone_3d', 'map_to_bev', 'backbone_2d', 'dense_head',
             'point_head', 'roi_head')
    prev = [m for m in order[:order.index(name)] if m in jax_run['after']][-1]
    return {k: _torch(v) for k, v in jax_run['after'][prev].items()}


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


# ---- the inverse convolution's rulebook ----

INVERSE = {  # the down ops an inverse convolution undoes: kernel, stride, pad
    'down2/3': ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    'down4': ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    'zcompress': ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
}


def _edge_table(seed, shape, cap=300, n=(220, 150)):
    """Two samples of unique voxels, sorted, -1 padded: random ones plus
    every corner and edge midpoint of the grid (z = 0 included, where
    down4's zero z-padding makes u + p - k negative)."""
    rng = np.random.RandomState(seed)
    d, h, w = shape
    edges = np.array([(z, y, x) for z in (0, d - 1) for y in (0, h // 2, h - 1)
                      for x in (0, w // 2, w - 1)])
    coords = np.full((2, cap, 3), -1, np.int32)
    num = np.zeros(2, np.int32)
    for b in range(2):
        keys = np.unique(np.concatenate([
            (edges[:, 0] * h + edges[:, 1]) * w + edges[:, 2],
            rng.choice(d * h * w, n[b], replace=False)]))[:cap]
        coords[b, :len(keys)] = np.stack(np.unravel_index(keys, shape), -1)
        num[b] = len(keys)
    return coords, num


@pytest.mark.parametrize('geometry', sorted(INVERSE))
@pytest.mark.parametrize('shape', [(11, 14, 12), (41, 24, 20)])
def test_inverse_rulebook_matches_jax_and_plan(geometry, shape):
    """Integer-equal to JAX's ``build_inverse_rulebook`` and to the host
    plan's numpy ``_np_inv``, on tables with voxels at every grid edge."""
    kernel, stride, padding = INVERSE[geometry]
    coords, num = _edge_table(len(geometry) + shape[0], shape)
    feats = np.zeros(coords.shape[:2] + (4,), np.float32)
    up = jsparse.SparseTensor(jnp.asarray(feats), jnp.asarray(coords),
                              jnp.asarray(num), shape)
    # room for every output (up to 8 a voxel), so none is cut
    d_coords, d_num, d_shape = jsparse.build_strided_out_coords(
        up, kernel, stride, padding, 8 * coords.shape[1])
    down = jsparse.SparseTensor(jnp.zeros(d_coords.shape[:2] + (4,)),
                                d_coords, d_num, d_shape)
    want = np.asarray(jsparse.build_inverse_rulebook(
        down, jnp.asarray(coords), shape, kernel, stride, padding))
    t_down = sparse.SparseTensor(
        torch.zeros(d_coords.shape[:2] + (4,)),
        torch.from_numpy(np.array(d_coords)),
        torch.from_numpy(np.array(d_num)), tuple(d_shape))
    got = sparse.build_inverse_rulebook(t_down, torch.from_numpy(coords),
                                        kernel, stride, padding)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    op = PlanOp('down', 'down', kernel, stride, padding)
    for b in range(2):
        plain = _np_inv(coords[b], num[b], np.asarray(d_coords[b]),
                        int(d_num[b]), tuple(d_shape), op)
        np.testing.assert_array_equal(plain, want[b])
    v_down = d_coords.shape[1]
    hits = (want < v_down).sum(-1)
    # every live up voxel hears from at least one down voxel, padding none
    live = coords[..., 0] >= 0
    assert (hits[live] > 0).all() and (hits[~live] == 0).all()
    assert (want == v_down).any()
    # the edge voxels at z = 0 and the far corner are among the live rows
    assert ((coords[..., 0] == 0) & live).sum() >= 9


# ---- UNetV2 ----

def _held_unet(got, want, point_atol):
    _close(got['point_features'], want['point_features'], 'point_features')
    assert float(np.abs(np.asarray(want['point_features'])).max()) > 0
    np.testing.assert_array_equal(got['point_valid'].numpy(),
                                  np.asarray(want['point_valid']))
    _close(got['point_coords'], want['point_coords'], 'point_coords',
           atol=point_atol)
    for name in STAGES:
        g, w = got['multi_scale_3d_features'][name], \
            want['multi_scale_3d_features'][name]
        np.testing.assert_array_equal(g.coords.numpy(), np.asarray(w.coords))
        np.testing.assert_array_equal(g.num_voxels.numpy(),
                                      np.asarray(w.num_voxels))
        _close(g.features, w.features, name)
    _close(got['encoded_spconv_tensor'], want['encoded_spconv_tensor'],
           'encoded_spconv_tensor')


@pytest.mark.parametrize('tables', ['host plan', 'device-built'])
def test_unet_matches_jax(jax_run, port, tables):
    """point_features, the stages' tables and features and the encoded
    tensor; on the host plan's tables against the jitted forward, on
    device-built rulebooks against the module run op by op."""
    batch = _before(jax_run, 'backbone_3d')
    if tables == 'device-built':
        batch = {k: v for k, v in batch.items() if not k.startswith('rb_')}
        want, point_atol = jax_run['unet_device'], 0.0
    else:
        assert 'rb_inv2' in batch
        want, point_atol = jax_run['after']['backbone_3d'], 1e-5
    counts = (rulebook_conv.launches, rulebook_conv_dw.launches)
    with torch.inference_mode():
        got = port.model.backbone_3d(batch)
    assert (rulebook_conv.launches, rulebook_conv_dw.launches) == counts
    assert len(port.model.backbone_3d.convs) == 20
    assert len(port.model.backbone_3d.blocks) == 4
    assert tuple(got['point_features'].shape) == (2, 1200, 16)
    _held_unet(got, want, point_atol)


def test_channel_reduction_sums_adjacent_pairs():
    """On a tensor whose two halves differ: channel i is x[2i] + x[2i+1],
    as JAX's reshape-sum, and not x[i] + x[i + C]."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    x[..., 8:] += 10.0
    want = np.asarray(jnp.asarray(x).reshape(2, 5, 8, -1).sum(-1))
    got = channel_reduction(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, x[..., 0::2] + x[..., 1::2], rtol=1e-6)
    assert np.abs(got - (x[..., :8] + x[..., 8:])).max() > 1.0


# ---- RoI-aware pooling ----

def _pool_case(seed):
    """Points in and around 7 RoIs of two samples: RoI 3 of sample 0 lies
    far from every point (empty), RoI 5 of sample 1 is not valid; one cell
    of RoI 0 holds a point twice (tied maxima); the live points are the
    first `num`."""
    rng = np.random.RandomState(seed)
    b, n, r = 2, 700, 7
    rois = np.zeros((b, r, 7), np.float32)
    rois[..., 0:2] = rng.uniform(-6, 6, (b, r, 2))
    rois[..., 2] = rng.uniform(-1.5, -0.5, (b, r))
    rois[..., 3:6] = rng.uniform(0.8, 4.0, (b, r, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (b, r))
    rois[0, 3, 0:3] = (60.0, 60.0, 0.0)
    valid = np.ones((b, r), bool)
    valid[1, 5] = False
    pts = rng.uniform(-8, 8, (b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3, 1, (b, n))
    near = rng.randint(r, size=(b, 400))
    near[0][near[0] == 3] = 0  # no point near the far RoI
    for s in range(b):
        pts[s, :400] = rois[s, near[s], 0:3] + rng.randn(400, 3) * 0.5 * \
            rois[s, near[s], 3:6] / 3
    pts[0, 1] = pts[0, 0]  # the same point twice: tied maxima in its cell
    feats = rng.randn(b, n, 5).astype(np.float32)
    feats[0, 1] = feats[0, 0]
    num = np.array([n, 620], np.int32)
    return pts, feats, num, rois, valid


@pytest.mark.parametrize('cap', [16, 64, 1024])
def test_roi_point_sample_matches_jax(cap):
    pts, _, num, rois, valid = _pool_case(cap)
    want_idx, want_hit = (np.asarray(x) for x in jax_roi_pool.roi_point_sample(
        jnp.asarray(pts), jnp.asarray(num), jnp.asarray(rois),
        jnp.asarray(valid), cap))
    idx, hit = roi_pool.roi_point_sample(
        torch.from_numpy(pts), torch.from_numpy(num), torch.from_numpy(rois),
        torch.from_numpy(valid), cap)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    counts = want_hit.sum(-1)
    assert counts[0, 3] == 0 and counts[1, 5] == 0  # empty and invalid
    assert (counts[0, :3] > 0).all()
    if cap == 16:
        assert (counts == cap).any()  # a RoI with more points than the cap


@pytest.mark.parametrize('method', ['max', 'avg'])
def test_roiaware_pool3d_and_gradient_match_jax(method):
    """Both reductions and their gradients of the features, through one
    shared sample; with an empty RoI, an invalid one and a cell whose
    maximum two points share."""
    pts, feats, num, rois, valid = _pool_case(3)
    out_size = (4, 5, 3)
    cot = np.random.RandomState(9).randn(2, 7, *out_size, 5).astype(np.float32)

    def jax_pool(f):
        sample = jax_roi_pool.roi_point_sample(
            jnp.asarray(pts), jnp.asarray(num), jnp.asarray(rois),
            jnp.asarray(valid), 64)
        return jax_roi_pool.roiaware_pool3d(
            jnp.asarray(pts), f, jnp.asarray(num), jnp.asarray(rois),
            jnp.asarray(valid), out_size=out_size, pool_method=method,
            sample=sample)

    want, vjp = jax.vjp(jax_pool, jnp.asarray(feats))
    want_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    f = torch.from_numpy(feats).requires_grad_(True)
    args = [torch.from_numpy(x) for x in (pts, num, rois, valid)]
    sample = roi_pool.roi_point_sample(*args, 64)
    got = roi_pool.roiaware_pool3d(args[0], f, args[2], sample, out_size,
                                   method)
    (got * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    assert not want[0, 3].any() and not want[1, 5].any()  # 0, not -inf
    np.testing.assert_allclose(f.grad.numpy(), want_grad, rtol=0, atol=1e-6)
    if method == 'max':
        # the tied pair shares its cell's gradient evenly
        assert f.grad[0, 0].abs().sum() > 0
        np.testing.assert_array_equal(f.grad[0, 0].numpy(),
                                      f.grad[0, 1].numpy())
        np.testing.assert_array_equal(want_grad[0, 0], want_grad[0, 1])


# ---- the RoI head's dense convolution ----

@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_masked_dense_subm_conv_matches_jax(training):
    """Zeroed inactive inputs, the 3x3x3 convolution (flax kernel (X, Y, Z,
    I, O) -> weight (O, I, X, Y, Z)), BatchNorm over the active cells,
    ReLU and the output mask; in training the statistics too."""
    rng = np.random.RandomState(int(training))
    x = rng.randn(3, 6, 5, 4, 7).astype(np.float32)  # (N, X, Y, Z, C)
    active = rng.rand(3, 6, 5, 4) < 0.4
    module = JaxMaskedConv(12)
    variables = jax.device_get(module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(active), False))
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)
    want, mutated = module.apply(
        {'params': params, 'batch_stats': stats}, jnp.asarray(x),
        jnp.asarray(active), training, mutable=['batch_stats'])
    tm = MaskedDenseSubMConv3d(7, 12)
    tm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    tm.train(training)
    got = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
             torch.from_numpy(active))
    want = np.moveaxis(np.asarray(want), -1, 1)
    assert float(np.abs(want).max()) > 0
    _close(got.detach(), want, 'output')
    assert not got.detach().numpy().transpose(0, 2, 3, 4, 1)[~active].any()
    got_stats, = state_dict_to_flax(tm.state_dict(), stats)
    for key in ('mean', 'var'):
        _close(got_stats['MaskedBatchNorm_0'][key],
               mutated['batch_stats']['MaskedBatchNorm_0'][key], key,
               atol=1e-5)


# ---- the heads and the slice ----

def test_point_head_matches_jax(jax_run, port):
    with torch.inference_mode():
        got = port.model.point_head(_before(jax_run, 'point_head'))
    want = jax_run['after']['point_head']
    for key in ('point_cls_scores', 'point_part_offset'):
        _close(got[key], want[key], key)
    p = got['point_part_offset']
    assert tuple(p.shape) == (2, 1200, 3) and 0 <= float(p.min()) \
        and float(p.max()) <= 1


def test_roi_head_matches_jax(jax_run, port):
    """Proposals, the point sample both pools share, and the RCNN outputs,
    on proposals around the voxels; the sample is integer and compared
    first."""
    roi_in, want = jax_run['roi_case']
    batch = {k: torch.from_numpy(v) for k, v in roi_in.items()}
    samples = []
    real = roi_pool.roi_point_sample

    def recording(*args, **kwargs):
        samples.append(real(*args, **kwargs))
        return samples[-1]

    with pytest.MonkeyPatch.context() as mp:
        from lidardetection_tpu_torch.models.roi_heads import parta2_head
        mp.setattr(parta2_head, 'roi_point_sample', recording)
        with torch.inference_mode():
            got = port.model.roi_head(batch)
    for key in ('roi_valid', 'roi_labels'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert int(np.asarray(want['roi_valid']).sum()) > 8
    _close(got['rois'], want['rois'], 'rois')
    idx, hit = samples[0]
    want_idx, want_hit = jax_roi_pool.roi_point_sample(
        jnp.asarray(batch['point_coords'].numpy()),
        jnp.asarray(batch['point_valid'].numpy().sum(1).astype(np.int32)),
        jnp.asarray(np.asarray(want['rois'])[..., :7]),
        jnp.asarray(np.asarray(want['roi_valid'])), 1024)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert int(hit.sum()) > 1000 and int(hit.sum(-1).amin()) == 0
    for key in ('roi_scores', 'batch_cls_preds', 'batch_box_preds'):
        _close(got[key], want[key], key)


def test_parta2_slice_matches_make_eval_step(jax_run, port):
    """The whole eval forward and post-processing on the host plan's
    tables."""
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in jax_run['batch'].items()}
    out = port.forward(batch)
    got = port.postprocess(out)
    want = jax_run['preds']
    np.testing.assert_array_equal(got['num_preds'].numpy(), want['num_preds'])
    assert (got['num_preds'] > 1).all()
    np.testing.assert_array_equal(got['pred_mask'].numpy(), want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'].numpy(),
                                  want['pred_labels'])
    _close(got['pred_scores'], want['pred_scores'], 'pred_scores')
    _close(got['pred_boxes'], want['pred_boxes'], 'pred_boxes')


def test_parta2_converter_round_trip(jax_run, port):
    """Every flax leaf lands in the port's state_dict (strict load) and
    comes back unchanged, the 3D convolution kernels included."""
    assert set(port.model.state_dict()) == set(jax_run['state'])
    w = port.model.state_dict()['roi_head.sub_convs.2.weight']
    assert tuple(w.shape) == (64, 16, 3, 3, 3)
    flax_kernel = jax_run['params']['roi_head']['MaskedDenseSubMConv3d_2'][
        'Conv_0']['kernel']
    np.testing.assert_array_equal(w[5, 7].numpy(), flax_kernel[:, :, :, 7, 5])
    params, stats = state_dict_to_flax(port.model.state_dict(),
                                       jax_run['params'], jax_run['stats'])
    for got, want in ((params, jax_run['params']), (stats, jax_run['stats'])):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            np.testing.assert_array_equal(leaf, flat_want[path])


def test_parta2_predict_from_clouds(port):
    """A raw cloud through the port's voxelizer and device-built
    rulebooks (the serving path)."""
    from lidardetection_tpu_torch.datasets.synthetic import make_scene
    points, _, _ = make_scene(np.random.RandomState(5),
                              np.asarray(port.info['point_cloud_range']),
                              num_ground=3000)
    batch = port.make_batch([points])
    assert not any(k.startswith('rb_') for k in batch) and 'points' not in batch
    (result,) = port.predict([points])
    n = len(result['boxes'])
    assert 0 < n <= 16 and result['boxes'].shape == (n, 7)
    assert np.isfinite(result['boxes']).all()
    assert (np.diff(result['scores']) <= 0).all()
    assert set(np.unique(result['labels'])) <= {1, 2, 3}


def test_flax_module_names_follow_creation_order(port):
    """The UNet's flax names in creation order, as the converter maps
    them: the encoder's 12 layers, then conv_m and the inverse conv (or
    conv5) of each UR block."""
    unet = port.model.backbone_3d
    widths = [tuple(c.kernel.shape) for c in unet.convs]
    assert widths[:12] == [(27, 4, 16), (27, 16, 16), (27, 16, 32),
                           (27, 32, 32), (27, 32, 32), (27, 32, 64),
                           (27, 64, 64), (27, 64, 64), (27, 64, 64),
                           (27, 64, 64), (27, 64, 64), (3, 64, 128)]
    assert widths[12:] == [(27, 128, 64), (27, 64, 64), (27, 128, 64),
                           (27, 64, 32), (27, 64, 32), (27, 32, 16),
                           (27, 32, 16), (27, 16, 16)]
    assert [c.subm for c in unet.convs[12:]] == [True, False] * 3 + [True] * 2
    assert [tuple(b.convs[0].kernel.shape) for b in unet.blocks] == [
        (27, 64, 64), (27, 64, 64), (27, 32, 32), (27, 16, 16)]
