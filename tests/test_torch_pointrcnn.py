"""The PointRCNN serving slice, port against the JAX package, on the CPU.

At tests/test_pointrcnn_e2e.py's reduced size (1024 sampled points, SA
NPOINTS [256, 64, 16, 8], RoI NMS 512 -> 32 in eval, 64 pooled points a
RoI, RoI SA NPOINTS [32, 16, -1], final NMS 64 -> 16) in float32, B = 2,
on the JAX package's own ``build_dataloader`` batch with converted random
weights. On the CPU both packages run the exact point ops (exact FPS,
brute-force ball query), so integer results (neighbour indices, pooled
point lists, RoI counts and labels, kept masks) must be equal; float
results agree within 1e-4. The JAX loader samples the test points from
numpy's global generator, which the fixture seeds (and puts back).

The module and slice comparisons run with both packages' ``_pairwise_d2``
replaced by the same exact formula, ``sum((a - b)^2)`` (`exact_d2`). The
packages' own ``|a|^2 + |b|^2 - 2 a.b`` cancels: at 70 m its rounding is
about 1e-3 m^2, so a point's distance to itself reads anywhere in [0,
0.03] m, and the feature propagation's inverse-distance weights
(1 / (d + 1e-8)) turn that into weights anywhere in [0.98, 1]. XLA:CPU
rounds the formula differently under jit than op by op (another order of
the 3-term product, contracted multiply-adds), so the jitted JAX model
parts from itself run op by op by up to 0.009 in the point features
(measured), while the port equals the op-by-op run within 5e-6; op by op
the slice takes minutes of compiling. `test_three_nn_and_interpolation_
match_jax` holds the real formula's three_nn against the JAX package's
(op by op), and tests/test_torch_pointnet2.py its ball queries.

The point ops (three_nn with tied distances and padded sources, its
weights and interpolation; the RoI point pool with fewer hits than slots,
an empty RoI and fewer points than slots), the point residual coder, the
GroupAll set abstraction and a feature propagation module are held
against their JAX counterparts on the same inputs; the backbone and the
two heads on the JAX package's own input to each (the batch after the
modules before it, from one jitted forward); then the whole eval forward
and post-processing against ``make_eval_step``, the converter's round
trip, a request through ``serve.Detector`` from a raw cloud, and the
point processors bit-equal to the JAX package's under the same seed.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.core import box_coders as jax_box_coders
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.datasets.processor.data_processor import (
    DataProcessor as JaxDataProcessor,
)
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.models.backbones_3d.pointnet2_modules import (
    PointnetFPModule as JaxFPModule, PointnetSAModuleMSG as JaxSAModule,
)
from lidardetection_tpu.ops import pointnet2 as jax_p2
from lidardetection_tpu.ops import roi_pool as jax_roi_pool
from lidardetection_tpu.parallel.train_step import (
    device_batch, make_eval_step,
)
from lidardetection_tpu_torch.config import (
    cfg_from_yaml_file, dataset_info, raw_point_capacity, voxel_processor_cfg,
)
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.core.box_coders import build_box_coder
from lidardetection_tpu_torch.datasets.processor import data_processor
from lidardetection_tpu_torch.models.backbones_3d.pointnet2_modules import (
    PointnetFPModule, PointnetSAModuleMSG,
)
from lidardetection_tpu_torch.ops import pointnet2 as p2
from lidardetection_tpu_torch.ops import roi_pool
from lidardetection_tpu_torch.ops.select_cuda import ball_select
from lidardetection_tpu_torch.ops.voxelize import build_point_batch
from lidardetection_tpu_torch.serve import Detector
from test_torch_pvrcnn import _random_variables, _randomize, _torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CFG = 'tools/cfgs/kitti_models/pointrcnn.yaml'
ATOL = 1e-4
MEAN_SIZE = ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))


def _reduce(cfg):
    """The size of tests/test_pointrcnn_e2e.py."""
    data = cfg.DATA_CONFIG
    data.DATASET = 'SyntheticDataset'
    data.MAX_POINTS = 1024
    if 'DATA_AUGMENTOR' in data:
        del data.DATA_AUGMENTOR
    sample = [p for p in data.DATA_PROCESSOR if p.NAME == 'sample_points'][0]
    sample.NUM_POINTS = {'train': 1024, 'test': 1024}
    m = cfg.MODEL
    m.COMPUTE_DTYPE = 'float32'
    m.BACKBONE_3D.SA_CONFIG.NPOINTS = [256, 64, 16, 8]
    m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 512
    m.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 64
    m.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 512
    m.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 32
    m.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 32
    m.ROI_HEAD.ROI_POINT_POOL.NUM_SAMPLED_POINTS = 64
    m.ROI_HEAD.SA_CONFIG.NPOINTS = [32, 16, -1]
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 64
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 16
    return cfg


_CAPTURED = ('backbone_3d', 'point_head')
REAL_D2 = p2._pairwise_d2


def _jax_exact_d2(a, b):
    """(M, 3), (N, 3) -> (M, N): ``(s0 + s1) + s2`` of the squared
    differences, each rounded apart (the barrier keeps XLA from
    contracting the sum into multiply-adds)."""
    d = a[:, None, :] - b[None, :, :]
    sq = jax.lax.optimization_barrier(d * d)
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _port_exact_d2(a, b):
    """The port's counterpart of `_jax_exact_d2` over (..., M, 3) and (...,
    N, 3)."""
    sq = (a[..., :, None, :] - b[..., None, :, :]) ** 2
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


@pytest.fixture(scope='module')
def exact_d2():
    """Both packages' pairwise squared distances by the exact formula, for
    the rest of the module (the module docstring says why)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_p2, '_pairwise_d2', _jax_exact_d2)
        mp.setattr(p2, '_pairwise_d2', _port_exact_d2)
        yield


@contextlib.contextmanager
def seeded_numpy(seed):
    """numpy's global generator seeded for the JAX loader, then put back."""
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)


@pytest.fixture(scope='module')
def jax_run(exact_d2):
    """The JAX model on a two-scene eval batch: the batch after each module
    (one jitted forward, the modules' outputs captured) and
    make_eval_step's predictions."""
    cfg = _reduce(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=False,
                                       num_scenes=2, seed=3)
    with seeded_numpy(3):
        batch = device_batch(next(iter(loader)))
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

    step = make_eval_step(model, cfg.MODEL.POST_PROCESSING,
                          len(cfg.CLASS_NAMES))
    out, after = jax.device_get(jax.jit(forward)(params, stats, batch))
    preds = jax.device_get(step(params, stats, batch))
    after['roi_head'] = out
    return {'batch': jax.device_get(batch), 'params': params, 'stats': stats,
            'state': flax_to_state_dict(params, stats), 'after': after,
            'preds': preds, 'info': dataset.dataset_info}


@pytest.fixture(scope='module')
def port(jax_run):
    return Detector(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                    state_dict=jax_run['state'])


def _before(jax_run, name):
    """The JAX batch entering module `name`, as the port holds it."""
    if name == 'backbone_3d':
        batch = {k: _torch(np.asarray(v)) for k, v in jax_run['batch'].items()}
        n = batch['points'].shape[1]
        return {**batch, 'point_valid': torch.arange(n)
                < batch['num_points'][:, None]}
    prev = {'point_head': 'backbone_3d', 'roi_head': 'point_head'}[name]
    return {k: _torch(v) for k, v in jax_run['after'][prev].items()}


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


def _init_module(module, args, seed):
    """flax variables of `module` on `args`, with random BN affines and
    statistics."""
    variables = jax.device_get(module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)
    return (_randomize(variables['params'], rng),
            _randomize(variables['batch_stats'], rng))


def test_config_has_no_grid_and_reads_raw_points():
    cfg = cfg_from_yaml_file(CFG)
    assert voxel_processor_cfg(cfg.DATA_CONFIG) is None
    info = dataset_info(cfg.DATA_CONFIG)
    assert info['grid_size'] is None and info['voxel_size'] is None
    assert info['num_point_features'] == 4
    assert raw_point_capacity(cfg) == 16384
    want = jax_cfg_from_yaml(CFG)
    _, loader = build_dataloader(_reduce(want).DATA_CONFIG, want.CLASS_NAMES,
                                 batch_size=1, training=False, num_scenes=1)
    jax_info = loader.dataset.dataset_info
    assert info['point_cloud_range'] == jax_info['point_cloud_range']
    assert jax_info['grid_size'] is None and jax_info['voxel_size'] is None


# ---- the point ops ----

def _three_nn_case():
    """Queries among sources with exact ties: duplicated sources and
    queries equidistant from two sources; the second sample's last
    sources are padding, one of them nearest to every query."""
    rng = np.random.RandomState(7)
    b, m, n = 2, 300, 120
    src = rng.uniform(-4, 4, (b, n, 3)).astype(np.float32)
    src[:, 10:20] = src[:, 0:10]  # duplicates: tied distances
    query = rng.uniform(-4, 4, (b, m, 3)).astype(np.float32)
    query[:, :10] = src[:, 20:30]  # on a source: distance 0
    query[:, 10:20] = (src[:, 30:40] + src[:, 40:50]) / 2  # midway
    src[1, 100:] = 0.0
    query[1, 50:60] = 0.0  # nearest to the padding
    num = np.array([n, 100], np.int32)
    return query, src, num


def test_three_nn_and_interpolation_match_jax():
    assert p2._pairwise_d2 is REAL_D2  # runs before the slice's fixture
    query, src, num = _three_nn_case()
    want_d, want_i = (np.asarray(x) for x in jax_p2.three_nn(
        jnp.asarray(query), None, jnp.asarray(src), jnp.asarray(num)))
    d, i = p2.three_nn(torch.from_numpy(query), torch.from_numpy(src),
                       torch.from_numpy(num))
    np.testing.assert_array_equal(i.numpy(), want_i)
    _close(d, want_d, 'dists', atol=1e-5)
    assert (want_i[1] < 100).all()  # never a padding source
    # a duplicated pair: the lower index first
    assert ((want_i[..., 0] < 10) | (want_i[..., 0] >= 20)).all()
    w = p2.three_nn_weights(d)
    want_w = np.asarray(jax_p2.three_nn_weights(jnp.asarray(want_d)))
    _close(w, want_w, 'weights', atol=1e-6)
    feats = np.random.RandomState(8).randn(2, 120, 6).astype(np.float32)
    got = p2.three_interpolate(torch.from_numpy(feats), i, w)
    want = jax_p2.three_interpolate(jnp.asarray(feats), jnp.asarray(want_i),
                                    jnp.asarray(want_w))
    _close(got, want, 'interpolated', atol=1e-5)


def test_three_nn_blocks_give_one_answer(monkeypatch):
    """Query rows split over blocks read what one block reads."""
    query, src, num = (torch.from_numpy(x) for x in _three_nn_case())
    whole = p2.three_nn(query, src, num)
    monkeypatch.setattr(p2, '_THREE_NN_BLOCK', 2 * 120 * 7)
    parts = p2.three_nn(query, src, num)
    for got, want in zip(parts, whole):
        assert torch.equal(got, want)


@pytest.mark.parametrize('use_mean_size', [True, False])
def test_point_residual_coder_matches_jax(use_mean_size):
    rng = np.random.RandomState(int(use_mean_size))
    n = 200
    boxes = np.concatenate([rng.uniform(-30, 30, (n, 3)),
                            rng.uniform(0.3, 5.0, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    boxes[:5, 3:6] = 0.0  # degenerate sizes: clamped to 1e-5
    boxes = boxes.astype(np.float32)
    points = (boxes[:, :3] + rng.randn(n, 3)).astype(np.float32)
    classes = rng.randint(1, 4, n).astype(np.int32)
    kw = {'use_mean_size': use_mean_size, 'mean_size': MEAN_SIZE}
    coder = build_box_coder('PointResidualCoder', **kw)
    want_coder = jax_box_coders.build_box_coder('PointResidualCoder', **kw)
    enc = coder.encode(torch.from_numpy(boxes), torch.from_numpy(points),
                       torch.from_numpy(classes))
    want_enc = np.array(want_coder.encode(
        jnp.asarray(boxes), jnp.asarray(points), jnp.asarray(classes)))
    assert enc.shape == (n, 8)
    _close(enc, want_enc, 'encode', atol=1e-5)
    dec = coder.decode(torch.from_numpy(want_enc), torch.from_numpy(points),
                       torch.from_numpy(classes))
    want_dec = np.asarray(want_coder.decode(
        jnp.asarray(want_enc), jnp.asarray(points), jnp.asarray(classes)))
    _close(dec, want_dec, 'decode', atol=1e-5)
    _close(dec[5:], boxes[5:], 'round trip', atol=1e-4)


def test_group_all_and_fp_modules_match_jax():
    """GroupAll (one group of every point, absolute xyz joined to the
    features, the origin as its centre) and a feature propagation module
    (three neighbours, interpolation, the unknown features joined, masked
    to the valid points), each from converted random weights."""
    rng = np.random.RandomState(11)
    b, n, c = 2, 48, 7
    xyz = rng.uniform(-2, 2, (b, n, 3)).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    num = np.array([n, n], np.int32)
    jm = JaxSAModule(npoint=None, radii=(100.0,), nsamples=(16,),
                     mlps=((16, 32),))
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(num), False)
    params, stats = _init_module(jm, args, 12)
    want = jm.apply({'params': params, 'batch_stats': stats}, *args)
    tm = PointnetSAModuleMSG(None, (100.0,), (16,), [[16, 32]], c).eval()
    tm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    with torch.inference_mode():
        got = tm(*(torch.from_numpy(x) for x in (xyz, feats, num)))
    assert tuple(got[1].shape) == (b, 1, 32)
    for g, w in zip(got, want):
        _close(g, w, 'group all')

    m = 20
    known, known_feats = xyz[:, :m], feats[:, :m] * 3
    unknown_num = np.array([n, 30], np.int32)
    known_num = np.array([m, 15], np.int32)
    fm = JaxFPModule(mlp=(24, 16))
    args = tuple(jnp.asarray(x) for x in (xyz, known, feats, known_feats,
                                          unknown_num, known_num)) + (False,)
    params, stats = _init_module(fm, args, 13)
    want = fm.apply({'params': params, 'batch_stats': stats}, *args)
    tm = PointnetFPModule(2 * c, (24, 16)).eval()
    tm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    with torch.inference_mode():
        got = tm(*(torch.from_numpy(x) for x in (
            xyz, known, feats, known_feats, unknown_num, known_num)))
    assert float(np.abs(np.asarray(want)).max()) > 0
    assert not got[1, 30:].any()
    _close(got, want, 'feature propagation')


def _pool_case():
    """Points in and around 6 RoIs of two samples: RoI 2 of sample 0 lies
    far from every point (empty), RoI 4 of sample 1 is not valid; the live
    points are the first `num`."""
    rng = np.random.RandomState(21)
    b, n, r = 2, 700, 6
    rois = np.zeros((b, r, 7), np.float32)
    rois[..., 0:2] = rng.uniform(-6, 6, (b, r, 2))
    rois[..., 2] = rng.uniform(-1.5, -0.5, (b, r))
    rois[..., 3:6] = rng.uniform(0.8, 4.0, (b, r, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (b, r))
    rois[0, 2, 0:3] = (60.0, 60.0, 0.0)
    valid = np.ones((b, r), bool)
    valid[1, 4] = False
    pts = rng.uniform(-8, 8, (b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3, 1, (b, n))
    near = rng.randint(r, size=(b, 300))
    near[0][near[0] == 2] = 0
    for s in range(b):
        pts[s, :300] = rois[s, near[s], 0:3] + rng.randn(300, 3) * 0.4 * \
            rois[s, near[s], 3:6] / 3
    feats = rng.randn(b, n, 5).astype(np.float32)
    num = np.array([n, 610], np.int32)
    return pts, feats, num, rois, valid


@pytest.mark.parametrize('slots', [16, 128, 1024],
                         ids=['full RoIs', 'repeated hits', 'N < slots'])
def test_roipoint_pool3d_matches_jax(slots):
    pts, feats, num, rois, valid = _pool_case()
    want, want_empty = (np.asarray(x) for x in jax_roi_pool.roipoint_pool3d(
        *(jnp.asarray(x) for x in (pts, feats, num, rois, valid)),
        num_sampled_points=slots))
    got, empty = roi_pool.roipoint_pool3d(
        *(torch.from_numpy(x) for x in (pts, feats, num, rois, valid)),
        num_sampled_points=slots)
    np.testing.assert_array_equal(empty.numpy(), want_empty)
    assert want_empty[0, 2] and want_empty[1, 4] and want_empty.sum() == 2
    # the pooled rows are copies of input rows: equal
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0, 2].any()
    hits = [len(np.unique(want[s, i, :, :3], axis=0))
            for s in range(2) for i in range(6) if not want_empty[s, i]]
    if slots == 16:
        assert max(hits) == slots  # a RoI with more points than slots
    else:
        assert min(hits) < slots  # a RoI repeats its hits


# ---- the modules on the JAX package's own input ----

def test_backbone_matches_jax(jax_run, port):
    with torch.inference_mode():
        got = port.model.backbone_3d(_before(jax_run, 'backbone_3d'))
    want = jax_run['after']['backbone_3d']
    assert tuple(got['point_features'].shape) == (2, 1024, 128)
    assert got['point_features'].dtype == torch.float32
    np.testing.assert_array_equal(got['point_coords'].numpy(),
                                  np.asarray(want['point_coords']))
    assert float(np.abs(np.asarray(want['point_features'])).max()) > 0
    _close(got['point_features'], want['point_features'], 'point_features')


def test_point_head_matches_jax(jax_run, port):
    """Class logits, scores and the point boxes decoded with the best
    class, which the proposal layer reads."""
    with torch.inference_mode():
        got = port.model.point_head(_before(jax_run, 'point_head'))
    want = jax_run['after']['point_head']
    for key in ('point_cls_scores', 'batch_cls_preds', 'batch_box_preds'):
        _close(got[key], want[key], key)
    np.testing.assert_array_equal(got['batch_valid_preds'].numpy(),
                                  np.asarray(want['batch_valid_preds']))


def test_roi_head_matches_jax(jax_run, port):
    """Proposals, their pooled points in the canonical frame, the RoI set
    abstractions and the RCNN outputs."""
    with torch.inference_mode():
        got = port.model.roi_head(_before(jax_run, 'roi_head'))
    want = jax_run['after']['roi_head']
    for key in ('roi_valid', 'roi_labels'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert int(np.asarray(want['roi_valid']).sum()) > 8
    for key in ('rois', 'roi_scores', 'batch_cls_preds', 'batch_box_preds'):
        _close(got[key], want[key], key)


def test_pointrcnn_slice_matches_make_eval_step(jax_run, port):
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in jax_run['batch'].items() if hasattr(v, 'shape')}
    before = ball_select.launches
    got = port.postprocess(port.forward(batch))
    assert ball_select.launches == before  # the CPU runs the exact paths
    want = jax_run['preds']
    np.testing.assert_array_equal(got['num_preds'].numpy(), want['num_preds'])
    assert (got['num_preds'] > 1).all()
    np.testing.assert_array_equal(got['pred_mask'].numpy(), want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'].numpy(),
                                  want['pred_labels'])
    _close(got['pred_scores'], want['pred_scores'], 'pred_scores')
    _close(got['pred_boxes'], want['pred_boxes'], 'pred_boxes')


def test_pointrcnn_converter_round_trip(jax_run, port):
    """Every flax leaf lands in the port's state_dict (strict load) and
    comes back unchanged; PointnetFPModule_0 is the deepest level."""
    assert set(port.model.state_dict()) == set(jax_run['state'])
    fp0 = port.model.backbone_3d.fp_layers[0].mlps[0].dense[0].kernel
    assert tuple(fp0.shape) == (1536, 512)
    assert tuple(port.model.roi_head.conv_mlps[0].dense[0].kernel.shape) \
        == (5, 128)
    params, stats = state_dict_to_flax(port.model.state_dict(),
                                       jax_run['params'], jax_run['stats'])
    for got, want in ((params, jax_run['params']), (stats, jax_run['stats'])):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            np.testing.assert_array_equal(leaf, flat_want[path])


def test_pointrcnn_predict_from_clouds(port):
    """A raw cloud through the range mask, the test split's sample (no
    shuffle) and the padding (the serving path)."""
    from lidardetection_tpu_torch.datasets.synthetic import make_scene
    points, _, _ = make_scene(np.random.RandomState(5),
                              np.asarray(port.info['point_cloud_range']),
                              num_ground=3000)
    batch = port.make_batch([points])
    assert set(batch) == {'points', 'num_points'}
    assert tuple(batch['points'].shape) == (1, 1024, 4)
    assert int(batch['num_points'][0]) == 1024
    (result,) = port.predict([points])
    n = len(result['boxes'])
    assert 0 < n <= 16 and result['boxes'].shape == (n, 7)
    assert np.isfinite(result['boxes']).all()
    assert (np.diff(result['scores']) <= 0).all()
    assert set(np.unique(result['labels'])) <= {1, 2, 3}


# ---- the point processors ----

def _cloud(rng, n, far_share):
    """(n, 4) points, a `far_share` of them at least 40 m away, some out of
    the range."""
    pts = np.zeros((n, 4), np.float32)
    far = rng.rand(n) < far_share
    pts[:, 0] = np.where(far, rng.uniform(41, 75, n), rng.uniform(-2, 39, n))
    pts[:, 1] = rng.uniform(-20, 20, n)
    pts[:, 2] = rng.uniform(-2, 0.5, n)
    pts[:, 3] = rng.rand(n)
    return pts


@pytest.mark.parametrize('n,far_share,training', [
    (3000, 0.1, True), (3000, 0.9, True), (600, 0.3, True),
    (3000, 0.1, False), (600, 0.3, False)],
    ids=['few far', 'many far', 'fewer points', 'test', 'test, fewer'])
def test_point_processors_match_jax(n, far_share, training):
    """The chain of pointrcnn.yaml (range mask, near/far-aware sample,
    shuffle in training) bit-equal to the JAX processor's under the same
    seed, the range mask of the gt boxes too; then two clouds through
    ``build_point_batch``."""
    cfg = cfg_from_yaml_file(CFG)
    procs = cfg.DATA_CONFIG.DATA_PROCESSOR
    for p in procs:
        if p.NAME == 'sample_points':
            p.NUM_POINTS = {'train': 1024, 'test': 1024}
    pc_range = np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32)
    rng = np.random.RandomState(n + int(100 * far_share))
    clouds = [_cloud(rng, n, far_share), _cloud(rng, n + 7, far_share)]
    boxes = np.concatenate([rng.uniform(-10, 80, (6, 2)),
                            rng.uniform(-2, 0, (6, 1)),
                            rng.uniform(1, 4, (6, 3)),
                            rng.uniform(-3, 3, (6, 1))], 1).astype(np.float32)
    jax_proc = JaxDataProcessor(procs, pc_range, training=training,
                                max_points=1024)
    np.random.seed(31)
    want = [jax_proc.forward({'points': c.copy(), 'gt_boxes': boxes.copy()})
            for c in clouds]
    got = build_point_batch(clouds, procs, pc_range, 1024, training,
                            np.random.RandomState(31))
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got['points'][i], w['points'])
        assert got['num_points'][i] == w['num_points'] == 1024
    _, got_boxes = data_processor.mask_points_and_boxes_outside_range(
        clouds[0], pc_range, boxes, remove_outside_boxes=training)
    np.testing.assert_array_equal(got_boxes, want[0]['gt_boxes'])
    if training:
        assert len(got_boxes) < len(boxes)
