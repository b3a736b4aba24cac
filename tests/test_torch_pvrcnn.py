"""The PV-RCNN serving slice, port against the JAX package, on the CPU.

At tests/test_pvrcnn_e2e.py's reduced size (0.2 m voxels, 1500-voxel cap,
4000 raw points, 256 keypoints, RoI NMS 256 -> 32, final NMS 64 -> 16) in
float32, B = 2, on the JAX package's own ``build_dataloader`` batch with
converted random weights. On the CPU both packages run the exact point ops
(exact FPS, brute-force ball query), so integer results (keypoint
indices, RoI counts and labels, kept masks) must be equal; float results
agree within 1e-4 (the same float32 math in another summation order).

Each module is held against its JAX counterpart on the JAX package's own
input to it (the batch after the modules before it, from one jitted
forward), then the whole eval forward and post-processing against
``make_eval_step``. The VSA is held against its JAX module run op by op:
under jit XLA:CPU fuses the voxel centre's multiply-add, which moves most
centres by an ulp (1383 of the 1500 of a stage here), and a keypoint-voxel
pair 0.4 m apart then reads d2 = 0.1600039 in the jitted JAX and 0.1600047
in the port and the JAX package run op by op, around r^2 = 0.16 through
``_pairwise_d2``'s cancelling formula: one group flips from one
neighbour to none. That is float32 rounding at a radius boundary; op by op
the JAX module rounds each operation as the port does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.models.backbones_3d.pointnet2_modules import (
    PointnetSAModuleMSG as JaxSAModule,
)
from lidardetection_tpu.parallel.train_step import (
    device_batch, make_eval_step,
)
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.models.backbones_3d.pointnet2_modules import (
    PointnetSAModuleMSG,
)
from lidardetection_tpu_torch.ops import sparse
from lidardetection_tpu_torch.ops.select_cuda import ball_select
from lidardetection_tpu_torch.serve import Detector
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CFG = 'tools/cfgs/kitti_models/pv_rcnn.yaml'
ATOL = 1e-4


def _randomize(tree, rng):
    """Random BN affines and statistics; class bias 0 so NMS sees live
    candidates (the focal init puts every score under SCORE_THRESH)."""
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


def _reduce(cfg):
    """The size of tests/test_pvrcnn_e2e.py."""
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
    m.PFE.NUM_KEYPOINTS = 256
    m.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 256
    m.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 32
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 64
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 16
    return cfg


def _torch(value):
    """A JAX batch entry as the port holds it."""
    if hasattr(value, 'spatial_shape'):  # a SparseTensor
        return sparse.SparseTensor(
            *(torch.from_numpy(np.array(v)) for v in value[:3]),
            tuple(int(s) for s in value.spatial_shape))
    if isinstance(value, dict):
        return {k: _torch(v) for k, v in value.items()}
    if isinstance(value, np.ndarray) and value.ndim == 0:
        return value.item()  # a static int or flag, an array out of jit
    if hasattr(value, 'shape'):
        return torch.from_numpy(np.array(value))  # a writable copy
    return value


def _random_variables(model, batch, seed):
    """flax variables of the model's shapes from a numpy seed: kernels
    lecun-normal, box kernels at std 0.001 as the heads initialize them,
    then `_randomize` (no compiled init: only the shapes are traced)."""
    shapes = jax.eval_shape(lambda k, b: model.init(k, b, training=False),
                            jax.random.PRNGKey(0), batch)
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for key, value in tree.items():
            if hasattr(value, 'items'):
                out[key] = fill(value)
                continue
            fan_in = int(np.prod(value.shape[:-1])) or 1
            std = 1e-3 if 'box' in key else fan_in ** -0.5
            out[key] = (rng.randn(*value.shape) * std).astype(np.float32)
        return out

    return (_randomize(fill(shapes['params']), rng),
            _randomize(fill(shapes['batch_stats']), rng))


_CAPTURED = ('backbone_2d', 'dense_head', 'pfe', 'point_head')


@pytest.fixture(scope='module')
def jax_run():
    """The JAX model on a two-scene batch: the batch after each module
    (one jitted forward, the modules' outputs captured) and
    make_eval_step's predictions."""
    cfg = _reduce(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=False,
                                       num_scenes=2, seed=3)
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

    out, after = jax.device_get(jax.jit(forward)(params, stats, batch))
    after['roi_head'] = out
    bound = model.bind({'params': params, 'batch_stats': stats})
    pfe_op_by_op = jax.device_get(bound.pfe(after['dense_head'], training=False))
    step = make_eval_step(model, cfg.MODEL.POST_PROCESSING,
                          len(cfg.CLASS_NAMES))
    preds = jax.device_get(step(params, stats, batch))
    state = flax_to_state_dict(params, stats)
    return {'batch': batch, 'params': params, 'stats': stats, 'state': state,
            'after': after, 'pfe_op_by_op': pfe_op_by_op, 'preds': preds}


@pytest.fixture(scope='module')
def port(jax_run):
    det = Detector(_reduce(cfg_from_yaml_file(CFG)), device='cpu',
                   state_dict=jax_run['state'])
    return det


def _before(jax_run, name):
    """The JAX batch entering module `name`, as the port holds it."""
    order = _CAPTURED + ('roi_head',)
    return {k: _torch(v) for k, v in
            jax_run['after'][order[order.index(name) - 1]].items()}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize('features', [True, False], ids=['features', 'xyz'])
def test_sa_module_matches_jax(features):
    """One MSG set abstraction, its FPS centres and its groups included,
    with and without source features."""
    rng = np.random.RandomState(4)
    b, n, c = 2, 600, 5
    xyz = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32) if features else None
    num = np.array([n, 450], np.int32)
    kw = dict(npoint=64, radii=(0.6, 1.2), nsamples=(8, 16),
              mlps=((16, 16), (16, 32)))
    jm = JaxSAModule(**kw, zero_empty=True)  # as VSA builds it
    args = (jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
            jnp.asarray(num), False)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(5)
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)
    want = jm.apply({'params': params, 'batch_stats': stats}, *args)

    tm = PointnetSAModuleMSG(**kw, in_channels=c if features else 0).eval()
    tm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(xyz),
                 None if feats is None else torch.from_numpy(feats),
                 torch.from_numpy(num))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert float(np.abs(np.asarray(want[1])).max()) > 0
    _close(got[1], want[1], 'new_features')


def test_vsa_matches_jax(jax_run, port):
    with torch.inference_mode():
        got = port.model.pfe(_before(jax_run, 'pfe'))
    want = jax_run['pfe_op_by_op']
    np.testing.assert_array_equal(got['point_coords'].numpy(),
                                  np.asarray(want['point_coords']))
    np.testing.assert_array_equal(got['point_valid'].numpy(),
                                  np.asarray(want['point_valid']))
    assert tuple(got['point_features_before_fusion'].shape) == (2, 256, 640)
    for key in ('point_features_before_fusion', 'point_features'):
        _close(got[key], want[key], key)


def test_point_head_matches_jax(jax_run, port):
    with torch.inference_mode():
        got = port.model.point_head(_before(jax_run, 'point_head'))
    _close(got['point_cls_scores'], jax_run['after']['point_head']['point_cls_scores'],
           'point_cls_scores')


def test_two_stage_dense_head_matches_jax(jax_run, port):
    """The dense head ahead of a second stage decodes every anchor."""
    with torch.inference_mode():
        got = port.model.dense_head(_before(jax_run, 'dense_head'))
    want = jax_run['after']['dense_head']
    assert tuple(got['batch_cls_preds'].shape) == \
        tuple(want['batch_cls_preds'].shape)
    for key in ('batch_cls_preds', 'batch_box_preds'):
        _close(got[key], want[key], key)


def test_roi_head_matches_jax(jax_run, port):
    with torch.inference_mode():
        got = port.model.roi_head(_before(jax_run, 'roi_head'))
    want = jax_run['after']['roi_head']
    for key in ('roi_valid', 'roi_labels'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert int(np.asarray(want['roi_valid']).sum()) > 2
    for key in ('rois', 'roi_scores', 'batch_cls_preds', 'batch_box_preds'):
        _close(got[key], want[key], key)


def test_pvrcnn_slice_matches_make_eval_step(jax_run, port):
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in jax_run['batch'].items()}
    before = ball_select.launches
    out = port.forward(batch)
    got = port.postprocess(out)
    assert ball_select.launches == before  # the CPU runs the exact paths
    want = jax_run['preds']
    np.testing.assert_array_equal(got['num_preds'].numpy(), want['num_preds'])
    assert (got['num_preds'] > 1).all()
    np.testing.assert_array_equal(got['pred_mask'].numpy(), want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'].numpy(),
                                  want['pred_labels'])
    _close(got['pred_scores'], want['pred_scores'], 'pred_scores')
    _close(got['pred_boxes'], want['pred_boxes'], 'pred_boxes')


def test_pvrcnn_converter_round_trip(jax_run, port):
    """Every flax leaf lands in the port's state_dict (strict load) and
    comes back unchanged."""
    assert set(port.model.state_dict()) == set(jax_run['state'])
    params, stats = state_dict_to_flax(port.model.state_dict(),
                                       jax_run['params'], jax_run['stats'])
    for got, want in ((params, jax_run['params']), (stats, jax_run['stats'])):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            np.testing.assert_array_equal(leaf, flat_want[path])


def test_pvrcnn_predict_from_clouds(port):
    """Raw clouds through the port's voxelizer and point padding."""
    from lidardetection_tpu_torch.datasets.synthetic import make_scene
    points, _, _ = make_scene(np.random.RandomState(5),
                              np.asarray(port.info['point_cloud_range']),
                              num_ground=3000)
    batch = port.make_batch([points])
    assert tuple(batch['points'].shape) == (1, 4000, 4)
    (result,) = port.predict([points])
    n = len(result['boxes'])
    assert 0 < n <= 16 and result['boxes'].shape == (n, 7)
    assert np.isfinite(result['boxes']).all()
    assert (np.diff(result['scores']) <= 0).all()
    assert set(np.unique(result['labels'])) <= {1, 2, 3}
