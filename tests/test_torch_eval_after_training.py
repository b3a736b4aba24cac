"""The eval after a short training run, port against the JAX package, on
the CPU: the non-finite boxes that a card run's eval gives after a few
steps are the reference's.

A reduced SECOND (tests/test_torch_train_step.py::_reduce: 0.2 m voxels,
2000-voxel cap, f32, two 2D stages of one layer) trains STEPS steps at
LR in the port from seed 0 (adam_onecycle, B = 2, the port's synthetic
scenes made from a numpy seed). Its BatchNorm running statistics
(momentum 0.99) then hold 1 - 0.99^6 = 5.9% of the batch statistics of
weights that moved far, so the eval forward's head outputs reach ~1e4 and
the decode's ``exp`` overflows in about a thousand anchor rows of a batch
(SCORE_THRESH 0.001, as chip_smoke's training CLI phase sets it). The
state goes to the JAX package (``convert.state_dict_to_flax``) and both
evaluate the JAX package's own eval batch and loader:

  * every anchor row's decoded box (the forward's ``decode_box_fn`` over
    all rows): the non-finite mask equal row for row, the finite boxes
    within 2e-3 of max(1, |value|) (activations of ~1e4 summed in
    another order differ by ~1e-4 of them);
  * ``make_eval_step``: the kept rows (``pred_mask``, ``num_preds``,
    labels) equal, the non-finite mask of the kept boxes equal, the finite
    kept boxes within 2e-3 of max(1, |value|), the scores within 1e-4, the
    recall counters equal;
  * ``eval_one_epoch`` over the loader: the annos (names, scores, the
    boxes' non-finite masks, the finite boxes) and the recall and AP keys
    of the KITTI evaluation equal.

So the port follows the reference: JAX's decode overflows at the same
rows (ROADMAP section 3, properties of the JAX package), and no clamp is
added. The cause is held too: the same weights with every BatchNorm
taking the eval batch's own statistics decode every row finite, and
precise-BN's population statistics over the training batches
(``engine/bn_recalibrate.py``, held against JAX's in
test_torch_bn_recalibrate.py) leave fewer rows overflowing than the
running statistics do, but not none.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.engine.evaluator import eval_one_epoch as jax_eval_one_epoch
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.parallel.train_step import (
    device_batch, jit_init, make_eval_step as jax_make_eval_step,
)
from lidardetection_tpu_torch.config import cfg_from_yaml_file
from lidardetection_tpu_torch.convert import state_dict_to_flax
from lidardetection_tpu_torch.datasets import synthetic
from lidardetection_tpu_torch.engine.bn_recalibrate import recalibrate_bn_stats
from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
from lidardetection_tpu_torch.models.layers import MaskedBatchNorm
from lidardetection_tpu_torch.parallel import train_step
from lidardetection_tpu_torch.train import Trainer
from test_torch_train_step import _reduce
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CFG = 'tools/cfgs/kitti_models/second.yaml'
STEPS, LR = 6, 0.01
EVAL_SCENES, EVAL_SEED = 4, 3
KEYS = ('voxels', 'voxel_coords', 'voxel_num_points', 'num_voxels',
        'gt_boxes')


def _cfg(cfg):
    cfg = _reduce(cfg, 'second')
    cfg.OPTIMIZATION.LR = LR
    post = cfg.MODEL.POST_PROCESSING
    post.SCORE_THRESH = 0.001
    post.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    post.NMS_CONFIG.NMS_POST_MAXSIZE = 32
    return cfg


def _decoded_rows(out, arange):
    """Every anchor row's decoded box from a forward's output (either
    package, `arange` its ``arange``): ``decode_box_fn`` over all rows."""
    nc, code, nd = out['head_raw_sizes']
    h, w, na = out['head_layout']
    fused = out['batch_fused_preds']
    rows = fused.reshape(fused.shape[0], h * w * na, nc + code + nd)
    anchors = out['anchor_from_idx'](arange(rows.shape[1]))[None]
    return out['decode_box_fn'](rows[..., nc:nc + code], rows[..., nc + code:],
                                anchors)


def _port_rows(model, host):
    """The port's decoded boxes of every anchor row of `host`."""
    with torch.inference_mode():
        return _decoded_rows(model(host), torch.arange)


@pytest.fixture(scope='module')
def short_run():
    """The port's state after STEPS steps, and both packages' evals of it
    on the JAX package's eval batch and loader."""
    pcfg = _cfg(cfg_from_yaml_file(CFG))
    trainer = Trainer(pcfg, device='cpu', seed=0, total_steps=STEPS)
    scenes = trainer.dataset(2 * STEPS, seed=1)
    train_batches = [trainer.make_batch([scenes[2 * s], scenes[2 * s + 1]])
                     for s in range(STEPS)]
    for batch in train_batches:
        tb = trainer.step(batch)
    assert np.isfinite(float(tb['loss']))
    model = trainer.model.eval()

    jcfg = _cfg(jax_cfg_from_yaml(CFG))
    dataset, loader = build_dataloader(
        jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2, training=False,
        num_scenes=EVAL_SCENES, seed=EVAL_SEED)
    batch = device_batch(next(iter(loader)))
    jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES),
                               jcfg.CLASS_NAMES, dataset.dataset_info)
    variables = jax.device_get(jit_init(jmodel, batch))
    params, stats = state_dict_to_flax(model.state_dict(), variables['params'],
                                       variables['batch_stats'])

    def jax_rows(p, s, b):
        return _decoded_rows(jmodel.apply({'params': p, 'batch_stats': s}, b,
                                          training=False), jnp.arange)

    want = {
        'boxes': np.asarray(jax.jit(jax_rows)(params, stats, batch)),
        'preds': jax.device_get(jax_make_eval_step(
            jmodel, jcfg.MODEL.POST_PROCESSING, 3)(params, stats, batch)),
    }
    logger = logging.getLogger('test_torch_eval_after_training')
    want['epoch'] = jax_eval_one_epoch(
        jmodel, {'params': params, 'batch_stats': stats}, loader,
        jcfg.MODEL.POST_PROCESSING, jcfg.CLASS_NAMES, logger)

    host = {k: torch.from_numpy(np.asarray(batch[k])) for k in KEYS}
    _, ploader = synthetic.build_test_loader(pcfg, 2, EVAL_SCENES,
                                             seed=EVAL_SEED)
    got = {
        'boxes': _port_rows(model, host).numpy(),
        'preds': train_step.make_eval_step(
            model, pcfg.MODEL.POST_PROCESSING, 3)(host),
        'epoch': eval_one_epoch(model, ploader, pcfg.MODEL.POST_PROCESSING,
                                list(pcfg.CLASS_NAMES), logger),
    }
    return trainer, train_batches, host, pcfg, got, want


def _finite_close(got, want, err_msg=''):
    """Same non-finite rows; the finite rows within 2e-3 of max(1, |want|)."""
    bad_got = ~np.isfinite(got).all(-1)
    bad_want = ~np.isfinite(want).all(-1)
    np.testing.assert_array_equal(bad_got, bad_want, err_msg=err_msg)
    ok = ~bad_want
    np.testing.assert_array_less(
        np.abs(got[ok] - want[ok]), 2e-3 * np.maximum(1.0, np.abs(want[ok])),
        err_msg=err_msg)
    return int(bad_want.sum()), int(ok.sum())


def test_decoded_boxes_overflow_at_the_same_rows(short_run):
    *_, got, want = short_run
    bad, ok = _finite_close(got['boxes'], want['boxes'])
    # a thousand of the 2 x 13200 anchor rows overflow in both packages
    assert 500 < bad < ok


def test_eval_step_keeps_the_same_rows(short_run):
    *_, got, want = short_run
    g, w = got['preds'], want['preds']
    for key in ('num_preds', 'pred_mask', 'pred_labels'):
        np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]),
                                      err_msg=key)
    mask = np.asarray(w['pred_mask'])
    bad, ok = _finite_close(g['pred_boxes'].numpy()[mask],
                            np.asarray(w['pred_boxes'])[mask])
    assert bad > 0 and ok > 0  # kept boxes of both kinds
    np.testing.assert_allclose(g['pred_scores'].numpy()[mask],
                               np.asarray(w['pred_scores'])[mask], rtol=0,
                               atol=1e-4)
    assert {k: int(v) for k, v in g['recall'].items()} == \
        {k: int(v) for k, v in w['recall'].items()}


def test_kitti_evaluation_equals_jax(short_run):
    *_, got, want = short_run
    (result, annos), (want_result, want_annos) = got['epoch'], want['epoch']
    assert len(annos) == len(want_annos) == EVAL_SCENES
    n_bad = 0
    for a, w in zip(annos, want_annos):
        assert int(a['frame_id']) == int(w['frame_id'])
        np.testing.assert_array_equal(a['name'], w['name'])
        np.testing.assert_allclose(a['score'], w['score'], rtol=0, atol=1e-4)
        n_bad += _finite_close(a['boxes_lidar'], w['boxes_lidar'])[0]
    assert n_bad > 0
    assert set(result) == set(want_result)
    for key, value in want_result.items():
        if key.startswith('recall/') or key.endswith('_R40'):
            assert result[key] == value, key


def _overflowing_rows(model, host):
    """The anchor rows of `host` whose decoded box is not finite."""
    return int((~torch.isfinite(_port_rows(model, host)).all(-1)).sum())


def test_the_batch_statistics_make_every_box_finite(short_run):
    """The cause: the eval normalizes with statistics that are not the
    batch's own. The same weights with every BatchNorm taking the eval
    batch's own statistics (train-mode BatchNorm, the heads in eval mode)
    decode every anchor row finite; with precise-BN's population
    statistics over the six training batches fewer rows overflow than
    with the running statistics (5.9% of the batch statistics after six
    steps at momentum 0.99), but some still do: at this state the network
    amplifies any mismatch between the statistics it normalizes with and
    the batch's."""
    trainer, train_batches, host, pcfg, got, _ = short_run
    running = int((~np.isfinite(got['boxes']).all(-1)).sum())

    def fresh():
        return Trainer(pcfg, device='cpu', seed=0, total_steps=STEPS,
                       state_dict=trainer.model.state_dict()).model.eval()

    own = fresh()
    for m in own.modules():
        if isinstance(m, MaskedBatchNorm):
            m.train()
    assert _overflowing_rows(own, host) == 0
    precise = recalibrate_bn_stats(fresh(), train_batches, lambda b: b,
                                   n_batches=len(train_batches))
    assert 0 < _overflowing_rows(precise, host) < running
