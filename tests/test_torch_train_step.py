"""The training slice, port against the JAX package, on the CPU in f32.

PointPillar and SECOND at the reduced sizes of test_torch_pointpillar.py and
test_torch_second.py, on the JAX package's own training batch
(``build_dataloader(training=True)``, no augmentor) with converted weights:

  * the loss terms, every gradient leaf and the BatchNorm statistics after
    one step against the pieces of ``make_train_step`` (forward with
    ``mutable=['batch_stats']``, ``model.loss``, ``jax.value_and_grad``);
  * two optimizer steps run, the loss stays finite and parameters move;
  * a run that is interrupted, saved and resumed ends bit for bit where the
    uninterrupted run ends (parameters, statistics, moments, step).

Tolerances: loss terms 1e-4 relative. A gradient leaf agrees within 2e-3 of
its largest value (f32 sums in another order through 20-odd layers with
batch statistics); Adam would turn a tiny gradient of the wrong sign into a
full step, so parameters after a step are not compared here: the optimizer
is held against optax on given gradients in test_torch_optimization.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.parallel.train_step import device_batch, jit_init
from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.datasets.synthetic import (
    SyntheticScenes, SyntheticLoader,
)
from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows
from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
    rulebook_conv, rulebook_conv_dw,
)
from lidardetection_tpu_torch.parallel import train_step
from lidardetection_tpu_torch.train import Trainer
from lidardetection_tpu_torch.utils.checkpoint import latest_checkpoint
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

KEYS = ('voxels', 'voxel_coords', 'voxel_num_points', 'num_voxels', 'gt_boxes')


def _reduce(cfg, name):
    data = cfg.DATA_CONFIG
    data.DATASET = 'SyntheticDataset'
    if 'DATA_AUGMENTOR' in data:
        del data.DATA_AUGMENTOR
    vox = [p for p in data.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    m = cfg.MODEL
    m.COMPUTE_DTYPE = 'float32'
    if name == 'pointpillar':  # the size of test_torch_pointpillar.py
        data.POINT_CLOUD_RANGE = [0, -40.96, -3, 71.68, 40.96, 1]
        data.MAX_POINTS = 24000
        vox.VOXEL_SIZE = [0.64, 0.64, 4]
        vox.MAX_NUMBER_OF_VOXELS = {'train': 6000, 'test': 6000}
        m.VFE.NUM_FILTERS = [32]
        m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
        m.BACKBONE_2D.LAYER_NUMS = [1, 1, 1]
        m.BACKBONE_2D.NUM_FILTERS = [32, 32, 64]
        m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [32, 32, 32]
    else:  # the size of test_torch_second.py, with a shallower 2D backbone
        data.MAX_POINTS = 8000
        vox.VOXEL_SIZE = [0.2, 0.2, 0.1]
        vox.MAX_NUMBER_OF_VOXELS = {'train': 2000, 'test': 2000}
        m.BACKBONE_2D.LAYER_NUMS = [1, 1]
    return cfg


def _randomize(tree, rng):
    """Random BN affines and running statistics."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, 'items'):
            out[key] = _randomize(value, rng)
        elif key in ('scale', 'var', 'pfn_bn_scale', 'pfn_var'):
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ('bias', 'mean', 'pfn_bn_bias', 'pfn_mean'):
            out[key] = (rng.randn(*value.shape) * 0.1).astype(np.float32)
        else:
            out[key] = np.asarray(value)
    return out


def _leaves(tree, prefix=''):
    for key, value in tree.items():
        if hasattr(value, 'items'):
            yield from _leaves(value, f'{prefix}{key}/')
        else:
            yield prefix + key, np.asarray(value)


@pytest.fixture(scope='module', params=['pointpillar', 'second'])
def jax_step(request):
    """One training step's pieces in the JAX package."""
    name = request.param
    cfg_file = f'tools/cfgs/kitti_models/{name}.yaml'
    cfg = _reduce(jax_cfg_from_yaml(cfg_file), name)
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=True,
                                       num_scenes=2, seed=3)
    batch = device_batch(next(iter(loader)))
    assert not any(k.startswith('rb_') for k in batch)
    assert (np.asarray(batch['gt_boxes'])[..., -1] > 0).sum() > 4
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    variables = jax.device_get(jit_init(model, batch))
    rng = np.random.RandomState(0)
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)

    def loss_fn(p):
        out, mutated = model.apply({'params': p, 'batch_stats': stats}, batch,
                                   training=True, mutable=['batch_stats'])
        loss, tb = model.apply({'params': p, 'batch_stats': stats}, out,
                               method=model.loss)
        return loss, (tb, mutated['batch_stats'],
                      out['anchor_head_fwd']['box_cls_labels'])

    (_, (tb, new_stats, labels)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    host = {k: np.asarray(batch[k]) for k in KEYS}
    return (name, cfg_file, host, params, stats,
            jax.device_get((tb, new_stats, labels, grads)))


def _trainer(name, cfg_file, params, stats, **kwargs):
    cfg = _reduce(cfg_from_yaml_file(cfg_file), name)
    return Trainer(cfg, device='cpu',
                   state_dict=flax_to_state_dict(params, stats), **kwargs)


def test_one_step_matches_make_train_step_pieces(jax_step):
    name, cfg_file, host, params, stats, (tb, new_stats, labels, grads) = jax_step
    trainer = _trainer(name, cfg_file, params, stats, total_steps=4)
    assert trainer.model.training
    batch = train_step.device_batch(host, 'cpu')
    counters = (rulebook_conv, rulebook_conv_dw, scatter_rows)
    before = [k.launches for k in counters]
    out = trainer.model(batch)
    loss, got_tb = trainer.model.loss(out)
    loss.backward()
    # CPU tensors: every wrapper took its plain version
    assert [k.launches for k in counters] == before

    np.testing.assert_array_equal(
        out['anchor_head_fwd']['box_cls_labels'].numpy(), labels)
    assert (labels > 0).sum() > 10 and (labels == -1).sum() > 0
    assert set(got_tb) == set(tb) == {'rpn_loss_cls', 'rpn_loss_loc',
                                      'rpn_loss_dir', 'rpn_loss', 'loss'}
    for key, want in tb.items():
        np.testing.assert_allclose(float(got_tb[key].detach()), float(want), rtol=1e-4,
                                   err_msg=key)

    got_stats, = state_dict_to_flax(trainer.model.state_dict(), new_stats)
    moved = 0
    for (key, got), (_, want), (_, old) in zip(
            _leaves(got_stats), _leaves(new_stats), _leaves(stats)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=key)
        moved += int(not np.array_equal(got, old))
    assert moved == len(list(_leaves(stats)))  # every statistic moved, once

    named = dict(trainer.model.named_parameters())
    assert all(p.grad is not None for p in named.values())
    got_grads, = state_dict_to_flax({k: p.grad for k, p in named.items()}, grads)
    n_leaves = 0
    for (key, got), (_, want) in zip(_leaves(got_grads), _leaves(grads)):
        assert got.shape == want.shape, key
        top = np.abs(want).max()
        assert top > 0, key
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * top,
                                   err_msg=key)
        n_leaves += 1
    assert n_leaves == len(named)


def test_two_steps_run_and_move_parameters(jax_step):
    name, cfg_file, host, params, stats, _ = jax_step
    trainer = _trainer(name, cfg_file, params, stats, total_steps=4)
    batch = train_step.device_batch(host, 'cpu')
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for i in range(2):
        tb = trainer.step(batch)
        assert np.isfinite(float(tb['loss'])) and float(tb['loss']) > 0
        assert trainer.state.step == i + 1
    after = trainer.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.isfinite(v).all() for v in after.values())
    assert all(not p.requires_grad or p.grad is not None
               for p in trainer.model.parameters())


class _ListLoader:
    """Prebuilt host batches; raises in `crash_epoch` to interrupt a run."""

    def __init__(self, batches, crash_epoch=None):
        self.batches, self.crash_epoch, self.epoch = batches, crash_epoch, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        if self.epoch == self.crash_epoch:
            raise KeyboardInterrupt('interrupted')
        return iter(self.batches)


def test_resume_reproduces_the_uninterrupted_run(jax_step, tmp_path):
    name, cfg_file, host, params, stats, _ = jax_step
    other = {k: v[::-1].copy() for k, v in host.items()}

    def run(ckpt_dir, crash_epoch=None):
        trainer = _trainer(name, cfg_file, params, stats)
        with pytest.raises(RuntimeError, match='total_steps'):
            trainer.step(host)
        trainer.fit(_ListLoader([host, other], crash_epoch), ckpt_dir,
                    total_epochs=3, max_ckpt_save_num=2)
        return trainer.state

    whole = run(tmp_path / 'whole').state_dict()
    assert whole['step'] == 6
    # rotation kept the two newest checkpoints
    assert sorted(p.name for p in (tmp_path / 'whole').iterdir()) == [
        'checkpoint_epoch_2.pth', 'checkpoint_epoch_3.pth']

    with pytest.raises(KeyboardInterrupt):
        run(tmp_path / 'cut', crash_epoch=2)
    assert latest_checkpoint(tmp_path / 'cut').endswith('checkpoint_epoch_2.pth')
    (tmp_path / 'cut' / 'checkpoint_epoch_3.pth.77.tmp').write_bytes(b'torn')
    resumed = run(tmp_path / 'cut').state_dict()  # epoch 3 only

    assert resumed['step'] == whole['step']
    for key, want in whole['model'].items():
        assert torch.equal(resumed['model'][key], want), key
    for kind in ('mu', 'nu'):
        for key, want in whole['optimizer'][kind].items():
            assert torch.equal(resumed['optimizer'][kind][key], want), key


def test_trainer_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Trainer('tools/cfgs/kitti_models/second.yaml')


def test_synthetic_training_set_and_make_batch():
    """The port's own scenes through `make_batch`: the step's keys at the
    train cap, gt padded with class 0, the JAX package's scene draws."""
    from lidardetection_tpu.datasets.synthetic import make_scene as jax_make_scene

    cfg = _reduce(cfg_from_yaml_file('tools/cfgs/kitti_models/second.yaml'),
                  'second')
    trainer = Trainer(cfg, device='cpu', total_steps=2)
    dataset = SyntheticScenes(trainer.class_names,
                               trainer.info['point_cloud_range'],
                               num_scenes=4, seed=2, max_gt_boxes=16)
    points, gt = dataset[1]
    want_points, want_gt, _ = jax_make_scene(
        np.random.RandomState(2 * 100003 + 1),
        np.asarray(trainer.info['point_cloud_range'], np.float32))
    np.testing.assert_array_equal(points, want_points)
    n = int((gt[:, 7] > 0).sum())
    assert 0 < n <= len(want_gt) and (gt[n:] == 0).all()
    assert set(gt[:n, 7]) <= {1.0, 2.0, 3.0}
    loader = SyntheticLoader(dataset, 2, trainer.make_batch, seed=0)
    assert len(loader) == 2
    batch = next(iter(loader))
    # with the training plan's host rulebooks, transposed ones included
    assert set(batch) == set(KEYS) | set(trainer.plan.batch_keys())
    assert 'rb_down2_bwd' in batch and batch['rb_down2_bwd'].dtype == torch.int32
    assert tuple(batch['voxels'].shape) == (2, 2000, 5, 4)
    assert tuple(batch['gt_boxes'].shape) == (2, 16, 8)
    tb = trainer.step(batch)
    assert np.isfinite(float(tb['loss']))


def test_strided_input_gradient_runs_on_the_transposed_rulebooks(monkeypatch):
    """A SECOND step on the training plan never takes the plain scatter-add
    for a strided layer's input gradient (K3 over ``rb_<name>_bwd``, its
    plain version here); every gradient leaf is within 1e-5 of its largest
    value of the same step on the device-built rulebooks, whose strided
    layers take the scatter-add."""
    from lidardetection_tpu_torch.ops import sparse

    cfg = _reduce(cfg_from_yaml_file('tools/cfgs/kitti_models/second.yaml'),
                  'second')
    dataset = SyntheticScenes(('Car', 'Pedestrian', 'Cyclist'),
                               dataset_info(cfg['DATA_CONFIG'])
                               ['point_cloud_range'], num_scenes=2, seed=5,
                               max_gt_boxes=16)
    scenes = [dataset[i] for i in range(2)]
    grads = []
    plain_calls = []
    real = sparse._conv_input_grad_plain

    def counted(*args, **kwargs):
        plain_calls.append(1)
        return real(*args, **kwargs)

    for host in (True, False):
        trainer = Trainer(cfg, device='cpu', seed=1, total_steps=2)
        batch = trainer.make_batch(scenes)
        if host:
            assert {'rb_down2_bwd', 'rb_down3_bwd', 'rb_down4_bwd',
                    'rb_out_bwd'} <= set(batch)
            monkeypatch.setattr(sparse, '_conv_input_grad_plain',
                                _refuse_scatter_add)
        else:
            batch = {k: v for k, v in batch.items() if not k.startswith('rb_')}
            monkeypatch.setattr(sparse, '_conv_input_grad_plain', counted)
        loss, _ = trainer.model.loss(trainer.model(batch))
        loss.backward()
        grads.append({k: p.grad for k, p in trainer.model.named_parameters()})
    assert len(plain_calls) == 4  # the device path: down2, down3, down4, out
    n_sparse = 0
    for key, want in grads[1].items():
        top = float(want.abs().max())
        assert top > 0, key
        torch.testing.assert_close(grads[0][key], want, rtol=0,
                                   atol=1e-5 * top, msg=key)
        n_sparse += key.startswith('backbone_3d.')
    assert n_sparse > 0


def _refuse_scatter_add(*args, **kwargs):
    raise AssertionError('a strided layer took the plain scatter-add df')
