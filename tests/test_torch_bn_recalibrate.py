"""Precise-BN (``engine/bn_recalibrate.py``), port against the JAX package,
on the CPU in f32.

PointPillar and SECOND at the reduced sizes of test_torch_train_step.py,
with the JAX package's weights (random BatchNorm statistics, so every leaf
must move) carried across by ``flax_to_state_dict``, on the same 3 training
batches of the JAX package's own loader:

* every ``batch_stats`` leaf within 2e-3 of the leaf's largest magnitude
  of what ``recalibrate_bn_stats`` of the JAX package gives. The JAX
  function recovers each batch's statistics from two f32 EMA steps at
  momentum 0.99 with an estimated momentum and divides by 1 - m, so its
  own error is near 1e-3 of a leaf; the test prints the largest gap;
* every leaf within 1e-5 of the leaf's largest magnitude of the average of
  the per-batch statistics computed directly from each BatchNorm call's
  input (masked mean, biased variance; PillarVFE's from its points) in
  float64;
* parameters unchanged, the model left in eval mode, and a BatchNorm that
  no forward reaches keeps its statistics.
"""

import jax
import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import build_dataloader
from lidardetection_tpu.engine.bn_recalibrate import (
    recalibrate_bn_stats as jax_recalibrate,
)
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.parallel.train_step import device_batch, jit_init
from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.engine.bn_recalibrate import recalibrate_bn_stats
from lidardetection_tpu_torch.models import build_network
from lidardetection_tpu_torch.models.backbones_3d.vfe import PillarVFE
from lidardetection_tpu_torch.models.layers import MaskedBatchNorm
from lidardetection_tpu_torch.parallel import train_step
from test_torch_train_step import KEYS, _leaves, _randomize, _reduce
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

N_BATCHES = 3


@pytest.fixture(scope='module', params=['pointpillar', 'second'])
def jax_recal(request):
    name = request.param
    cfg_file = f'tools/cfgs/kitti_models/{name}.yaml'
    cfg = _reduce(jax_cfg_from_yaml(cfg_file), name)
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                       batch_size=2, training=True,
                                       num_scenes=2 * N_BATCHES, seed=4)
    host = [{k: np.asarray(b[k]) for k in KEYS} for b in loader]
    assert len(host) == N_BATCHES
    model = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                              dataset.dataset_info)
    variables = jax.device_get(jit_init(model, device_batch(host[0])))
    rng = np.random.RandomState(1)
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables['batch_stats'], rng)
    out = jax_recalibrate(model, {'params': params, 'batch_stats': stats},
                          host, device_batch, n_batches=N_BATCHES)
    return name, cfg_file, host, params, stats, jax.device_get(
        out['batch_stats'])


def _port_model(name, cfg_file, params, stats):
    cfg = _reduce(cfg_from_yaml_file(cfg_file), name)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES),
                          dataset_info(cfg.DATA_CONFIG))
    model.load_state_dict(flax_to_state_dict(params, stats))
    return model


def _vfe_statistics(module, batch):
    """PillarVFE's batch statistics from its input, in float64: the
    (V, P, 10) augmented points times ``pfn_kernel``, over every slot of
    the valid pillars (empty slots count as zeros)."""
    voxels = batch['voxels'].double()
    npts = batch['voxel_num_points']
    coords = batch['voxel_coords'].double()
    p = voxels.shape[2]
    valid = npts > 0
    mean_xyz = voxels[..., :3].sum(2) / npts.clamp(min=1)[..., None]
    vs, lo = module.voxel_size, module.point_cloud_range
    centers = torch.stack([coords[..., 2 - i] * vs[i] + vs[i] / 2 + lo[i]
                           for i in range(3)], -1)
    xyz = voxels[..., :3]
    aug = torch.cat([voxels, xyz - mean_xyz[:, :, None],
                     xyz - centers[:, :, None]], -1)
    slot = (torch.arange(p) < npts[..., None]) & valid[..., None]
    z = (aug * slot[..., None]) @ module.pfn_kernel.double()
    z = z[valid].reshape(-1, z.shape[-1])  # every slot of the valid pillars
    mean = z.mean(0)
    return mean, ((z - mean) ** 2).mean(0)


def _direct_statistics(model, batches):
    """{module name: (mean, var)} averaged over `batches`, each batch's taken
    in float64 from the inputs of the statistics holders' calls in a
    train-mode forward (nothing of the modules' own statistics code)."""
    per_batch = {}

    def hook(module, args, kwargs):
        if isinstance(module, PillarVFE):
            stats = _vfe_statistics(module, args[0])
        else:
            x = args[0].double()
            mask = kwargs.get('mask', args[1] if len(args) > 1 else None)
            xm = x.movedim(module.axis % x.dim(), -1)
            w = torch.ones(xm.shape[:-1], dtype=torch.float64) if mask is None \
                else mask.double().expand(xm.shape[:-1])
            xm, w = xm.reshape(-1, xm.shape[-1]), w.reshape(-1, 1)
            cnt = w.sum().clamp(min=1.0)
            mean = (xm * w).sum(0) / cnt
            stats = (mean, ((xm - mean) ** 2 * w).sum(0) / cnt)
        per_batch.setdefault(module, []).append(stats)

    holders = [m for m in model.modules()
               if isinstance(m, (MaskedBatchNorm, PillarVFE))]
    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in holders]
    model.train()
    try:
        with torch.no_grad():
            for batch in batches:
                model(batch)
    finally:
        for h in hooks:
            h.remove()
    assert all(len(v) == len(batches) for v in per_batch.values())
    names = {m: n for n, m in model.named_modules()}
    return {names[m]: tuple(torch.stack(s).mean(0) for s in zip(*v))
            for m, v in per_batch.items()}


def test_recalibrate_matches_jax_and_the_direct_average(jax_recal):
    name, cfg_file, host, params, stats, want_stats = jax_recal
    model = _port_model(name, cfg_file, params, stats)
    batches = [train_step.device_batch(b, 'cpu') for b in host]
    direct = _direct_statistics(_port_model(name, cfg_file, params, stats),
                                batches)
    before = {k: v.clone() for k, v in model.named_parameters()}

    out = recalibrate_bn_stats(model, batches, lambda b: b,
                               n_batches=N_BATCHES)
    assert out is model and not model.training
    for key, p in model.named_parameters():
        assert torch.equal(p, before[key]), key

    # the direct averages, laid out as the model's state
    modules = dict(model.named_modules())
    exact = dict(model.state_dict())
    for mod, values in direct.items():
        for buf, value in zip(modules[mod].bn_statistics, values):
            exact[f'{mod}.{buf}' if mod else buf] = value
    got_stats, exact_stats = state_dict_to_flax(model.state_dict(), want_stats,
                                                want_stats)[0], \
        state_dict_to_flax(exact, want_stats)[0]
    worst, strays = 0.0, []
    leaves = list(zip(_leaves(got_stats), _leaves(want_stats),
                      _leaves(exact_stats), _leaves(stats)))
    assert len(leaves) == 2 * len(direct)
    for (key, got), (_, want), (_, ex), (_, old) in leaves:
        top = np.abs(ex).max()
        assert not np.allclose(ex, old), key
        # tight: the port against the average of the per-batch statistics
        np.testing.assert_allclose(got, ex, rtol=0, atol=1e-5 * top,
                                   err_msg=key)
        gap = float(np.abs(got - want).max() / top)
        worst = max(worst, gap)
        if np.abs(want - ex).max() <= 1e-3 * top:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * top,
                                       err_msg=key)
        else:
            # the JAX estimate itself strays from the exact average here:
            # the whole gap to it must be that stray
            strays.append((key, gap))
            np.testing.assert_allclose(got - want, ex - want, rtol=0,
                                       atol=1e-5 * top, err_msg=key)
    print(f'{name}: largest gap to the JAX package {worst:.3e} of a leaf\'s '
          f'largest magnitude over {len(leaves)} leaves; leaves where the '
          f'JAX estimate strays over 1e-3 from the exact average: {strays}')
    assert len(strays) <= 2


def test_unreached_batchnorm_keeps_its_statistics(jax_recal):
    name, cfg_file, host, params, stats, _ = jax_recal
    model = _port_model(name, cfg_file, params, stats)
    spare = MaskedBatchNorm(4)
    spare.mean.fill_(0.25)
    spare.var.fill_(2.0)
    model.add_module('spare_bn', spare)  # no forward calls it
    momenta = {m: m.momentum for m in model.modules()
               if isinstance(m, MaskedBatchNorm)}
    batches = [train_step.device_batch(b, 'cpu') for b in host[:1]]
    recalibrate_bn_stats(model, batches, lambda b: b, n_batches=2)
    assert torch.equal(spare.mean, torch.full((4,), 0.25))
    assert torch.equal(spare.var, torch.full((4,), 2.0))
    assert all(m.momentum == mom for m, mom in momenta.items())
