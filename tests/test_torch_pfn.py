"""The general PillarVFE path (the PFN stack), port against the JAX
package's ``PillarVFE``, on the CPU in f32.

The NuScenes pillars have 5 point features (x, y, z, intensity,
timestamp), so cbgs_pp_multihead.yaml takes this path and not K1's. Each
case gives both packages the same (B, V, P, 5) pillars, made from a numpy
seed (a quarter of the pillars empty, the rest with 1..P points), and the
same converted weights: 5 features with NUM_FILTERS [64] and [64, 64],
with and without the BatchNorm (USE_NORM), with WITH_DISTANCE and with
relative xyz (USE_ABSLOTE_XYZ false). In eval the pillar features agree
within 1e-5 and 1e-6 relative (the absolute coordinates reach 51 m, where
a float32 ulp is 4e-6); in training too, and the BatchNorm statistics
within 1e-5 and the gradient of a random projection of the features, leaf
by leaf, within 1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.models.backbones_3d.vfe import PillarVFE as JaxPillarVFE
from lidardetection_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from lidardetection_tpu_torch.models.backbones_3d.vfe import PillarVFE

VOXEL = (0.2, 0.2, 8.0)
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
B, V, P = 2, 96, 10

CASES = {
    'one_layer': {'NUM_FILTERS': [64]},
    'two_layers': {'NUM_FILTERS': [64, 64]},
    'no_norm_distance': {'NUM_FILTERS': [32, 64], 'USE_NORM': False,
                         'WITH_DISTANCE': True},
    'relative_xyz': {'NUM_FILTERS': [64], 'USE_ABSLOTE_XYZ': False,
                     'WITH_DISTANCE': True},
}


def _pillars(rng):
    coords = np.full((B, V, 3), -1, np.int32)
    npts = np.zeros((B, V), np.int32)
    voxels = np.zeros((B, V, P, 5), np.float32)
    for b in range(B):
        live = int(V * 0.75)
        cells = rng.choice(512 * 512, live, replace=False)
        coords[b, :live] = np.stack([np.zeros(live), cells // 512, cells % 512],
                                    axis=1)
        npts[b, :live] = rng.randint(1, P + 1, live)
        for v in range(live):
            n = npts[b, v]
            x = PC_RANGE[0] + (coords[b, v, 2] + rng.rand(n)) * VOXEL[0]
            y = PC_RANGE[1] + (coords[b, v, 1] + rng.rand(n)) * VOXEL[1]
            z = rng.uniform(-3, 1, n)
            voxels[b, v, :n] = np.stack(
                [x, y, z, rng.rand(n), rng.choice([0.0, 0.05, 0.4], n)], 1)
    return {'voxels': voxels, 'voxel_num_points': npts, 'voxel_coords': coords}


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


def _leaves(tree, prefix=''):
    for key, value in tree.items():
        if hasattr(value, 'items'):
            yield from _leaves(value, f'{prefix}{key}/')
        else:
            yield prefix + key, np.asarray(value)


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    cfg = {'NAME': 'PillarVFE', **CASES[request.param]}
    rng = np.random.RandomState(0)
    batch = _pillars(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxPillarVFE(model_cfg=cfg, num_point_features=5, voxel_size=VOXEL,
                         point_cloud_range=PC_RANGE)
    variables = jax.device_get(jax.jit(lambda b: model.init(
        jax.random.PRNGKey(0), b, training=False))(jbatch))
    params = _randomize(variables['params'], rng)
    stats = _randomize(variables.get('batch_stats', {}), rng)
    c_out = cfg['NUM_FILTERS'][-1]
    proj = rng.randn(B, V, c_out).astype(np.float32)

    def run(p, training):
        out, mutated = model.apply(
            {'params': p, 'batch_stats': stats}, jbatch, training=training,
            mutable=['batch_stats'])
        feats = out['pillar_features']
        return (feats * proj).sum(), (feats, mutated.get('batch_stats', {}))

    evaluated = jax.device_get(jax.jit(lambda p: run(p, False)[1][0])(params))
    (_, (feats, new_stats)), grads = jax.jit(jax.value_and_grad(
        lambda p: run(p, True), has_aux=True))(params)
    return (cfg, batch, params, stats, proj, evaluated,
            jax.device_get((feats, new_stats, grads)))


def _port(cfg, params, stats):
    vfe = PillarVFE(cfg, 5, VOXEL, PC_RANGE)
    state = flax_to_state_dict(params, stats)
    vfe.load_state_dict(state)
    assert not vfe.fast and len(state) == len(vfe.state_dict())
    return vfe


def test_eval_features_match_jax(case):
    cfg, batch, params, stats, _, want, _ = case
    vfe = _port(cfg, params, stats).eval()
    with torch.no_grad():
        out = vfe({k: torch.from_numpy(v) for k, v in batch.items()})
    got = out['pillar_features'].numpy()
    assert got.shape == want.shape == (B, V, cfg['NUM_FILTERS'][-1])
    assert (got[batch['voxel_num_points'] == 0] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_training_features_statistics_and_gradients_match_jax(case):
    cfg, batch, params, stats, proj, _, (want, new_stats, grads) = case
    vfe = _port(cfg, params, stats).train()
    out = vfe({k: torch.from_numpy(v) for k, v in batch.items()})
    feats = out['pillar_features']
    np.testing.assert_allclose(feats.detach().numpy(), want, rtol=1e-6,
                               atol=1e-5)
    (feats * torch.from_numpy(proj)).sum().backward()
    if new_stats:
        got_stats, = state_dict_to_flax(vfe.state_dict(), new_stats)
        for (key, g), (_, w) in zip(_leaves(got_stats), _leaves(new_stats)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=key)
    named = {k: p.grad for k, p in vfe.named_parameters()}
    got_grads, = state_dict_to_flax(named, grads)
    n = 0
    for (key, g), (_, w) in zip(_leaves(got_grads), _leaves(grads)):
        assert np.linalg.norm(w) > 0, key
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), key
        n += 1
    assert n == len(named)
