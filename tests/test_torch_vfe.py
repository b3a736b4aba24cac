"""K1 pillar_vfe (port) against the JAX package's fused VFE kernel and
PillarVFE module, on the CPU.

The plain version is held against ``pillar_vfe_fused`` run in interpret
mode, as tests/test_vfe_fused.py runs it: both round the centered points
and W4 to bf16 and accumulate in f32, so they agree to f32 rounding
(atol 1e-5). The module is held against the JAX module in f32 compute
(atol 1e-5: the same f32 math, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.models.backbones_3d.vfe import PillarVFE as JaxPillarVFE
from lidardetection_tpu.ops.voxelize import voxelize_np
from lidardetection_tpu.ops.vfe_tpu import pillar_vfe_fused
from lidardetection_tpu_torch.convert import flax_to_state_dict
from lidardetection_tpu_torch.datasets.synthetic import make_scene
from lidardetection_tpu_torch.models.backbones_3d.vfe import PillarVFE
from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe, pillar_vfe_plain

PC_RANGE = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
VOXEL = (0.16, 0.16, 4.0)
VFE_CFG = {'NAME': 'PillarVFE', 'WITH_DISTANCE': False,
           'USE_ABSLOTE_XYZ': True, 'USE_NORM': True, 'NUM_FILTERS': [64]}


def _kernel_inputs(seed, b, v, p, c):
    rng = np.random.RandomState(seed)
    vox = rng.randn(b, v, p, 4).astype(np.float32)
    counts = rng.randint(0, p + 1, (b, v)).astype(np.int32)
    counts[0, :5] = [0, p, 1, p - 1, 0]  # empty, full and edge pillars
    vox *= (np.arange(p)[None, None, :] < counts[..., None])[..., None]
    ctr = np.concatenate([rng.randn(b, v, 3), np.zeros((b, v, 1))],
                         -1).astype(np.float32)
    pb = (rng.randn(b, v, c) * 0.1).astype(np.float32)
    w4 = (rng.randn(4, c) * 0.2).astype(np.float32)
    shift = (rng.randn(c) * 0.1).astype(np.float32)
    return vox, ctr, pb, counts, w4, shift


@pytest.mark.parametrize('p', [16, 32])
def test_plain_matches_pallas_interpret(p):
    vox, ctr, pb, counts, w4, shift = _kernel_inputs(p, 2, 600, p, 64)
    want = pillar_vfe_fused(jnp.asarray(vox), jnp.asarray(ctr),
                            jnp.asarray(pb), jnp.asarray(counts),
                            jnp.asarray(w4), jnp.asarray(shift),
                            out_dtype=jnp.float32, interpret=True)
    got = pillar_vfe_plain(
        torch.from_numpy(vox), torch.from_numpy(ctr), torch.from_numpy(pb),
        torch.from_numpy(counts), torch.from_numpy(w4).to(torch.bfloat16),
        torch.from_numpy(shift), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
def test_wrapper_takes_plain_version_on_cpu(out_dtype):
    args = [torch.from_numpy(a) for a in _kernel_inputs(3, 1, 300, 20, 48)]
    args[4] = args[4].to(out_dtype)
    before = pillar_vfe.launches
    got = pillar_vfe(*args, out_dtype=out_dtype)
    assert pillar_vfe.launches == before  # no kernel launch for CPU tensors
    assert got.dtype == out_dtype and got.shape == (1, 300, 48)
    torch.testing.assert_close(got, pillar_vfe_plain(*args, out_dtype=out_dtype),
                               rtol=0, atol=0)
    # an empty pillar gives relu(shift), a full one ignores it
    torch.testing.assert_close(got[0, 0].float(),
                               torch.relu(args[5]).to(out_dtype).float())


def test_pillar_vfe_module_matches_jax():
    rng = np.random.RandomState(0)
    points, _, _ = make_scene(rng, np.asarray(PC_RANGE, np.float32),
                              num_ground=4000)
    tables = [voxelize_np(points, PC_RANGE, VOXEL, 32, 3000)]
    batch = {'voxels': np.stack([t[0] for t in tables]),
             'voxel_coords': np.stack([t[1] for t in tables]),
             'voxel_num_points': np.stack([t[2] for t in tables])}

    jax_vfe = JaxPillarVFE(model_cfg=VFE_CFG, num_point_features=4,
                           voxel_size=VOXEL, point_cloud_range=PC_RANGE)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.device_get(jax_vfe.init(jax.random.PRNGKey(0), jbatch))
    params = dict(variables['params'])
    stats = dict(variables['batch_stats'])
    params['pfn_bn_scale'] = rng.uniform(0.5, 2, 64).astype(np.float32)
    params['pfn_bn_bias'] = (rng.randn(64) * 0.2).astype(np.float32)
    stats['pfn_mean'] = (rng.randn(64) * 0.1).astype(np.float32)
    stats['pfn_var'] = rng.uniform(0.5, 2, 64).astype(np.float32)
    want = jax_vfe.apply({'params': params, 'batch_stats': stats}, jbatch)

    vfe = PillarVFE(VFE_CFG, 4, VOXEL, PC_RANGE).eval()
    vfe.load_state_dict(flax_to_state_dict(params, stats))
    with torch.inference_mode():
        got = vfe({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got['pillar_features'].numpy(),
                               np.asarray(want['pillar_features']),
                               rtol=0, atol=1e-5)
    assert (got['pillar_features'][0, batch['voxel_num_points'][0] == 0]
            == 0).all()
