"""The host sparse plan (ops/sparse_plan.py, native/rulebooks.cpp) and the
eval loader's bucketing against the JAX package's ops/sparse_plan.py and
``DataLoader._bucket``, on the CPU. No JAX model is compiled: both sides
are numpy and host C++.

Every table is integer and must be equal bit for bit: the plan's ops and
batch keys, each scan's rulebooks and stage tables from the port's host
library and from its numpy plain version, and a bucketed batch.
"""

import numpy as np
import pytest
import torch

from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets import DataLoader as JaxDataLoader
from lidardetection_tpu.ops import sparse_plan as jax_plan
from lidardetection_tpu_torch import native
from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
from lidardetection_tpu_torch.datasets.synthetic import (
    bucket_voxels, build_test_loader, make_scene,
)
from lidardetection_tpu_torch.ops import sparse, sparse_plan
from lidardetection_tpu_torch.ops.voxelize import build_batch

CFGS = {name: f'tools/cfgs/kitti_models/{name}.yaml'
        for name in ('second', 'pv_rcnn', 'PartA2')}


@pytest.mark.parametrize('training', [False, True], ids=['test', 'train'])
@pytest.mark.parametrize('name', sorted(CFGS))
def test_plan_equals_jax_backbone_plan(name, training):
    """The plan of each sparse config, its batch keys and its bucket spec;
    `config_plan` takes the split's cap as set_sparse_plan does."""
    port = sparse_plan.config_plan(cfg_from_yaml_file(CFGS[name]), training)
    jcfg = jax_cfg_from_yaml(CFGS[name])
    vox = [p for p in jcfg.DATA_CONFIG.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    cap = vox.MAX_NUMBER_OF_VOXELS['train' if training else 'test']
    want = jax_plan.backbone_plan(
        jcfg.MODEL, dataset_info(cfg_from_yaml_file(CFGS[name]).DATA_CONFIG)
        ['grid_size'], cap, training=training)
    assert [tuple(op) for op in port.ops] == [tuple(op) for op in want.ops]
    assert port.spatial_shape == want.spatial_shape == (41, 1600, 1408)
    assert port.cap_in == want.cap_in == cap
    assert port.batch_keys() == want.batch_keys()
    assert port.bucket_spec() == want.bucket_spec()
    assert np.array_equal(sparse_plan._plan_records(port),
                          jax_plan._plan_records(want))
    bwd = [k for k in port.batch_keys() if k.endswith('_bwd')]
    assert bwd == (['rb_down2_bwd', 'rb_down3_bwd', 'rb_down4_bwd',
                    'rb_out_bwd'] if training else [])
    if name == 'PartA2':  # UNetV2's inverse convs and its rewind
        assert [op.type for op in port.ops].count('inv') == 3 + len(bwd)


def test_no_plan_without_a_sparse_backbone():
    cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/pointpillar.yaml')
    assert sparse_plan.config_plan(cfg, True) is None


def _table(seed, spatial, n, cap):
    """A scan's voxel table: n unique voxels in clumps, sorted by key."""
    rng = np.random.RandomState(seed)
    d, h, w = spatial
    centres = rng.randint(0, [d, h, w], (max(1, n // 40), 3))
    pts = centres[rng.randint(len(centres), size=4 * n)] \
        + rng.randint(-4, 5, (4 * n, 3))
    pts = pts[((pts >= 0) & (pts < [d, h, w])).all(1)]
    keys = np.unique((pts[:, 0] * h + pts[:, 1]) * w + pts[:, 2])[:n]
    coords = np.full((cap, 3), -1, np.int32)
    coords[:len(keys)] = np.stack(np.unravel_index(keys, (d, h, w)), -1)
    return coords, len(keys)


def _plans(name, grid, cap, training):
    model = cfg_from_yaml_file(CFGS[name])['MODEL']
    return (sparse_plan.backbone_plan(model, grid, cap, training),
            jax_plan.backbone_plan(jax_cfg_from_yaml(CFGS[name]).MODEL, grid,
                                   cap, training))


@pytest.mark.parametrize('name,grid,n,cap,training', [
    ('second', (16, 24, 40), 700, 800, True),     # small grid, full depth
    ('second', (16, 24, 40), 800, 800, False),    # table full
    ('PartA2', (20, 18, 12), 500, 900, True),     # UNetV2's inv / rewind
    ('PartA2', (20, 18, 12), 0, 64, False),       # an empty scan
    ('second', (1408, 1600, 40), 2000, 2000, True),   # second.yaml's grid
])
def test_host_rulebooks_equal_jax_native_and_plain(name, grid, n, cap,
                                                   training):
    port, want_plan = _plans(name, grid, cap, training)
    coords, n_vox = _table(n + cap, port.spatial_shape, n, cap)
    want = jax_plan.build_host_rulebooks(want_plan, coords, n_vox)
    got = sparse_plan.build_host_rulebooks(port, coords, n_vox)
    with native.plain_host():
        plain = sparse_plan.build_host_rulebooks(port, coords, n_vox)
    assert list(got) == list(want) == list(plain) == port.batch_keys()
    for key, value in want.items():
        for other in (got, plain):
            assert other[key].dtype == value.dtype, key
            np.testing.assert_array_equal(other[key], value, err_msg=key)
    assert n == 0 or int(got['rb_down2_num']) > 0


def test_host_tables_equal_the_device_builders():
    """The host plan's tables against the port's own device-path builders
    (ops/sparse.py) on the same table: the forward rulebooks and stage
    tables, and each transposed rulebook against the forward one."""
    plan, _ = _plans('second', (16, 24, 40), 600, True)
    coords, n_vox = _table(3, plan.spatial_shape, 520, 600)
    host = sparse_plan.build_host_rulebooks(plan, coords, n_vox)
    st = sparse.SparseTensor(torch.zeros(1, 600, 1),
                             torch.from_numpy(coords)[None],
                             torch.tensor([n_vox]), plan.spatial_shape)
    np.testing.assert_array_equal(host['rb_subm1'],
                                  sparse.build_subm_rulebook(st)[0].numpy())
    for name, kernel, stride, pad in (
            ('down2', (3, 3, 3), (2, 2, 2), (1, 1, 1)),
            ('down3', (3, 3, 3), (2, 2, 2), (1, 1, 1)),
            ('down4', (3, 3, 3), (2, 2, 2), (0, 1, 1)),
            ('out', (3, 1, 1), (2, 1, 1), (0, 0, 0))):
        out_coords, out_num, out_shape = sparse.build_strided_out_coords(
            st, kernel, stride, pad, 600)
        rule = sparse.build_strided_rulebook(st, out_coords, out_shape,
                                             kernel, stride, pad)
        np.testing.assert_array_equal(host[f'rb_{name}_coords'],
                                      out_coords[0].numpy())
        assert int(host[f'rb_{name}_num']) == int(out_num[0])
        np.testing.assert_array_equal(host[f'rb_{name}'], rule[0].numpy())
        # rb_bwd[i, k] = o  <=>  rb[o, k] = i, misses at the other table's
        # capacity
        rb, bwd = host[f'rb_{name}'], host[f'rb_{name}_bwd']
        o, k = np.nonzero(rb < 600)
        assert (bwd[rb[o, k], k] == o).all()
        assert (bwd < 600).sum() == len(o)
        st = sparse.SparseTensor(st.features, out_coords, out_num, out_shape)
        if name != 'out':
            np.testing.assert_array_equal(
                host[f'rb_subm{name[-1]}'],
                sparse.build_subm_rulebook(st)[0].numpy())


def test_bucketing_equals_jax_dataloader():
    """`bucket_voxels` against the JAX package's ``DataLoader._bucket`` on
    the same eval batch of PartA2.yaml's plan (every kind of op) at
    second.yaml's grid and a 16000 cap."""
    cfg = cfg_from_yaml_file(CFGS['PartA2'])
    info = dataset_info(cfg['DATA_CONFIG'])
    port, want_plan = _plans('PartA2', info['grid_size'], 16000, False)
    clouds = [make_scene(np.random.RandomState(s),
                         np.asarray(info['point_cloud_range']),
                         num_ground=4000 + 2000 * s)[0] for s in range(2)]
    batch = build_batch(clouds, info['point_cloud_range'], info['voxel_size'],
                        5, 16000, plan=port)
    assert 0 < batch['num_voxels'].max() < 16000 - 4096

    class _Set:
        sparse_plan = want_plan

    loader = JaxDataLoader(_Set(), 2, bucket_voxels=True)
    want = loader._bucket({k: v.copy() for k, v in batch.items()})
    got = bucket_voxels({k: v.copy() for k, v in batch.items()}, port)
    assert sorted(got) == sorted(want)
    cut = 0
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        cut += got[key].shape != batch[key].shape
    assert cut >= 10 and got['voxels'].shape[1] % 4096 == 0


def test_test_loader_buckets_its_plan():
    """build_test_loader: the eval plan's tables in the batch, cut to the
    occupancy; VOXEL_BUCKETING false keeps the caps."""
    cfg = cfg_from_yaml_file(CFGS['second'])
    _, loader = build_test_loader(cfg, 2, 2, seed=1)
    batch = next(iter(loader))
    plan = sparse_plan.config_plan(cfg, False)
    assert set(plan.batch_keys()) <= set(batch)
    assert not any(k.endswith('_bwd') for k in batch)
    assert batch['voxels'].shape[1] % 4096 == 0
    assert batch['voxels'].shape[1] < 40000
    assert batch['rb_subm1'].shape[1] == batch['voxels'].shape[1]
    cfg['DATA_CONFIG']['VOXEL_BUCKETING'] = False
    _, loader = build_test_loader(cfg, 2, 2, seed=1)
    whole = next(iter(loader))
    assert whole['voxels'].shape[1] == 40000
    assert whole['rb_subm1'].shape == (2, 40000, 27)
    np.testing.assert_array_equal(
        np.minimum(whole['rb_subm1'][:, :batch['voxels'].shape[1]],
                   batch['voxels'].shape[1]), batch['rb_subm1'])
