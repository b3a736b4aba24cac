"""The port's measurement and diagnostic tools (``lidardetection_tpu_torch/
tools/``: profile_trace, profile_stages, profile_sparse, profile_vsa,
microbench, microbench_rbconv, microbench_select, bench_input,
bench_kitti_eval, probe_rcnn_refine, ablate_approx, and measure.py), on
the CPU, held against the JAX tools where their arithmetic can be
reached:

* bench_kitti_eval: ``synth_annos`` equals tools/bench_kitti_eval.py's
  array for array at 24 frames, seed 0; the protocol's result string and
  APs on them equal the JAX package's exactly, native against its native
  library and numpy against its Python loops;
* microbench_rbconv: ``make_rulebook`` equals the JAX tool's at one seed
  (and verify_cuda reads this copy); on that rulebook K3's plain version
  equals ``rulebook_conv_pallas_v3`` in interpret mode within 1e-5;
* ablate_approx: each variant's config equals what the JAX tool's
  ``make_cfg`` builds from the same yaml (read by running the JAX tool's
  ``main`` with its loader replaced by one that records the config);
* profile_stages: PointPillar's and PV-RCNN's stages in the JAX tool's
  order and names (its ``module_order``, read without initialising);
* every tool's ``main([..., '--cpu'])`` runs at a tiny size (reduced
  configs) and prints its rows, probe_rcnn_refine and ablate_approx on a
  checkpoint written by one CPU training step;
* without ``--cpu`` and without CUDA every tool raises;
* the trace reader charges a kernel to the innermost module span open
  where it was launched; the bound and the work counters.
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from lidardetection_tpu import native as jax_native
from lidardetection_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from lidardetection_tpu.datasets.kitti.kitti_object_eval import eval as jax_eval
from lidardetection_tpu.models import build_network as jax_build_network
from lidardetection_tpu.ops import sparse_conv_tpu
from lidardetection_tpu_torch import native
from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
from lidardetection_tpu_torch.ops.sparse_conv_cuda import rulebook_conv_plain
from lidardetection_tpu_torch.tools import (
    ablate_approx, bench_input, bench_kitti_eval, measure, microbench,
    microbench_rbconv, microbench_select, probe_rcnn_refine, profile_sparse,
    profile_stages, profile_trace, profile_vsa, verify_cuda,
)
from torch_threads import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))
import ablate_approx as jax_ablate  # noqa: E402
import bench_kitti_eval as jax_bench_kitti_eval  # noqa: E402
import microbench_rbconv as jax_rbconv  # noqa: E402

TOOLS = ('profile_trace', 'profile_stages', 'profile_sparse', 'profile_vsa',
         'microbench', 'microbench_rbconv', 'microbench_select', 'bench_input',
         'bench_kitti_eval', 'probe_rcnn_refine', 'ablate_approx')
CLASSES = ['Car', 'Pedestrian', 'Cyclist']


def plain(tree):
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    return tree


def shrink(cfg):
    """A config at a tiny size: float32, a 64 x 64 grid, 1000 voxels,
    2048 points, 256 keypoints, short NMS lists."""
    cfg['MODEL']['COMPUTE_DTYPE'] = 'float32'
    data = cfg['DATA_CONFIG']
    data.pop('DATA_AUGMENTOR', None)
    data['MAX_POINTS'] = 2048
    pillar = cfg['MODEL']['MAP_TO_BEV']['NAME'] == 'PointPillarScatter'
    pcr = data['POINT_CLOUD_RANGE']
    for p in data['DATA_PROCESSOR']:
        if p['NAME'] == 'transform_points_to_voxels':
            p['MAX_NUMBER_OF_VOXELS'] = {'train': 1000, 'test': 1000}
            p['VOXEL_SIZE'] = [(pcr[3] - pcr[0]) / 64.0, (pcr[4] - pcr[1]) / 64.0,
                               pcr[5] - pcr[2] if pillar else p['VOXEL_SIZE'][2]]
    m = cfg['MODEL']
    if 'PFE' in m:
        m['PFE']['NUM_KEYPOINTS'] = 256
    if 'ROI_HEAD' in m:
        for phase in ('TRAIN', 'TEST'):
            m['ROI_HEAD']['NMS_CONFIG'][phase]['NMS_PRE_MAXSIZE'] = 256
            m['ROI_HEAD']['NMS_CONFIG'][phase]['NMS_POST_MAXSIZE'] = 32
        m['ROI_HEAD']['TARGET_CONFIG']['ROI_PER_IMAGE'] = 16
    m['POST_PROCESSING']['NMS_CONFIG']['NMS_PRE_MAXSIZE'] = 128
    m['POST_PROCESSING']['NMS_CONFIG']['NMS_POST_MAXSIZE'] = 16
    return cfg


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    """{model: the path of its reduced yaml}."""
    root = tmp_path_factory.mktemp('small_cfgs')
    out = {}
    for name in ('pointpillar', 'second', 'pv_rcnn'):
        cfg = shrink(cfg_from_yaml_file(f'tools/cfgs/kitti_models/{name}.yaml'))
        out[name] = root / f'{name}.yaml'
        out[name].write_text(yaml.safe_dump(plain(cfg)))
    return out


# ---- bench_kitti_eval ---------------------------------------------------

def test_synth_annos_match_jax():
    got = bench_kitti_eval.synth_annos(24, 0)
    want = jax_bench_kitti_eval.synth_annos(24, 0)
    for g_set, w_set in zip(got, want):
        assert len(g_set) == len(w_set) == 24
        for g, w in zip(g_set, w_set):
            assert list(g) == list(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize('path', ['native', 'plain'])
def test_bench_kitti_eval_matches_jax(path, monkeypatch, capsys):
    if path == 'native':
        assert jax_native.load() is not None
        monkeypatch.delenv(native.PLAIN_ENV, raising=False)
    else:  # the JAX package's Python loops and numpy IoU
        monkeypatch.setattr(jax_native, '_lib', None)
        monkeypatch.setattr(jax_native, '_tried', True)
        monkeypatch.setenv(native.PLAIN_ENV, '1')
    row, got_str, got = bench_kitti_eval.main(['--frames', '24', '--cpu'])
    gt, dt = jax_bench_kitti_eval.synth_annos(24, 0)
    want_str, want = jax_eval.get_official_eval_result(gt, dt, CLASSES)
    assert got_str == want_str
    assert list(got) == list(want)
    for key, value in want.items():
        assert float(got[key]) == float(value), key
    assert row['host'] == ('native' if path == 'native' else 'numpy')
    assert 0 < row['car_3d_moderate_R40'] < 100
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row


# ---- microbench_rbconv ------------------------------------------------

def test_make_rulebook_matches_jax_and_is_verify_cudas():
    got = microbench_rbconv.make_rulebook(np.random.RandomState(3), 2, 700, 500)
    want = jax_rbconv.make_rulebook(np.random.RandomState(3), 2, 700, 500)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and (got < 700).mean() > 0.3
    assert verify_cuda.make_rulebook is microbench_rbconv.make_rulebook


def test_rulebook_conv_plain_matches_pallas_v3_on_the_tools_rulebook():
    args = microbench_rbconv.parse_args(['--b', '2', '--vin', '512',
                                         '--cin', '16', '--cout', '16'])
    rule, f, w = microbench_rbconv.inputs(args, 'cpu')
    f, w = f.float(), w.float()
    want = np.asarray(sparse_conv_tpu.rulebook_conv_pallas_v3(
        f.numpy(), rule.numpy(), w.numpy(), kernel_z=3, t_out=128, blk=64,
        n_wg=3, interpret=True))
    got = rulebook_conv_plain(f, rule, w).numpy()
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_microbench_rbconv_runs(capsys):
    row = microbench_rbconv.main(['--b', '1', '--vin', '256', '--cin', '8',
                                  '--cout', '8', '--iters', '1', '--cpu'])
    assert row['max_abs_err'] == 0.0 and row['bound_ms'] > 0
    assert 'kernel' in capsys.readouterr().out


# ---- ablate_approx ----------------------------------------------------

def test_ablate_variants_match_jax_make_cfg(tmp_path, monkeypatch):
    import jax

    import lidardetection_tpu.datasets as jax_datasets

    seen = []

    def record(data_cfg, *args, **kwargs):
        seen.append(data_cfg)
        raise RuntimeError('recorded')

    monkeypatch.setattr(jax.config, 'update', lambda *a, **k: None)
    monkeypatch.setattr(jax_datasets, 'build_dataloader', record)
    cfg_file = 'tools/cfgs/kitti_models/pv_rcnn.yaml'
    monkeypatch.setattr(sys, 'argv', ['ablate_approx.py', '--cfg_file', cfg_file,
                                      '--output_dir', str(tmp_path)])
    captured = []
    real_make = jax_cfg_from_yaml

    def spy(path):
        cfg = real_make(path)
        captured.append(cfg)
        return cfg

    monkeypatch.setattr('lidardetection_tpu.config.cfg_from_yaml_file', spy)
    jax_ablate.main()
    assert jax_ablate.VARIANTS == ablate_approx.VARIANTS
    assert len(captured) == len(seen) == len(ablate_approx.VARIANTS)
    for (name, overrides), want in zip(ablate_approx.VARIANTS, captured):
        got = ablate_approx.make_cfg(cfg_file, overrides)
        for key in ('CLASS_NAMES', 'DATA_CONFIG', 'MODEL', 'OPTIMIZATION'):
            assert plain(got[key]) == plain(want[key]), (name, key)


# ---- profile_stages ---------------------------------------------------

@pytest.mark.parametrize('model', ['pointpillar', 'pv_rcnn'])
def test_profile_stages_lists_the_jax_tools_stages(model):
    path = f'tools/cfgs/kitti_models/{model}.yaml'
    jcfg = jax_cfg_from_yaml(path)
    order = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES), jcfg.CLASS_NAMES,
                              dataset_info(jcfg.DATA_CONFIG)).bind({}).module_order
    want = [f'{i}:{order[i - 1]}' for i in range(1, len(order) + 1)] \
        + ['post_processing']
    model_ = measure.eval_model(cfg_from_yaml_file(path), 'cpu')
    assert profile_stages.stage_names(model_) == want


# ---- each tool on the CPU ----------------------------------------------

def test_profile_stages_runs(small, capsys):
    row = profile_stages.main(['--cfg_file', str(small['pointpillar']),
                               '--batch_size', '1', '--iters', '1', '--cpu'])
    names = [r[0] for r in row['stages']]
    assert names == ['1:vfe', '2:map_to_bev', '3:backbone_2d', '4:dense_head',
                     'post_processing']
    assert all(np.isfinite(r[1]) and r[1] > 0 for r in row['stages'])
    assert 'marginal ms' in capsys.readouterr().out


@pytest.mark.parametrize('train', [False, True])
def test_profile_trace_runs(small, tmp_path, capsys, train):
    row = profile_trace.main(['--cfg_file', str(small['pointpillar']),
                              '--batch_size', '1', '--iters', '1', '--top', '5',
                              '--out', str(tmp_path), '--cpu']
                             + (['--train'] if train else []))
    out = capsys.readouterr().out
    assert (tmp_path / 'trace.json').exists()
    assert row['device_ms_per_iter'] is None and row['wall_ms_per_iter'] > 0
    assert len(row['top']) == 5 and 'by module path' in out
    # the top-level modules' host time
    assert all(m in out for m in ('vfe', 'backbone_2d', 'dense_head'))


def test_profile_sparse_runs(small, capsys):
    row = profile_sparse.main(['--cfg', str(small['second']), '--batch_size',
                               '1', '--cpu'])
    ops = [r[0] for r in row['layers']]
    assert ops == ['subm1', 'down2', 'subm2', 'down3', 'subm3', 'down4',
                   'subm4', 'out']
    assert all(np.isfinite(r[5]) and r[6] > 0 for r in row['layers'])
    assert row['conv_total_ms'] > 0 and row['s2d_ms'] > 0
    assert 'conv total' in capsys.readouterr().out


def test_profile_vsa_runs(capsys):
    row = profile_vsa.main(['--batch_size', '1', '--num_kp', '64', '--iters',
                            '1', '--cpu'])
    labels = [r[0] for r in row['rows']]
    assert labels[0] == 'sector_fps 32768->64' and len(labels) == 1 + 5 * 4 + 2
    assert all(np.isfinite(r[1]) for r in row['rows'])
    k5 = [r for r in row['rows'] if 'K5' in r[0]]
    assert len(k5) == 5 and all(r[2] > 0 for r in k5)


def test_microbench_runs(capsys):
    scatter = microbench.main(['--case', 'scatter', '--b', '2', '--v', '300',
                               '--c', '8', '--slots', '4096', '--iters', '1',
                               '--cpu'])['scatter']
    assert scatter['max_abs_err'] == 0.0 and scatter['bound_ms'] > 0
    vfe = microbench.main(['--case', 'vfe', '--b', '1', '--v', '500',
                           '--iters', '1', '--cpu'])['vfe']
    assert vfe['bit_equal'] and vfe['bound_ms'] > 0
    nms = microbench.bench_nms(torch.device('cpu'), 2, 128, iters=1)
    assert nms['kept_equal'] and min(nms['kept']) > 0
    out = capsys.readouterr().out
    assert 'scatter K2' in out and 'vfe K1' in out and 'nms b2' in out


def test_microbench_select_runs(capsys):
    row = microbench_select.main(['--case', 'all', '--batch_size', '1',
                                  '--num_kp', '64', '--n_src', '4096',
                                  '--caps', '64,16', '--iters', '1', '--cpu'])
    assert [r[0] for r in row['pieces']] == [
        'sort alone', 'boundaries alone', 'runs alone', 'candidates alone',
        'K5 alone']
    assert len(row['prefix']) == 5 and len(row['split']) == 15
    assert [r[0] for r in row['cap']] == ['cap=64', 'cap=16']
    assert all(np.isfinite(r[1]) for rows in row.values() if isinstance(rows, list)
               for r in rows)


def test_bench_input_runs(small, capsys):
    rows = bench_input.main(['--cfg_file', str(small['pointpillar']),
                             '--batch_size', '2', '--num_scenes', '6',
                             '--batches', '2', '--workers', '0', '--cpu'])
    assert len(rows) == 1 and rows[0]['batches'] == 2 and rows[0]['value'] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rows[0]


@pytest.fixture(scope='module')
def pvrcnn_ckpt(small, tmp_path_factory):
    """A PV-RCNN checkpoint of the reduced config under the harness's
    edits, written after one CPU training step."""
    from lidardetection_tpu_torch.train import Trainer
    from lidardetection_tpu_torch.train_to_ap import overfit_config
    from lidardetection_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = overfit_config(cfg_from_yaml_file(str(small['pv_rcnn'])))
    trainer = Trainer(cfg, device='cpu', seed=42, total_steps=1)
    trainer.step(trainer.make_batch([trainer.dataset(1, seed=0)[0]]))
    ckpt = tmp_path_factory.mktemp('pvrcnn_ckpt')
    save_checkpoint(trainer.state, ckpt, 1)
    return ckpt


def test_probe_rcnn_refine_runs(small, pvrcnn_ckpt, capsys):
    row = probe_rcnn_refine.main(['--cfg_file', str(small['pv_rcnn']),
                                  '--ckpt_dir', str(pvrcnn_ckpt), '--scenes', '2',
                                  '--batch_size', '1', '--batches', '1', '--cpu'])
    out = capsys.readouterr().out
    assert row['epoch'] == 1 and 'iou_before' in out and row['finite']
    # after one step few RoIs, if any, reach the foreground's IoU
    assert {r[1] for r in row['rows']} <= {'train', 'eval'}
    assert bool(row['rows']) != ('no foreground RoI' in out)


def test_ablate_approx_runs(small, pvrcnn_ckpt, tmp_path, capsys):
    row = ablate_approx.main(['--cfg_file', str(small['pv_rcnn']),
                              '--ckpt_dir', str(pvrcnn_ckpt), '--scenes', '1',
                              '--batch_size', '1', '--output_dir', str(tmp_path),
                              '--cpu'])
    names = [n for n, _ in ablate_approx.VARIANTS]
    assert list(row['rows']) == names
    for name in names:
        aps = {k: v for k, v in row['rows'][name].items() if k != 'note'}
        assert 'Car_3d/moderate_R40' in aps and all(np.isfinite(list(aps.values())))
    assert 'not read by the port' in row['rows']['exact_ball_query']['note']
    # on the CPU every point op takes its exact path: the knobs change nothing
    assert row['deltas']['exact_fps'] == {k: 0.0 for k in row['deltas']['exact_fps']}
    assert '"metric": "approximation_ablation"' in capsys.readouterr().out


# ---- the card's absence -----------------------------------------------

@pytest.mark.parametrize('tool', TOOLS)
def test_tools_raise_without_cuda_or_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    module = importlib.import_module(f'lidardetection_tpu_torch.tools.{tool}')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        module.main([])


# ---- measure.py ---------------------------------------------------------

def test_trace_summary_charges_the_innermost_span(tmp_path):
    events = [
        {'cat': 'user_annotation', 'name': 'module::backbone_3d', 'ts': 0,
         'dur': 100, 'tid': 1},
        {'cat': 'user_annotation', 'name': 'module::backbone_3d.conv2.0',
         'ts': 10, 'dur': 20, 'tid': 1},
        {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 15, 'tid': 1,
         'args': {'correlation': 7}},
        {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 50, 'tid': 1,
         'args': {'correlation': 8}},
        {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': 50, 'tid': 2,
         'args': {'correlation': 9}},
        {'cat': 'kernel', 'name': 'conv_mma_kernel', 'ts': 200, 'dur': 3000,
         'args': {'correlation': 7}},
        {'cat': 'kernel', 'name': 'conv_mma_kernel', 'ts': 300, 'dur': 1000,
         'args': {'correlation': 8}},
        {'cat': 'gpu_memset', 'name': 'Memset', 'ts': 400, 'dur': 500,
         'args': {'correlation': 9}},
    ]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    by_name, by_module = measure.trace_summary(path)
    assert by_name == {'conv_mma_kernel': (4.0, 2), 'Memset': (0.5, 1)}
    assert by_module == {'backbone_3d.conv2': 3.0, 'backbone_3d': 1.0,
                         '<no module>': 0.5}


def test_bound_and_work_counters():
    assert measure.bound_ms(3.35e9, 0) == (1.0, 'bytes')
    assert measure.bound_ms(0, 67e9) == (1.0, 'operations')
    keys = torch.tensor([[0, 5, 9, 10]], dtype=torch.int32)
    feats = torch.zeros((1, 4, 8), dtype=torch.bfloat16)
    assert measure.scatter_work(feats, keys, 10) == (3, 10 * 8 * 2 + 4 * 4 + 3 * 8 * 2)
    with pytest.raises(ValueError):
        measure.l2_flush('warm')
