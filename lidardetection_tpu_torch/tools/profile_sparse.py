"""The sparse 3D backbone layer by layer at SECOND's eval shapes
(counterpart of tools/profile_sparse.py:30-143): K3 at each convolution
of the host plan, the conv total, and K2's ``sparse_to_dense`` of the
encoded tensor.

A test batch of ``--batch_size`` synthetic scenes (the JAX tool's edits,
:44-48) carries the host plan's rulebooks (``ops/sparse_plan.py``, the
tables cut to the batch's occupancy). The plan's ops are walked as the
JAX tool walks them (:69-84: each op's input stage, its output stage's
valid rows); each convolution gets random bf16 features (B, vin, cin) and
weights (K, cin, cout) of VoxelBackBone8x's channel plan (:59-62) and is
timed by ``measure.cuda_ms`` (CUDA events, the L2 flushed clean, the
median of 30) beside its bound. ``layers`` is how many layers of that
shape a forward runs (the submanifold pairs), which the conv total
counts.

    python -m lidardetection_tpu_torch.tools.profile_sparse --cfg second \\
        --batch_size 8

``--cfg`` names a yaml under tools/cfgs/kitti_models/ (or is a yaml's
path). ``--cpu`` runs the plain versions on the host clock.
"""

import argparse
from pathlib import Path

import torch

from ..config import dataset_info
from ..datasets.synthetic import build_test_loader
from ..ops import sparse
from ..ops.scatter_cuda import scatter_rows
from ..ops.sparse_conv_cuda import rulebook_conv
from ..ops.sparse_plan import config_plan
from ..parallel.train_step import device_batch
from . import measure
from .common import tool_device

# VoxelBackBone8x's channels per op (profile_sparse.py:59-62)
CHANNELS = {'subm1': (4, 16), 'down2': (16, 32), 'subm2': (32, 32),
            'down3': (32, 64), 'subm3': (64, 64), 'down4': (64, 64),
            'subm4': (64, 64), 'out': (64, 128)}
LAYERS = {'subm1': 2, 'subm2': 2, 'subm3': 2, 'subm4': 2}


def plan_stages(plan, batch):
    """Per op of the plan: its input stage, its rulebook's output stage;
    and each stage's valid mask (the JAX tool's walk, :69-84)."""
    valid = [batch['voxel_coords'][..., 0] >= 0]
    op_in, op_out, cur = [], [], 0
    for op in plan.ops:
        op_in.append(cur)
        if op.type == 'down':
            valid.append(batch[f'rb_{op.name}_coords'][..., 0] >= 0)
            cur = len(valid) - 1
        elif op.type == 'inv':
            cur = op_in[op.match]
        elif op.type == 'rewind':
            cur = op_out[op.match]
        op_out.append(cur)
    out_stage = [op_out[i] if op.type == 'down' else
                 (op_in[op.match] if op.type == 'inv' else op_in[i])
                 for i, op in enumerate(plan.ops)]
    return op_in, out_stage, valid


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg', default='second')
    ap.add_argument('--batch_size', type=int, default=8)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f'# device: {measure.device_line(device)}', flush=True)
    cfg_file = args.cfg if args.cfg.endswith('.yaml') \
        else f'tools/cfgs/kitti_models/{args.cfg}.yaml'
    cfg = measure.synthetic_config(cfg_file)
    plan = config_plan(cfg, training=False)
    if plan is None:
        raise SystemExit(f'{Path(cfg_file).name} has no sparse 3D backbone')
    _, loader = build_test_loader(cfg, args.batch_size, args.batch_size)
    batch = device_batch(next(iter(loader)), device)
    op_in, out_stage, valid = plan_stages(plan, batch)
    rows_of_stage = [v.shape[1] for v in valid]
    g = torch.Generator(device=device).manual_seed(0)

    measure.reset_launches()
    print(f'{"op":<10}{"rows":>8}{"vin":>8}{"cin":>5}{"cout":>5}{"ms":>10}'
          f'{"bound_ms":>10}{"layers":>7}', flush=True)
    rows, total, total_bound = [], 0.0, 0.0
    for i, op in enumerate(plan.ops):
        if op.type == 'rewind':
            continue
        rule = batch[f'rb_{op.name}']
        vin = rows_of_stage[op_in[i]]
        vm = valid[out_stage[i]]
        cin, cout = CHANNELS.get(op.name, (64, 64))
        f = torch.randn((args.batch_size, vin, cin), generator=g,
                        device=device).bfloat16()
        w = torch.randn((rule.shape[-1], cin, cout), generator=g,
                        device=device).bfloat16()
        ms = measure.time_ms(lambda: rulebook_conv(f, rule, w, vm), device)
        _, _, n_bytes, n_flop = measure.conv_work(f, rule, w, vm)
        bound, _ = measure.bound_ms(n_bytes, n_flop, measure.BF16_FLOP_PER_S)
        n_layers = LAYERS.get(op.name, 1)
        total += ms * n_layers
        total_bound += bound * n_layers
        rows.append([op.name, rule.shape[1], vin, cin, cout, ms, bound, n_layers])
        print(f'{op.name:<10}{rule.shape[1]:>8}{vin:>8}{cin:>5}{cout:>5}'
              f'{ms:>10.4f}{bound:>10.4f}{n_layers:>7}', flush=True)
    print(f'{"conv total":<36}{total:>10.4f}{total_bound:>10.4f} ms/batch',
          flush=True)

    # sparse_to_dense (K2) of the encoded tensor: conv_out's table into
    # (2, ny / 8, nx / 8) slots, 128 channels
    nx, ny, _ = dataset_info(cfg['DATA_CONFIG'])['grid_size']
    coords = batch['rb_out_coords']
    st = sparse.SparseTensor(
        torch.randn((args.batch_size, coords.shape[1], 128), generator=g,
                    device=device), coords, batch['rb_out_num'],
        (2, ny // 8, nx // 8))
    s2d = measure.time_ms(lambda: sparse.sparse_to_dense(st), device)
    keys = sparse.linear_key(coords, st.spatial_shape).int()
    _, n_bytes = measure.scatter_work(st.features, keys, 2 * (ny // 8) * (nx // 8))
    s2d_bound, _ = measure.bound_ms(n_bytes, 0)
    print(f'{"s2d":<36}{s2d:>10.4f}{s2d_bound:>10.4f} ms/batch (K2 '
          f'{scatter_rows.__name__})', flush=True)
    return measure.summary_line('profile_sparse', device, layers=rows,
                                conv_total_ms=total, s2d_ms=s2d,
                                s2d_bound_ms=s2d_bound)


if __name__ == '__main__':
    main()
