"""The VSA's (PV-RCNN's voxel set abstraction) pieces at its eval shapes
(counterpart of tools/profile_vsa.py:19-97): sector FPS, each source's
grid ball query (its prep, then K5, then the whole query), each source's
set abstraction (the query, the grouping and the MLP stacks), the
grouping alone, and the BEV bilinear interpolation.

Shapes are the JAX tool's: ``--batch_size`` clouds of uniform points over
PV-RCNN's range (x 0-69, y -39-39, z -3-1, ``default_rng(0)``),
``--num_kp`` keypoints, the five sources raw_points (32768 rows),
x_conv1 (20480), x_conv2 (32768), x_conv3 (24576) and x_conv4 (16384),
each 128 rows short of full, with pv_rcnn.yaml's radii, nsamples and
MLPs (the set abstractions' weights from seed 0, bf16), ``--cell_cap``
rows a cell. Each piece is timed by ``measure.cuda_ms`` (CUDA events,
the L2 flushed clean, the median of ``--iters``); K5's row stands beside
its bound. The JAX tool times the same pieces as ``fori_loop`` chains.

    python -m lidardetection_tpu_torch.tools.profile_vsa --batch_size 8

``--cpu`` runs on the host clock; there the ball queries take the plain
selection (K5's plain version) and the set abstractions the brute-force
query, as every point op does on the CPU.
"""

import argparse

import numpy as np
import torch

from ..config import cfg_from_yaml_file
from ..models.backbones_3d.pfe import bilinear_interpolate
from ..models.backbones_3d.pointnet2_modules import PointnetSAModuleMSG
from ..ops import pointnet2 as p2
from ..ops.select_cuda import ball_select
from . import measure
from .common import tool_device

CFG = 'tools/cfgs/kitti_models/pv_rcnn.yaml'
BOUNDS = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
# (source, rows, feature channels, radii, nsamples): profile_vsa.py:58-62,
# as pv_rcnn.yaml's SA_LAYER has them
SOURCES = (('raw_points', 32768, 1, (0.4, 0.8), (16, 16)),
           ('x_conv1', 20480, 16, (0.4, 0.8), (16, 16)),
           ('x_conv2', 32768, 32, (0.8, 1.2), (16, 32)),
           ('x_conv3', 24576, 64, (1.2, 2.4), (16, 32)),
           ('x_conv4', 16384, 64, (2.4, 4.8), (16, 32)))


def uniform_points(rng, b, n, device):
    """(b, n, 3) points uniform over PV-RCNN's range (profile_vsa.py:40-44)."""
    x = rng.uniform(0, 69, (b, n)).astype(np.float32)
    y = rng.uniform(-39, 39, (b, n)).astype(np.float32)
    z = rng.uniform(-3, 1, (b, n)).astype(np.float32)
    return torch.from_numpy(np.stack([x, y, z], axis=-1)).to(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch_size', type=int, default=8)
    ap.add_argument('--num_kp', type=int, default=2048)
    ap.add_argument('--cell_cap', type=int, default=64)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f'# device: {measure.device_line(device)}', flush=True)
    b, m = args.batch_size, args.num_kp
    rng = np.random.default_rng(0)
    g = torch.Generator(device='cpu').manual_seed(0)
    pfe = cfg_from_yaml_file(CFG)['MODEL']['PFE']
    knobs = p2.PointOpKnobs(bq_grid=(BOUNDS, args.cell_cap),
                            fps_sectors=int(pfe.get('FPS_SECTORS', 32)))
    rows = []

    def timed(label, fn, bound=None):
        ms = measure.time_ms(fn, device, iters=args.iters)
        rows.append([label, ms, bound])
        tail = '' if bound is None else f'{bound:>10.4f}'
        print(f'{label:<44}{ms:>10.4f}{tail}', flush=True)
        return ms

    print(f'{"piece (B=" + str(b) + ", M=" + str(m) + ")":<44}{"ms":>10}'
          f'{"bound_ms":>10}', flush=True)
    measure.reset_launches()
    raw = uniform_points(rng, b, 32768, device)
    nraw = torch.full((b,), 32000, dtype=torch.int32, device=device)
    timed(f'sector_fps 32768->{m}', lambda: p2.sector_fps(raw, nraw, m, 32))

    kp = uniform_points(rng, b, m, device)
    kv = torch.ones((b, m), dtype=torch.bool, device=device)
    kp_num = torch.full((b,), m, dtype=torch.int32, device=device)
    for name, n, channels, radii, ns in SOURCES:
        mlps = [list(x) for x in pfe['SA_LAYER'][name]['MLPS']]
        src = uniform_points(rng, b, n, device)
        nn_ = torch.full((b,), n - 128, dtype=torch.int32, device=device)
        args_k5 = p2.grid_select_args(radii, ns, src, nn_, kp, kv, BOUNDS,
                                      args.cell_cap)
        *_, n_bytes, n_flop, _ = measure.select_work(args_k5)
        timed(f'{name} V={n}: prep', lambda: p2.grid_select_args(
            radii, ns, src, nn_, kp, kv, BOUNDS, args.cell_cap))
        timed(f'{name} V={n}: K5 ball_select', lambda: ball_select(*args_k5),
              measure.bound_ms(n_bytes, n_flop)[0])
        timed(f'{name} V={n}: grid_ball_query_multi',
              lambda: p2.grid_ball_query_multi(radii, ns, src, nn_, kp, kv,
                                               BOUNDS, args.cell_cap))
        sa = PointnetSAModuleMSG(
            npoint=m, radii=radii, nsamples=ns,
            mlps=mlps, in_channels=channels,
            zero_empty=True, knobs=knobs, dtype=torch.bfloat16,
            generator=g).to(device).eval()
        feats = torch.randn((b, n, channels), device=device)

        def run_sa():
            with torch.inference_mode():
                return sa(src, feats, nn_, new_xyz=kp, new_xyz_num=kp_num)
        timed(f'{name} V={n}: SA (query, group, MLPs)', run_sa)

    feats = torch.randn((b, 32768, 64), device=device)
    idx = torch.from_numpy(rng.integers(0, 32768, (b, m, 32))).to(
        device, torch.int32)
    timed(f'group_points (B,{m},32) of C=64', lambda: p2.group_points(feats, idx))
    bev = torch.randn((b, 200, 176, 256), device=device)
    x_idx = kp[..., 0] / 0.05 / 8
    y_idx = (kp[..., 1] + 40.0) / 0.05 / 8
    timed('bev bilinear (200x176, C=256)',
          lambda: bilinear_interpolate(bev, x_idx, y_idx))
    return measure.summary_line('profile_vsa', device, rows=rows)


if __name__ == '__main__':
    main()
