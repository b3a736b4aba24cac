"""The kernels on the card against their plain versions, at real shapes
(the counterpart of tools/verify_tpu.py): the check a user runs on their
own card.

    python -m lidardetection_tpu_torch.tools.verify_cuda
    python -m lidardetection_tpu_torch.tools.verify_cuda --kernels conv,ball

Cases (``--kernels``, default all):
  conv     K3 (``rulebook_conv``) against its plain version, and K4
           (``rulebook_conv_dw``) against its plain version and against
           autograd of the plain convolution, bf16, B 4, V 8192, C 32, on a
           banded rulebook with 55% hits;
  ball     K5 (``ball_select``) through the grid ball query against its
           plain version on the same runs, and a brute-force spot check of
           200 centres a sample: PV-RCNN's VSA shape (B 4, N 16384, M 1024)
           exactly; PointRCNN's clustered SA1 shape (B 8, N 16384, M 4096),
           whose cells overflow the 64-point cap by design, as a subset of
           the true hits;
  scatter  K2 (``scatter_rows``) against numpy, V 16384 -> 214272 slots,
           C 64;
  vfe      K1 (``pillar_vfe``) against the numpy algebra of its contract,
           (2, 4096, 32, 64), empty pillars among them;
  rank     ``ops/pointnet2.py::candidate_rank_select`` against brute force;
  iou      ``core/iou3d.py::boxes_iou3d`` against the exact rotated BEV IoU
           (``np_geometry.boxes_bev_iou_cpu``) up to 60 m out: the pairs
           apart within 5e-3, the cluster of pairs jittered by millimetres
           within NEAR_IDENTICAL_IOU (the misread both packages share),
           and self-IoU == 1 within 1e-3 (a product in TF32 or bf16 reads
           it 0.33 or 1e7).

One ``ok`` / ``FAIL`` line a case with its largest error; the exit code is
1 when any case fails. It needs a card: there is nothing to verify on the
CPU, where every wrapper takes its plain version. ``verify(kernels)``
returns the cases as dicts.
"""

import argparse
import sys

import numpy as np
import torch

from ..core.iou3d import boxes_iou3d
from ..core.np_geometry import boxes_bev_iou_cpu
from ..ops import pointnet2
from ..ops.scatter_cuda import scatter_rows
from ..ops.select_cuda import ball_select, ball_select_plain
from ..ops.sparse_conv_cuda import (
    rulebook_conv, rulebook_conv_dw, rulebook_conv_dw_plain,
    rulebook_conv_plain,
)
from ..ops.vfe_cuda import pillar_vfe
from ..utils.precision import full_f32
from .microbench_rbconv import make_rulebook

ALL = ('conv', 'ball', 'scatter', 'vfe', 'rank', 'iou')
BOUNDS = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)  # PV-RCNN's range
SPOT_CENTRES = 200
# the clipping IoU of both packages misreads pairs jittered by millimetres
# by up to this much, with the order of float32 rounding (ROADMAP.md
# section 3; tests/test_torch_iou_nms.py::test_near_identical_cluster_self_iou)
NEAR_IDENTICAL_IOU = 0.08


def case(name, kernel, got, want, atol, rtol):
    """A case's record: ok when every |got - want| <= atol + rtol *
    max(|want|, 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = err > atol + rtol * np.maximum(np.abs(want), 1.0)
    return {'case': name, 'kernel': kernel, 'ok': not bad.any(),
            'max_abs_err': float(err.max()) if err.size else 0.0,
            'bad': f'{int(bad.sum())}/{bad.size}'}


def verify_conv(device):
    rng = np.random.RandomState(0)
    b, vi, c, co = 4, 8192, 32, 32
    rule = torch.from_numpy(make_rulebook(rng, b, vi, vi)).to(device)
    f = torch.from_numpy(rng.randn(b, vi, c).astype(np.float32)).to(
        device, torch.bfloat16)
    w = torch.from_numpy((rng.randn(27, c, co) * 0.1).astype(np.float32)).to(
        device, torch.bfloat16)
    g = torch.from_numpy(rng.randn(b, vi, co).astype(np.float32)).to(
        device, torch.bfloat16)
    out = [case('K3 rulebook_conv (bf16, C 32, V 8192)', 'rulebook_conv',
                rulebook_conv(f, rule, w).cpu(),
                rulebook_conv_plain(f, rule, w).cpu(), 1e-3, 1e-4)]
    dw = rulebook_conv_dw(f, rule, g).cpu()
    out.append(case('K4 rulebook_conv_dw (bf16, C 32, V 8192)',
                    'rulebook_conv_dw', dw,
                    rulebook_conv_dw_plain(f, rule, g).cpu(), 1e-2, 1e-4))
    w32 = w.float().requires_grad_(True)
    (rulebook_conv_plain(f.float(), rule, w32) * g.float()).sum().backward()
    out.append(case('K4 against autograd of the plain conv',
                    'rulebook_conv_dw', dw, w32.grad.cpu(), 1e-2, 1e-4))
    return out


def ball_shape(rng, shape):
    """(sources, centres, radii, nsamples) of one of the two shapes."""
    if shape == 'vsa':
        b, n, m = 4, 16384, 1024
        radii, ns = (0.8, 1.2), (16, 32)

        def points(k):
            return np.stack([rng.uniform(0, 69, (b, k)),
                             rng.uniform(-39, 39, (b, k)),
                             rng.uniform(-3, 1, (b, k))], -1)

        return points(n), points(m), radii, ns
    # PointRCNN's SA1 shape with clustered sources: 64 tight clusters hold
    # half the points, so many cells overflow the cap
    b, n, m = 8, 16384, 4096
    cl = rng.uniform([2, -35, -2.5], [65, 35, 0.5], (b, 64, 3))
    which = rng.integers(0, 64, (b, n // 2))
    clustered = (np.take_along_axis(cl, which[..., None], axis=1)
                 + rng.normal(0, 0.15, (b, n // 2, 3)))
    uniform = np.stack([rng.uniform(0, 69, (b, n // 2)),
                        rng.uniform(-39, 39, (b, n // 2)),
                        rng.uniform(-3, 1, (b, n // 2))], -1)
    src = np.concatenate([clustered, uniform], 1)
    ctr = np.take_along_axis(src, rng.integers(0, n, (b, m))[..., None], axis=1)
    return src, ctr, (0.1, 0.5), (16, 32)


def verify_ball(device, shape):
    rng = np.random.default_rng(1 if shape == 'vsa' else 2)
    src, ctr, radii, ns = ball_shape(rng, shape)
    b, n = src.shape[:2]
    m = ctr.shape[1]
    xyz = torch.from_numpy(src.astype(np.float32)).to(device)
    centres = torch.from_numpy(ctr.astype(np.float32)).to(device)
    num = torch.full((b,), n - 64, dtype=torch.int32, device=device)
    args = pointnet2.grid_select_args(radii, ns, xyz, num, centres,
                                      torch.ones((b, m), dtype=torch.bool,
                                                 device=device),
                                      bounds=BOUNDS, cell_cap=64)
    tops = ball_select(*args)
    plain = ball_select_plain(*args)
    out = []
    exact = shape == 'vsa'
    sn, cn, nv = src.astype(np.float32), ctr.astype(np.float32), n - 64
    for ri, (r, k) in enumerate(zip(radii, ns)):
        err = (tops[ri] - plain[ri]).nan_to_num(posinf=0, neginf=0).abs()
        same = torch.equal(torch.isfinite(tops[ri]), torch.isfinite(plain[ri]))
        gi, ge = (t.cpu().numpy() for t in pointnet2.decode(tops[ri], k))
        sel = rng.integers(0, m, SPOT_CENTRES)
        bad = 0
        for bi in range(b):
            d2 = ((sn[bi, :nv, None, :] - cn[bi, sel][None]) ** 2).sum(-1)
            for j, c in enumerate(sel):
                hits = np.where(d2[:, j] < np.float32(r) * np.float32(r))[0]
                if len(hits) == 0:
                    bad += 0 if ge[bi, c] else 1
                elif not exact or len(hits) >= k:
                    bad += 0 if set(gi[bi, c]) <= set(hits) else 1
                else:
                    bad += 0 if set(gi[bi, c]) == set(hits) else 1
        name = (f'K5 ball_select [{shape}] r {r} nsample {k} '
                f'({"exact" if exact else "cap-relaxed"})')
        out.append({'case': name, 'kernel': 'ball_select',
                    'ok': bool(same) and float(err.max()) == 0.0 and bad == 0,
                    'max_abs_err': float(err.max()),
                    'bad': f'{bad}/{b * SPOT_CENTRES} centres'})
    return out


def verify_scatter(device):
    rng = np.random.default_rng(2)
    b, v, c, s, n = 4, 16384, 64, 214272, 12000
    keys = np.full((b, v), s, np.int32)
    for bi in range(b):
        keys[bi, :n] = np.sort(rng.choice(s, n, replace=False))
    feats = rng.standard_normal((b, v, c)).astype(np.float32)
    got = scatter_rows(torch.from_numpy(feats).to(device),
                       torch.from_numpy(keys).to(device), s).cpu()
    want = np.zeros((b, s, c), np.float32)
    for bi in range(b):
        want[bi, keys[bi, :n]] = feats[bi, :n]
    return [case('K2 scatter_rows (V 16384 -> 214272 slots, C 64)',
                 'scatter_rows', got, want, 0.0, 0.0)]


def verify_vfe(device):
    rng = np.random.default_rng(3)
    b, v, p, c = 2, 4096, 32, 64
    vox4 = rng.standard_normal((b, v, p, 4)).astype(np.float32)
    ctr4 = np.concatenate([rng.standard_normal((b, v, 3)),
                           np.zeros((b, v, 1))], axis=-1).astype(np.float32)
    pillar_bias = rng.standard_normal((b, v, c)).astype(np.float32)
    counts = rng.integers(0, p + 1, (b, v)).astype(np.int32)
    w4 = (rng.standard_normal((4, c)) * 0.1).astype(np.float32)
    shift = rng.standard_normal((c,)).astype(np.float32)
    got = pillar_vfe(*(torch.from_numpy(a).to(device) for a in
                       (vox4, ctr4, pillar_bias, counts, w4, shift)),
                     out_dtype=torch.float32).cpu()
    xc = vox4 - ctr4[:, :, None, :]
    z = xc @ w4 + pillar_bias[:, :, None, :]
    rows = np.arange(p)[None, None, :, None]
    z = np.where(rows < counts[:, :, None, None], z, -np.inf)
    pad = np.where((counts < p)[..., None], shift[None, None], -np.inf)
    want = np.maximum(np.maximum(z.max(axis=2), pad), 0.0)
    return [case('K1 pillar_vfe (f32, V 4096, P 32, C 64)', 'pillar_vfe',
                 got, want, 1e-4, 1e-5)]


def verify_rank(device):
    rng = np.random.default_rng(4)
    b, r, k, g, ns, radius = 2, 32, 128, 27, 16, 1.5
    cand = rng.uniform(-3, 3, (b, r, k, 3)).astype(np.float32)
    live = rng.uniform(size=(b, r, k)) < 0.8
    grid = rng.uniform(-2, 2, (b, r, g, 3)).astype(np.float32)
    idx, empty = pointnet2.candidate_rank_select(
        *(torch.from_numpy(a).to(device) for a in (cand, live, grid)),
        radius, ns)
    idx, empty = idx.cpu().numpy(), empty.cpu().numpy()
    bad = 0
    for bi in range(b):
        for ri in range(r):
            for gi in range(g):
                d2 = ((cand[bi, ri] - grid[bi, ri, gi]) ** 2).sum(-1)
                hits = np.where(live[bi, ri] & (d2 < np.float32(radius ** 2)))[0]
                if len(hits) == 0:
                    bad += 0 if empty[bi, ri, gi] else 1
                    continue
                want = list(hits[:ns]) + [hits[0]] * max(0, ns - len(hits))
                bad += 0 if list(idx[bi, ri, gi]) == want else 1
    return [{'case': 'RoI candidate_rank_select', 'kernel': None,
             'ok': bad == 0, 'max_abs_err': float(bad),
             'bad': f'{bad}/{b * r * g} grid points'}]


def verify_iou(device):
    rng = np.random.default_rng(7)
    n = 96
    base = np.concatenate([
        rng.uniform(-60, 60, (n, 2)), rng.uniform(-2, 2, (n, 1)),
        rng.uniform(1.5, 4.5, (n, 2)), rng.uniform(1.2, 2.0, (n, 1)),
        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)
    # half the pairs: the same boxes moved by millimetres, as a converged
    # two-stage head's boxes are
    jit = base.copy()
    jit[:n // 2, :3] += rng.normal(0, 2e-3, (n // 2, 3))
    jit[:n // 2, 6] += rng.normal(0, 1e-4, n // 2)
    got = boxes_iou3d(torch.from_numpy(base).to(device),
                      torch.from_numpy(jit).to(device)).cpu().numpy()
    bev = boxes_bev_iou_cpu(base, jit)
    area_a = (base[:, 3] * base[:, 4])[:, None]
    area_b = (jit[:, 3] * jit[:, 4])[None, :]
    ov_bev = bev * (area_a + area_b) / (1.0 + bev)
    za1, za2 = base[:, 2] - base[:, 5] / 2, base[:, 2] + base[:, 5] / 2
    zb1, zb2 = jit[:, 2] - jit[:, 5] / 2, jit[:, 2] + jit[:, 5] / 2
    zov = np.clip(np.minimum(za2[:, None], zb2[None, :])
                  - np.maximum(za1[:, None], zb1[None, :]), 0, None)
    ov3d = ov_bev * zov
    vol_a = (base[:, 3] * base[:, 4] * base[:, 5])[:, None]
    vol_b = (jit[:, 3] * jit[:, 4] * jit[:, 5])[None, :]
    want = ov3d / np.clip(vol_a + vol_b - ov3d, 1e-6, None)
    near = np.zeros((n, n), bool)  # the millimetre-jittered pairs
    near[np.arange(n // 2), np.arange(n // 2)] = True
    diag = np.diagonal(got)[n // 2:]  # the exact self pairs
    return [case('boxes_iou3d (pairs apart)', None, got[~near], want[~near],
                 5e-3, 5e-3),
            case('boxes_iou3d (near-identical pairs)', None, got[near],
                 want[near], NEAR_IDENTICAL_IOU, 0.0),
            case('boxes_iou3d self-IoU == 1', None, diag, np.ones_like(diag),
                 1e-3, 0.0)]


def verify(kernels=ALL, device='cuda'):
    """The cases of `kernels` (names of ALL) on `device`, a card."""
    device = torch.device(device)
    if device.type != 'cuda' or not torch.cuda.is_available():
        raise RuntimeError('verify_cuda checks the kernels on a card: CUDA is '
                           'not available (on the CPU every wrapper takes its '
                           'plain version, so there is nothing to verify)')
    unknown = set(kernels) - set(ALL)
    if unknown:
        raise ValueError(f'unknown kernels {sorted(unknown)}; choose from {ALL}')
    runs = {'conv': [verify_conv], 'ball': [
        lambda d: verify_ball(d, 'vsa'), lambda d: verify_ball(d, 'prcnn')],
        'scatter': [verify_scatter], 'vfe': [verify_vfe],
        'rank': [verify_rank], 'iou': [verify_iou]}
    out = []
    with full_f32():  # the plain versions' products in float32, not TF32
        for name in ALL:
            if name in kernels:
                for fn in runs[name]:
                    out += fn(device)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernels', default=','.join(ALL))
    args = parser.parse_args(argv)
    results = verify(tuple(args.kernels.split(',')))
    for r in results:
        print(f'{"ok  " if r["ok"] else "FAIL"} {r["case"]:<52} '
              f'max_abs_err={r["max_abs_err"]:.3e} bad={r["bad"]}', flush=True)
    failed = [r['case'] for r in results if not r['ok']]
    if failed:
        print('FAILED:', ', '.join(failed), flush=True)
        return 1
    print(f'all cases verified on {torch.cuda.get_device_name(0)}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
