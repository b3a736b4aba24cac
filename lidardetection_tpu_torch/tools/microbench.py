"""PointPillar's hot stages one at a time on the card (counterpart of
tools/microbench.py:1-300, tools/microbench_conv.py:1-76 and
tools/bench_scatter.py:1-77).

Cases (``--case``, default all):
  matmul       dense products at microbench.py's four shapes (:131-134),
               TFLOP/s against the H100's peak for ``--dtype``;
  conv_blocks  the BEV backbone's 3x3 convolutions one at a time
               (microbench_conv.py's ten shapes, :31-42, and
               microbench.py's 256-channel 64 x 64, :153): cuDNN,
               channels_last, ms, GFLOP, TFLOP/s and the share of the
               peak for ``--dtype``;
  conv         the whole BEV backbone of pointpillar.yaml (three blocks
               of 3x3 convolutions, the three deconvolutions to 128
               channels each, ReLUs; microbench.py:53-112) at 496 x 432,
               512 x 448 and 512 x 512;
  vfe          K1 (``pillar_vfe``) at B x 40960 pillars (``--v``), P 32,
               C 64 against its plain version (bit for bit), its bound and
               a bare fill of its output (microbench.py:187-229);
  scatter      K2 (``scatter_rows``) at bench_scatter.py's shape (B 8, V
               40448, C 64, 496 x 432 slots, a tail of padding rows in
               each sample) against numpy, beside its plain version,
               ``zeros`` + ``index_put_`` (the library call), a bare
               ``zero_`` of the canvas, and its bound;
  nms          the blocked NMS walk (``core/iou3d.py::nms_bev_batched``)
               at B x 4096 boxes, threshold 0.01, 500 kept
               (microbench.py:264-290), against the full-matrix oracle
               (``measure.full_matrix_nms``): the kept lists equal, both
               times.

Times are ``measure.cuda_ms``'s (CUDA events, the L2 flushed clean, the
median of ``--iters``; the NMS walk, which reads its blocks back on the
host, as a caller sees it). The JAX tools' Pallas variants and
``fori_loop`` chains have no counterpart: the port has one kernel a
stage.

    python -m lidardetection_tpu_torch.tools.microbench --case all
    python -m lidardetection_tpu_torch.tools.microbench --case scatter --b 8

``--cpu`` runs the plain versions and PyTorch's CPU operators on the host
clock.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..core.iou3d import nms_bev_batched
from ..ops.scatter_cuda import scatter_rows, scatter_rows_plain
from ..ops.vfe_cuda import pillar_vfe, pillar_vfe_plain
from ..utils.precision import full_f32
from . import measure
from .common import tool_device

CASES = ('matmul', 'conv_blocks', 'conv', 'vfe', 'scatter', 'nms')
# (name, H, W, cin, cout, stride): microbench_conv.py's ten and
# microbench.py's 64 x 64
CONV_BLOCKS = (
    ('b1 stride', 496, 432, 64, 64, 2), ('b1 conv', 248, 216, 64, 64, 1),
    ('b2 stride', 248, 216, 64, 128, 2), ('b2 conv', 124, 108, 128, 128, 1),
    ('b3 stride', 124, 108, 128, 256, 2), ('b3 conv', 62, 54, 256, 256, 1),
    ('b1 conv pad512', 256, 224, 64, 64, 1),
    ('b1 conv c128', 248, 216, 128, 128, 1),
    ('b2 conv pad', 128, 112, 128, 128, 1), ('b3 conv pad', 64, 56, 256, 256, 1),
    ('b3 conv 64x64', 64, 64, 256, 256, 1))
MATMULS = ((4096, 4096, 4096), (8192, 2048, 2048),
           (53568 * 8 // 64 * 64, 576, 64), (53568, 576, 128))
BLOCKS = ((64, 3, 2), (128, 5, 2), (256, 5, 2))  # filters, layers, stride
UPSAMPLE = ((64, 1), (128, 2), (256, 4))         # each to 128 channels


def bench_matmul(device, dtype, iters):
    rows = []
    peak = measure.peak_flop_per_s(dtype)
    g = torch.Generator(device=device).manual_seed(0)
    for m, k, n in MATMULS:
        a = torch.randn((m, k), generator=g, device=device).to(dtype)
        b = torch.randn((k, n), generator=g, device=device).to(dtype)
        ms = measure.time_ms(lambda: a @ b, device, iters=iters)
        tf = 2 * m * k * n / (ms / 1e3) / 1e12
        rows.append({'shape': f'{m}x{k}x{n}', 'ms': ms, 'tflop_per_s': tf,
                     'peak_share': tf * 1e12 / peak})
        print(f'matmul {m}x{k}x{n} {str(dtype)[6:]}: {ms:.4f} ms = {tf:.1f} '
              f'TFLOP/s ({100 * tf * 1e12 / peak:.1f}% of peak)', flush=True)
    return rows


def bench_conv_blocks(device, batch, dtype, iters):
    peak = measure.peak_flop_per_s(dtype)
    g = torch.Generator(device=device).manual_seed(0)
    print(f'{"case":<18}{"ms":>9}{"GFLOP":>9}{"TF/s":>8}{"peak%":>7}', flush=True)
    rows = []
    for name, h, w, cin, cout, stride in CONV_BLOCKS:
        x = torch.randn((batch, cin, h, w), generator=g, device=device).to(
            dtype).contiguous(memory_format=torch.channels_last)
        k = (torch.randn((cout, cin, 3, 3), generator=g, device=device) * 0.05
             ).to(dtype).contiguous(memory_format=torch.channels_last)
        ms = measure.time_ms(
            lambda: F.conv2d(x, k, stride=stride, padding=1), device,
            iters=iters)
        gflop = 2 * batch * (h // stride) * (w // stride) * 9 * cin * cout / 1e9
        tfs = gflop / ms
        rows.append({'case': name, 'ms': ms, 'gflop': gflop, 'tflop_per_s': tfs,
                     'peak_share': tfs * 1e12 / peak})
        print(f'{name:<18}{ms:>9.4f}{gflop:>9.1f}{tfs:>8.1f}'
              f'{100 * tfs * 1e12 / peak:>7.1f}', flush=True)
    return rows


def bev_stack(device, dtype, cin=64, seed=0):
    """pointpillar.yaml's BEV backbone as bare convolutions (random
    weights): (forward(x), FLOP of one call at (h, w))."""
    g = torch.Generator(device=device).manual_seed(seed)

    def weight(*shape):
        return (torch.randn(shape, generator=g, device=device) * 0.05).to(
            dtype).contiguous(memory_format=torch.channels_last)

    convs, c = [], cin
    for nf, n_layers, stride in BLOCKS:
        convs.append([(weight(nf, c, 3, 3), stride)]
                     + [(weight(nf, nf, 3, 3), 1) for _ in range(n_layers)])
        c = nf
    deconvs = [(weight(nf, 128, us, us), us) for nf, us in UPSAMPLE]

    def forward(x):
        ups = []
        for block in convs:
            for wgt, s in block:
                x = torch.relu(F.conv2d(x, wgt, stride=s, padding=1))
            ups.append(x)
        return torch.cat([torch.relu(F.conv_transpose2d(u, wgt, stride=us))
                          for u, (wgt, us) in zip(ups, deconvs)], dim=1)

    def flop(batch, h, w):
        total, c = 0, cin
        for (nf, n_layers, stride), (_, us) in zip(BLOCKS, UPSAMPLE):
            h, w = h // stride, w // stride
            total += 2 * batch * h * w * 9 * (c * nf + n_layers * nf * nf)
            total += 2 * batch * h * w * nf * 128 * us * us
            c = nf
        return total

    return forward, flop


def bench_conv(device, batch, dtype, iters):
    forward, flop = bev_stack(device, dtype)
    peak = measure.peak_flop_per_s(dtype)
    g = torch.Generator(device=device).manual_seed(1)
    rows = []
    for h, w in ((496, 432), (512, 448), (512, 512)):
        x = torch.randn((batch, 64, h, w), generator=g, device=device).to(
            dtype).contiguous(memory_format=torch.channels_last)
        ms = measure.time_ms(lambda: forward(x), device, iters=iters)
        tf = flop(batch, h, w) / (ms / 1e3) / 1e12
        rows.append({'shape': f'{h}x{w}', 'ms': ms, 'tflop_per_s': tf,
                     'peak_share': tf * 1e12 / peak})
        print(f'conv bev {h}x{w} b{batch}: {ms:.3f} ms/batch = {tf:.1f} '
              f'TFLOP/s ({100 * tf * 1e12 / peak:.1f}% of peak)', flush=True)
    return rows


def bench_vfe(device, batch, v=40960, p=32, c=64, iters=20):
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(a).to(device)

    vox = t(rng.rand(batch, v, p, 4).astype(np.float32))
    ctr = t(rng.rand(batch, v, 4).astype(np.float32))
    pb = t(rng.rand(batch, v, c).astype(np.float32))
    counts = t(rng.randint(0, p + 1, size=(batch, v)).astype(np.int32))
    w4 = t((rng.randn(4, c) * 0.1).astype(np.float32)).bfloat16()
    shift = t(rng.randn(c).astype(np.float32))
    a = (vox, ctr, pb, counts, w4, shift)
    got, want = pillar_vfe(*a), pillar_vfe_plain(*a)
    err = float((got.float() - want.float()).abs().max())
    n_bytes, n_flop = measure.vfe_work(counts, p, c)
    bound, by = measure.bound_ms(n_bytes, n_flop)
    out = torch.empty((batch, v, c), dtype=torch.bfloat16, device=device)
    row = {'shape': f'B={batch} V={v} P={p} C={c}', 'bit_equal': bool(torch.equal(got, want)),
           'max_abs_err': err,
           'ms': measure.time_ms(lambda: pillar_vfe(*a), device, iters=iters),
           'plain_ms': measure.time_ms(lambda: pillar_vfe_plain(*a), device,
                                       iters=max(iters // 4, 1)),
           'fill_ms': measure.time_ms(out.zero_, device, iters=iters),
           'bound_ms': bound, 'bound_by': by}
    print(f'vfe K1 {row["shape"]}: {row["ms"]:.4f} ms, plain '
          f'{row["plain_ms"]:.4f} ms, bound {bound:.4f} ms ({by}), a fill of '
          f'its output {row["fill_ms"]:.4f} ms; bit-equal to plain '
          f'{row["bit_equal"]}', flush=True)
    return row


def scatter_inputs(device, b, v, c, n_slots, dtype, seed=0):
    """bench_scatter.py:36-50: per sample v distinct sorted keys, a tail of
    padding rows (key n_slots) from a random valid count; features
    standard normal; and the numpy reference canvas."""
    rng = np.random.RandomState(seed)
    keys = np.sort(np.stack([rng.choice(n_slots, v, replace=False)
                             for _ in range(b)]), axis=1)
    nvalid = rng.randint(v // 2, v, size=b)
    for i in range(b):
        keys[i, nvalid[i]:] = n_slots
    feats = torch.from_numpy(rng.randn(b, v, c).astype(np.float32)).to(dtype)
    ref = np.zeros((b, n_slots, c), np.float32)
    for i in range(b):
        ref[i, keys[i, :nvalid[i]]] = feats[i, :nvalid[i]].float().numpy()
    return (feats.to(device), torch.from_numpy(keys.astype(np.int32)).to(device),
            ref)


def bench_scatter(device, b, v, c, n_slots, dtype, iters):
    feats, keys, ref = scatter_inputs(device, b, v, c, n_slots, dtype)
    got = scatter_rows(feats, keys, n_slots)
    err = float(np.abs(got.float().cpu().numpy() - ref).max())
    n_kept, n_bytes = measure.scatter_work(feats, keys, n_slots)
    kept = keys < n_slots
    rows_b = torch.nonzero(kept)[:, 0]
    rows_k, rows_f = keys[kept].long(), feats[kept]

    def library():
        canvas = torch.zeros((b, n_slots, c), dtype=feats.dtype, device=device)
        canvas.index_put_((rows_b, rows_k), rows_f)

    canvas = torch.empty((b, n_slots, c), dtype=feats.dtype, device=device)
    bound, by = measure.bound_ms(n_bytes, 0)
    row = {'shape': f'B={b} V={v} C={c} slots={n_slots} kept={n_kept}',
           'max_abs_err': err,
           'ms': measure.time_ms(lambda: scatter_rows(feats, keys, n_slots),
                                 device, iters=iters),
           'plain_ms': measure.time_ms(
               lambda: scatter_rows_plain(feats, keys, n_slots), device,
               iters=iters),
           'library_ms': measure.time_ms(library, device, iters=iters),
           'fill_ms': measure.time_ms(canvas.zero_, device, iters=iters),
           'bound_ms': bound, 'bound_by': by, 'bytes': n_bytes}
    print(f'scatter K2 {row["shape"]} {str(dtype)[6:]}: {row["ms"]:.4f} ms '
          f'(~{n_bytes / row["ms"] / 1e6:.0f} GB/s), plain {row["plain_ms"]:.4f} '
          f'ms, zeros + index_put_ {row["library_ms"]:.4f} ms, zero_ of the '
          f'canvas {row["fill_ms"]:.4f} ms, bound {bound:.4f} ms ({by}); '
          f'maxerr={err:.2e}', flush=True)
    return row


def nms_inputs(device, batch, n, seed=0):
    """microbench.py:238-250: KITTI-like boxes over 60 m, scores sorted
    descending."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(batch, n, 2).astype(np.float32) * 60
    wh = 1.5 + rng.rand(batch, n, 2).astype(np.float32) * 2.5
    boxes = np.concatenate([
        xy, np.zeros((batch, n, 1), np.float32), wh,
        1.5 * np.ones((batch, n, 1), np.float32),
        rng.rand(batch, n, 1).astype(np.float32) * np.pi], axis=2)
    scores = np.sort(rng.rand(batch, n).astype(np.float32))[:, ::-1].copy()
    return torch.from_numpy(boxes).to(device), torch.from_numpy(scores).to(device)


def bench_nms(device, batch, n=4096, iters=10):
    boxes, scores = nms_inputs(device, batch, n)

    def walk():
        return nms_bev_batched(boxes, scores, 0.01, n, 500, assume_sorted=True)

    idx, mask, num, rows_read = walk()
    got = [i[m].tolist() for i, m in zip(idx.cpu(), mask.cpu())]
    want = measure.full_matrix_nms(boxes, scores, None, 0.01, n, 500)
    row = {'shape': f'B={batch} N={n}', 'kept_equal': got == want,
           'kept': [len(k) for k in got], 'rows_read': rows_read.tolist(),
           'ms': measure.time_ms(walk, device, iters=iters, queued=False),
           'full_matrix_ms': measure.time_ms(
               lambda: measure.full_matrix_nms(boxes, scores, None, 0.01, n, 500),
               device, iters=max(iters // 4, 1), queued=False)}
    print(f'nms b{batch} n{n} thresh 0.01: walk {row["ms"]:.3f} ms/batch '
          f'(rows read {row["rows_read"]}), full matrix '
          f'{row["full_matrix_ms"]:.3f} ms; kept {row["kept"]}, equal lists '
          f'{row["kept_equal"]}', flush=True)
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--case', default='all', choices=CASES + ('all',))
    ap.add_argument('--batch', '--b', dest='batch', type=int, default=8)
    ap.add_argument('--dtype', default='bfloat16',
                    help='the convolutions\', products\' and scatter rows\' type')
    ap.add_argument('--v', type=int, default=None,
                    help='rows of K2 (default 40448) and pillars of K1 '
                         '(default 40960)')
    ap.add_argument('--c', type=int, default=64, help='channels of K2')
    ap.add_argument('--slots', type=int, default=496 * 432)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    dtype = getattr(torch, args.dtype)
    print(f'# device: {measure.device_line(device)}', flush=True)
    measure.reset_launches()
    out = {}
    with full_f32(dtype == torch.float32):
        for case in CASES:
            if args.case not in (case, 'all'):
                continue
            if case == 'matmul':
                out[case] = bench_matmul(device, dtype, args.iters)
            elif case == 'conv_blocks':
                out[case] = bench_conv_blocks(device, args.batch, dtype, args.iters)
            elif case == 'conv':
                out[case] = bench_conv(device, args.batch, dtype, args.iters)
            elif case == 'vfe':
                out[case] = bench_vfe(device, args.batch, args.v or 40960,
                                      iters=args.iters)
            elif case == 'scatter':
                out[case] = bench_scatter(device, args.batch, args.v or 40448,
                                          args.c, args.slots, dtype, args.iters)
            else:
                out[case] = bench_nms(device, args.batch, iters=args.iters)
    return measure.summary_line('microbench', device, **out)


if __name__ == '__main__':
    main()
