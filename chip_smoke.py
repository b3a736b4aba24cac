"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: PointPillar and
SECOND serving.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises on failure (non-zero exit, no result line):
  1. build the kernels of csrc/ with nvcc (one nvcc per source, together);
  2. K1 and K2 against their plain PyTorch versions on the card, at the
     PointPillar path's shapes (40000-pillar table of voxelized synthetic
     scenes, P = 32, C = 64, 496 x 432 canvas, B = 1 and B = 4), and their
     times beside the bound, the plain version's time and a library call's;
  3. serve requests through ``serve.Detector`` on the full
     tools/cfgs/kitti_models/pointpillar.yaml (bf16 compute, random
     weights from a seed, class-logit bias 0 so NMS sees live candidates),
     with every kernel's launch count set to 0 just before and read after;
  4. the same weights and clouds in f32 on the card (kernels) and on the
     CPU (plain versions): head outputs and kept detections must agree;
  5. K3 against its plain version on the card at the SECOND path's shapes:
     the twelve convolutions of the full second.yaml backbone, with the
     rulebooks and activations of real voxelized scans (V = 40000), in
     bf16 and f32, B = 1 and B = 4, one rulebook with shuffled rows, and
     K2 at SECOND's shape (C = 128, 2 x 200 x 176 slots); their times;
  6. and 7. phases 3 and 4 for the full tools/cfgs/kitti_models/second.yaml.
The line before the last is the kernels' JSON, preceded by the card's name
and power limit; the last line is the device JSON.
"""

import json
import subprocess
import sys
import time

import numpy as np

CFG = 'tools/cfgs/kitti_models/pointpillar.yaml'
CFG_SECOND = 'tools/cfgs/kitti_models/second.yaml'
SEED = 0
N_REQUESTS = 5               # PointPillar
N_REQUESTS_SECOND = 10
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12     # H100 SXM, dense bf16 on the tensor cores


def check(ok, what):
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def gpu_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, torch, iters=30, warmup=5, queued=True):
    """Median time of fn() in ms over `iters` calls, from CUDA events
    around each call, with a 64 MB write between calls so every call
    finds the 50 MB L2 cold, as a request's first touch does.

    queued=True holds the stream in a ~1 ms device sleep while the host
    enqueues the events and fn's kernels, so the events time the device
    work alone; queued=False times the call as a caller sees it, host
    overhead between launches included."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')
    times = []
    for i in range(warmup + iters):
        flush.zero_()
        if queued:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes, n_flop, flop_per_s=F32_FLOP_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / flop_per_s
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def make_clouds(det, n, seed):
    """n synthetic scans (18k ground-ring points + objects) from a seed."""
    from lidardetection_tpu_torch.datasets.synthetic import make_scene

    rng = np.random.RandomState(seed)
    pc_range = np.asarray(det.info['point_cloud_range'], np.float32)
    return [make_scene(rng, pc_range)[0] for _ in range(n)]


def time_scatter(torch, feats, keys, n_slots):
    """K2 at one request's shape: the kernel's, the plain version's and a
    library call's time (``zeros`` + ``index_put_`` with the kept rows
    selected beforehand), and the bound: the canvas written once, the keys
    and the kept rows read once."""
    from lidardetection_tpu_torch.ops.scatter_cuda import (
        scatter_rows, scatter_rows_plain,
    )

    _, v, c = feats.shape
    kept = keys[0] < n_slots
    n_kept = int(kept.sum())
    rows_b = torch.zeros(n_kept, dtype=torch.long, device='cuda')
    rows_k, rows_f = keys[0][kept].long(), feats[0][kept]

    def library():
        canvas = torch.zeros((1, n_slots, c), dtype=feats.dtype, device='cuda')
        canvas.index_put_((rows_b, rows_k), rows_f)

    size = feats.element_size()
    n_bytes = n_slots * c * size + v * 4 + n_kept * c * size
    row = {'shape': f'V={v} C={c} slots={n_slots} kept={n_kept}',
           'ms': cuda_ms(lambda: scatter_rows(feats, keys, n_slots), torch),
           'plain_ms': cuda_ms(
               lambda: scatter_rows_plain(feats, keys, n_slots), torch),
           'library_ms': cuda_ms(library, torch), 'bytes': n_bytes}
    row['bound_ms'], row['bound_by'] = bound_ms(n_bytes, 0)
    return row


def pillar_kernel_phase(torch, det):
    """K1 and K2 against their plain versions at PointPillar's shapes."""
    from lidardetection_tpu_torch.ops.scatter_cuda import (
        scatter_rows, scatter_rows_plain,
    )
    from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe, pillar_vfe_plain

    batch = det.make_batch(make_clouds(det, 4, SEED + 100))
    vox, counts, coords = (batch['voxels'], batch['voxel_num_points'],
                           batch['voxel_coords'])
    b4, v, p, _ = vox.shape
    c = 64
    nx, ny = det.info['grid_size'][:2]
    n_slots = nx * ny
    vx, vy, vz = det.info['voxel_size']
    lo = det.info['point_cloud_range']
    g = torch.Generator(device='cuda').manual_seed(SEED)
    centers = torch.stack([coords[..., 2] * vx + (vx / 2 + lo[0]),
                           coords[..., 1] * vy + (vy / 2 + lo[1]),
                           coords[..., 0] * vz + (vz / 2 + lo[2]),
                           torch.zeros_like(coords[..., 0])], -1).float()
    pb = torch.randn((b4, v, c), generator=g, device='cuda') * 0.5
    w4 = torch.randn((4, c), generator=g, device='cuda') * 0.3
    shift = torch.randn((c,), generator=g, device='cuda') * 0.1
    keys = torch.where(coords[..., 0] >= 0, coords[..., 1] * nx + coords[..., 2],
                       torch.full_like(coords[..., 0], n_slots)).int()
    feats = torch.randn((b4, v, c), generator=g, device='cuda').bfloat16()
    print(f'kernel inputs: B={b4} V={v} P={p} C={c} pillars per scene '
          f'{batch["num_voxels"].tolist()}, points kept per scene '
          f'{counts.sum(1).tolist()}', flush=True)

    err = {'pillar_vfe': 0.0, 'scatter_rows': 0.0}
    for b in (1, b4):
        args = (vox[:b], centers[:b], pb[:b], counts[:b])
        for wdt, odt, atol, rtol in ((torch.bfloat16, torch.bfloat16, 1e-2, 1e-2),
                                     (torch.float32, torch.float32, 1e-5, 0.0)):
            got = pillar_vfe(*args, w4.to(wdt), shift, out_dtype=odt)
            want = pillar_vfe_plain(*args, w4.to(wdt), shift, out_dtype=odt)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            e = float(d.max())
            print(f'K1 pillar_vfe B={b} {str(odt)[6:]}: max|kernel-plain| = {e:.3g} '
                  f'(tolerance atol {atol} rtol {rtol})', flush=True)
            check(bool((d <= atol + rtol * want.float().abs()).all()),
                  f'pillar_vfe B={b} {odt} within tolerance')
            err['pillar_vfe'] = max(err['pillar_vfe'], e)
        got = scatter_rows(feats[:b], keys[:b], n_slots)
        want = scatter_rows_plain(feats[:b], keys[:b], n_slots)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        print(f'K2 scatter_rows B={b}: max|kernel-plain| = {e} (bit-exact '
              f'required: {torch.equal(got, want)})', flush=True)
        check(torch.equal(got, want), f'scatter_rows B={b} bit-exact')
        err['scatter_rows'] = max(err['scatter_rows'], e)

    # timings at the main path's shape: one request, B = 1
    a1 = (vox[:1], centers[:1], pb[:1], counts[:1], w4.bfloat16(), shift)
    f1, k1keys = feats[:1], keys[:1]
    calls = {'pillar_vfe': lambda: pillar_vfe(*a1),
             'scatter_rows': lambda: scatter_rows(f1, k1keys, n_slots)}
    n_pts = int(counts[:1].sum())
    n_live = int((counts[:1] > 0).sum())
    k1_bytes = (v * 4 + n_live * (16 + c * 4) + n_pts * 16 + v * c * 2
                + 4 * c * 2 + c * 4)
    k1_flop = n_pts * c * 8 + v * c * 3
    k1 = {'name': 'pillar_vfe', 'route': 'cuda',
          'source': 'lidardetection_tpu_torch/csrc/vfe.cu',
          'replaces': 'lidardetection_tpu/ops/vfe_tpu.py:78',
          'max_abs_err': err['pillar_vfe'],
          'ms': cuda_ms(calls['pillar_vfe'], torch),
          'plain_ms': cuda_ms(lambda: pillar_vfe_plain(*a1), torch),
          'library_ms': None}
    k1['bound_ms'], k1['bound_by'] = bound_ms(k1_bytes, k1_flop)

    k2 = {'name': 'scatter_rows', 'route': 'cuda',
          'source': 'lidardetection_tpu_torch/csrc/scatter.cu',
          'replaces': 'lidardetection_tpu/ops/scatter_tpu.py:128',
          'max_abs_err': err['scatter_rows'],
          **time_scatter(torch, f1, k1keys, n_slots)}
    for k, nbytes in ((k1, k1_bytes), (k2, k2['bytes'])):
        call = cuda_ms(calls[k['name']], torch, queued=False)
        print(f'{k["name"]} B=1: device {k["ms"]:.4f} ms (call with host '
              f'overhead {call:.4f} ms), plain {k["plain_ms"]:.4f} ms, '
              f'library {k["library_ms"]}, bound {k["bound_ms"]:.4f} ms '
              f'({nbytes} bytes)', flush=True)
    return [k1, k2]


def record_sparse_layers(det, batch):
    """One forward of the SECOND detector with a hook on every sparse
    layer: [(layer, features, valid_mask, rulebook)] in call order, and the
    model's output."""
    from lidardetection_tpu_torch.models.backbones_3d.spconv_backbone import (
        SparseConvLayer,
    )

    records, hooks = [], []
    for module in det.model.modules():
        if isinstance(module, SparseConvLayer):
            hooks.append(module.register_forward_pre_hook(
                lambda m, args: records.append((m, *args))))
    try:
        out = det.forward(batch)
    finally:
        for hook in hooks:
            hook.remove()
    return records, out


def sparse_kernel_phase(torch, det):
    """K3 against its plain version at the SECOND path's shapes: every
    convolution of a forward over real scans, then its time per layer; K2
    at SECOND's shape."""
    from lidardetection_tpu_torch.ops import sparse
    from lidardetection_tpu_torch.ops.scatter_cuda import (
        scatter_rows, scatter_rows_plain,
    )
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv, rulebook_conv_plain,
    )

    batch = det.make_batch(make_clouds(det, 4, SEED + 200))
    records, out = record_sparse_layers(det, batch)
    check(len(records) == 12, f'12 sparse layers in a forward ({len(records)})')

    # f32 sums of up to K * C_in = 1728 exact products in another order:
    # the error stays under 1e-4 of the largest output
    err = 0.0
    for n, (layer, f, valid, rb) in enumerate(records, 1):
        for dtype in (torch.bfloat16, torch.float32):
            fd = f.to(dtype).contiguous()
            wd = layer.kernel.detach().to(dtype).contiguous()
            for b in (1, 4):
                got = rulebook_conv(fd[:b], rb[:b], wd, valid[:b])
                want = rulebook_conv_plain(fd[:b], rb[:b], wd, valid[:b])
                torch.cuda.synchronize()
                e, top = float((got - want).abs().max()), float(want.abs().max())
                check(top > 0 and e <= 1e-4 * top and bool(torch.isfinite(got).all()),
                      f'rulebook_conv layer {n} B={b} {dtype}: max error {e} '
                      f'against max|want| {top}')
                check(bool((got[:b][~valid[:b]] == 0).all()),
                      f'rulebook_conv layer {n}: padding rows are zero')
                err = max(err, e)
        k, c_in, c_out = layer.kernel.shape
        print(f'K3 rulebook_conv layer {n:2d} K={k} C {c_in}->{c_out}: rows '
              f'{valid.sum(1).tolist()} of {valid.shape[1]}, bf16 and f32, '
              f'B=1 and B=4 within 1e-4 * max|want|', flush=True)
    # a rulebook whose columns do not ascend: the rows of layer 7, shuffled
    layer, f, valid, rb = records[6]
    perm = torch.randperm(rb.shape[1], device='cuda',
                          generator=torch.Generator('cuda').manual_seed(SEED))
    fd = f[:1].bfloat16().contiguous()
    wd = layer.kernel.detach().bfloat16().contiguous()
    got = rulebook_conv(fd, rb[:1, perm].contiguous(), wd,
                        valid[:1, perm].contiguous())
    want = rulebook_conv_plain(fd, rb[:1], wd, valid[:1])[:, perm]
    torch.cuda.synchronize()
    e, top = float((got - want).abs().max()), float(want.abs().max())
    print(f'K3 rulebook_conv layer 7, rows shuffled: max|kernel-plain| = '
          f'{e:.3g} (max|want| {top:.3g})', flush=True)
    check(e <= 1e-4 * top, 'rulebook_conv on a shuffled rulebook')
    err = max(err, e)

    # times at the main path's shape: one request (B = 1), the model's dtype
    shapes, total = [], {'ms': 0.0, 'plain_ms': 0.0, 'bytes_ms': 0.0,
                         'ops_ms': 0.0}
    for n, (layer, f, valid, rb) in enumerate(records, 1):
        dtype = layer.dtype or torch.float32
        fd = f[:1].to(dtype).contiguous()
        wd = layer.kernel.detach().to(dtype).contiguous()
        rb1, v1 = rb[:1].contiguous(), valid[:1].contiguous()
        k, c_in, c_out = wd.shape
        hit = (rb1 >= 0) & (rb1 < fd.shape[1]) & v1[..., None]
        hits, live = int(hit.sum()), int(v1.sum())
        rows_read = int(torch.unique(rb1[hit]).numel())
        n_bytes = (live * k * 4 + v1.numel() + rows_read * c_in * fd.element_size()
                   + wd.numel() * wd.element_size() + v1.numel() * c_out * 4)
        n_flop = 2 * hits * c_in * c_out
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        row = {'layer': n, 'K': k, 'C_in': c_in, 'C_out': c_out,
               'dtype': str(dtype)[6:], 'live_rows': live, 'hits': hits,
               'bytes': n_bytes, 'flop': n_flop,
               'ms': cuda_ms(lambda: rulebook_conv(fd, rb1, wd, v1), torch),
               'plain_ms': cuda_ms(
                   lambda: rulebook_conv_plain(fd, rb1, wd, v1), torch)}
        row['bound_ms'], row['bound_by'] = bound_ms(n_bytes, n_flop, rate)
        total['ms'] += row['ms']
        total['plain_ms'] += row['plain_ms']
        total['bytes_ms'] += n_bytes / HBM_BYTES_PER_S * 1e3
        total['ops_ms'] += n_flop / rate * 1e3
        shapes.append(row)
        print(f'rulebook_conv layer {n:2d} B=1 {row["dtype"]} K={k} C '
              f'{c_in}->{c_out}: {live} live rows, {hits} hits '
              f'({hits / max(live * k, 1):.3f} of entries), device '
              f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, bound '
              f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}; {n_bytes} bytes, '
              f'{n_flop} FLOP)', flush=True)
    bound = sum(r['bound_ms'] for r in shapes)
    print(f'rulebook_conv, the 12 launches of a request: device '
          f'{total["ms"]:.4f} ms, plain {total["plain_ms"]:.4f} ms, bound '
          f'{bound:.4f} ms', flush=True)
    k3 = {'name': 'rulebook_conv', 'route': 'cuda',
          'source': 'lidardetection_tpu_torch/csrc/sparse_conv.cu',
          'replaces': 'lidardetection_tpu/ops/sparse_conv_tpu.py:346',
          'max_abs_err': err,
          # per call: the mean over the 12 launches of a request
          'ms': total['ms'] / 12, 'plain_ms': total['plain_ms'] / 12,
          'bound_ms': bound / 12,
          'bound_by': 'bytes' if total['bytes_ms'] >= total['ops_ms']
          else 'operations',
          'library_ms': None, 'per_request_ms': total['ms'], 'layers': shapes}

    # K2 at SECOND's shape: the conv_out table into 2 x 200 x 176 slots
    st4 = out['multi_scale_3d_features']['x_conv4']
    coords, _, shape = sparse.build_strided_out_coords(
        st4, (3, 1, 1), (2, 1, 1), (0, 0, 0), st4.coords.shape[1])
    n_slots = shape[0] * shape[1] * shape[2]
    check(n_slots == int(np.prod(out['encoded_spconv_tensor'].shape[1:4])),
          'the scatter target is the encoded tensor')
    keys = sparse.linear_key(coords, shape).int().contiguous()
    g = torch.Generator(device='cuda').manual_seed(SEED)
    feats = torch.randn((4, keys.shape[1], 128), generator=g,
                        device='cuda').bfloat16()
    for b in (1, 4):
        got = scatter_rows(feats[:b], keys[:b], n_slots)
        want = scatter_rows_plain(feats[:b], keys[:b], n_slots)
        torch.cuda.synchronize()
        print(f'K2 scatter_rows B={b} C=128 into {n_slots} slots: bit-exact '
              f'required: {torch.equal(got, want)}', flush=True)
        check(torch.equal(got, want), f'scatter_rows (SECOND shape) B={b}')
    k2 = time_scatter(torch, feats[:1], keys[:1], n_slots)
    print(f'scatter_rows B=1 at SECOND\'s shape ({k2["shape"]}): device '
          f'{k2["ms"]:.4f} ms, plain {k2["plain_ms"]:.4f} ms, library '
          f'{k2["library_ms"]:.4f} ms, bound {k2["bound_ms"]:.4f} ms '
          f'({k2["bytes"]} bytes)', flush=True)
    return k3, k2


def stage_counts(out):
    """Live rows of each stage's table of a SECOND forward, per sample."""
    counts = {name: st.num_voxels.tolist()
              for name, st in out['multi_scale_3d_features'].items()}
    enc = out['encoded_spconv_tensor']
    counts['out'] = (enc != 0).any(-1).flatten(1).sum(1).tolist()
    return counts


def serve_phase(torch, det, clouds, per_request):
    """The main path: one request per cloud; every launch count set to 0
    just before and read just after. `per_request` maps each kernel's
    wrapper to the launches one request must make."""
    for k in per_request:
        k.launches = 0
    latency, forward, stages = [], [], []
    for i, points in enumerate(clouds):
        t0 = time.perf_counter()
        batch = det.make_batch([points])
        t1 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = det.forward(batch)
        end.record()
        end.synchronize()
        t2 = time.perf_counter()
        preds = det.postprocess(out)
        n = int(preds['num_preds'][0])
        boxes = preds['pred_boxes'][0, :n].cpu().numpy()
        t3 = time.perf_counter()
        latency.append((t3 - t0) * 1e3)
        forward.append(start.elapsed_time(end))
        stages.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        live = int(preds['num_candidates'][0])
        tables = f', stage tables {stage_counts(out)}' \
            if 'multi_scale_3d_features' in out else ''
        print(f'request {i}: {len(points)} points, '
              f'{int(batch["num_voxels"][0])} voxels{tables}, {live} live NMS '
              f'candidates, num_preds {n}, latency {latency[-1]:.2f} ms '
              f'(host clock: make_batch {stages[-1][0]:.2f}, forward '
              f'{stages[-1][1]:.2f}, postprocess {stages[-1][2]:.2f}), '
              f'forward device {forward[-1]:.2f} ms', flush=True)
        check(boxes.shape == (n, 7) and np.isfinite(boxes).all(),
              f'request {i}: finite boxes')
        check(live > 0 and n > 0, f'request {i}: live candidates and detections')
        for k, each in per_request.items():
            check(k.launches == each * (i + 1),
                  f'{k.__name__} launched {each} times per request '
                  f'({k.launches} after {i + 1})')
    print('p50 host clock, ms: make_batch {:.2f}, forward {:.2f}, '
          'postprocess {:.2f}'.format(*np.median(stages, axis=0)), flush=True)
    print(json.dumps({'config': det.cfg['MODEL']['NAME'],
                      'requests': len(clouds),
                      'p50_latency_ms': float(np.median(latency)),
                      'p50_forward_ms': float(np.median(forward))}), flush=True)
    return {k.__name__: k.launches for k in per_request}


def forward_split(torch, det, points, repeats=3):
    """Where a request's forward goes, by module: host clock around each
    top-level module (and around the sparse layers inside the 3D backbone)
    with the device drained at both ends, median of `repeats`."""
    from lidardetection_tpu_torch.models.backbones_3d.spconv_backbone import (
        SparseConvLayer,
    )

    spans, hooks, t0 = {}, [], {}

    def watch(name, module):
        def before(m, args):
            torch.cuda.synchronize()
            t0[name] = time.perf_counter()

        def after(m, args, result):
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0[name]
        hooks.extend([module.register_forward_pre_hook(before),
                      module.register_forward_hook(after)])

    for name, module in det.model.named_children():
        watch(name, module)
    for module in det.model.modules():
        if isinstance(module, SparseConvLayer):
            watch('sparse layers', module)
    runs = []
    try:
        for _ in range(repeats):
            spans.clear()
            det.forward(det.make_batch([points]))
            runs.append(dict(spans))
    finally:
        for hook in hooks:
            hook.remove()
    med = {k: float(np.median([r[k] for r in runs])) * 1e3 for k in runs[0]}
    if 'sparse layers' in med:
        med['rulebooks and scatter'] = med['backbone_3d'] - med['sparse layers']
    print('forward split, ms (device drained around each module): '
          + ', '.join(f'{k} {v:.2f}' for k, v in med.items()), flush=True)


def profile_request(torch, det, points):
    """One request under torch.profiler: the device's busy share of the
    request and the kernels that take its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        preds = det.postprocess(det.forward(det.make_batch([points])))
        preds['pred_boxes'].cpu()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    if not rows:
        print('profiler: no device time recorded', flush=True)
        return
    print(f'profiled request: wall {wall:.2f} ms (profiler on), device '
          f'kernels {busy:.2f} ms, idle share {1 - busy / wall:.3f}', flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f'  {ms:8.3f} ms  x{count:<5d} {key[:90]}', flush=True)


def compare_phase(torch, det, cfg_file, clouds):
    """f32 on the card (kernels) against f32 on the CPU (plain versions)."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.serve import Detector

    cfg = cfg_from_yaml_file(cfg_file)
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    state = {k: v.cpu() for k, v in det.model.state_dict().items()}
    on_card = Detector(cfg, device='cuda', state_dict=state)
    on_cpu = Detector(cfg, device='cpu', state_dict=state)
    for i, points in enumerate(clouds):
        out_g = on_card.forward(on_card.make_batch([points]))
        out_c = on_cpu.forward(on_cpu.make_batch([points]))
        # f32 sums in another order on the two devices: 1e-3 of the largest
        # value, and never more than 1e-3 absolute
        for key in ('encoded_spconv_tensor', 'batch_fused_preds'):
            if key not in out_c:
                continue
            top = float(out_c[key].abs().max())
            dmax = float((out_g[key].cpu() - out_c[key]).abs().max())
            print(f'f32 cloud {i}: max|card - cpu| {key} = {dmax:.3g}, max|cpu| '
                  f'= {top:.3g} (tolerance 1e-3 * max|cpu|, at most 1e-3)',
                  flush=True)
            check(top > 0 and dmax <= 1e-3 * min(top, 1.0), f'{key} card vs cpu')
        pg, pc = on_card.postprocess(out_g), on_cpu.postprocess(out_c)
        compare_kept(pg, pc, dmax, i)


def compare_kept(pg, pc, dmax, i):
    """Matching rule for the kept detections of two devices. They are walked
    in kept (score) order and must be the same detection rank by rank: same
    label, scores within the tie tolerance, boxes within 1 cm / 0.01 rad.
    The tie tolerance is dmax / 4 + 1e-6, the most two scores can differ
    when their logits differ by dmax (the sigmoid's slope is at most 1/4).
    A divergence is allowed only as a tie: the two differing detections
    have scores within the tie tolerance, so device rounding may order them
    either way; greedy NMS outcomes cascade from that rank, so the ranks
    after a tie are not compared."""
    tie = dmax / 4 + 1e-6
    ng, nc = int(pg['num_preds'][0]), int(pc['num_preds'][0])
    sg, sc = pg['pred_scores'][0].cpu().numpy(), pc['pred_scores'][0].numpy()
    bg, bc = pg['pred_boxes'][0].cpu().numpy(), pc['pred_boxes'][0].numpy()
    lg, lc = pg['pred_labels'][0].cpu().numpy(), pc['pred_labels'][0].numpy()
    for r in range(min(ng, nc)):
        same = (lg[r] == lc[r] and abs(sg[r] - sc[r]) <= tie
                and np.abs(bg[r] - bc[r]).max() <= 1e-2)
        if not same:
            check(abs(sg[r] - sc[r]) <= tie,
                  f'cloud {i}: kept detections differ at rank {r} without a '
                  f'tie ({sg[r]} vs {sc[r]})')
            print(f'f32 cloud {i}: kept sets equal for {r} ranks, then a score '
                  f'tie ({sg[r]:.7f} vs {sc[r]:.7f}); card {ng} / cpu {nc} kept',
                  flush=True)
            return
    check(ng == nc, f'cloud {i}: kept counts {ng} (card) vs {nc} (cpu)')
    print(f'f32 cloud {i}: kept sets equal, {ng} detections, max|dbox| '
          f'{np.abs(bg[:ng] - bc[:ng]).max() if ng else 0:.3g}', flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from lidardetection_tpu_torch.ops import _build
    from lidardetection_tpu_torch.serve import Detector

    card = gpu_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    messages = _build.build()
    print(f'built {sorted(messages)} in {time.perf_counter() - t0:.1f} s '
          f'(nvcc {" ".join(_build.NVCC_FLAGS)})', flush=True)
    for name, text in messages.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}.cu: {line.strip()}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import rulebook_conv
    from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe

    def served(cfg_file, n_requests, per_request):
        """Detector with live NMS candidates, warmed up, then the main
        path: returns it, its clouds and the launch counts of the run."""
        det = Detector(cfg_file, device='cuda', seed=SEED)
        with torch.no_grad():
            det.model.dense_head.conv_cls_bias.zero_()
        clouds = make_clouds(det, n_requests + 2, SEED)
        for points in clouds[:2]:  # warm-up: cuDNN plans, allocator
            det.postprocess(det.forward(det.make_batch([points])))
        torch.cuda.synchronize()
        return det, clouds[2:], serve_phase(torch, det, clouds[2:], per_request)

    print('== PointPillar ==', flush=True)
    det, clouds, launches = served(CFG, N_REQUESTS,
                                   {pillar_vfe: 1, scatter_rows: 1})
    k1, k2 = pillar_kernel_phase(torch, det)
    profile_request(torch, det, clouds[0])
    compare_phase(torch, det, CFG, clouds[:2])
    del det

    print('== SECOND ==', flush=True)
    det, clouds, launches_second = served(
        CFG_SECOND, N_REQUESTS_SECOND, {rulebook_conv: 12, scatter_rows: 1})
    k3, k2_second = sparse_kernel_phase(torch, det)
    k2['second'] = k2_second
    forward_split(torch, det, clouds[0])
    profile_request(torch, det, clouds[0])
    compare_phase(torch, det, CFG_SECOND, clouds[:2])

    # launches: the sum over the two main paths' runs, each counted from 0
    kernels = [k1, k2, k3]
    for k in kernels:
        k['launches'] = launches.get(k['name'], 0) \
            + launches_second.get(k['name'], 0)
        check(k['launches'] > 0, f'{k["name"]} ran on a main path')
    print(json.dumps({'launches': {'PointPillar': launches,
                                   'SECONDNet': launches_second},
                      'card': card}), flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
