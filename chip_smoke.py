"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: PointPillar serving.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises on failure (non-zero exit, no result line):
  1. build the kernels of csrc/ with nvcc (all sources at once);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (40000-pillar table of voxelized synthetic scenes,
     P = 32, C = 64, 496 x 432 canvas, B = 1 and B = 4), and its time
     beside its bound, the plain version's time and a library call's;
  3. serve requests through ``serve.Detector`` on the full
     tools/cfgs/kitti_models/pointpillar.yaml (bf16 compute, random
     weights from a seed, class-logit bias 0 so NMS sees live candidates),
     with every kernel's launch count set to 0 just before and read after;
  4. the same weights and clouds in f32 on the card (kernels) and on the
     CPU (plain versions): head outputs and kept detections must agree.
The line before the last is the kernels' JSON, preceded by the card's name
and power limit; the last line is the device JSON.
"""

import json
import subprocess
import sys
import time

import numpy as np

CFG = 'tools/cfgs/kitti_models/pointpillar.yaml'
SEED = 0
N_REQUESTS = 10
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores


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


def bound_ms(n_bytes, n_flop):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def make_clouds(det, n, seed):
    """n synthetic scans (18k ground-ring points + objects) from a seed."""
    from lidardetection_tpu_torch.datasets.synthetic import make_scene

    rng = np.random.RandomState(seed)
    pc_range = np.asarray(det.info['point_cloud_range'], np.float32)
    return [make_scene(rng, pc_range)[0] for _ in range(n)]


def kernel_phase(torch, det):
    """K1 and K2 against their plain versions at the main path's shapes."""
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

    kept = k1keys[0] < n_slots
    n_kept = int(kept.sum())
    rows_b = torch.zeros(n_kept, dtype=torch.long, device='cuda')
    rows_k, rows_f = k1keys[0][kept].long(), f1[0][kept]

    def library():  # canvas[b_idx, keys] = feats, kept rows pre-selected
        canvas = torch.zeros((1, n_slots, c), dtype=f1.dtype, device='cuda')
        canvas.index_put_((rows_b, rows_k), rows_f)

    k2_bytes = n_slots * c * 2 + v * 4 + n_kept * c * 2
    k2 = {'name': 'scatter_rows', 'route': 'cuda',
          'source': 'lidardetection_tpu_torch/csrc/scatter.cu',
          'replaces': 'lidardetection_tpu/ops/scatter_tpu.py:128',
          'max_abs_err': err['scatter_rows'],
          'ms': cuda_ms(calls['scatter_rows'], torch),
          'plain_ms': cuda_ms(lambda: scatter_rows_plain(f1, k1keys, n_slots),
                              torch),
          'library_ms': cuda_ms(library, torch)}
    k2['bound_ms'], k2['bound_by'] = bound_ms(k2_bytes, 0)
    for k, nbytes in ((k1, k1_bytes), (k2, k2_bytes)):
        call = cuda_ms(calls[k['name']], torch, queued=False)
        print(f'{k["name"]} B=1: device {k["ms"]:.4f} ms (call with host '
              f'overhead {call:.4f} ms), plain {k["plain_ms"]:.4f} ms, '
              f'library {k["library_ms"]}, bound {k["bound_ms"]:.4f} ms '
              f'({nbytes} bytes)', flush=True)
    return [k1, k2]


def serve_phase(torch, det, clouds):
    """The main path: one request per cloud; every launch count set to 0
    just before and read just after."""
    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows
    from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe

    kernels = (pillar_vfe, scatter_rows)
    for k in kernels:
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
        print(f'request {i}: {len(points)} points, '
              f'{int(batch["num_voxels"][0])} pillars, {live} live NMS '
              f'candidates, num_preds {n}, latency {latency[-1]:.2f} ms '
              f'(host clock: make_batch {stages[-1][0]:.2f}, forward '
              f'{stages[-1][1]:.2f}, postprocess {stages[-1][2]:.2f}), '
              f'forward device {forward[-1]:.2f} ms', flush=True)
        check(boxes.shape == (n, 7) and np.isfinite(boxes).all(),
              f'request {i}: finite boxes')
        check(live > 0 and n > 0, f'request {i}: live candidates and detections')
        for k in kernels:
            check(k.launches == i + 1, f'{k.__name__} launched once per request '
                  f'({k.launches} after {i + 1})')
    print('p50 host clock, ms: make_batch {:.2f}, forward {:.2f}, '
          'postprocess {:.2f}'.format(*np.median(stages, axis=0)), flush=True)
    return {k.__name__: k.launches for k in kernels}, latency, forward


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


def compare_phase(torch, det, clouds):
    """f32 on the card (kernels) against f32 on the CPU (plain versions)."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.serve import Detector

    cfg = cfg_from_yaml_file(CFG)
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    state = {k: v.cpu() for k, v in det.model.state_dict().items()}
    on_card = Detector(cfg, device='cuda', state_dict=state)
    on_cpu = Detector(cfg, device='cpu', state_dict=state)
    for i, points in enumerate(clouds):
        out_g = on_card.forward(on_card.make_batch([points]))
        out_c = on_cpu.forward(on_cpu.make_batch([points]))
        dmax = float((out_g['batch_fused_preds'].cpu()
                      - out_c['batch_fused_preds']).abs().max())
        print(f'f32 cloud {i}: max|card - cpu| batch_fused_preds = {dmax:.3g} '
              f'(tolerance atol 1e-3)', flush=True)
        check(dmax <= 1e-3, 'batch_fused_preds card vs cpu')
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

    det = Detector(CFG, device='cuda', seed=SEED)
    with torch.no_grad():
        det.model.dense_head.conv_cls_bias.zero_()
    kernels = kernel_phase(torch, det)

    clouds = make_clouds(det, N_REQUESTS + 2, SEED)
    for points in clouds[:2]:  # warm-up: cuDNN plans, allocator
        det.postprocess(det.forward(det.make_batch([points])))
    torch.cuda.synchronize()
    launches, latency, forward = serve_phase(torch, det, clouds[2:])
    for k in kernels:
        k['launches'] = launches[k['name']]
        check(k['launches'] > 0, f'{k["name"]} ran on the main path')

    profile_request(torch, det, clouds[2])
    compare_phase(torch, det, clouds[2:4])

    print(json.dumps({'requests': N_REQUESTS,
                      'p50_latency_ms': float(np.median(latency)),
                      'p50_forward_ms': float(np.median(forward)),
                      'card': card}), flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
