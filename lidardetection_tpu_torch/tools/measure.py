"""What the measurement and diagnostic tools share (and ``chip_smoke.py``
with them): the card's name line, the kernels' launch counts, a kernel
timer with a clean L2 flush, the least time the card could take for a
call (``bound_ms``), the host split of a forward by module, the
torch.profiler readers, and the full-matrix NMS oracle of the blocked NMS
walk.

Times on the card come from CUDA events; a tool given ``--cpu`` times on
the host clock (``time_ms``) and says so in its device line, so that no
CPU number stands under the name of a device metric.

The L2 flush (``l2_flush``). Before each timed call the 50 MB L2 must
hold none of the call's inputs (cold, as a request's first touch finds
it) and no dirty line (clean): a dirty line is written back to memory
when the timed call evicts it, and the call pays for a write it did not
make. ``l2_flush('clean')`` reads a buffer of twice the L2, which evicts
every line, dirty ones written back then, outside the timed span, and
leaves the L2 full of clean lines. ``l2_flush('dirty')`` is the earlier
timer's flush, a 64 MB write, which leaves the L2 full of dirty lines;
it stays only so that a run can put the two readings side by side.
"""

import bisect
import contextlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12     # H100 SXM, dense bf16 on the tensor cores
L2_BYTES = 50 << 20          # H100 SXM

def gpu_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def device_line(device):
    """What a tool prints first: the card's line, or the CPU and its
    clock."""
    if torch.device(device).type == 'cuda':
        return gpu_line()
    return 'cpu (host clock; no device metric)'


def peak_flop_per_s(dtype):
    """The H100's dense peak for products of `dtype` (float32 outside the
    tensor cores: the port holds f32 as f32, TF32 off)."""
    return BF16_FLOP_PER_S if dtype in (torch.bfloat16, torch.float16) \
        else F32_FLOP_PER_S


def bound_ms(n_bytes, n_flop, flop_per_s=F32_FLOP_PER_S):
    """The least time of a call: the larger of its bytes over the memory
    rate and its operations over the peak rate; and which of the two."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / flop_per_s
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def vfe_work(counts, p, c):
    """K1's bytes (the counts, each live pillar's center and bias row and
    its points below the count read once, the output written once in
    bf16, the weights) and FLOP, for these counts."""
    n = counts.numel()
    n_pts = int(counts.clamp(0, p).sum())
    n_live = int((counts > 0).sum())
    n_bytes = (n * 4 + n_live * (16 + c * 4) + n_pts * 16 + n * c * 2
               + 4 * c * 2 + c * 4)
    return n_bytes, n_pts * c * 8 + n * c * 3


def scatter_work(feats, keys, n_slots):
    """K2's kept rows and bytes: the canvas written once, the keys and the
    kept rows read once."""
    b, v, c = feats.shape
    n_kept = int((keys < n_slots).sum())
    size = feats.element_size()
    return n_kept, b * n_slots * c * size + b * v * 4 + n_kept * c * size


def conv_work(f, rb, w, valid):
    """K3's work at one layer: the live output rows, the (row, offset)
    hits, and the bytes and FLOP of its bound: each live row's k table
    entries and the mask, each input row that a hit reads once, the
    weights, the f32 output written once; 2 FLOP a hit and channel
    pair."""
    k, c_in, c_out = w.shape
    hit = (rb >= 0) & (rb < f.shape[1]) & valid[..., None]
    hits, live = int(hit.sum()), int(valid.sum())
    flat = rb.long() + torch.arange(rb.shape[0], device=rb.device)[
        :, None, None] * f.shape[1]
    rows_read = int(torch.unique(flat[hit]).numel())
    n_bytes = (live * k * 4 + valid.numel() + rows_read * c_in * f.element_size()
               + w.numel() * w.element_size() + valid.numel() * c_out * 4)
    return live, hits, n_bytes, 2 * hits * c_in * c_out


def select_work(args):
    """K5's live (centre, candidate) pairs, and the bytes and FLOP its bound
    counts: the distinct table rows the runs cover, each read once (xyz and
    orig, 16 bytes a row; runs never reach the padding rows past the valid
    count, and runs of different centres overlap), the centres, the runs and
    the outputs; 9 FLOP a live pair (3 differences, 3 squares, 2 sums, 1
    compare). Returns (pairs, rows read, bytes, FLOP, the most pairs of a
    centre)."""
    xyz, orig, start, end, centers, radii, nsamples, max_run = args
    b, n = orig.shape
    m, n_row = start.shape[1:]
    s = start.long().reshape(b, -1)
    e = torch.minimum(end, start + max_run).long().reshape(b, -1)
    live = (e > s).long()
    pairs = int(((e - s) * live).sum())
    most = int(((e - s) * live).reshape(b, m, n_row).sum(-1).max())
    # +1 where a run starts, -1 where it ends: a row is read where the
    # running sum is above 0
    edge = torch.zeros((b, n + 1), dtype=torch.long, device=orig.device)
    edge.scatter_add_(1, s.clamp(0, n), live)
    edge.scatter_add_(1, e.clamp(0, n), -live)
    rows_read = int((edge.cumsum(1)[:, :n] > 0).sum())
    n_bytes = rows_read * 16 + b * m * 12 + 2 * b * m * n_row * 4 \
        + b * m * sum(nsamples) * 4
    return pairs, rows_read, n_bytes, 9 * pairs, most


def kernel_wrappers():
    """The wrappers of K1-K5, each counting its launches in ``.launches``."""
    from ..ops.scatter_cuda import scatter_rows
    from ..ops.select_cuda import ball_select
    from ..ops.sparse_conv_cuda import rulebook_conv, rulebook_conv_dw
    from ..ops.vfe_cuda import pillar_vfe
    return pillar_vfe, scatter_rows, rulebook_conv, rulebook_conv_dw, ball_select


def reset_launches():
    for k in kernel_wrappers():
        k.launches = 0


def launches():
    """{kernel name: launches since the last ``reset_launches``}."""
    return {k.__name__: k.launches for k in kernel_wrappers()}


def summary_line(tool, device, **numbers):
    """The last line a tool prints: its name, device, launch counts and
    headline numbers, as one JSON object."""
    row = {'tool': tool, 'device': device_line(device), 'launches': launches(),
           **numbers}
    print(json.dumps(row), flush=True)
    return row


def synchronize(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def l2_flush(kind='clean'):
    """A call that leaves the L2 without the next call's data: 'clean'
    reads a buffer of twice its size (no dirty line left), 'dirty' writes
    64 MB (the earlier timer's flush)."""
    if kind == 'clean':
        return torch.ones(2 * L2_BYTES // 4, device='cuda').sum
    if kind == 'dirty':
        return torch.empty((64 << 20) // 4, device='cuda').zero_
    raise ValueError(f'flush is clean or dirty, not {kind!r}')


def cuda_ms(fn, iters=30, warmup=5, queued=True, flush='clean'):
    """Median time of fn() in ms over `iters` calls, from CUDA events
    around each call, the L2 flushed (``l2_flush(flush)``) before each.

    queued=True holds the stream in a ~1 ms device sleep while the host
    enqueues the events and fn's kernels, so the events time the device
    work alone; queued=False times the call as a caller sees it, host
    overhead between launches included."""
    times, flush_l2 = [], l2_flush(flush)
    for i in range(warmup + iters):
        flush_l2()
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


def host_ms(fn, iters=3, warmup=1):
    """Median host-clock time of fn() in ms (the CPU's timer)."""
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        fn()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_ms(fn, device, iters=30, warmup=5, queued=True):
    """``cuda_ms`` on the card, ``host_ms`` on the CPU (one warm-up)."""
    if torch.device(device).type == 'cuda':
        return cuda_ms(fn, iters, warmup, queued)
    return host_ms(fn, iters, min(warmup, 1))


def forward_split(det, points, repeats=3, functions=(), modules=()):
    """Where a request's forward goes, by module: host clock around each
    top-level module (and around the sparse layers inside the 3D backbone,
    around each module of `modules`, (label, module), the calls of one
    label summed, and around each call of the functions of `functions`,
    (owner, attribute, labels): the n-th call of a forward is labelled
    labels[n]) with the device drained at both ends, median of
    `repeats`."""
    from ..models.backbones_3d.spconv_backbone import SparseConvLayer

    spans, hooks, t0 = {}, [], {}
    wrapped, calls = [], {}

    def drain():
        synchronize(det.device)

    def timed(attr, labels, fn):
        def run(*args, **kwargs):
            name = labels[calls.get(attr, 0)]
            calls[attr] = calls.get(attr, 0) + 1
            drain()
            start = time.perf_counter()
            result = fn(*args, **kwargs)
            drain()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - start
            return result
        return run

    def watch(name, module):
        def before(m, args):
            drain()
            t0[name] = time.perf_counter()

        def after(m, args, result):
            drain()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0[name]
        hooks.extend([module.register_forward_pre_hook(before),
                      module.register_forward_hook(after)])

    for name, module in det.model.named_children():
        watch(name, module)
    for module in det.model.modules():
        if isinstance(module, SparseConvLayer):
            watch('sparse layers', module)
    for name, module in modules:
        watch(name, module)
    for owner, attr, labels in functions:
        wrapped.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, timed(attr, labels, getattr(owner, attr)))
    runs = []
    try:
        for _ in range(repeats):
            spans.clear()
            calls.clear()
            det.forward(det.make_batch([points]))
            runs.append(dict(spans))
    finally:
        for hook in hooks:
            hook.remove()
        for owner, attr, fn in wrapped:
            setattr(owner, attr, fn)
    med = {k: float(np.median([r[k] for r in runs])) * 1e3 for k in runs[0]}
    if 'sparse layers' in med:
        med['rulebooks and scatter'] = med['backbone_3d'] - med['sparse layers']
    print('forward split, ms (device drained around each module): '
          + ', '.join(f'{k} {v:.2f}' for k, v in med.items()), flush=True)
    return med


def profiler_activities(device):
    from torch.profiler import ProfilerActivity
    if torch.device(device).type == 'cuda':
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def profile_run(what, fn, top=12):
    """fn() under torch.profiler: the device's busy share of the call and
    the kernels that take its time. Runs after every timed phase: the
    profiler's tracing callbacks stay attached once it has been used and
    slow every later launch on the host. Returns {wall_ms, busy_ms,
    idle_share, rows (ms, count, name)}, or None when no device time was
    recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=profiler_activities('cuda')) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f'profiler, {what}: no device time recorded', flush=True)
        return None
    print(f'profiled {what}: wall {wall:.2f} ms (profiler on), device '
          f'kernels {busy:.2f} ms, idle share {1 - busy / wall:.3f}', flush=True)
    rows.sort(reverse=True)
    for ms, count, key in rows[:top]:
        print(f'  {ms:8.3f} ms  x{count:<5d} {key[:90]}', flush=True)
    return {'wall_ms': wall, 'busy_ms': busy, 'idle_share': 1 - busy / wall,
            'rows': rows}


@contextlib.contextmanager
def module_spans(model, prefix='module::'):
    """A ``record_function`` span around every named submodule's forward,
    named `prefix` + its ``named_modules()`` path, for the block (forward
    hooks that the caller registers and removes; the package has none)."""
    from torch.autograd.profiler import record_function

    hooks, open_spans = [], []

    def before(name):
        def hook(module, args):
            span = record_function(prefix + name)
            span.__enter__()
            open_spans.append(span)
        return hook

    def after(module, args, result):
        open_spans.pop().__exit__(None, None, None)

    for name, module in model.named_modules():
        if name:
            hooks.append(module.register_forward_pre_hook(before(name)))
            hooks.append(module.register_forward_hook(after))
    try:
        yield
    finally:
        for hook in hooks:
            hook.remove()


DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def trace_summary(trace_path, depth=2, prefix='module::'):
    """A Chrome trace of ``torch.profiler`` read back: the device's work
    events by name ({name: (ms, count)}) and by module path ({path: ms},
    each event charged to the innermost ``module_spans`` span open on the
    launching thread when its launch was made, the path cut to its first
    `depth` parts; '<no module>' outside every span, e.g. a backward
    launched from autograd's thread)."""
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    launch = {}
    spans = {}
    work = []
    for e in events:
        cat = e.get('cat', '')
        if cat in DEVICE_CATEGORIES:
            work.append(e)
        elif cat in ('cuda_runtime', 'cuda_driver') and 'correlation' in e.get('args', {}):
            launch[e['args']['correlation']] = (e['ts'], e['tid'])
        elif cat == 'user_annotation' and e.get('name', '').startswith(prefix):
            spans.setdefault(e['tid'], []).append(
                (e['ts'], e['ts'] + e['dur'], e['name'][len(prefix):]))
    for tid in spans:
        spans[tid].sort()
    starts = {tid: [s[0] for s in v] for tid, v in spans.items()}

    def owner(ts, tid):
        if tid not in spans:
            return '<no module>'
        i = bisect.bisect_right(starts[tid], ts) - 1
        while i >= 0:
            s, e, name = spans[tid][i]
            if s <= ts <= e:
                return '.'.join(name.split('.')[:depth])
            i -= 1
        return '<no module>'

    by_name, by_module = {}, {}
    for e in work:
        ms = e.get('dur', 0) / 1e3
        t, n = by_name.get(e['name'], (0.0, 0))
        by_name[e['name']] = (t + ms, n + 1)
        corr = e.get('args', {}).get('correlation')
        path = owner(*launch[corr]) if corr in launch else '<no module>'
        by_module[path] = by_module.get(path, 0.0) + ms
    return by_name, by_module


def full_matrix_nms(boxes, scores, valid, thresh, pre_maxsize, post_maxsize):
    """The oracle of the NMS walk: per sample, of the `pre_maxsize` best
    scores, the whole live x live IoU matrix (``boxes_iou_bev``, on the
    boxes' device), then the greedy sweep on the host, rows in score order
    (ties to the lower index). Returns a list of kept index lists into
    N."""
    from ..core.iou3d import boxes_iou_bev, top_k

    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    out = []
    for b, s, v in zip(boxes, scores, valid):
        _, order = top_k(torch.where(v, s, -float('inf'))[None], pre_maxsize)
        order = order[0][v[order[0]]]
        bx = b[order, :7].contiguous()
        sup = (boxes_iou_bev(bx, bx) > thresh).cpu().numpy()
        removed = np.zeros(len(order), bool)
        keep = []
        for i in range(len(order)):
            if removed[i]:
                continue
            keep.append(i)
            if len(keep) == post_maxsize:
                break
            removed |= sup[i]
        out.append(order[keep].tolist())
    return out


def synthetic_config(cfg_file, max_points=32768):
    """A config with the JAX tools' edits (profile_trace.py:44-48): the
    synthetic set, MAX_POINTS `max_points`, no augmentor."""
    from ..config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(cfg_file)
    data = cfg['DATA_CONFIG']
    data['DATASET'] = 'SyntheticDataset'
    data['MAX_POINTS'] = max_points
    data.pop('DATA_AUGMENTOR', None)
    return cfg


def eval_batch(cfg, batch_size, device):
    """The first test batch of `batch_size` synthetic scenes on `device`
    (``build_test_loader``: host voxels, the eval plan's rulebooks, cut to
    the batch's occupancy)."""
    from ..datasets.synthetic import build_test_loader
    from ..parallel.train_step import device_batch

    _, loader = build_test_loader(cfg, batch_size, batch_size)
    return device_batch(next(iter(loader)), device)


def eval_model(cfg, device, seed=0):
    """The config's detector on `device` in eval mode, weights from
    `seed`."""
    from ..config import dataset_info
    from ..models import build_network

    classes = list(cfg['CLASS_NAMES'])
    return build_network(cfg['MODEL'], len(classes),
                         dataset_info(cfg['DATA_CONFIG']), seed=seed,
                         class_names=classes).to(device).eval()


def output_dir(path):
    """`path` made, as a Path."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    return path
