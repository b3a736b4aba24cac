"""An operator-level profile of a detector's eval step (``--train``: its
training step) under ``torch.profiler`` (counterpart of
tools/profile_trace.py:20-156).

Runs ``--iters`` steps of ``--cfg_file`` at ``--batch_size`` on synthetic
scenes (the JAX tool's edits, :44-48: the synthetic set, MAX_POINTS
32768, no augmentor; weights from seed 0) after one warm-up step, with
the CPU and CUDA activities on, and prints the device's kernel time an
iteration, the wall time an iteration and the device's idle share (1 -
kernel time / wall), the device time by module path, and the ``--top``
device kernels by self time with their count and cumulative share.

The module spans come from forward hooks that this tool registers
(``measure.module_spans``: a ``record_function`` named by each
submodule's ``named_modules()`` path; the package has none). A kernel is
charged to the innermost span open on the thread that launched it, the
path cut to two parts (``backbone_3d.conv2``); a backward's kernels,
launched from autograd's thread, go to '<no module>'. Where the JAX tool
parses an XLA xplane and charges HLO ops by their op_name metadata
(:103-156), this tool reads the Chrome trace that torch.profiler writes
to ``--out``/trace.json (open it in chrome://tracing or
ui.perfetto.dev).

    python -m lidardetection_tpu_torch.tools.profile_trace \\
        --cfg_file tools/cfgs/kitti_models/pv_rcnn.yaml --batch_size 8
    python -m lidardetection_tpu_torch.tools.profile_trace --train \\
        --cfg_file tools/cfgs/kitti_models/second.yaml --batch_size 4

``--cpu`` profiles on the CPU: CPU operators by self time and the host
time of each top-level module; no device metric.
"""

import argparse
import time

from ..parallel.train_step import make_eval_step
from . import measure
from .common import SEED, tool_device


def make_step(cfg, batch_size, device, train):
    """(step, model): step() runs one eval step (the forward and
    post-processing) or, with `train`, one training step of the config on
    one synthetic batch of `batch_size` scenes."""
    if train:
        from ..train import Trainer

        trainer = Trainer(cfg, device=device, seed=SEED, total_steps=100)
        dataset = trainer.dataset(batch_size, seed=SEED)
        batch = trainer.make_batch([dataset[i] for i in range(batch_size)])
        return (lambda: trainer.step(batch)), trainer.model
    model = measure.eval_model(cfg, device)
    step = make_eval_step(model, cfg['MODEL']['POST_PROCESSING'],
                          len(cfg['CLASS_NAMES']))
    batch = measure.eval_batch(cfg, batch_size, device)
    return (lambda: step(batch)), model


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg_file', default='tools/cfgs/kitti_models/pv_rcnn.yaml')
    ap.add_argument('--batch_size', type=int, default=8)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--top', type=int, default=40)
    ap.add_argument('--out', default='output/profile_trace',
                    help='the directory of the Chrome trace')
    ap.add_argument('--train', action='store_true',
                    help='trace the training step (forward, backward, '
                         'optimizer) instead of the eval step')
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    from torch.autograd import DeviceType
    from torch.profiler import profile

    args = parse_args(argv)
    device = tool_device(args.cpu)
    on_card = device.type == 'cuda'
    print(f'# device: {measure.device_line(device)}', flush=True)
    cfg = measure.synthetic_config(args.cfg_file)
    step, model = make_step(cfg, args.batch_size, device, args.train)
    step()  # warm-up: cuDNN plans, the allocator
    measure.synchronize(device)
    measure.reset_launches()
    with profile(activities=measure.profiler_activities(device)) as prof, \
            measure.module_spans(model):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        measure.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3 / args.iters
    counts = measure.launches()
    trace = measure.output_dir(args.out) / 'trace.json'
    prof.export_chrome_trace(str(trace))
    what = 'training' if args.train else 'eval'

    if on_card:
        by_name, by_module = measure.trace_summary(trace)
        busy = sum(t for t, _ in by_name.values()) / args.iters
        print(f'{what} step, {cfg["MODEL"]["NAME"]} B={args.batch_size}: '
              f'device kernels {busy:.3f} ms/iter, wall {wall:.3f} ms/iter '
              f'(profiler on), idle share {1 - busy / wall:.3f}, over '
              f'{args.iters} iters; trace {trace}', flush=True)
        rows = sorted(((t, n, name) for name, (t, n) in by_name.items()),
                      reverse=True)
        total = busy * args.iters
    else:
        # the CPU: operators by self time; top-level modules' host time
        averages = prof.key_averages()
        rows = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                       for e in averages
                       if e.device_type == DeviceType.CPU
                       and not e.key.startswith('module::')
                       and e.self_cpu_time_total > 0), reverse=True)
        by_module = {e.key[len('module::'):]: e.cpu_time_total / 1e3
                     for e in averages if e.key.startswith('module::')
                     and '.' not in e.key}
        total = sum(r[0] for r in rows)
        busy = None
        print(f'{what} step, {cfg["MODEL"]["NAME"]} B={args.batch_size} on '
              f'the CPU: wall {wall:.3f} ms/iter (profiler on), operators '
              f'{total / args.iters:.3f} ms/iter of host self time; no device '
              f'time; trace {trace}', flush=True)

    print('\n--- by module path (ms/iter) ---', flush=True)
    for path, t in sorted(by_module.items(), key=lambda kv: -kv[1])[:30]:
        print(f'{t / args.iters:>10.3f}  {path}', flush=True)
    print(f'\n{"rank":>4}  {"self-ms":>9}  {"cum%":>5}  {"count":>6}  '
          f'{"kernel" if on_card else "operator"}', flush=True)
    cum = 0.0
    for i, (t, n, name) in enumerate(rows[:args.top]):
        cum += t
        print(f'{i:>4}  {t / args.iters:>9.3f}  {100 * cum / max(total, 1e-12):>5.1f}'
              f'  {n:>6}  {name[:100]}', flush=True)
    return measure.summary_line(
        'profile_trace', device, step=what, cfg=cfg['MODEL']['NAME'],
        iters=args.iters, wall_ms_per_iter=wall,
        device_ms_per_iter=busy,
        idle_share=None if busy is None else 1 - busy / wall,
        top=[[name, t / args.iters, n] for t, n, name in rows[:5]],
        launches_per_iter={k: v / args.iters for k, v in counts.items()})


if __name__ == '__main__':
    main()
