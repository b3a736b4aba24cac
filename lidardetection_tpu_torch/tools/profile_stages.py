"""A detector's eval path by stage (counterpart of
tools/profile_stages.py:20-143): the time of each cumulative prefix of its
module topology (``vfe``, ``map_to_bev``, ``backbone_2d``,
``dense_head``, ...), then of the whole forward with post-processing, and
each stage's marginal cost.

A prefix runs the first k modules of ``model.module_order`` on a test
batch of ``--batch_size`` synthetic scenes (the JAX tool's edits,
:41-45), as the JAX tool's ``prefix_fn`` does (:82-90), under
``torch.inference_mode()``; each is timed by CUDA events around the call
with the device drained before it (``measure.cuda_ms`` with
``queued=False``: the call as a caller sees it, its host work included),
the median of ``--iters`` after two warm-up calls. Where the JAX tool
slope-times ``fori_loop`` chains over a relay, the card's events time a
call directly.

    python -m lidardetection_tpu_torch.tools.profile_stages \\
        --cfg_file tools/cfgs/kitti_models/pointpillar.yaml --batch_size 8

``--cpu`` times on the host clock.
"""

import argparse

import torch

from ..models.detectors.post_processing import post_processing
from ..utils.precision import full_f32
from . import measure
from .common import tool_device


def stage_names(model):
    """The stages in the JAX tool's order and names (:118-119):
    '<k>:<module>' for each prefix, then 'post_processing'."""
    return [f'{i}:{name}' for i, name in enumerate(model.module_order, 1)] \
        + ['post_processing']


def prefix_fn(model, k, post_cfg=None, num_class=None):
    """run(batch): the first k modules of the model on the batch (and, given
    `post_cfg`, post-processing of their output)."""
    def run(batch):
        with torch.inference_mode(), \
                full_f32(model.compute_dtype == torch.float32):
            if 'points' in batch and 'point_valid' not in batch:
                n = batch['points'].shape[1]
                batch = {**batch, 'point_valid': torch.arange(
                    n, device=batch['points'].device)
                    < batch['num_points'][:, None]}
            for name in model.module_order[:k]:
                batch = getattr(model, name)(batch)
            if post_cfg is not None:
                batch = post_processing(batch, post_cfg, num_class)
        return batch
    return run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg_file', default='tools/cfgs/kitti_models/pointpillar.yaml')
    ap.add_argument('--batch_size', type=int, default=8)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f'# device: {measure.device_line(device)}', flush=True)
    cfg = measure.synthetic_config(args.cfg_file)
    model = measure.eval_model(cfg, device)
    batch = measure.eval_batch(cfg, args.batch_size, device)
    n = len(model.module_order)
    runs = [prefix_fn(model, k) for k in range(1, n + 1)]
    runs.append(prefix_fn(model, n, cfg['MODEL']['POST_PROCESSING'],
                          len(cfg['CLASS_NAMES'])))
    print(f'{cfg["MODEL"]["NAME"]} B={args.batch_size}, ms a batch '
          f'({"CUDA events" if device.type == "cuda" else "host clock"})',
          flush=True)
    print(f'{"stage":<24}{"cum ms/batch":>14}{"marginal ms":>14}', flush=True)
    measure.reset_launches()
    rows, prev = [], 0.0
    for name, run in zip(stage_names(model), runs):
        ms = measure.time_ms(lambda: run(dict(batch)), device,
                             iters=args.iters, warmup=2, queued=False)
        print(f'{name:<24}{ms:>14.3f}{ms - prev:>14.3f}', flush=True)
        rows.append([name, ms, ms - prev])
        prev = ms
    return measure.summary_line('profile_stages', device,
                                cfg=cfg['MODEL']['NAME'], stages=rows)


if __name__ == '__main__':
    main()
