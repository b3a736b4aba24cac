"""The KITTI protocol's wall time at the val split's scale (counterpart
of tools/bench_kitti_eval.py:1-167): ``get_official_eval_result`` over
``--frames`` synthetic frames (``synth_annos``, copied: ~6 cars, ~1.2
pedestrians, ~0.8 cyclists and ~1.5 DontCare a frame; detections are the
gt jittered with 85% recall, plus false positives), on the port's host
library (``native/``, built by g++ at first use, outside the timed span)
or, under ``LIDARDET_TORCH_PLAIN_HOST=1``, its numpy plain version.
Prints the result string on stderr and one JSON line (the JAX tool's
keys, the host path and the device line).

    python -m lidardetection_tpu_torch.tools.bench_kitti_eval --frames 3769
    LIDARDET_TORCH_PLAIN_HOST=1 python -m \\
        lidardetection_tpu_torch.tools.bench_kitti_eval --frames 3769

It launches no kernel; without ``--cpu`` it needs the card, as every tool
does.
"""

import argparse
import json
import sys
import time

import numpy as np

from .. import native
from ..datasets.kitti.kitti_object_eval.eval import get_official_eval_result
from . import measure
from .common import tool_device


def synth_annos(n_frames, seed=0):
    """GT and detection annos shaped like the KITTI val split
    (bench_kitti_eval.py:26-141, copied).

    Realistic densities: ~6 gt cars + ~1 ped + ~1 cyc per frame, dets =
    gt perturbed + score + a few false positives, so matcher loops see
    genuine TP/FP/FN mixes across the score sweep.
    """
    rng = np.random.default_rng(seed)
    gt_annos, dt_annos = [], []
    for _ in range(n_frames):
        n_car = rng.poisson(6)
        n_ped = rng.poisson(1.2)
        n_cyc = rng.poisson(0.8)
        n_dc = rng.poisson(1.5)
        names, boxes, dims, locs, rys, alphas, trunc, occ = \
            [], [], [], [], [], [], [], []
        for cls, n, dim_mu in (('Car', n_car, (3.9, 1.56, 1.6)),
                               ('Pedestrian', n_ped, (0.8, 1.73, 0.6)),
                               ('Cyclist', n_cyc, (1.76, 1.73, 0.6))):
            for _ in range(n):
                names.append(cls)
                x = rng.uniform(-20, 20)
                z = rng.uniform(5, 70)
                y = rng.uniform(1.4, 1.8)
                locs.append([x, y, z])
                dims.append(np.asarray(dim_mu) * rng.uniform(0.9, 1.1, 3))
                ry = rng.uniform(-np.pi, np.pi)
                rys.append(ry)
                alphas.append(ry - np.arctan2(x, z))
                # image box: project size shrinks with depth
                h_img = 900.0 / z * dim_mu[1]
                w_img = 900.0 / z * dim_mu[0] * 0.6
                cx = 620 + x * 700.0 / z
                cy = 190 + (y - 1.6) * 700.0 / z
                boxes.append([cx - w_img / 2, cy - h_img / 2,
                              cx + w_img / 2, cy + h_img / 2])
                trunc.append(float(rng.uniform(0, 0.4) * (rng.random() < 0.2)))
                occ.append(int(rng.choice([0, 0, 0, 1, 1, 2])))
        for _ in range(n_dc):
            names.append('DontCare')
            boxes.append([rng.uniform(0, 1200), rng.uniform(150, 300), 0, 0])
            boxes[-1][2] = boxes[-1][0] + rng.uniform(20, 120)
            boxes[-1][3] = boxes[-1][1] + rng.uniform(10, 60)
            locs.append([-1000, -1000, -1000])
            dims.append([-1, -1, -1])
            rys.append(-10)
            alphas.append(-10)
            trunc.append(-1.0)
            occ.append(-1)
        gt = dict(
            name=np.asarray(names),
            truncated=np.asarray(trunc),
            occluded=np.asarray(occ, np.int64),
            alpha=np.asarray(alphas),
            bbox=np.asarray(boxes, np.float64).reshape(-1, 4),
            dimensions=np.asarray(dims, np.float64).reshape(-1, 3),
            location=np.asarray(locs, np.float64).reshape(-1, 3),
            rotation_y=np.asarray(rys, np.float64),
        )
        gt_annos.append(gt)

        # detections: each non-DontCare gt detected with p=0.85 + jitter,
        # plus Poisson(2) false positives
        keep = [i for i, n in enumerate(gt['name'])
                if n != 'DontCare' and rng.random() < 0.85]
        d_names = list(gt['name'][keep])
        d_boxes = gt['bbox'][keep] + rng.normal(0, 3, (len(keep), 4))
        d_dims = gt['dimensions'][keep] * rng.uniform(0.95, 1.05, (len(keep), 3))
        d_locs = gt['location'][keep] + rng.normal(0, 0.15, (len(keep), 3))
        d_rys = gt['rotation_y'][keep] + rng.normal(0, 0.05, len(keep))
        d_alpha = gt['alpha'][keep] + rng.normal(0, 0.05, len(keep))
        d_score = rng.uniform(0.3, 1.0, len(keep))
        n_fp = rng.poisson(2)
        fp_names, fp_rows = [], []
        for _ in range(n_fp):
            cls = rng.choice(['Car', 'Pedestrian', 'Cyclist'],
                             p=[0.7, 0.15, 0.15])
            fp_names.append(cls)
            x, z = rng.uniform(-20, 20), rng.uniform(5, 70)
            fp_rows.append((x, rng.uniform(1.4, 1.8), z))
        if n_fp:
            fp_rows = np.asarray(fp_rows)
            d_names += fp_names
            d_locs = np.concatenate([d_locs, fp_rows])
            d_dims = np.concatenate(
                [d_dims, np.abs(rng.normal([3.5, 1.6, 1.6], 0.5, (n_fp, 3)))])
            d_rys = np.concatenate([d_rys, rng.uniform(-np.pi, np.pi, n_fp)])
            d_alpha = np.concatenate([d_alpha, rng.uniform(-np.pi, np.pi, n_fp)])
            fb = np.stack([620 + fp_rows[:, 0] * 700 / fp_rows[:, 2] - 30,
                           200 - 20 * np.ones(n_fp),
                           620 + fp_rows[:, 0] * 700 / fp_rows[:, 2] + 30,
                           200 + 20 * np.ones(n_fp)], 1)
            d_boxes = np.concatenate([d_boxes, fb])
            d_score = np.concatenate([d_score, rng.uniform(0.05, 0.6, n_fp)])
        dt_annos.append(dict(
            name=np.asarray(d_names),
            truncated=np.zeros(len(d_names)),
            occluded=np.zeros(len(d_names), np.int64),
            alpha=np.asarray(d_alpha),
            bbox=np.asarray(d_boxes, np.float64).reshape(-1, 4),
            dimensions=np.asarray(d_dims, np.float64).reshape(-1, 3),
            location=np.asarray(d_locs, np.float64).reshape(-1, 3),
            rotation_y=np.asarray(d_rys, np.float64),
            score=np.asarray(d_score, np.float64),
        ))
    return gt_annos, dt_annos


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=3769)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--classes', default='Car,Pedestrian,Cyclist')
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    host = 'numpy' if native.plain_requested() else 'native'
    if host == 'native':
        native.load()  # the g++ build, if any, before the timed span
    gt_annos, dt_annos = synth_annos(args.frames, args.seed)
    n_gt = sum(len(a['name']) for a in gt_annos)
    n_dt = sum(len(a['name']) for a in dt_annos)
    print(f'# {args.frames} frames, {n_gt} gt, {n_dt} dt', file=sys.stderr)

    t0 = time.perf_counter()
    result_str, result_dict = get_official_eval_result(
        gt_annos, dt_annos, args.classes.split(','))
    dt = time.perf_counter() - t0
    print(result_str, file=sys.stderr)
    row = {
        'metric': 'kitti_eval_wall_seconds',
        'frames': args.frames,
        'value': round(dt, 2),
        'unit': 's',
        'frames_per_sec': round(args.frames / dt, 1),
        'car_3d_moderate_R40':
            round(float(result_dict.get('Car_3d/moderate_R40', -1)), 2),
        'host': host,
        'device': measure.device_line(device),
    }
    print(json.dumps(row), flush=True)
    return row, result_str, result_dict


if __name__ == '__main__':
    main()
