"""The PV-RCNN path's approximation knobs against exact settings on one
checkpoint (counterpart of tools/ablate_approx.py:1-145): the checkpoint
is evaluated under each variant of ``VARIANTS`` (the JAX tool's, :21-37)
and the per-class 3D moderate R40 APs, and their deltas against
'shipping', are printed.

Each variant's config is ``make_cfg``'s (the JAX tool's, :72-90: the
synthetic set, no augmentor, with ``--half_res`` x/y voxels doubled and
caps of 8000 / 24000, then the variant's MODEL overrides); the newest
checkpoint of ``--ckpt_dir`` is restored into the variant's model,
precise-BN runs over its training batches under the same setting (the
knobs change the forward), and ``eval_one_epoch`` scores the test scenes
through the KITTI protocol, as the JAX tool does. The port's knobs:
``FPS_SECTORS`` (sector FPS on the card; 1 is exact FPS),
``BALL_QUERY_GRID_CELL_CAP`` (the grid ball query on K5; 0 is the
brute-force query) and the RoI grid pool's ``CANDIDATE_CAP``.
``BALL_QUERY_APPROX_RECALL`` is set as the JAX tool sets it, but the port
does not read it: K5's selection is exact (``ops/pointnet2.py``), and the
variant's row says so. On the CPU every point op takes its exact path, so
only the card's run separates the variants (``--cpu`` drives the code).

    python -m lidardetection_tpu_torch.tools.ablate_approx \\
        --ckpt_dir output/train_to_ap_pvrcnn/ckpt
"""

import argparse
import json
import logging
import time

from ..config import cfg_from_yaml_file
from ..datasets.synthetic import SyntheticLoader, build_test_loader
from ..engine.bn_recalibrate import recalibrate_bn_stats
from ..engine.evaluator import eval_one_epoch
from ..train import Trainer
from ..train_to_ap import overfit_config
from ..utils.checkpoint import latest_checkpoint, restore_model
from . import measure
from .common import tool_device

VARIANTS = [
    # (name, MODEL overrides), brute-force ball-query variants last: the
    # M x N scan is memory-hungry and must not take the rest down
    ('shipping', {}),
    ('eval_f32', {'COMPUTE_DTYPE': 'float32'}),
    ('exact_fps', {'FPS_SECTORS': 1}),
    ('wide_roi_candidates', {'__ROI_CANDIDATE_CAP__': 256}),
    ('exact_ball_query', {'BALL_QUERY_GRID_CELL_CAP': 0,
                          'BALL_QUERY_APPROX_RECALL': None}),
    ('all_exact', {'FPS_SECTORS': 1, 'BALL_QUERY_GRID_CELL_CAP': 0,
                   'BALL_QUERY_APPROX_RECALL': None,
                   '__ROI_CANDIDATE_CAP__': 256}),
]
NOT_READ = {'BALL_QUERY_APPROX_RECALL': 'not read by the port: K5 is exact'}
SEED = 42
SCENE_SEED = 0


def make_cfg(cfg_file, overrides, half_res=True):
    """A variant's config (ablate_approx.py:72-90): the harness's edits
    (``overfit_config``), then the variant's overrides."""
    cfg = overfit_config(cfg_from_yaml_file(cfg_file), half_res)
    for k, v in overrides.items():
        if k == '__ROI_CANDIDATE_CAP__':
            cfg['MODEL']['ROI_HEAD']['ROI_GRID_POOL']['CANDIDATE_CAP'] = v
        else:
            cfg['MODEL'][k] = v
    return cfg


def run_variant(args, name, overrides, device, logger, out):
    """{AP key: value} of the 3D moderate R40 APs of one variant."""
    cfg = make_cfg(args.cfg_file, overrides, args.half_res)
    trainer = Trainer(cfg, device=device, seed=SEED)
    loader = SyntheticLoader(trainer.dataset(args.scenes, seed=SCENE_SEED),
                             args.batch_size, trainer.make_batch, seed=SEED)
    model = trainer.model
    restore_model(latest_checkpoint(args.ckpt_dir), model, logger)
    recalibrate_bn_stats(model, loader, lambda batch: batch,
                         n_batches=len(loader), logger=logger)
    _, test_loader = build_test_loader(cfg, args.batch_size, args.scenes,
                                       seed=SCENE_SEED)
    result, _ = eval_one_epoch(model, test_loader,
                               cfg['MODEL']['POST_PROCESSING'],
                               list(cfg['CLASS_NAMES']), logger,
                               result_dir=str(out / f'eval_{name}'))
    return {k: round(float(result[k]), 2) for k in sorted(result)
            if 'moderate_R40' in k and '_3d/' in k}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg_file', default='tools/cfgs/kitti_models/pv_rcnn.yaml')
    ap.add_argument('--ckpt_dir', default='output/train_to_ap_pvrcnn/ckpt')
    ap.add_argument('--scenes', type=int, default=48)
    ap.add_argument('--batch_size', type=int, default=8)
    ap.add_argument('--half_res', action='store_true', default=True)
    ap.add_argument('--variants', default=','.join(n for n, _ in VARIANTS))
    ap.add_argument('--output_dir', default='output/ablate_approx')
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f'# device: {measure.device_line(device)}', flush=True)
    if latest_checkpoint(args.ckpt_dir) is None:
        raise SystemExit(f'no checkpoint in {args.ckpt_dir}')
    out = measure.output_dir(args.output_dir)
    logger = logging.getLogger(__name__)
    todo = args.variants.split(',')
    rows, seconds = {}, {}
    measure.reset_launches()
    for name, overrides in VARIANTS:
        if name not in todo:
            continue
        t0 = time.perf_counter()
        try:
            rows[name] = run_variant(args, name, overrides, device, logger, out)
        except Exception as e:  # keep the other variants' verdicts flowing
            logger.exception('variant %s failed', name)
            rows[name] = {'error': f'{type(e).__name__}: {e}'[:160]}
        seconds[name] = time.perf_counter() - t0
        notes = [f'{k} {v}' for k, v in NOT_READ.items() if k in overrides]
        if notes:
            rows[name]['note'] = '; '.join(notes)
        print(json.dumps({name: rows[name]}), flush=True)
    base = rows.get('shipping', {})
    deltas = {name: {k: round(v - base[k], 2) for k, v in row.items()
                     if k in base and isinstance(v, float)}
              for name, row in rows.items() if name != 'shipping'}
    print(json.dumps({'metric': 'approximation_ablation', 'rows': rows,
                      'deltas_vs_shipping': deltas}, indent=1), flush=True)
    return measure.summary_line('ablate_approx', device, rows=rows,
                                deltas=deltas, seconds=seconds)


if __name__ == '__main__':
    main()
