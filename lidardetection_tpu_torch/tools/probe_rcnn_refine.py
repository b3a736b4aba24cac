"""Does PV-RCNN's RCNN head improve or degrade the boxes it refines?
(counterpart of tools/probe_rcnn_refine.py:1-197.) On a checkpoint of the
port's, per class, the mean 3D IoU with the matched gt box before and
after the head, and recall@0.7 (the share of boxes at IoU >= 0.7) before
and after, on two RoI sets:

* train: the RoIs sampled for the RCNN head in a training forward
  (``assign_roi_targets``: its foreground, ``reg_valid_mask``), each
  against its assigned gt (``gt_of_rois_src``), as JAX's ``probe_train``
  (:117-140);
* eval: the RoIs of the eval forward (the proposal NMS), each against the
  gt it overlaps most, those above 0.55 (the training foreground's
  regime), as JAX's ``probe_eval`` (:142-166).

The config takes the train-to-AP harness's edits (``train_to_ap.py::
overfit_config``: the synthetic set, no augmentor, x/y voxels doubled)
and ``--compute_dtype``; the newest checkpoint of ``--ckpt_dir`` is
restored, then precise-BN over the training batches (as JAX's probe does,
:92-105), so both sets read the same statistics. The training forward's
BatchNorm statistics are put back after it; its draws are
``step_draw(0, batch)``.

    python -m lidardetection_tpu_torch.tools.probe_rcnn_refine \\
        --ckpt_dir output/train_to_ap_pvrcnn/ckpt --compute_dtype float32

``--cpu`` runs on the CPU.
"""

import argparse
import logging

import numpy as np
import torch

from ..config import cfg_from_yaml_file
from ..core.iou3d import boxes_iou3d
from ..datasets.synthetic import SyntheticLoader
from ..engine.bn_recalibrate import recalibrate_bn_stats
from ..models.roi_heads.roi_head_utils import generate_rcnn_boxes
from ..parallel.train_step import step_draw
from ..train import Trainer
from ..train_to_ap import overfit_config
from ..utils.checkpoint import latest_checkpoint, restore_model
from ..utils.precision import full_f32
from . import measure
from .common import tool_device

SEED = 42  # the harness's parameter and loader seed
SCENE_SEED = 0


def probe_train(model, batch, step):
    """(iou before, iou after, labels) of the foreground sampled RoIs of a
    training forward; the model's BatchNorm statistics unchanged."""
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    with torch.no_grad(), full_f32(model.compute_dtype == torch.float32):
        out = model(batch, step_draw(0, step, batch['gt_boxes'].device))
    model.load_state_dict(kept)
    fwd = out['roi_head_fwd']
    rois, gt = fwd['rois'].float(), fwd['gt_of_rois_src'].float()
    _, refined = generate_rcnn_boxes(rois, fwd['rcnn_cls'].float(),
                                     fwd['rcnn_reg'].float(),
                                     model.roi_head.box_coder)
    before = torch.stack([torch.diagonal(boxes_iou3d(r[:, :7], g[:, :7]))
                          for r, g in zip(rois, gt)])
    after = torch.stack([torch.diagonal(boxes_iou3d(r[:, :7], g[:, :7]))
                         for r, g in zip(refined, gt)])
    fg = fwd['reg_valid_mask'] > 0
    return before[fg], after[fg], fwd['roi_labels'][fg]


def probe_eval(model, batch):
    """(iou before, iou after, labels) of the eval RoIs that overlap a gt
    box by more than 0.55, each against that gt box."""
    model.eval()
    with torch.inference_mode(), full_f32(model.compute_dtype == torch.float32):
        out = model(batch)
    befores, afters, labels = [], [], []
    for roi, ref, gt in zip(out['rois'].float(), out['batch_box_preds'].float(),
                            batch['gt_boxes'].float()):
        valid = gt[:, -1] > 0
        iou_roi = torch.where(valid[None], boxes_iou3d(roi[:, :7], gt[:, :7]), 0.0)
        before, best = iou_roi.max(dim=1)
        iou_ref = torch.where(valid[None], boxes_iou3d(ref[:, :7], gt[:, :7]), 0.0)
        after = torch.gather(iou_ref, 1, best[:, None])[:, 0]
        good = before > 0.55
        befores.append(before[good])
        afters.append(after[good])
        labels.append(gt[best, -1].long()[good])
    return torch.cat(befores), torch.cat(afters), torch.cat(labels)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg_file', default='tools/cfgs/kitti_models/pv_rcnn.yaml')
    ap.add_argument('--ckpt_dir', default='output/train_to_ap_pvrcnn_f32/ckpt')
    ap.add_argument('--compute_dtype', default='float32')
    ap.add_argument('--scenes', type=int, default=48)
    ap.add_argument('--batch_size', type=int, default=8)
    ap.add_argument('--batches', type=int, default=2)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f'# device: {measure.device_line(device)}', flush=True)
    logger = logging.getLogger(__name__)
    cfg = cfg_from_yaml_file(args.cfg_file)
    cfg['MODEL']['COMPUTE_DTYPE'] = args.compute_dtype
    overfit_config(cfg, half_res=True)
    ckpt = latest_checkpoint(args.ckpt_dir)
    if ckpt is None:
        raise SystemExit(f'no checkpoint in {args.ckpt_dir}')
    trainer = Trainer(cfg, device=device, seed=SEED)
    loader = SyntheticLoader(trainer.dataset(args.scenes, seed=SCENE_SEED),
                             args.batch_size, trainer.make_batch, seed=SEED)
    model = trainer.model
    epoch = restore_model(ckpt, model, logger)
    print(f'# restored epoch {epoch} of {ckpt}', flush=True)
    measure.reset_launches()
    recalibrate_bn_stats(model, loader, lambda batch: batch,
                         n_batches=len(loader), logger=logger)

    names = {i + 1: n for i, n in enumerate(cfg['CLASS_NAMES'])}
    sets = {'train': [], 'eval': []}
    for bi, batch in zip(range(args.batches), loader):
        sets['train'].append(probe_train(model, batch, bi))
        sets['eval'].append(probe_eval(model, batch))

    print(f'{"class":<12} {"set":<6} {"n":>5} {"iou_before":>10} '
          f'{"iou_after":>10} {"delta":>8} {"rec@.7_before":>13} '
          f'{"rec@.7_after":>12}', flush=True)
    rows = []
    for c, name in names.items():
        for tag in ('train', 'eval'):
            b, a, lbl = (torch.cat(x).cpu().numpy() for x in zip(*sets[tag]))
            m = lbl == c
            if not m.any():
                continue
            row = [name, tag, int(m.sum()), float(b[m].mean()),
                   float(a[m].mean()), float(a[m].mean() - b[m].mean()),
                   float((b[m] >= 0.7).mean()), float((a[m] >= 0.7).mean())]
            rows.append(row)
            print(f'{name:<12} {tag:<6} {row[2]:>5} {row[3]:>10.3f} '
                  f'{row[4]:>10.3f} {row[5]:>+8.3f} {row[6]:>13.3f} '
                  f'{row[7]:>12.3f}', flush=True)
    if not rows:
        print('no foreground RoI in the probed batches', flush=True)
    return measure.summary_line('probe_rcnn_refine', device, epoch=epoch,
                                rows=rows, finite=bool(np.isfinite(
                                    [r[3:] for r in rows]).all()) if rows else True)


if __name__ == '__main__':
    main()
