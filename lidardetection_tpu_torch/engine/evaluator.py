"""Evaluation loop (lidardetection_tpu/engine/evaluator.py:23).

Batches (a voxel table, or a point-based config's sampled raw points)
run through the eval step (``parallel/train_step.py::make_eval_step``); the kept detections of each sample come back to the
host as numpy (the rows that ``pred_mask`` marks: the multi-class NMS of
the multi-head detectors leaves gaps between them), become KITTI annos
through the dataset's ``generate_prediction_dicts`` and are scored by its
``evaluation`` (the official protocol). In a process group each rank
evaluates its loader shard; ``parallel/dist.py::merge_results_dist``
gathers the annos (cut to the dataset's length) and the recall counters
on the main process, which scores them, as the JAX package's does
(evaluator.py:24-75); the other ranks return ``({}, [])``.
"""

import pickle
import time
from pathlib import Path

import torch

from ..parallel.dist import (
    get_world_size, in_group, is_main_process, merge_results_dist,
)
from ..parallel.train_step import device_batch, make_eval_step


def to_host(tree):
    """A dict tree of tensors as numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy() if torch.is_tensor(tree) else tree


def eval_one_epoch(model, loader, post_cfg, class_names, logger,
                   result_dir=None):
    """Evaluate `model` (its parameters on the device to run on) over
    `loader`, whose batches are host dicts with ``frame_id`` and
    ``batch_size`` and whose ``dataset`` makes the annos and scores them.

    Returns ``(ret_dict, det_annos)``: ``recall/<k>`` (each counter over the
    gt count), the protocol's AP keys (``Car_3d/moderate_R40``, ...) and
    ``sec_per_example``; one anno per frame, each with ``num_candidates``,
    the live rows that entered NMS. Writes ``result.pkl`` (the annos) under
    `result_dir` when one is given. In a process group the ranks' parts
    meet under `result_dir`/tmpdir, a directory every rank sees; the merged
    annos are cut to the dataset's length.
    """
    dataset = loader.dataset
    device = next(model.parameters()).device
    step_fn = make_eval_step(model, post_cfg, len(class_names))

    det_annos = []
    recall_totals = {}
    n_samples = 0
    t0 = time.time()
    for batch in loader:
        preds = to_host(step_fn(device_batch(batch, device)))
        for k, v in preds.pop('recall', {}).items():
            recall_totals[k] = recall_totals.get(k, 0) + int(v)
        annos = dataset.generate_prediction_dicts(batch, preds, class_names)
        for anno, live in zip(annos, preds['num_candidates']):
            anno['num_candidates'] = int(live)
        det_annos += annos
        n_samples += batch['batch_size']

    sec_per_example = (time.time() - t0) / max(n_samples, 1)
    logger.info('eval: %d samples, %.4f sec/example', n_samples,
                sec_per_example)

    if in_group():
        world = get_world_size()
        if result_dir is None:
            raise ValueError('evaluation in a process group needs a '
                             'result_dir that every rank sees')
        tmpdir = Path(result_dir) / 'tmpdir'
        # the recall counters first, in a directory inside the annos': the
        # annos' merge then removes both
        merged = merge_results_dist([sorted(recall_totals.items())], world,
                                    tmpdir / 'recall')
        det_annos = merge_results_dist(det_annos, len(dataset), tmpdir)
        if not is_main_process():
            return {}, []
        recall_totals = {}
        for items in merged:
            for k, v in items:
                recall_totals[k] = recall_totals.get(k, 0) + v

    ret_dict = {}
    gt = max(recall_totals.get('gt', 0), 1)
    for k, v in recall_totals.items():
        if k == 'gt':
            continue
        logger.info('recall_%s: %.4f', k, v / gt)
        ret_dict[f'recall/{k}'] = v / gt

    if result_dir is not None:
        Path(result_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(result_dir) / 'result.pkl', 'wb') as f:
            pickle.dump(det_annos, f)

    if hasattr(dataset, 'evaluation'):
        result_str, result_dict = dataset.evaluation(
            det_annos, class_names,
            eval_metric=post_cfg.get('EVAL_METRIC', 'kitti'))
        logger.info(result_str)
        ret_dict.update(result_dict)
    ret_dict['sec_per_example'] = sec_per_example
    return ret_dict, det_annos
