"""The training and eval steps (lidardetection_tpu/parallel/train_step.py:
21-123).

`TrainState` holds what a step changes: the model (parameters and BatchNorm
statistics) and the optimizer (moments and the step count), and the seed
of the run's random layers.
``make_train_step(state)`` returns ``step(batch) -> tb``: train-mode
forward, loss, backward, then one optimizer step (clip, Adam, weight decay).
The forward runs once, so the BatchNorm statistics move once a step. The
random layers (RoI sampling, dropout) draw from ``step_draw(seed, step)``,
a generator made anew each step from the seed and the step count, as the
JAX package folds ``state.step`` into its key: a resumed run draws what
the uninterrupted one drew.
Parameters are updated in place. A float32 model steps in float32 whatever
the process's TF32 and matmul-precision flags are (``utils/precision.py``).
In a process group the step is the single-process step over the global
batch, the ranks' batches stacked in rank order (``parallel/dist.py``):
the gradients are averaged over the ranks before the optimizer step, and
the loss terms it returns are the global batch's.
``make_eval_step`` returns ``step(batch) -> preds``: the eval forward,
post-processing and the recall counters.
"""

import torch

from ..models.detectors.post_processing import compute_recall, post_processing
from ..utils.precision import full_f32
from .dist import average_gradients, average_terms, get_rank, get_world_size

# batch keys the step reads; ``rb_*`` (host-built rulebooks) ride along
DEVICE_KEYS = ('voxels', 'voxel_coords', 'voxel_num_points', 'num_voxels',
               'points', 'num_points', 'gt_boxes', 'locations', 'rotations_y')


def device_batch(batch, device):
    """The step's keys of a host batch (numpy arrays or tensors), on
    `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if k in DEVICE_KEYS or k.startswith('rb_')}


def step_draw(seed, step, device):
    """``draw(name, shape)`` -> float32 uniforms in [0, 1) on `device`, in
    call order from a ``torch.Generator`` seeded with (seed, step). The
    names say which layer draws; this source ignores them. Every draw's
    first dimension runs over the batch's samples (a sample's rows
    together); in a process group each rank draws the global batch's
    numbers, its batch times the group's size, and takes its own rows:
    the ranks' samples draw what they draw in the global step."""
    generator = torch.Generator(device=device)
    generator.manual_seed((int(seed) << 32) + int(step))
    rank, world = get_rank(), get_world_size()

    def draw(name, shape):
        rows = shape[0]
        whole = torch.rand((rows * world, *shape[1:]), generator=generator,
                           device=device)
        return whole[rank * rows:(rank + 1) * rows]

    return draw


class TrainState:
    def __init__(self, model, optimizer, seed=0):
        self.model, self.optimizer, self.seed = model, optimizer, seed

    @property
    def step(self):
        return self.optimizer.count

    def state_dict(self):
        """Plain dicts of tensors: parameters and BatchNorm statistics, the
        optimizer's moments, the step."""
        return {'step': self.step, 'model': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict()}

    def load_state_dict(self, state):
        self.model.load_state_dict(state['model'])
        self.optimizer.load_state_dict(state['optimizer'])


def make_train_step(state):
    """step(batch) -> dict of the loss terms (detached 0-d tensors)."""
    model, optimizer = state.model, state.optimizer

    def step(batch):
        model.train()
        for p in optimizer.params:
            p.grad = None
        draw = step_draw(state.seed, state.step,
                         next(model.parameters()).device)
        with full_f32(model.compute_dtype == torch.float32):
            loss, tb = model.loss(model(batch, draw))
            loss.backward()
            average_gradients(optimizer.params)
            optimizer.step()
        return average_terms({k: v.detach() for k, v in tb.items()})

    return step


def make_eval_step(model, post_cfg, num_class):
    """step(batch) -> the post-processed predictions of
    ``models/detectors/post_processing.py`` (padded, with ``num_preds`` and
    ``num_candidates``, the live rows entering NMS), plus ``recall``, the
    counters of ``compute_recall`` over RECALL_THRESH_LIST, when the batch
    carries ``gt_boxes``. Runs the model in eval mode under
    ``torch.inference_mode()``, in float32 whatever the process flags for
    a float32 model, as ``serve.Detector`` does."""
    def step(batch):
        model.eval()
        with torch.inference_mode(), \
                full_f32(model.compute_dtype == torch.float32):
            out = model(batch)
            preds = post_processing(out, post_cfg, num_class)
            if 'gt_boxes' in batch:
                preds['recall'] = compute_recall(
                    preds['pred_boxes'], preds['pred_mask'],
                    batch['gt_boxes'], tuple(post_cfg['RECALL_THRESH_LIST']),
                    rois=out.get('rois'), roi_mask=out.get('roi_valid'))
        return preds

    return step
