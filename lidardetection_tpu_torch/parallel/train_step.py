"""The training step (lidardetection_tpu/parallel/train_step.py:21-103).

`TrainState` holds what a step changes: the model (parameters and BatchNorm
statistics) and the optimizer (moments and the step count).
``make_train_step(state)`` returns ``step(batch) -> tb``: train-mode
forward, loss, backward, then one optimizer step (clip, Adam, weight decay).
The forward runs once, so the BatchNorm statistics move once a step.
Parameters are updated in place. A float32 model steps in float32 whatever
the process's TF32 and matmul-precision flags are (``utils/precision.py``).
"""

import torch

from ..utils.precision import full_f32

# batch keys the step reads; ``rb_*`` (host-built rulebooks) ride along
DEVICE_KEYS = ('voxels', 'voxel_coords', 'voxel_num_points', 'num_voxels',
               'points', 'num_points', 'gt_boxes', 'locations', 'rotations_y')


def device_batch(batch, device):
    """The step's keys of a host batch (numpy arrays or tensors), on
    `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if k in DEVICE_KEYS or k.startswith('rb_')}


class TrainState:
    def __init__(self, model, optimizer):
        self.model, self.optimizer = model, optimizer

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
        with full_f32(model.compute_dtype == torch.float32):
            loss, tb = model.loss(model(batch))
            loss.backward()
            optimizer.step()
        return {k: v.detach() for k, v in tb.items()}

    return step
