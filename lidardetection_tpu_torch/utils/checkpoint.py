"""Checkpoint save and restore (lidardetection_tpu/utils/checkpoint.py).

A checkpoint is ``<ckpt_dir>/checkpoint_epoch_<n>.pth``: ``torch.save`` of
plain dicts, {step, model (parameters and BatchNorm statistics), optimizer
(moments and count), meta {epoch, version}}. Rotation keeps at most
``max_ckpt_save_num`` files. A save writes to a temporary name and renames
it, so an interrupted save never counts as a checkpoint. Restore brings
back the optimizer's moments and the step with the weights: a resumed run
continues the one-cycle schedule where it stopped.
"""

import os
import re
from pathlib import Path

import torch

from .. import __version__

_NAME = re.compile(r'checkpoint_epoch_(\d+)\.pth')


def _complete_checkpoints(ckpt_dir):
    """[(epoch, path)] ascending; temporary files do not match."""
    found = []
    for path in Path(ckpt_dir).glob('checkpoint_epoch_*'):
        match = _NAME.fullmatch(path.name)
        if match:
            found.append((int(match.group(1)), path))
    return sorted(found)


def save_checkpoint(state, ckpt_dir, epoch, max_ckpt_save_num=30, logger=None):
    """Save a TrainState as checkpoint_epoch_<epoch>.pth; returns the path."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    ckpts = _complete_checkpoints(ckpt_dir)
    while len(ckpts) >= max_ckpt_save_num:
        ckpts.pop(0)[1].unlink(missing_ok=True)
    path = ckpt_dir / f'checkpoint_epoch_{epoch}.pth'
    payload = {**state.state_dict(), 'meta': {
        'epoch': epoch, 'version': f'lidardetection_tpu_torch+{__version__}'}}
    tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if logger:
        logger.info('checkpoint saved: %s', path)
    return str(path)


def checkpoints(ckpt_dir):
    """Paths of the complete checkpoints in epoch order ([] where there is
    no such directory)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return [str(path) for _, path in _complete_checkpoints(ckpt_dir)]


def latest_checkpoint(ckpt_dir):
    """Path of the newest complete checkpoint, or None."""
    ckpts = checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def restore_checkpoint(path, state, logger=None):
    """Load a checkpoint into a TrainState built for the same model and
    optimizer; returns the epoch it was saved after."""
    device = next(iter(state.optimizer.params)).device
    loaded = torch.load(path, map_location=device, weights_only=True)
    state.load_state_dict(loaded)
    epoch = int(loaded.get('meta', {}).get('epoch', 0))
    if logger:
        logger.info('restored %s (epoch %d, step %d)', path, epoch, state.step)
    return epoch


def restore_model(path, model, logger=None):
    """Load a checkpoint's parameters and BatchNorm statistics into a bare
    model (no optimizer), on the model's device; returns the epoch it was
    saved after."""
    device = next(model.parameters()).device
    loaded = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(loaded['model'])
    epoch = int(loaded.get('meta', {}).get('epoch', 0))
    if logger:
        logger.info('restored the model of %s (epoch %d)', path, epoch)
    return epoch


def checkpoint_epoch(path):
    """The epoch in a checkpoint's name (0 for None)."""
    return int(_NAME.fullmatch(Path(path).name).group(1)) if path else 0
