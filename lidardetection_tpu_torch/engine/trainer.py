"""Training loop (lidardetection_tpu/engine/trainer.py:20).

The loop feeds batches to the train step and logs; checkpoints are saved
per epoch with rotation, and a run started on a directory that holds
checkpoints resumes from the newest. In a process group every rank steps
on its loader shard and only the main process writes the checkpoints
(engine/trainer.py:95 of the JAX package); every rank resumes from them.
"""

import time

import numpy as np
import torch

from ..parallel.dist import barrier, is_main_process
from ..parallel.train_step import device_batch, make_train_step
from ..utils.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)


def train_model(state, loader, total_epochs, ckpt_dir, logger, device,
                lr_fn=None, start_epoch=0, max_ckpt_save_num=30,
                ckpt_save_interval=1, log_interval=20):
    """Train `state` (a TrainState) for epochs start_epoch..total_epochs.

    `loader` yields host batches, has a length and ``set_epoch``. Returns
    the state.
    """
    latest = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if latest is not None:
        start_epoch = restore_checkpoint(latest, state, logger)
        logger.info('resumed from %s (epoch %d)', latest, start_epoch)
    step_fn = make_train_step(state)
    sync = torch.cuda.synchronize if torch.device(device).type == 'cuda' \
        else (lambda: None)

    for epoch in range(start_epoch, total_epochs):
        loader.set_epoch(epoch)
        t_epoch = time.time()
        losses = []
        for it, batch in enumerate(loader):
            tb = step_fn(device_batch(batch, device))
            if it % log_interval == 0:
                losses.append(float(tb['loss']))
                cur_lr = lr_fn(state.step) if lr_fn else float('nan')
                logger.info('epoch %d it %d/%d loss %.4f lr %.2e', epoch, it,
                            len(loader), losses[-1], cur_lr)
        sync()  # the epoch's time includes its queued device work
        logger.info('epoch %d done in %.1fs (mean logged loss %.4f)', epoch,
                    time.time() - t_epoch,
                    np.mean(losses) if losses else float('nan'))
        if ckpt_dir and is_main_process() and (
                (epoch + 1) % ckpt_save_interval == 0
                or epoch + 1 == total_epochs):
            save_checkpoint(state, ckpt_dir, epoch + 1,
                            max_ckpt_save_num=max_ckpt_save_num, logger=logger)
    barrier()  # the last checkpoint is on disk for every rank
    return state
