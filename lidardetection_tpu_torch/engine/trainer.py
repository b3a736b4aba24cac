"""Training loop (lidardetection_tpu/engine/trainer.py:20).

The loop feeds batches to the train step and logs; checkpoints are saved
per epoch with rotation, and a run started on a directory that holds
checkpoints resumes from the newest. In a process group every rank steps
on its loader shard and only the main process writes the checkpoints
(engine/trainer.py:95 of the JAX package); every rank resumes from them.
Given a TensorBoard writer, each logged step writes ``train/<term>`` and
``meta_data/learning_rate``. Given a profile directory, a window of steps
(`profile_window`) runs under ``torch.profiler`` and its Chrome trace is
written there.
"""

import time
from pathlib import Path

import numpy as np
import torch

from ..parallel.dist import barrier, is_main_process
from ..parallel.train_step import device_batch, make_train_step
from ..utils.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)


def profile_window(total_steps, steps=(10, 15)):
    """The steps [start, stop) of the run's profile window: `steps`
    clamped into a run of `total_steps`, so that a short run still
    traces its last two (engine/trainer.py:36-45 of the JAX package)."""
    start, stop = steps
    stop = min(stop, total_steps)
    return min(start, max(stop - 2, 0)), stop


class StepProfiler:
    """``torch.profiler`` over the steps of a window, CPU and CUDA
    activities (CPU alone on a CPU device), each step a span named
    ``train_step <n>``; the device is drained at the window's start and
    stop, and the trace goes to `profile_dir` as a Chrome trace."""

    def __init__(self, profile_dir, window, device, logger):
        self.dir, (self.start, self.stop) = Path(profile_dir), window
        self.device, self.logger = torch.device(device), logger
        self.prof, self.span, self.t0 = None, None, 0.0
        self.trace = None  # the Chrome trace's path, once written

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def before(self, global_it):
        if global_it == self.start and self.trace is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(ProfilerActivity.CUDA)
            self._sync()
            self.prof = profile(activities=activities)
            self.prof.start()
            self.t0 = time.perf_counter()
            self.logger.info('profiler: tracing steps %d-%d to %s', self.start,
                             self.stop, self.dir)
        if self.prof is not None:
            self.span = torch.profiler.record_function(f'train_step {global_it}')
            self.span.__enter__()

    def after(self, global_it):
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
        if self.prof is not None and global_it + 1 == self.stop:
            self.close()

    def close(self):
        """Stop an open window (also one that the data ran past) and write
        its trace."""
        if self.prof is None:
            return
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.trace = self.dir / f'trace_steps_{self.start}_{self.stop}.json'
        self.prof.export_chrome_trace(str(self.trace))
        self.prof = None
        self.logger.info('profiler: steps %d-%d in %.3f s (wall, profiler on), '
                         'trace %s', self.start, self.stop, wall, self.trace)


def train_model(state, loader, total_epochs, ckpt_dir, logger, device,
                lr_fn=None, start_epoch=0, max_ckpt_save_num=30,
                ckpt_save_interval=1, log_interval=20, tb_writer=None,
                profile_dir=None, profile_steps=(10, 15)):
    """Train `state` (a TrainState) for epochs start_epoch..total_epochs.

    `loader` yields host batches, has a length and ``set_epoch``. Every
    `log_interval` steps of an epoch the loss and learning rate are
    logged, and written to `tb_writer` where one is given; with
    `profile_dir`, the steps `profile_steps` (clamped into the run by
    `profile_window`) are traced there. Returns the state.
    """
    latest = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if latest is not None:
        start_epoch = restore_checkpoint(latest, state, logger)
        logger.info('resumed from %s (epoch %d)', latest, start_epoch)
    step_fn = make_train_step(state)
    sync = torch.cuda.synchronize if torch.device(device).type == 'cuda' \
        else (lambda: None)
    iters = len(loader)
    profiler = StepProfiler(
        profile_dir, profile_window((total_epochs - start_epoch) * iters,
                                    profile_steps), device, logger) \
        if profile_dir else None

    for epoch in range(start_epoch, total_epochs):
        loader.set_epoch(epoch)
        t_epoch = time.time()
        losses = []
        for it, batch in enumerate(loader):
            global_it = (epoch - start_epoch) * iters + it
            if profiler:
                profiler.before(global_it)
            tb = step_fn(device_batch(batch, device))
            if profiler:
                profiler.after(global_it)
            if it % log_interval == 0:
                losses.append(float(tb['loss']))
                cur_lr = lr_fn(state.step) if lr_fn else float('nan')
                logger.info('epoch %d it %d/%d loss %.4f lr %.2e', epoch, it,
                            iters, losses[-1], cur_lr)
                if tb_writer is not None:
                    tb_writer.add_scalar('meta_data/learning_rate', cur_lr,
                                         state.step)
                    for k, v in tb.items():
                        tb_writer.add_scalar(f'train/{k}', float(v), state.step)
        if profiler:  # a window that the data ran past
            profiler.close()
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
