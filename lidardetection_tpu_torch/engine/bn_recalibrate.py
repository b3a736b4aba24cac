"""Precise-BN (lidardetection_tpu/engine/bn_recalibrate.py:40): replace each
BatchNorm's running statistics with population statistics over training
batches, the parameters frozen.

A short schedule leaves the running averages (momentum 0.99) lagging the
batch statistics, and the gap compounds through the layers at eval
(TRAIN_TO_AP.md). With the parameters frozen each BatchNorm's batch
statistics are stationary, so the population statistic is their average
over batches.

The JAX package cannot reach a module's batch statistic and recovers it
from two EMA steps with an estimated momentum. Here every module that keeps
running statistics (``MaskedBatchNorm``, and ``PillarVFE`` for its inline
BatchNorm; each names its buffers in ``bn_statistics``) is run with
momentum 0 inside ``_accumulating``, so after a train-mode call its
buffers hold exactly that call's statistics, taken as the module takes
them (masked, biased variance, float32); a forward hook adds them into
float64 sums. On leaving, the momenta found are put back. Modules the
forward never reached keep their values.
"""

import contextlib

import torch

from ..parallel.train_step import step_draw
from ..utils.precision import full_f32


def _holders(model):
    """The modules of `model` that keep BatchNorm running statistics."""
    return [m for m in model.modules() if hasattr(m, 'bn_statistics')]


@contextlib.contextmanager
def _accumulating(model):
    """Yields {module: [mean sum, var sum, calls]}, filled by every
    train-mode call of a statistics holder of `model` in the block."""
    sums, hooks, momenta = {}, [], {}

    def hook(module, args, output):
        if module.training:
            mean, var = (getattr(module, n) for n in module.bn_statistics)
            acc = sums.setdefault(module, [0.0, 0.0, 0])
            acc[0] = acc[0] + mean.double()
            acc[1] = acc[1] + var.double()
            acc[2] += 1

    try:
        for m in _holders(model):
            momenta[m] = m.momentum
            m.momentum = 0.0
            hooks.append(m.register_forward_hook(hook))
        yield sums
    finally:
        for h in hooks:
            h.remove()
        for m, momentum in momenta.items():
            m.momentum = momentum


def recalibrate_bn_stats(model, loader, device_batch_fn, n_batches=16,
                         logger=None):
    """Set every BatchNorm's running mean and variance of `model` to the
    average of its statistics over `n_batches` batches of `loader`
    (training data; restarted when it runs out), each taken by a train-mode
    forward under ``torch.no_grad()`` (in float32 whatever the process
    flags for a float32 model), whose random layers draw from
    ``step_draw(0, i)`` for the i-th batch. ``device_batch_fn`` maps a
    loader batch to the model's input. Parameters do not change; the model
    is left in eval mode. Returns the model."""
    model.train()
    it = iter(loader)
    with torch.no_grad(), _accumulating(model) as sums, \
            full_f32(model.compute_dtype == torch.float32):
        saved = {m: [getattr(m, n).clone() for n in m.bn_statistics]
                 for m in _holders(model)}
        device = next(model.parameters()).device
        for i in range(n_batches):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                batch = next(it)
            model(device_batch_fn(batch), step_draw(0, i, device))
        for m, values in saved.items():
            if m in sums:
                s_mean, s_var, calls = sums[m]
                values = [s_mean / calls, s_var / calls]
            for name, value in zip(m.bn_statistics, values):
                buf = getattr(m, name)
                buf.copy_(value.to(buf.dtype))
    model.eval()
    if logger is not None:
        logger.info('BN recalibration: %d batches, %d of %d BatchNorms '
                    'reached (precise-BN population statistics)', n_batches,
                    len(sums), len(saved))
    return model
