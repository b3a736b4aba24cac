"""Why the f32 CBGS step strays from a float64 step, on the CPU.

A reduced cbgs_second_multihead.yaml (tests/test_torch_multihead_slice.py's
widths, 0.2 m voxels so that the 64 x 64 BEV map is mostly empty, 900
voxels a scene, f32), one step of two synthetic scenes from the port's
own weights (seed 0), against a step that is float64 from end to end
(``tools/step_precision.py::float64_step_gradient``):

  * the float64 step rounds nothing to float32 (``Float32Audit``; the
    same forward without ``KeepFloat64`` rounds where the heads cast) and
    assigns the f32 step's anchor labels;
  * on the float64 step's ReLU branch (``ReluBranch``, 62 ReLUs, ~8.5e6
    entries) the plain f32 step summed in two orders (the rulebook's
    offsets as they are, and rolled by 18: ``REORDERINGS``) lies within
    2e-5 of it (whole gradient, relative L2; ~4e-6 here), with float32 or
    float64 BatchNorm statistics alike;
  * left free, with float32 statistics, the same step in either order
    puts a few ReLU entries on the other side of 0 from the float64
    step's and lies more than 50 times as far from it (6e-4 to 1.6e-3
    here);
  * with each ReLU's input entry nearest 0 (each within 1e-5 of its
    ReLU's largest input) on the other side, the branch that a change of
    rounding reaches, the same step lies more than 50 times as far
    (~2.1e-3 here), and float64 BatchNorm statistics do not bring it back.

So a change of summation order, the hand kernels' included, moves the f32
gradient through the ReLUs' kinks, where an entry within rounding of 0
takes the other branch and the leaves behind it jump; the BatchNorm
statistics' cancellation is not what moves it. chip_smoke.py's
``whole_step_phase`` reads the same on the card at full width (the ReLU
entries that take the other side, the three reorderings, float64
statistics) and holds ``float64_rule`` on the float64 step's branch.
"""

import contextlib

import pytest
import torch

from lidardetection_tpu_torch.config import cfg_from_yaml_file, voxel_processor_cfg
from lidardetection_tpu_torch.parallel.train_step import step_draw
from lidardetection_tpu_torch.tools import step_precision as sp
from lidardetection_tpu_torch.train import Trainer
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CFG = 'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml'


def _cfg():
    """tests/test_torch_multihead_slice.py::_reduce's widths, 0.2 m
    voxels, 900 of them a scene."""
    cfg = cfg_from_yaml_file(CFG)
    data = cfg.DATA_CONFIG
    data.DATASET = 'SyntheticDataset'
    del data.DATA_AUGMENTOR
    data.MAX_GT_BOXES = 24
    vox = voxel_processor_cfg(data)
    vox.VOXEL_SIZE = [0.2, 0.2, 0.2]
    vox.MAX_NUMBER_OF_VOXELS = {'train': 900, 'test': 900}
    m = cfg.MODEL
    m.COMPUTE_DTYPE = 'float32'
    m.BACKBONE_2D.LAYER_NUMS = [1, 1]
    m.BACKBONE_2D.NUM_FILTERS = [32, 64]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [32, 32]
    m.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 16
    m.DENSE_HEAD.SEPARATE_REG_CONFIG.NUM_MIDDLE_FILTER = 16
    return cfg


def _distance(grads, exact):
    """The whole gradient's relative L2 distance from `exact`."""
    err = sum(float((grads[k].double() - v).pow(2).sum())
              for k, v in exact.items())
    return (err / sum(float(v.pow(2).sum()) for v in exact.values())) ** 0.5


@pytest.fixture(scope='module')
def step():
    cfg = _cfg()
    trainer = Trainer(cfg, device='cpu', seed=0, total_steps=4)
    scenes = trainer.dataset(2, seed=1)
    batch = trainer.make_batch([scenes[0], scenes[1]])
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    recorded = sp.ReluBranch()
    loss, exact, rounded, labels = sp.float64_step_gradient(
        cfg, state, batch, 0, 'cpu', context=recorded)
    # one model for every f32 step: a step moves only the running
    # statistics, which a training step's forward does not read
    twin = Trainer(cfg, device='cpu', seed=0, state_dict=state,
                   total_steps=4).model
    done = {}

    def f32(order='as is', stats='float32', branch='free'):
        """The plain f32 step with the rulebook's offsets in `order`, the
        BatchNorm statistics in `stats`, on the ReLU `branch` ('free',
        'float64': the float64 step's, 'crossed': that one with each
        ReLU's entry nearest 0 on the other side), computed once. Returns
        (loss, gradient, labels, the ReLU entries whose own sign differs
        from the float64 step's)."""
        key = (order, stats, branch)
        if key not in done:
            masks = {'free': None, 'float64': recorded.masks,
                     'crossed': sp.nearest_flipped(recorded.masks,
                                                   recorded.nearest)}[branch]
            relus = sp.ReluBranch(masks)
            with sp.summed_in_order(dict(sp.REORDERINGS).get(order)), \
                    sp.float64_batch_statistics() if stats == 'float64' \
                    else contextlib.nullcontext(), relus:
                out = sp.step_gradient(twin, batch, step_draw(0, 0, 'cpu'))
            flips = relus.flips if masks is not None else sum(
                int((a != b).sum()) for a, b in zip(relus.masks,
                                                    recorded.masks))
            done[key] = (*out, flips)
        return done[key]

    return cfg, state, batch, (loss, exact, rounded, labels, recorded), f32


def test_float64_step_rounds_nothing_to_float32(step):
    cfg, state, batch, (loss, exact, rounded, labels, recorded), f32 = step
    assert rounded == {}
    assert all(g.dtype == torch.float64 for g in exact.values())
    assert len(recorded.masks) > 50
    loss_p, _, labels_p, _ = f32('as is', 'float32', 'float64')
    torch.testing.assert_close(labels_p, labels, rtol=0, atol=0)
    assert abs(loss - loss_p) <= 1e-5 * abs(loss)
    # the audit's control: the float64 model's forward without KeepFloat64
    # rounds where the heads cast to float32
    twin = Trainer(cfg, device='cpu', seed=0, state_dict=state, total_steps=4)
    twin.model.double()
    audit = sp.Float32Audit()
    with torch.no_grad(), audit:
        twin.model({k: v.double() if v.is_floating_point() else v
                    for k, v in batch.items()}, step_draw(0, 0, 'cpu'))
    assert sum(audit.rounded.values()) > 0


# two summation orders with float32 BatchNorm statistics, and the first
# with float64 ones
CASES = [('as is', 'float32'), ('offsets rolled by 18', 'float32'),
         ('as is', 'float64')]


@pytest.mark.parametrize('order,stats', CASES)
def test_on_the_float64_branch_each_order_stays_near(step, order, stats):
    """With the float64 step's ReLU branch imposed, the plain f32 step
    summed in either order lies within 2e-5 of the float64 step (whole
    gradient, relative L2): off the kinks the f32 arithmetic is well
    conditioned, with float32 BatchNorm statistics as with float64 ones."""
    *_, (_, exact, _, _, _), f32 = step
    _, grads, _, _ = f32(order, stats, 'float64')
    assert _distance(grads, exact) < 2e-5


@pytest.mark.parametrize('order', ['as is', 'offsets rolled by 18'])
def test_free_steps_cross_a_kink_and_stray(step, order):
    """Left free, with float32 BatchNorm statistics, the plain f32 step
    summed in either order puts a few ReLU entries (four or five here)
    on the other side of 0 from the float64 step's and lies more than 50
    times as far from it as on the float64 step's branch (~1.6e-3 and
    ~6.3e-4 here, against ~4e-6). Whether a free step strays is the
    batch's luck: an entry within rounding of 0 must take the other side
    where it matters, which happens on this batch in both orders."""
    *_, (_, exact, _, _, _), f32 = step
    _, grads, _, flips = f32(order)
    assert flips > 0
    assert _distance(grads, exact) > 50 * _distance(
        f32(order, 'float32', 'float64')[1], exact)


@pytest.mark.parametrize('stats', ['float32', 'float64'])
def test_relu_entries_nearest_zero_move_the_gradient(step, stats):
    """The branch a change of rounding reaches: each ReLU's input entry
    nearest 0 on the other side (62 entries of ~8.5e6, each within 1e-5
    of its ReLU's largest input). The plain f32 step on it lies more than
    50 times as far from the float64 step as on the float64 step's
    branch, more than 1e-4, whether the BatchNorm statistics are float32
    or float64: their cancellation is not what moves the step."""
    *_, (_, exact, _, _, recorded), f32 = step
    assert max(share for _, share in recorded.nearest) < 1e-5
    near = _distance(f32('as is', stats, 'float64')[1], exact)
    assert _distance(f32('as is', stats, 'crossed')[1], exact) > max(
        1e-4, 50 * near)
