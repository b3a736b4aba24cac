"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: PointPillar,
SECOND, Part-A² and PointRCNN, serving, training and evaluation; PV-RCNN
serving and training; the variants (the NuScenes CBGS multi-head
detectors, multiframe PV-RCNN, PartA2-free, second_multihead); training
and evaluation from KITTI, NuScenes, PlusAI and Mix trees on disk; a
one-process NCCL group.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises on failure (non-zero exit, no result line):
  1. build the kernels of csrc/ with nvcc (one nvcc per source, together)
     and the KITTI protocol's host library (native/) with g++, and read
     the timing floor (a one-element kernel under ``cuda_ms``, which
     flushes the L2 clean before each call: ``tools/measure.py``), beside
     the earlier timer's (its flush, a 64 MB write, left the L2 dirty) and
     a 32 MB read and write after each flush; every kernel row below
     carries its time under the earlier flush too (``old_flush_ms``);
  2. K1 and K2 against their plain PyTorch versions on the card, at the
     PointPillar path's shapes (40000-pillar table of voxelized synthetic
     scenes, P = 32, C = 64, 496 x 432 canvas, B = 1 and B = 4), bit-equal;
     K1 in bf16 and f32, also with no live pillar, every pillar full,
     counts out of [0, P], V a multiple of no block's pillars, P = 20 at
     C = 100 and its scalar path (C = 99); K2 also on a sample of padding
     alone and one that hits every slot; their times beside the bound, the
     plain version's time and a library call's (K1 at B = 1 and B = 4);
  3. serve requests through ``serve.Detector`` on the full
     tools/cfgs/kitti_models/pointpillar.yaml (bf16 compute, random
     weights from a seed, class-logit bias 0 so NMS sees live candidates),
     with every kernel's launch count set to 0 just before and read after;
     the rows each request's blocked NMS walk read, the p50s beside the
     earlier ones (the full-matrix NMS, the numpy voxelizer); the forward
     split by module;
  4. the same weights and clouds in f32 on the card (kernels) and on the
     CPU (plain versions): head outputs and kept detections must agree
     (the TF32 flags are left as PyTorch sets them: the port holds f32
     as f32 itself);
  5. K3 against its plain version on the card at the SECOND path's shapes:
     the twelve convolutions of the full second.yaml backbone, with the
     rulebooks and activations of real voxelized scans (V = 40000), in
     bf16 and f32, B = 1 and B = 4, the same bits on a second run, one
     rulebook with shuffled rows, and K2 at SECOND's shape (C = 128, 2 x
     200 x 176 slots); their times, and per layer the share of (tile,
     offset) pairs and 16-row fragments K3 skips and its rate on hits;
  6. and 7. phases 3 and 4 for the full tools/cfgs/kitti_models/second.yaml;
  8. train through ``train.Trainer`` at full width (the yaml's train cap of
     16000 voxels, B = 4, bf16, adam_onecycle), PointPillar then SECOND
     (on the host plan's rulebooks, ops/sparse_plan.py): 2 warm-up and 3
     timed steps each, launch counts set to 0 before every step and
     checked after it (SECOND: 12 K4, 12 + 11 K3 (7 submanifold and 4
     strided df), 1 K2; PointPillar: 1 K2), finite loss and gradients,
     BatchNorm statistics moved, peak memory, the step p50 beside the
     earlier one (device-built rulebooks, the full-matrix NMS);
     one SECOND step split by forward / backward / optimizer; two
     identical SECOND steps from one state, deterministic mode off, held
     bit-equal leaf by leaf (``reproducibility_phase``: where they differ,
     the differing leaves are printed by module); per scan at the
     train cap the voxelizer and the plan's rulebooks, host library
     against numpy plain version (equal) and their times;
  9. K4 against its plain version on the (f, rulebook, g) of the 12 sparse
     layers of one SECOND training step (bf16 and f32, B = 1 and B = 4, one
     rulebook with shuffled rows, the same bits on a second run), its times,
     row splits, workspace bytes and rate on hits per layer; K3 at the
     step's shape (its 12 forward and 7 df launches) against its plain
     version, and its times; each strided layer's df (K3 over its
     transposed rulebook) against the plain scatter-add within 1e-4 of
     the largest value;
     the K3 input gradient of a 64 -> 64 submanifold layer against autograd
     of the plain version; K2's backward against autograd of its plain
     version;
 10. one f32 training step on the card with the kernels against the same
     forward and backward with the plain versions under autograd, on the
     card (only the kernels differ: every gradient leaf within 1e-3) and on
     the CPU (the dense library differs too: looser, the sparse backbone's
     leaves within 1e-2), same weights and batch, both detectors;
 11. train PV-RCNN through ``train.Trainer`` at full width (the yaml's
     train cap of 16000 voxels, B = 2, bf16, adam_onecycle, 2048
     keypoints, proposal NMS 9000 -> 512, 128 sampled RoIs, dropout 0.3):
     2 warm-up and 3 timed steps on the host plan's rulebooks, launch
     counts set to 0 before every step and checked after it: 12 K3
     forward + 7 submanifold and 4 strided K3 df, 12 K4, 1
     K2 (HeightCompression's scatter; its backward is a gather) and 5 K5
     (the VSA's raw-point and x_conv1-4 ball queries; no backward) a step,
     no K1; finite loss and gradients, BatchNorm statistics moved, peak
     memory; one step split by forward (the proposal layer, its NMS and
     the anchor, point and RoI target assigners apart), backward and
     optimizer, the rows the NMS walk read per sample and its kept lists
     against the full-matrix oracle on the card (equal lists); one f32
     step with the kernels against the plain versions
     on the card, both drawing from the same per-step generator: the same
     sampled RoIs, then every gradient leaf within 1e-3;
 12. serve requests through ``serve.Detector`` on the full
     tools/cfgs/kitti_models/pv_rcnn.yaml (bf16, 2048 keypoints, 40000
     voxels, 131072 raw points of capacity), launch counts set to 0 before
     every request and checked after it (12 K3, 1 K2, 5 K5); the forward
     split by module, FPS, the five ball queries and the proposal layer
     apart;
 13. K5 against its plain version on the card on the five sources' (table,
     runs, centres) of a real request at B = 1 and B = 2, with the original
     indices shuffled or descending along each run, with a third of the
     centres invalid, with nsample 1 and 64, on a cloud whose cells hold
     more than the 64 cap, and with every candidate of that cloud's runs in
     radius (more hits than a warp's buffer holds): bit-equal; its times
     per source, beside each ball query's prep;
 14. one f32 PV-RCNN request on the card with the kernels against the same
     request on the card with the plain versions (only the kernels differ);
 15. evaluate through ``engine/evaluator.py::eval_one_epoch`` on the card,
     PointPillar then SECOND at the yaml's full width and test cap, random
     weights from a seed (class-logit bias 0), 4 synthetic scenes at B = 2,
     launch counts set to 0 before every batch and checked after it
     (PointPillar: 1 K1, 1 K2; SECOND on the eval plan's host rulebooks
     cut to the batch's occupancy: 12 K3, 1 K2); sec_per_example, the
     recall counters and the live NMS candidates; SECOND's detections on
     the bucketed host tables equal to those of the unbucketed
     device-built path on the same scenes;
 16. the KITTI protocol with the native host library built by the
     machine's g++: native against numpy plain version on both eval runs'
     annos and on perfect predictions over 48 scenes (equal results; the
     perfect set reads 100.0 for every class);
 17. precise-BN (``engine/bn_recalibrate.py``) on the card against the
     CPU, f32, a reduced PointPillar, the same 3 batches: every statistics
     leaf within 1e-3 of its largest magnitude;
 18. one request of each detector and one training step of each trained
     detector under torch.profiler (idle share, top kernels), after every
     timed phase; one K2 call under it: one kernel, no memset.
Part-A² (tools/cfgs/kitti_models/PartA2.yaml: UNetV2, the intra-part
point head, RoI-aware pooling, the masked dense RCNN convolutions), run
after the PV-RCNN phase of each kind:
 - serving, bf16, 40000 voxels, POOL_SIZE 12: 3 requests with 28 K3
   (UNetV2's 28 convolutions, 3 inverse) and 1 K2 checked per request,
   latency and peak memory; K3 against its plain version at each of the 28
   layers of a real request in bf16 and f32, and each layer's time; the
   forward split by module, the proposal layer, the RoI point sample, the
   two pools, the UNet's encoder and decoder and the RCNN convolutions and
   FCs apart; one f32 request, kernels against plain versions on the card;
 - training, B = 2, 16000 voxels, the host plan: 2 warm-up and 3 timed
   steps with 55 K3 (28 forward; 27 df: 20 submanifold, 4 strided, 3
   inverse over the paired ``rb_down<n>``), 28 K4 and 1 K2 checked per
   step; the step split; K4 at each layer (bf16 and f32, B = 1 and 2) and
   K3 at each of the step's 55 launches against their plain versions, with
   times; the inverse and strided df on K3 against the scatter-add; two
   identical steps held bit-equal; the plan per scan, host library
   against numpy; one f32 step, kernels against plain versions on the
   card, the same sampled RoIs, every leaf within 1e-3;
 - evaluation on the bucketed eval plan (4 scenes at B = 2, 28 K3 and 1 K2
   a batch), its detections equal to the unbucketed device-built path's;
   the KITTI protocol native against numpy on its annos; one request and
   one step under the profiler.
PointRCNN (tools/cfgs/kitti_models/pointrcnn.yaml: PointNet2MSG over 16384
sampled points, the point box head, RoI point pooling of 512 points, the
RoI set abstractions), run after Part-A²'s phase of each kind:
 - serving, bf16: 3 requests with 2 K5 checked per request (the first two
   set abstraction levels, 16384 and 4096 sources, take the grid query),
   latency and peak memory; K5 against its plain version at both levels
   of a real request (B = 1 and 2, a third of the centres invalid) and
   its time per level beside its bound; the forward split (the 4 SA and 4
   FP levels, the point head, the proposal layer, the RoI pool, the RoI
   set abstractions and FCs); one f32 request, kernels against plain
   versions on the card;
 - training, B = 2: 2 warm-up and 3 timed steps with 2 K5 checked per
   step; the step split; two identical steps held bit-equal; one
   f32 step, kernels against plain versions on the card, the same sampled
   RoIs, every leaf within 1e-3;
 - evaluation (4 scenes at B = 2, 2 K5 a batch), the KITTI protocol native
   against numpy on its annos; one request and one step under the
   profiler.
The variants, run after PointRCNN's phase of each kind:
 - tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml serving, bf16,
   B = 1, the 60000-voxel cap, class-logit biases 0, on clouds as dense
   as a 10-sweep NuScenes scan (``datasets/synthetic.py::make_sweeps``,
   ~270k points in range, printed): 3 requests with 19 K3
   (VoxelResBackBone8x) and 1 K2 checked per request, the rows each
   class's NMS walk read, peak memory; K3 against its plain version at
   the 19 layers of a real request in bf16 and f32 and each layer's time
   (the 128-channel stage 4 among them); the forward split with the head
   groups apart; the same weights and cloud in f32 on the card and on the
   CPU, every class's kept boxes equal up to a score tie;
 - its training, B = 4 dense scans on the host plan: 2 warm-up and 3
   timed steps with 37 K3 (19 forward, 14 submanifold and 4 strided df),
   19 K4 and 1 K2 checked per step, peak memory, the step split; K4 at
   each layer (bf16 and f32, B = 1 and 4) and K3 at each of the 37
   launches against their plain versions with times, the strided df on
   K3 against the scatter-add;
 - cbgs_pp_multihead.yaml (the PFN stack, no K1) served (1 K2 a
   request) and one timed training step (1 K2); pv_rcnn_multiframe.yaml
   served (12 K3, 1 K2, 5 K5) with an f32 request kernels vs plain, and
   trained (23 K3, 12 K4, 1 K2, 5 K5 a step), the tracking targets live
   in the RoI loss; PartA2_free.yaml served (27 K3) with an f32 request
   kernels vs plain, and trained (53 K3, 27 K4 a step);
 - second_multihead.yaml through ``eval_one_epoch`` (12 K3, 1 K2 a batch,
   multi-class NMS), the KITTI protocol native vs numpy on its annos.
The data layer, after precise-BN: a KITTI tree (12 train and 4 val
frames of an HDL-64E scan, ~129k returns, ~19k in the camera's view and
range) and a NuScenes tree (4 train and 2 val key frames with 9 sweeps of
an HDL-32E scan, ~27k returns each) written to a temporary directory,
``create_kitti_infos`` and the NuScenes gt database timed, all through
``datasets.build_dataloader`` (min(8, cores) forked workers). PointPillar
evaluates the val split, bucketed, through the KITTI protocol (1 K1 and 1
K2 a batch, both held bit for bit against their plain versions on one of
its batches, the largest ``num_voxels`` against the 40000 cap); the CBGS
SECOND multi-head trains from the NuScenes tree with CBGS (every kernel
call of one step on a loader batch held against its plain version; 16
warm-up and 8 timed steps, 37 K3, 19 K4, 1 K2 each; the step again with
no worker alive) and evaluates its 2 val frames through
``_kitti_style_eval`` (19 K3, 1 K2); SECOND trains from the KITTI tree
(the full augmentor, B = 4, bf16; one f32 step on a loader batch with the
kernels against the plain versions on the card and the CPU; 16 warm-up
steps, the batches the workers were sent at the start, then 48 timed with
23 K3, 12 K4 and 1 K2 checked per step: the wait on the loader, the copy
and the step apart, a batch's build time in one process). In the
profiler's section, after K2's launch count, 16 untraced SECOND steps
take the batches the workers built ahead meanwhile, then 16 traced ones
fed by the loader give the idle share of training from files.
In the data phase, the CBGS step's loader batch also takes one whole f32
step with the kernels against the plain versions and a step that is
float64 from end to end (``tools/step_precision.py``): every K3 and K4
call within sqrt(terms) units of float32 rounding of its plain version,
the loss within 1e-6, and, on the float64 step's ReLU branch, each
gradient leaf's distance from the float64 step within 3 times the plain
f32 step's plus 4 float32 ulps, held; the same rule on the free steps,
the plain step in three other summation orders, float64 BatchNorm
statistics and a layer walk, read (``whole_step_phase``). Each of the nine
trainers' synthetic training runs takes two identical steps, held
bit-equal with deterministic mode off (``reproducibility_phase``).
Before the data layer, ``ops/voxelize.py::voxelize_device`` on the card
at a KITTI and a NuScenes 10-sweep scan, held bit-equal to its CPU run
and the host voxelizer's table, timed beside the host voxelizer
(``voxelize_device_phase``).

    python3 chip_smoke.py --deterministic-cost

builds the kernels and, instead of the phases above, times the step of
PV-RCNN, multiframe PV-RCNN and PointRCNN as the package runs it (the
fixed-order row gathers of ops/gather.py), with the atomic gathers
patched back in, and with those in deterministic mode, on the host
clock; then the step's device time under the profiler, the repaired
form's held within +5% of the atomic form's (``deterministic_cost``).
The fork's datasets, after the data layer: a PlusAI multiframe tree (4
scenes of 6 frames of a forward 64-beam sector, ~51k returns, stacked
three at a time by the port's MOT generator) and a Mix tree (16 frames
of a Livox tree and a fake-lidar tree from blank scenes and an object
database, mixed by the port's generator), their infos and gt databases;
pv_rcnn_multiframe.yaml and pointpillars_xy.yaml each train from theirs
(16 warm-up and 8 timed steps, wait / copy / step) and evaluate the val
split through the KITTI protocol, every kernel call of one multiframe
step on a loader batch held against its plain version (K5 bit for bit),
K1 and K2 bit for bit on a Mix eval batch; then the Mix trainer in a
one-process NCCL group: its step and its eval through
``merge_results_dist`` against the bare ones (``distributed_phase``).
The tools, last (``tools_phase``): ``tools/verify_cuda.py`` (every case
ok), ``demo`` over 4 scans of the data phase's KITTI val split,
``inference --with_tracking`` and ``mot_benchmark --with_tracking`` over 8
synthetic scenes (the MOT table, the tracker's host ms a frame),
``inference_bag2json`` over the scans (the JSON read back), ``test
--eval_all`` over two checkpoints of PointPillar written by training steps
there, and ``demo_3d``'s computing path on SECOND, each scene or eval batch
a run with its launches checked; the image writers where their packages
are installed. The verifier's cases join the kernels' JSON.
The training CLI, after the tools (``train_cli_phase``): ``train.main``
on SECOND at full width with ``--synthetic --num_scenes 32 --batch_size
4 --epochs 2 --workers 8 --extra_tag smoke --max_ckpt_save_num 2
--num_epochs_to_eval 2 --profile`` from a temporary working directory,
each of its 16 steps with 23 K3, 12 K4 and 1 K2 checked, each eval batch
with 12 K3 and 1 K2: both checkpoints under
output/kitti_models/second/smoke/ckpt, eval/ and eval/epoch_1/, the
config dumped in the log, the profile window's Chrome trace naming K2's,
K3's and K4's kernels, the TensorBoard scalars where TensorBoard imports;
then ``tools.test.evaluate --eval_all`` with no ``--ckpt_dir`` reads
both epochs, each with the recall and the detections of the training
run's own eval. The final state's eval, taken again, has some kept boxes
that are not finite, as many as the training run's annos (the running
statistics of 16 steps: the JAX package's eval overflows at the same
rows, tests/test_torch_eval_after_training.py), and none with each eval
batch's own BatchNorm statistics (``finite_boxes_held``). It prints the
iteration p50 (wait, copy, step), the eval ``sec_per_example``, the
profile window's wall time and the phase's seconds.
The measurement tools, after the fork's datasets and before the
profiler (``measure_tools_phase``): each tool of
``lidardetection_tpu_torch/tools/`` that counterparts a JAX measuring
tool, through its ``main`` at reduced iterations, its launches counted
(set to 0 before, read after), each kernel it runs launched, every number
it returns finite, its headline on a line of its own: ``bench_input``
(PointPillar B = 8, 0 and 8 workers), ``profile_stages`` (PointPillar B =
8), ``profile_sparse`` (SECOND B = 8), ``profile_vsa`` (B = 8, 2048
keypoints), ``microbench --case all`` (K1 bit-equal, K2 against numpy,
the NMS walk's lists against the full-matrix oracle), ``microbench_rbconv``
(K3 within 1e-4), ``microbench_select --case all``, ``probe_rcnn_refine``
and ``ablate_approx`` (every variant evaluated) on a PV-RCNN checkpoint
that 3 training steps write there; ``bench_kitti_eval`` runs meanwhile as
two processes of its own (native at 3769 frames, numpy at 754).
``profile_trace`` (PV-RCNN's eval step, B = 8) runs last in the profiler's
section.
The line before the last is the kernels' JSON (K5's entry with PointRCNN's
two levels under ``pointrcnn``; K3's and K4's at VoxelResBackBone8x's
shapes under ``cbgs``), preceded by the card's name and power limit; the
last line is the device JSON.
"""

import contextlib
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the measuring code the port's tools share (the timer, the bound, the
# forward split, the profiler reader, the NMS oracle)
from lidardetection_tpu_torch.tools.measure import (
    BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S, bound_ms, conv_work,
    cuda_ms, forward_split, full_matrix_nms, gpu_line, profile_run,
    scatter_work, select_work, vfe_work,
)

CFG = 'tools/cfgs/kitti_models/pointpillar.yaml'
CFG_SECOND = 'tools/cfgs/kitti_models/second.yaml'
CFG_PVRCNN = 'tools/cfgs/kitti_models/pv_rcnn.yaml'
CFG_PARTA2 = 'tools/cfgs/kitti_models/PartA2.yaml'
CFG_POINTRCNN = 'tools/cfgs/kitti_models/pointrcnn.yaml'
SEED = 0
N_REQUESTS = 3               # PointPillar
N_REQUESTS_SECOND = 3
N_REQUESTS_PVRCNN = 3
N_REQUESTS_PARTA2 = 3
N_REQUESTS_POINTRCNN = 3
TRAIN_BATCH = 4              # BATCH_SIZE_PER_GPU of pointpillar and second
TRAIN_WARMUP, TRAIN_STEPS = 2, 3
EVAL_SCENES, EVAL_BATCH = 4, 2  # the eval phase, both detectors
PERFECT_SCENES = 48          # the protocol check's perfect predictions
CFG_CBGS_SECOND = 'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml'
CFG_CBGS_PP = 'tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml'
CFG_SECOND_MH = 'tools/cfgs/kitti_models/second_multihead.yaml'
CFG_MULTIFRAME = 'tools/cfgs/livox_models/pv_rcnn_multiframe.yaml'
CFG_PARTA2_FREE = 'tools/cfgs/kitti_models/PartA2_free.yaml'
N_REQUESTS_VARIANTS = 3
NUSCENES_SWEEPS = 10         # a NuScenes scan: the key frame and 9 sweeps
NUSCENES_GROUND = 26000      # ring returns a sweep: ~250k points in range
KITTI_TRAIN, KITTI_VAL = 12, 4      # the data phase's KITTI tree
NUSCENES_TRAIN, NUSCENES_VAL = 4, 2  # and NuScenes tree's key frames
LOADER_STEPS = 48      # SECOND steps timed from the loader (after warm-up)
PROFILED_STEPS = 16    # and then under the profiler
CBGS_LOADER_STEPS = 8  # CBGS SECOND multi-head steps timed from the loader
CFG_MIX_PP = 'tools/cfgs/mix_data_models/pointpillars_xy.yaml'
PLUSAI_SCENES, PLUSAI_FRAMES = 4, 6  # 4 stacked samples a scene, the last in val
MIX_FRAMES, MIX_VAL = 16, 4          # the Mix tree's frames, those in val
FORK_LOADER_STEPS = 8  # steps timed from the loader, each fork config
TOOL_SCANS = 4         # the tools' folder: scans of the KITTI tree's val split
TOOL_SCENES = 8        # inference and the MOT benchmark: synthetic scenes
CLI_SCENES, CLI_EPOCHS = 32, 2  # the training CLI's run: 8 steps an epoch


def check(ok, what):
    if not ok:
        raise RuntimeError(f'check failed: {what}')








@contextlib.contextmanager
def recorded(owner, attr, calls):
    """owner.attr wrapped for the block: each call's (args, kwargs, result)
    appended to `calls`."""
    fn = getattr(owner, attr)

    def run(*args, **kwargs):
        result = fn(*args, **kwargs)
        calls.append((args, kwargs, result))
        return result

    setattr(owner, attr, run)
    try:
        yield calls
    finally:
        setattr(owner, attr, fn)




def make_clouds(det, n, seed):
    """n synthetic scans (18k ground-ring points + objects) from a seed, at
    the config's point width (``serve.Detector.scene``)."""
    rng = np.random.RandomState(seed)
    return [det.scene(rng) for _ in range(n)]


def dense_clouds(det, n, seed):
    """n clouds as dense as a 10-sweep NuScenes scan: NUSCENES_SWEEPS scans
    of NUSCENES_GROUND ring returns each, moved back along x and stamped
    with their time lag (``datasets/synthetic.py::make_sweeps``)."""
    from lidardetection_tpu_torch.datasets.synthetic import make_sweeps

    rng = np.random.RandomState(seed)
    pc_range = np.asarray(det.info['point_cloud_range'], np.float32)
    return [make_sweeps(rng, pc_range, NUSCENES_SWEEPS, NUSCENES_GROUND,
                        class_names=tuple(det.cfg['CLASS_NAMES']))[0]
            for _ in range(n)]


def in_range(points, pc_range):
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:6])
    return int(((points[:, :3] >= lo) & (points[:, :3] <= hi)).all(1).sum())


def zero_class_bias(torch, model):
    """The dense head's class-logit biases at 0, so that live candidates
    reach NMS (the focal prior puts every random-weight score under
    SCORE_THRESH): the single head's, or every head group's class
    convolution of the multi-head."""
    head = model.dense_head
    if head is None:
        return
    with torch.no_grad():
        if hasattr(head, 'rpn_heads'):
            for group in head.rpn_heads:
                group.convs[0].bias.zero_()
        else:
            head.conv_cls_bias.zero_()


def batch_rows(batch):
    """What a batch holds per sample: voxels, or a point config's sampled
    points."""
    if 'num_voxels' in batch:
        return f'voxels {batch["num_voxels"].tolist()}'
    return f'points {batch["num_points"].tolist()}'


def time_scatter(torch, feats, keys, n_slots):
    """K2 at one request's shape: the kernel's, the plain version's and a
    library call's time (``zeros`` + ``index_put_`` with the kept rows
    selected beforehand), a zero fill of the canvas alone, and the bound:
    the canvas written once, the keys and the kept rows read once."""
    from lidardetection_tpu_torch.ops.scatter_cuda import (
        scatter_rows, scatter_rows_plain,
    )

    _, v, c = feats.shape
    kept = keys[0] < n_slots
    n_kept, n_bytes = scatter_work(feats, keys, n_slots)
    rows_b = torch.zeros(n_kept, dtype=torch.long, device='cuda')
    rows_k, rows_f = keys[0][kept].long(), feats[0][kept]

    def library():
        canvas = torch.zeros((1, n_slots, c), dtype=feats.dtype, device='cuda')
        canvas.index_put_((rows_b, rows_k), rows_f)

    canvas = torch.empty((1, n_slots, c), dtype=feats.dtype, device='cuda')
    row = {'shape': f'V={v} C={c} slots={n_slots} kept={n_kept}',
           'ms': cuda_ms(lambda: scatter_rows(feats, keys, n_slots)),
           # the earlier timer's flush (a 64 MB write: a dirty L2)
           'old_flush_ms': cuda_ms(lambda: scatter_rows(feats, keys, n_slots),
                                   flush='dirty'),
           # a PyTorch fill of the same canvas: the writes alone
           'fill_ms': cuda_ms(canvas.zero_),
           'plain_ms': cuda_ms(
               lambda: scatter_rows_plain(feats, keys, n_slots)),
           'library_ms': cuda_ms(library), 'bytes': n_bytes}
    row['bound_ms'], row['bound_by'] = bound_ms(n_bytes, 0)
    return row


def vfe_held(torch, what, vox, centers, pb, counts, w4, shift):
    """K1 against its plain version on the card in bf16 and in f32 (weights
    and output): the same bits required. Returns max|kernel - plain|."""
    from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe, pillar_vfe_plain

    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        args = (vox, centers, pb, counts, w4.to(dt), shift)
        got = pillar_vfe(*args, out_dtype=dt)
        want = pillar_vfe_plain(*args, out_dtype=dt)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        print(f'K1 pillar_vfe, {what}, {str(dt)[6:]}: max|kernel-plain| = {e} '
              f'(bit-exact required: {torch.equal(got, want)})', flush=True)
        check(torch.equal(got, want), f'pillar_vfe {what} {dt} bit-exact')
        worst = max(worst, e)
    return worst




def pillar_kernel_phase(torch, det):
    """K1 and K2 against their plain versions at PointPillar's shapes."""
    from lidardetection_tpu_torch.ops.scatter_cuda import (
        scatter_rows, scatter_rows_plain,
    )
    from lidardetection_tpu_torch.ops.vfe_cuda import (
        channels_per_thread, pillar_vfe, pillar_vfe_plain,
    )

    batch = det.make_batch(make_clouds(det, 4, SEED + 100))
    vox, counts, coords = (batch['voxels'], batch['voxel_num_points'],
                           batch['voxel_coords'])
    b4, v, p, _ = vox.shape
    c = 64
    nx, ny = det.info['grid_size'][:2]
    n_slots = nx * ny
    vx, vy, vz = det.info['voxel_size']
    lo = det.info['point_cloud_range']
    g = torch.Generator(device='cuda').manual_seed(SEED)
    centers = torch.stack([coords[..., 2] * vx + (vx / 2 + lo[0]),
                           coords[..., 1] * vy + (vy / 2 + lo[1]),
                           coords[..., 0] * vz + (vz / 2 + lo[2]),
                           torch.zeros_like(coords[..., 0])], -1).float()
    pb = torch.randn((b4, v, c), generator=g, device='cuda') * 0.5
    w4 = torch.randn((4, c), generator=g, device='cuda') * 0.3
    shift = torch.randn((c,), generator=g, device='cuda') * 0.1
    keys = torch.where(coords[..., 0] >= 0, coords[..., 1] * nx + coords[..., 2],
                       torch.full_like(coords[..., 0], n_slots)).int()
    feats = torch.randn((b4, v, c), generator=g, device='cuda').bfloat16()
    print(f'kernel inputs: B={b4} V={v} P={p} C={c} pillars per scene '
          f'{batch["num_voxels"].tolist()}, points kept per scene '
          f'{counts.sum(1).tolist()}', flush=True)

    for width in (c, 100, 99):
        vec = channels_per_thread(width)
        print(f'K1 path at C={width}: {vec} channel(s) a thread, {width // vec} '
              f'threads a pillar ({"vector" if vec == 4 else "scalar"} path)',
              flush=True)
    err = {'pillar_vfe': 0.0, 'scatter_rows': 0.0}
    for b in (1, b4):
        err['pillar_vfe'] = max(err['pillar_vfe'], vfe_held(
            torch, f'B={b}', vox[:b], centers[:b], pb[:b], counts[:b], w4, shift))
        got = scatter_rows(feats[:b], keys[:b], n_slots)
        want = scatter_rows_plain(feats[:b], keys[:b], n_slots)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        print(f'K2 scatter_rows B={b}: max|kernel-plain| = {e} (bit-exact '
              f'required: {torch.equal(got, want)})', flush=True)
        check(torch.equal(got, want), f'scatter_rows B={b} bit-exact')
        err['scatter_rows'] = max(err['scatter_rows'], e)
    # a sample of padding rows alone, and one whose rows hit every slot
    every = torch.arange(n_slots, device='cuda', dtype=torch.int32)
    for what, f, k in (
            ('all padding', feats[:1], torch.full_like(keys[:1], n_slots)),
            ('every slot hit', torch.randn((1, n_slots, c), generator=g,
                                           device='cuda').bfloat16(),
             every[None])):
        got = scatter_rows(f, k, n_slots)
        want = scatter_rows_plain(f, k, n_slots)
        torch.cuda.synchronize()
        print(f'K2 scatter_rows, {what} (V={k.shape[1]}): bit-exact required: '
              f'{torch.equal(got, want)}', flush=True)
        check(torch.equal(got, want), f'scatter_rows {what} bit-exact')

    # K1's edges, each on the first scene's table: no live pillar, every
    # pillar full, counts out of [0, P], V a multiple of no block's pillars,
    # P = 20 (which clamps the counts above it) at C = 100, and the scalar
    # path (C = 99)
    one = (vox[:1], centers[:1], pb[:1])
    g32 = torch.Generator(device='cuda').manual_seed(SEED + 1)
    wild = torch.randint(-3, p + 6, (1, v), generator=g32, device='cuda',
                         dtype=torch.int32)
    cut = v - 13
    for what, args in (
            ('empty pillars only', (*one, torch.zeros_like(counts[:1]))),
            (f'every pillar full (count {p})', (*one, torch.full_like(counts[:1], p))),
            (f'counts from -3 to {p + 5}', (*one, wild)),
            (f'V={cut}', (vox[:1, :cut].contiguous(), centers[:1, :cut].contiguous(),
                          pb[:1, :cut].contiguous(), counts[:1, :cut].contiguous()))):
        err['pillar_vfe'] = max(err['pillar_vfe'],
                                vfe_held(torch, what, *args, w4, shift))
    for pts, width in ((20, 100), (p, 99)):
        err['pillar_vfe'] = max(err['pillar_vfe'], vfe_held(
            torch, f'P={pts} C={width}', vox[:1, :, :pts].contiguous(),
            centers[:1], torch.randn((1, v, width), generator=g32, device='cuda'),
            counts[:1], torch.randn((4, width), generator=g32, device='cuda') * 0.3,
            torch.randn((width,), generator=g32, device='cuda') * 0.1))

    # timings at the main path's shape: one request, B = 1
    a1 = (vox[:1], centers[:1], pb[:1], counts[:1], w4.bfloat16(), shift)
    f1, k1keys = feats[:1], keys[:1]
    calls = {'pillar_vfe': lambda: pillar_vfe(*a1),
             'scatter_rows': lambda: scatter_rows(f1, k1keys, n_slots)}
    k1_bytes, k1_flop = vfe_work(counts[:1], p, c)
    k1 = {'name': 'pillar_vfe', 'route': 'cuda',
          'source': 'lidardetection_tpu_torch/csrc/vfe.cu',
          'replaces': 'lidardetection_tpu/ops/vfe_tpu.py:78',
          'max_abs_err': err['pillar_vfe'],
          'ms': cuda_ms(calls['pillar_vfe']),
          'old_flush_ms': cuda_ms(calls['pillar_vfe'], flush='dirty'),
          'plain_ms': cuda_ms(lambda: pillar_vfe_plain(*a1)),
          'library_ms': None}
    k1['bound_ms'], k1['bound_by'] = bound_ms(k1_bytes, k1_flop)
    # and at B = 4, where the bound stands above the timing floor
    a4 = (vox, centers, pb, counts, w4.bfloat16(), shift)
    n_bytes, n_flop = vfe_work(counts, p, c)
    k1['batch4'] = {'ms': cuda_ms(lambda: pillar_vfe(*a4)),
                    'old_flush_ms': cuda_ms(lambda: pillar_vfe(*a4),
                                            flush='dirty'),
                    'plain_ms': cuda_ms(lambda: pillar_vfe_plain(*a4)),
                    'bytes': n_bytes}
    k1['batch4']['bound_ms'], k1['batch4']['bound_by'] = bound_ms(n_bytes, n_flop)
    # what the rows alone cost under the same timing: K1 with no live
    # pillar (its counts and every row written), and a bare fill of its
    # output
    for row, args in ((k1, a1), (k1['batch4'], a4)):
        none = torch.zeros_like(args[3])
        row['no_live_ms'] = cuda_ms(
            lambda: pillar_vfe(*args[:3], none, *args[4:]))
        filled = torch.empty((args[0].shape[0], v, c), dtype=torch.bfloat16,
                             device='cuda')
        row['fill_ms'] = cuda_ms(filled.zero_)
    print(f'pillar_vfe B={b4}: device {k1["batch4"]["ms"]:.4f} ms, plain '
          f'{k1["batch4"]["plain_ms"]:.4f} ms, bound '
          f'{k1["batch4"]["bound_ms"]:.4f} ms ({n_bytes} bytes); no live '
          f'pillar {k1["batch4"]["no_live_ms"]:.4f} ms, a fill of its output '
          f'{k1["batch4"]["fill_ms"]:.4f} ms', flush=True)

    k2 = {'name': 'scatter_rows', 'route': 'cuda',
          'source': 'lidardetection_tpu_torch/csrc/scatter.cu',
          'replaces': 'lidardetection_tpu/ops/scatter_tpu.py:128',
          'max_abs_err': err['scatter_rows'],
          **time_scatter(torch, f1, k1keys, n_slots)}
    for k, nbytes in ((k1, k1_bytes), (k2, k2['bytes'])):
        call = cuda_ms(calls[k['name']], queued=False)
        print(f'{k["name"]} B=1: device {k["ms"]:.4f} ms (call with host '
              f'overhead {call:.4f} ms), plain {k["plain_ms"]:.4f} ms, '
              f'library {k["library_ms"]}, zero fill of the output '
              f'{k.get("fill_ms")}, bound {k["bound_ms"]:.4f} ms '
              f'({nbytes} bytes)' + (f', no live pillar {k["no_live_ms"]:.4f} ms'
                                     if 'no_live_ms' in k else ''), flush=True)
    return [k1, k2], (f1, k1keys, n_slots)


def scatter_launch_count(torch, feats, keys, n_slots):
    """The device work of one K2 call under torch.profiler: exactly one
    kernel (K2's), no memset and no copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows

    scatter_rows(feats, keys, n_slots)  # allocator warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scatter_rows(feats, keys, n_slots)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(f'K2 scatter_rows, one call under the profiler: device work {names}',
          flush=True)
    check(len(names) == 1 and 'scatter_rows_kernel' in names[0],
          f'one K2 call is one kernel and no memset ({names})')


def record_sparse_layers(model, run):
    """run() with a hook on every sparse layer of the model:
    [(layer, features, valid_mask, rulebook)] in call order, and run()'s
    result."""
    from lidardetection_tpu_torch.models.backbones_3d.spconv_backbone import (
        SparseConvLayer,
    )

    records, hooks = [], []
    for module in model.modules():
        if isinstance(module, SparseConvLayer):
            hooks.append(module.register_forward_pre_hook(
                lambda m, args: records.append((m, *args[:3]))))
    try:
        out = run()
    finally:
        for hook in hooks:
            hook.remove()
    return records, out


def conv_timing(torch, n, what, f, rb, w, valid):
    """K3 on one layer's inputs, held against its plain version (within
    1e-4 of max|want|): its time, the plain version's, the bound, what the
    tensor-core path skips (ops/sparse_conv_cuda.py conv_tile_skips) and
    the rate on hits."""
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        conv_tile_skips, rulebook_conv, rulebook_conv_plain,
    )

    fd, wd = f.contiguous(), w.contiguous()
    rb, valid = rb.contiguous(), valid.contiguous()
    got = rulebook_conv(fd, rb, wd, valid)
    want = rulebook_conv_plain(fd, rb, wd, valid)
    err, top = float((got - want).abs().max()), float(want.abs().max())
    check(top > 0 and err <= 1e-4 * top and bool(torch.isfinite(got).all()),
          f'rulebook_conv {n} {what}: max error {err} against plain '
          f'(max|want| {top})')
    k, c_in, c_out = wd.shape
    live, hits, n_bytes, n_flop = conv_work(fd, rb, wd, valid)
    rate = BF16_FLOP_PER_S if fd.dtype == torch.bfloat16 else F32_FLOP_PER_S
    skips = conv_tile_skips(rb, valid, fd.shape[1])
    row = {'layer': n, 'K': k, 'C_in': c_in, 'C_out': c_out,
           'dtype': str(fd.dtype)[6:], 'live_rows': live, 'hits': hits,
           'bytes': n_bytes, 'flop': n_flop, 'max_abs_err': err,
           'pairs_skipped': skips['pairs_skipped'] / max(skips['pairs'], 1),
           'fragments_skipped': skips['fragments_skipped']
           / max(skips['fragments'], 1),
           'ms': cuda_ms(lambda: rulebook_conv(fd, rb, wd, valid)),
           'old_flush_ms': cuda_ms(lambda: rulebook_conv(fd, rb, wd, valid),
                                   flush='dirty'),
           'plain_ms': cuda_ms(
               lambda: rulebook_conv_plain(fd, rb, wd, valid)),
           'bytes_ms': n_bytes / HBM_BYTES_PER_S * 1e3,
           'ops_ms': n_flop / rate * 1e3}
    row['bound_ms'], row['bound_by'] = bound_ms(n_bytes, n_flop, rate)
    row['tflop_per_s_on_hits'] = n_flop / row['ms'] * 1e-9
    print(f'rulebook_conv {n} {what} {row["dtype"]} K={k} C {c_in}->{c_out}: '
          f'{live} live rows, {hits} hits ({hits / max(live * k, 1):.3f} of '
          f'entries), max|kernel-plain| {err:.3g} (max|want| {top:.3g}), '
          f'(tile, offset) pairs skipped {row["pairs_skipped"]:.3f} '
          f'of {skips["pairs"]}, fragments skipped {row["fragments_skipped"]:.3f}, '
          f'device {row["ms"]:.4f} ms ({row["tflop_per_s_on_hits"]:.2f} TFLOP/s '
          f'on hits), plain {row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} '
          f'ms ({row["bound_by"]}; {n_bytes} bytes, {n_flop} FLOP)', flush=True)
    return row


def sparse_kernel_phase(torch, det):
    """K3 against its plain version at the SECOND path's shapes: every
    convolution of a forward over real scans, then its time per layer; K2
    at SECOND's shape."""
    from lidardetection_tpu_torch.ops import sparse
    from lidardetection_tpu_torch.ops.scatter_cuda import (
        scatter_rows, scatter_rows_plain,
    )
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv, rulebook_conv_plain,
    )

    batch = det.make_batch(make_clouds(det, 4, SEED + 200))
    records, out = record_sparse_layers(det.model, lambda: det.forward(batch))
    check(len(records) == 12, f'12 sparse layers in a forward ({len(records)})')

    # f32 sums of up to K * C_in = 1728 exact products in another order:
    # the error stays under 1e-4 of the largest output
    err = 0.0
    for n, (layer, f, valid, rb) in enumerate(records, 1):
        for dtype in (torch.bfloat16, torch.float32):
            fd = f.to(dtype).contiguous()
            wd = layer.kernel.detach().to(dtype).contiguous()
            for b in (1, 4):
                got = rulebook_conv(fd[:b], rb[:b], wd, valid[:b])
                want = rulebook_conv_plain(fd[:b], rb[:b], wd, valid[:b])
                again = rulebook_conv(fd[:b], rb[:b], wd, valid[:b])
                torch.cuda.synchronize()
                check(torch.equal(got, again), f'rulebook_conv layer {n} B={b} '
                      f'{dtype}: the same bits on a second run')
                e, top = float((got - want).abs().max()), float(want.abs().max())
                check(top > 0 and e <= 1e-4 * top and bool(torch.isfinite(got).all()),
                      f'rulebook_conv layer {n} B={b} {dtype}: max error {e} '
                      f'against max|want| {top}')
                check(bool((got[:b][~valid[:b]] == 0).all()),
                      f'rulebook_conv layer {n}: padding rows are zero')
                err = max(err, e)
        k, c_in, c_out = layer.kernel.shape
        print(f'K3 rulebook_conv layer {n:2d} K={k} C {c_in}->{c_out}: rows '
              f'{valid.sum(1).tolist()} of {valid.shape[1]}, bf16 and f32, '
              f'B=1 and B=4 within 1e-4 * max|want|', flush=True)
    # a rulebook whose columns do not ascend: the rows of layer 7, shuffled
    layer, f, valid, rb = records[6]
    perm = torch.randperm(rb.shape[1], device='cuda',
                          generator=torch.Generator('cuda').manual_seed(SEED))
    fd = f[:1].bfloat16().contiguous()
    wd = layer.kernel.detach().bfloat16().contiguous()
    got = rulebook_conv(fd, rb[:1, perm].contiguous(), wd,
                        valid[:1, perm].contiguous())
    want = rulebook_conv_plain(fd, rb[:1], wd, valid[:1])[:, perm]
    torch.cuda.synchronize()
    e, top = float((got - want).abs().max()), float(want.abs().max())
    print(f'K3 rulebook_conv layer 7, rows shuffled: max|kernel-plain| = '
          f'{e:.3g} (max|want| {top:.3g})', flush=True)
    check(e <= 1e-4 * top, 'rulebook_conv on a shuffled rulebook')
    err = max(err, e)

    # times at the main path's shape: one request (B = 1), the model's dtype
    shapes = [conv_timing(torch, n, 'B=1', f[:1].to(layer.dtype or torch.float32),
                          rb[:1], layer.kernel.detach().to(
                              layer.dtype or torch.float32), valid[:1])
              for n, (layer, f, valid, rb) in enumerate(records, 1)]
    total = {key: sum(r[key] for r in shapes) for key in
             ('ms', 'old_flush_ms', 'plain_ms', 'bytes_ms', 'ops_ms')}
    bound = sum(r['bound_ms'] for r in shapes)
    print(f'rulebook_conv, the 12 launches of a request: device '
          f'{total["ms"]:.4f} ms, plain {total["plain_ms"]:.4f} ms, bound '
          f'{bound:.4f} ms', flush=True)
    k3 = {'name': 'rulebook_conv', 'route': 'cuda',
          'source': 'lidardetection_tpu_torch/csrc/sparse_conv.cu',
          'replaces': 'lidardetection_tpu/ops/sparse_conv_tpu.py:346',
          'max_abs_err': err,
          # per call: the mean over the 12 launches of a request
          'ms': total['ms'] / 12, 'plain_ms': total['plain_ms'] / 12,
          'old_flush_ms': total['old_flush_ms'] / 12, 'bound_ms': bound / 12,
          'bound_by': 'bytes' if total['bytes_ms'] >= total['ops_ms']
          else 'operations',
          'library_ms': None, 'per_request_ms': total['ms'],
          'per_request_old_flush_ms': total['old_flush_ms'], 'layers': shapes}

    # K2 at SECOND's shape: the conv_out table into 2 x 200 x 176 slots
    st4 = out['multi_scale_3d_features']['x_conv4']
    coords, _, shape = sparse.build_strided_out_coords(
        st4, (3, 1, 1), (2, 1, 1), (0, 0, 0), st4.coords.shape[1])
    n_slots = shape[0] * shape[1] * shape[2]
    check(n_slots == int(np.prod(out['encoded_spconv_tensor'].shape[1:4])),
          'the scatter target is the encoded tensor')
    keys = sparse.linear_key(coords, shape).int().contiguous()
    g = torch.Generator(device='cuda').manual_seed(SEED)
    feats = torch.randn((4, keys.shape[1], 128), generator=g,
                        device='cuda').bfloat16()
    for b in (1, 4):
        got = scatter_rows(feats[:b], keys[:b], n_slots)
        want = scatter_rows_plain(feats[:b], keys[:b], n_slots)
        torch.cuda.synchronize()
        print(f'K2 scatter_rows B={b} C=128 into {n_slots} slots: bit-exact '
              f'required: {torch.equal(got, want)}', flush=True)
        check(torch.equal(got, want), f'scatter_rows (SECOND shape) B={b}')
    k2 = time_scatter(torch, feats[:1], keys[:1], n_slots)
    print(f'scatter_rows B=1 at SECOND\'s shape ({k2["shape"]}): device '
          f'{k2["ms"]:.4f} ms, plain {k2["plain_ms"]:.4f} ms, library '
          f'{k2["library_ms"]:.4f} ms, zero fill of the canvas '
          f'{k2["fill_ms"]:.4f} ms, bound {k2["bound_ms"]:.4f} ms '
          f'({k2["bytes"]} bytes)', flush=True)
    return k3, k2


def stage_counts(out):
    """Live rows of each stage's table of a SECOND forward, per sample."""
    counts = {name: st.num_voxels.tolist()
              for name, st in out['multi_scale_3d_features'].items()}
    if 'encoded_spconv_tensor' in out:  # not in a UNet without conv_out
        enc = out['encoded_spconv_tensor']
        counts['out'] = (enc != 0).any(-1).flatten(1).sum(1).tolist()
    return counts


def serve_phase(torch, det, clouds, per_request, earlier=None):
    """The main path: one request per cloud; every launch count set to 0
    just before each request and read just after it. `per_request` maps
    each kernel's wrapper to the launches one request must make; the p50s
    are printed beside `earlier` (the same shapes before the NMS walk and
    the native voxelizer). Each request's NMS
    reports the rows its walk read. Returns the launches of the run."""
    from lidardetection_tpu_torch.models.model_utils import nms_utils

    total = {k.__name__: 0 for k in per_request}
    latency, forward, stages, rows_read = [], [], [], []
    for i, points in enumerate(clouds):
        for k in per_request:
            k.launches = 0
        t0 = time.perf_counter()
        batch = det.make_batch([points])
        t1 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = det.forward(batch)
        end.record()
        end.synchronize()
        t2 = time.perf_counter()
        nms = []
        with recorded(nms_utils, 'nms_bev_batched', nms):
            preds = det.postprocess(out)
        # a multi-class NMS reads rows in each class's walk
        rows_read.append(preds['rows_read'][0].tolist() if 'rows_read' in preds
                         else int(nms[-1][2][3][0]))
        n = int(preds['num_preds'][0])
        boxes = preds['pred_boxes'][0][preds['pred_mask'][0]].cpu().numpy()
        t3 = time.perf_counter()
        latency.append((t3 - t0) * 1e3)
        forward.append(start.elapsed_time(end))
        stages.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        live = int(preds['num_candidates'][0])
        tables = f', stage tables {stage_counts(out)}' \
            if 'multi_scale_3d_features' in out else ''
        print(f'request {i}: {len(points)} points, '
              f'{batch_rows(batch)}{tables}, {live} live NMS '
              f'candidates, NMS rows read {rows_read[-1]}, num_preds {n}, '
              f'latency {latency[-1]:.2f} ms '
              f'(host clock: make_batch {stages[-1][0]:.2f}, forward '
              f'{stages[-1][1]:.2f}, postprocess {stages[-1][2]:.2f}), '
              f'forward device {forward[-1]:.2f} ms', flush=True)
        # 7 columns, 9 with NuScenes' velocity
        check(boxes.shape[0] == n and boxes.shape[1] in (7, 9)
              and np.isfinite(boxes).all(), f'request {i}: finite boxes')
        check(live > 0 and n > 0, f'request {i}: live candidates and detections')
        for k, each in per_request.items():
            check(k.launches == each, f'request {i}: {k.__name__} launched '
                  f'{k.launches} times, expected {each}')
            total[k.__name__] += k.launches
    p50 = dict(zip(('make_batch', 'forward', 'postprocess'),
                   np.median(stages, axis=0).tolist()),
               latency=float(np.median(latency)))
    print('p50 host clock, ms: ' + ', '.join(
        f'{k} {v:.2f}' + (f' (before: {earlier[k]})' if k in (earlier or {})
                          else '') for k, v in p50.items())
          + f'; NMS rows read {rows_read}', flush=True)
    print(json.dumps({'config': det.cfg['MODEL']['NAME'],
                      'requests': len(clouds),
                      'p50_latency_ms': p50['latency'],
                      'p50_forward_ms': float(np.median(forward)),
                      'p50_postprocess_ms': p50['postprocess'],
                      'nms_rows_read': rows_read}), flush=True)
    return total






def profile_request(torch, det, points):
    def request():
        preds = det.postprocess(det.forward(det.make_batch([points])))
        preds['pred_boxes'].cpu()

    profile_run(f'{det.cfg["MODEL"]["NAME"]} request', request)


def compare_phase(torch, det, cfg_file, clouds):
    """f32 on the card (kernels) against f32 on the CPU (plain versions)."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.serve import Detector

    cfg = cfg_from_yaml_file(cfg_file)
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    state = {k: v.cpu() for k, v in det.model.state_dict().items()}
    on_card = Detector(cfg, device='cuda', state_dict=state)
    on_cpu = Detector(cfg, device='cpu', state_dict=state)
    for i, points in enumerate(clouds):
        out_g = on_card.forward(on_card.make_batch([points]))
        out_c = on_cpu.forward(on_cpu.make_batch([points]))
        # f32 sums in another order on the two devices: 1e-3 of the largest
        # value, and never more than 1e-3 absolute
        for key in ('encoded_spconv_tensor', 'batch_fused_preds'):
            if key not in out_c:
                continue
            top = float(out_c[key].abs().max())
            dmax = float((out_g[key].cpu() - out_c[key]).abs().max())
            print(f'f32 cloud {i}: max|card - cpu| {key} = {dmax:.3g}, max|cpu| '
                  f'= {top:.3g} (tolerance 1e-3 * max|cpu|, at most 1e-3)',
                  flush=True)
            check(top > 0 and dmax <= 1e-3 * min(top, 1.0), f'{key} card vs cpu')
        pg, pc = on_card.postprocess(out_g), on_cpu.postprocess(out_c)
        compare_kept(pg, pc, dmax, i)


def compare_kept(pg, pc, dmax, i):
    """Matching rule for the kept detections of two devices. They are walked
    in kept (score) order and must be the same detection rank by rank: same
    label, scores within the tie tolerance, boxes within 1 cm / 0.01 rad.
    The tie tolerance is dmax / 4 + 1e-6, the most two scores can differ
    when their logits differ by dmax (the sigmoid's slope is at most 1/4).
    A divergence is allowed only as a tie: the two differing detections
    have scores within the tie tolerance, so device rounding may order them
    either way; greedy NMS outcomes cascade from that rank, so the ranks
    after a tie are not compared."""
    tie = dmax / 4 + 1e-6
    ng, nc = int(pg['num_preds'][0]), int(pc['num_preds'][0])
    sg, sc = pg['pred_scores'][0].cpu().numpy(), pc['pred_scores'][0].numpy()
    bg, bc = pg['pred_boxes'][0].cpu().numpy(), pc['pred_boxes'][0].numpy()
    lg, lc = pg['pred_labels'][0].cpu().numpy(), pc['pred_labels'][0].numpy()
    for r in range(min(ng, nc)):
        same = (lg[r] == lc[r] and abs(sg[r] - sc[r]) <= tie
                and np.abs(bg[r] - bc[r]).max() <= 1e-2)
        if not same:
            check(abs(sg[r] - sc[r]) <= tie,
                  f'cloud {i}: kept detections differ at rank {r} without a '
                  f'tie ({sg[r]} vs {sc[r]})')
            print(f'f32 cloud {i}: kept sets equal for {r} ranks, then a score '
                  f'tie ({sg[r]:.7f} vs {sc[r]:.7f}); card {ng} / cpu {nc} kept',
                  flush=True)
            return
    check(ng == nc, f'cloud {i}: kept counts {ng} (card) vs {nc} (cpu)')
    print(f'f32 cloud {i}: kept sets equal, {ng} detections, max|dbox| '
          f'{np.abs(bg[:ng] - bc[:ng]).max() if ng else 0:.3g}', flush=True)


def compare_multiclass_phase(torch, det, cfg_file, points):
    """A multi-head detector in f32 on the card (kernels) against f32 on
    the CPU (plain versions), one cloud: each head group's class logits
    within 1e-3 of the largest (at most 1e-3 absolute), then every class's
    kept detections by `compare_kept` (each class's block of
    NMS_POST_MAXSIZE slots holds its kept rows first)."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.serve import Detector

    cfg = cfg_from_yaml_file(cfg_file)
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    state = {k: v.cpu() for k, v in det.model.state_dict().items()}
    on_card = Detector(cfg, device='cuda', state_dict=state)
    on_cpu = Detector(cfg, device='cpu', state_dict=state)
    t0 = time.perf_counter()
    out_g = on_card.forward(on_card.make_batch([points]))
    out_c = on_cpu.forward(on_cpu.make_batch([points]))
    dmax = top = 0.0
    for got, want in zip(out_g['batch_cls_preds'], out_c['batch_cls_preds']):
        dmax = max(dmax, float((got.cpu() - want).abs().max()))
        top = max(top, float(want.abs().max()))
    print(f'f32 multi-head: max|card - cpu| of the class logits = {dmax:.3g}, '
          f'max|cpu| = {top:.3g} (tolerance 1e-3 * max|cpu|, at most 1e-3)',
          flush=True)
    check(top > 0 and dmax <= 1e-3 * min(top, 1.0), 'class logits card vs cpu')
    pg, pc = on_card.postprocess(out_g), on_cpu.postprocess(out_c)
    post = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    classes = pg['pred_mask'].shape[1] // post
    for k in range(classes):
        part = slice(k * post, (k + 1) * post)
        block = [{key: pr[key][:, part] for key in
                  ('pred_scores', 'pred_boxes', 'pred_labels')}
                 for pr in (pg, pc)]
        for b, pr in zip(block, (pg, pc)):
            b['num_preds'] = pr['pred_mask'][:, part].sum(1)
            check(bool((pr['pred_mask'][0, part]
                        == (torch.arange(post, device=pr['pred_mask'].device)
                            < b['num_preds'][0])).all()),
                  f'class {k}: the kept rows come first in its block')
        compare_kept(*block, dmax, f'0, class {k + 1}')
    print(f'f32 multi-head card vs cpu: {classes} classes compared, '
          f'{int(pg["num_preds"][0])} kept on the card, '
          f'{int(pc["num_preds"][0])} on the cpu '
          f'({time.perf_counter() - t0:.1f} s with the CPU forward)', flush=True)


def tracking_phase(torch, trainer, batch):
    """The multiframe RoI head's tracking targets in the loss, at full
    width on the card: one training forward of the model, then its RoI
    head again on proposals that are the batch's gt boxes moved by up to
    0.1 m (the random dense head proposes no box that overlaps a gt box
    by REG_FG_THRESH): the sampled RoIs' gt carries 8 tracking columns
    after its class, the regression-valid RoIs' are not all 0, the loss
    is finite and the box head's tracking outputs get a gradient."""
    from lidardetection_tpu_torch.parallel.train_step import step_draw

    model = trainer.model.train()
    for p in model.parameters():
        p.grad = None
    draw = step_draw(trainer.seed, trainer.state.step, 'cuda')
    out = model(batch, draw)
    check(bool(out['roi_head_fwd']['reg_tracking_info'])
          and out['roi_head_fwd']['gt_of_rois'].shape[-1] == 16,
          'multiframe: the RoI targets carry the tracking columns')
    gt = batch['gt_boxes']
    n = gt.shape[1]
    boxes = out['batch_box_preds'].detach().clone()
    scores = out['batch_cls_preds'].detach().clone()
    jitter = (torch.rand(gt.shape[:2] + (3,), device=gt.device) - 0.5) * 0.2
    boxes[:, :n, :7] = gt[..., :7] + torch.cat(
        [jitter, torch.zeros_like(gt[..., 3:7])], -1)
    live = gt[..., -1] > 0
    scores[:, :n] = torch.where(live[..., None], 10.0, -10.0)
    roi_out = model.roi_head({**out, 'batch_box_preds': boxes,
                              'batch_cls_preds': scores}, draw)
    fwd = roi_out['roi_head_fwd']
    valid = fwd['reg_valid_mask'] > 0
    track = fwd['gt_of_rois'][..., 8:][valid]
    loss, tb = model.roi_head.loss(fwd)
    loss.backward()
    kernel = model.roi_head.fc_heads[1].dense[-1].kernel
    grad = float(kernel.grad[:, 7:].abs().max())
    print(f'multiframe tracking: {int(valid.sum())} regression-valid RoIs of '
          f'{valid.numel()}, their tracking targets mean |.| '
          f'{float(track.abs().mean()) if len(track) else 0.0:.4f}, rcnn_loss_reg '
          f'{float(tb["rcnn_loss_reg"]):.4f}, max |grad| of the tracking '
          f'outputs\' weights {grad:.3g}', flush=True)
    check(int(valid.sum()) > 0 and float(track.abs().sum()) > 0
          and bool(torch.isfinite(loss)) and grad > 0,
          'multiframe: the tracking targets are live in the RoI loss')
    for p in model.parameters():
        p.grad = None


def train_batches(trainer, n, seed, dense=False):
    """n training batches of the yaml's BATCH_SIZE_PER_GPU synthetic scenes
    each (the config's point width, velocities and frame poses; with
    `dense` as dense as a 10-sweep NuScenes scan), on the card, and the
    median host time of `make_batch`."""
    size = train_batch_size(trainer)
    if dense:
        scenes_all = dense_train_scenes(trainer, n * size, seed)
    else:
        dataset = trainer.dataset(n * size, seed=seed)
        scenes_all = [dataset[i] for i in range(n * size)]
    batches, ms = [], []
    for i in range(n):
        scenes = scenes_all[i * size:(i + 1) * size]
        t0 = time.perf_counter()
        batches.append(trainer.make_batch(scenes))
        ms.append((time.perf_counter() - t0) * 1e3)
    return batches, float(np.median(ms))


def dense_train_scenes(trainer, n, seed):
    """n training scenes of `make_sweeps` clouds, their gt boxes padded as
    the config's synthetic set pads them (NuScenes: with velocities)."""
    from lidardetection_tpu_torch.datasets.synthetic import (
        make_sweeps, pad_gt_boxes,
    )

    rng = np.random.RandomState(seed)
    pc_range = np.asarray(trainer.info['point_cloud_range'], np.float32)
    scenes = []
    for _ in range(n):
        points, boxes, names = make_sweeps(
            rng, pc_range, NUSCENES_SWEEPS, NUSCENES_GROUND,
            class_names=trainer.class_names)
        if trainer.cfg['DATA_CONFIG'].get('PRED_VELOCITY', False):
            vel = (rng.randn(len(boxes), 2) * 2.0).astype(np.float32)
            boxes = np.concatenate([boxes.reshape(-1, 7), vel], axis=1)
        scenes.append((points, pad_gt_boxes(boxes, names, trainer.class_names,
                                            pc_range, trainer.max_gt_boxes)))
    return scenes


def train_batch_size(trainer):
    return int(trainer.cfg['OPTIMIZATION']['BATCH_SIZE_PER_GPU'])


def finite_gradients(torch, model):
    return all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def train_phase(torch, trainer, batches, per_step, earlier=None,
                warmup=TRAIN_WARMUP):
    """The training main path: `warmup` + TRAIN_STEPS optimizer steps
    through ``Trainer.step``; every launch count set to 0 just before each
    step and read just after. `per_step` maps each kernel's wrapper to the
    launches one step must make; the step p50 is printed beside `earlier`
    (ms, before the host plan and the NMS walk). Returns the launches of
    the timed steps."""
    name = trainer.cfg['MODEL']['NAME']
    model = trainer.model
    params = {k for k, _ in model.named_parameters()}
    stats_keys = [k for k in model.state_dict() if k not in params]
    total = {k.__name__: 0 for k in per_step}
    host_ms, device_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        for k in per_step:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tb = trainer.step(batch)
        end.record()
        end.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        counts = {k.__name__: k.launches for k in per_step}
        terms = {k: float(v) for k, v in tb.items()}
        timed = i >= warmup
        print(f'{name} step {i}{"" if timed else " (warm-up)"}: '
              + ' '.join(f'{k} {v:.4f}' for k, v in terms.items())
              + f', lr {trainer.lr_fn(i):.3e}, {batch_rows(batch)}, gt '
              f'{(batch["gt_boxes"][..., -1] > 0).sum(1).tolist()}, host clock '
              f'{host:.2f} ms, CUDA events {start.elapsed_time(end):.2f} ms, '
              f'launches {counts}, peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB', flush=True)
        check(all(np.isfinite(v) for v in terms.values()),
              f'{name} step {i}: finite loss terms')
        check(finite_gradients(torch, model),
              f'{name} step {i}: every parameter has a finite gradient')
        after = model.state_dict()
        check(all(not torch.equal(before[k], after[k]) for k in stats_keys),
              f'{name} step {i}: every BatchNorm statistic moved')
        check(all(bool(torch.isfinite(v).all()) for v in after.values()),
              f'{name} step {i}: finite parameters and statistics')
        for k, each in per_step.items():
            check(k.launches == each, f'{name} step {i}: {k.__name__} launched '
                  f'{k.launches} times, expected {each}')
        if timed:
            host_ms.append(host)
            device_ms.append(start.elapsed_time(end))
            for key, n in counts.items():
                total[key] += n
    check(trainer.state.step == len(batches), 'the optimizer counted the steps')
    if earlier is not None:
        print(f'{name} step p50 {float(np.median(host_ms)):.2f} ms (host '
              f'clock), {float(np.median(device_ms)):.2f} ms (CUDA events); '
              f'before: {earlier} ms', flush=True)
    print(json.dumps({
        'config': name, 'train_steps': len(host_ms),
        'batch_size': train_batch_size(trainer),
        'p50_step_ms': float(np.median(host_ms)),
        'p50_step_device_ms': float(np.median(device_ms)),
        'peak_memory_mib': torch.cuda.max_memory_allocated() / 2 ** 20}),
        flush=True)
    return total


def step_split(torch, trainer, batch, repeats=3, functions=()):
    """One training step by forward (with the loss) / backward / optimizer:
    host clock with the device drained between the parts, median of
    `repeats`; inside the forward, each function of `functions` (owner,
    attribute, label) apart, the device drained around each call. The
    random layers draw as ``Trainer.step`` does. Returns the medians in
    ms."""
    from lidardetection_tpu_torch.parallel.train_step import step_draw

    model, optimizer = trainer.model, trainer.state.optimizer
    spans, wrapped = {}, []

    def timed(label, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[label] = spans.get(label, 0.0) \
                + (time.perf_counter() - start) * 1e3
            return result
        return run

    for owner, attr, label in functions:
        wrapped.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, timed(label, getattr(owner, attr)))
    runs = []
    try:
        for _ in range(repeats):
            for p in optimizer.params:
                p.grad = None
            spans.clear()
            marks = []

            def mark():
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            draw = step_draw(trainer.seed, trainer.state.step, 'cuda')
            mark()
            loss, _ = model.loss(model(batch, draw))
            mark()
            check(bool(torch.isfinite(loss)), 'step split: a finite loss')
            loss.backward()
            mark()
            optimizer.step()
            mark()
            runs.append(dict(zip(('forward', 'backward', 'optimizer'),
                                 (np.diff(marks) * 1e3).tolist()), **spans))
    finally:
        for owner, attr, fn in wrapped:
            setattr(owner, attr, fn)
    split = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    print(f'{trainer.cfg["MODEL"]["NAME"]} step split, ms (device drained '
          'between the parts'
          + (' and around each function inside the forward' if functions else '')
          + '): ' + ', '.join(f'{k} {v:.2f}' for k, v in split.items()),
          flush=True)
    return split


def pvrcnn_step_split(torch, trainer, batch):
    """The PV-RCNN step split, with the proposal layer (its NMS over 9000
    candidates apart) and the three target assigners (anchors, points,
    RoIs) timed inside the forward; the rows the NMS walk read per sample,
    and its kept lists against the full-matrix oracle on the same
    proposals."""
    from lidardetection_tpu_torch.models.dense_heads import (
        point_head, target_assigner,
    )
    from lidardetection_tpu_torch.models.roi_heads import roi_head_utils

    calls = []
    with recorded(roi_head_utils, 'nms_bev_batched', calls):
        split = step_split(torch, trainer, batch, functions=(
            (target_assigner, 'assign_targets', 'anchor targets'),
            (point_head, 'assign_point_targets', 'point targets'),
            (roi_head_utils, 'proposal_layer', 'proposal layer'),
            (roi_head_utils, 'nms_bev_batched', 'proposal NMS'),
            (roi_head_utils, 'assign_roi_targets', 'RoI targets')))
    step = split['forward'] + split['backward'] + split['optimizer']
    print(f'PV-RCNN step: {step:.2f} ms split (before: 941.59); the proposal '
          f'layer {split["proposal layer"]:.2f} ms '
          f'({split["proposal layer"] / step:.3f} of the step; its NMS '
          f'{split["proposal NMS"]:.2f}; the full matrix before: 716.65), '
          'the targets '
          f'{split["anchor targets"] + split["point targets"] + split["RoI targets"]:.2f} '
          'ms', flush=True)
    (boxes, scores), kw, (idx, _, num, rows_read) = calls[0]
    live = kw['valid_mask'].sum(1).tolist() if kw.get('valid_mask') \
        is not None else [scores.shape[1]] * scores.shape[0]
    print(f'proposal NMS walk: rows read per sample {rows_read.tolist()} of '
          f'{min(kw["pre_maxsize"], scores.shape[1])} candidates ({live} live '
          f'of the anchors), kept {num.tolist()} (post_maxsize '
          f'{kw["post_maxsize"]}, thresh {kw["thresh"]})', flush=True)
    t0 = time.perf_counter()
    want = full_matrix_nms(boxes, scores, kw.get('valid_mask'),
                           kw['thresh'], kw['pre_maxsize'], kw['post_maxsize'])
    oracle_ms = (time.perf_counter() - t0) * 1e3
    got = [idx[b, :int(num[b])].tolist() for b in range(len(want))]
    print(f'proposal NMS walk vs the full-matrix oracle ({oracle_ms:.2f} ms) '
          f'on one step\'s proposals: kept lists equal {got == want} '
          f'({[len(w) for w in want]} kept)', flush=True)
    check(got == want, 'the NMS walk keeps what the full-matrix sweep keeps')
    return split


def dw_work(torch, f, rb, g, valid):
    """K4's work at one layer (f, rb, g), counted on the live output rows
    only: the live rows, the (row, offset) hits, and the bytes and FLOP of
    its bound: each live row's k table entries, each input row that a hit
    reads once, each live row's gradient once, the f32 dW written once."""
    k, c_in, c_out = rb.shape[2], f.shape[2], g.shape[2]
    hit = (rb >= 0) & (rb < f.shape[1]) & valid[..., None]
    hits, live = int(hit.sum()), int(valid.sum())
    flat = rb.long() + torch.arange(rb.shape[0], device=rb.device)[
        :, None, None] * f.shape[1]
    rows_read = int(torch.unique(flat[hit]).numel())
    size = f.element_size()
    n_bytes = (live * k * 4 + rows_read * c_in * size
               + live * c_out * size + k * c_in * c_out * 4)
    return live, hits, n_bytes, 2 * hits * c_in * c_out


def record_weight_gradients(trainer, batch):
    """One forward and backward of a trainer's model: the sparse
    layers' forward inputs (call order), the (f, rulebook, g) that each
    layer's backward hands to K4 (call order reversed to layer order) and
    the (f, rulebook, W, valid) of every K3 call of the step (12 forward,
    then 11 df in backward order: 7 submanifold, 4 strided over the
    training plan's transposed rulebooks)."""
    from lidardetection_tpu_torch.ops import sparse
    from lidardetection_tpu_torch.parallel.train_step import step_draw

    calls, convs = [], []
    real, real_conv = sparse.rulebook_conv_dw, sparse.rulebook_conv

    def recorder(f, rb, g, valid=None):
        calls.append((f.detach(), rb, g.detach()))
        return real(f, rb, g, valid)

    def conv_recorder(f, rb, w, valid=None):
        convs.append((f.detach(), rb, w.detach(), valid))
        return real_conv(f, rb, w, valid)

    def run():
        for p in trainer.model.parameters():
            p.grad = None
        draw = step_draw(trainer.seed, trainer.state.step,
                         next(trainer.model.parameters()).device)
        loss, _ = trainer.model.loss(trainer.model(batch, draw))
        loss.backward()

    sparse.rulebook_conv_dw, sparse.rulebook_conv = recorder, conv_recorder
    try:
        layers, _ = record_sparse_layers(trainer.model, run)
    finally:
        sparse.rulebook_conv_dw, sparse.rulebook_conv = real, real_conv
    return layers, calls[::-1], convs


def weight_gradient_phase(torch, trainer, batch, backward_ms):
    """K4 against its plain version at the shapes of a full-width SECOND
    training step, then its time per layer; the K3 input gradient of a
    submanifold layer and K2's backward against autograd of their plain
    versions."""
    from lidardetection_tpu_torch.ops import sparse
    from lidardetection_tpu_torch.ops.scatter_cuda import (
        scatter_rows, scatter_rows_plain,
    )
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        DW_WORKSPACE_BYTES, dw_split_plan, rulebook_conv, rulebook_conv_dw,
        rulebook_conv_dw_plain, rulebook_conv_plain,
    )

    layers, calls, convs = record_weight_gradients(trainer, batch)
    check(len(layers) == len(calls) == 12 and len(convs) == 12 + 11,
          f'12 sparse layers, 12 weight gradients and 23 K3 calls '
          f'({len(layers)}, {len(calls)}, {len(convs)})')

    # the strided layers' input gradient: K3 over the training plan's
    # transposed rulebook against the scatter-add the device-built path
    # takes (the same f32 products summed in another order)
    for name in ('down2', 'down3', 'down4', 'out'):
        rb_bwd = batch[f'rb_{name}_bwd']
        (g, _, wb, in_valid), = [c for c in convs
                                 if c[1].data_ptr() == rb_bwd.data_ptr()]
        got = rulebook_conv(g, rb_bwd, wb, in_valid)
        want = sparse._conv_input_grad_plain(
            g, batch[f'rb_{name}'], wb.transpose(1, 2), rb_bwd.shape[1]) \
            * in_valid[..., None]
        torch.cuda.synchronize()
        e, top = float((got - want).abs().max()), float(want.abs().max())
        print(f'strided df {name} ({str(g.dtype)[6:]}, V {rb_bwd.shape[1]} <- '
              f'{g.shape[1]}, K={wb.shape[0]}): max|K3 over rb_{name}_bwd - '
              f'scatter-add| = {e:.3g} (max|want| {top:.3g}, tolerance 1e-4 * '
              f'max)', flush=True)
        check(top > 0 and e <= 1e-4 * top, f'strided df {name} on K3')

    # f32 sums of up to ~1e6 exact products in another order (the kernel
    # adds rows in ascending order chunk by chunk, the plain version sums
    # 4096-row einsums): the error stays under 1e-4 of the largest |dW|
    err, rel = 0.0, 0.0
    for n, ((layer, _, _, _), (f, rb, g)) in enumerate(zip(layers, calls), 1):
        check(tuple(rb.shape[:2]) == tuple(g.shape[:2]) and
              (rb.shape[2], f.shape[2], g.shape[2]) == tuple(layer.kernel.shape),
              f'layer {n}: the recorded gradient belongs to this layer')
        for dtype in (torch.bfloat16, torch.float32):
            fd, gd = f.to(dtype), g.to(dtype)
            for b in (1, TRAIN_BATCH):
                args = (fd[:b].contiguous(), rb[:b].contiguous(),
                        gd[:b].contiguous())
                got = rulebook_conv_dw(*args)
                want = rulebook_conv_dw_plain(*args)
                again = rulebook_conv_dw(*args)
                torch.cuda.synchronize()
                e, top = float((got - want).abs().max()), float(want.abs().max())
                check(top > 0 and e <= 1e-4 * top
                      and bool(torch.isfinite(got).all()),
                      f'rulebook_conv_dw layer {n} B={b} {dtype}: max error '
                      f'{e} against max|want| {top}')
                check(torch.equal(got, again),
                      f'rulebook_conv_dw layer {n}: the same bits on a second run')
                err, rel = max(err, e), max(rel, e / top)
        k, c_in, c_out = layer.kernel.shape
        print(f'K4 rulebook_conv_dw layer {n:2d} K={k} C {c_in}->{c_out}: bf16 '
              f'and f32, B=1 and B={TRAIN_BATCH} within 1e-4 * max|want|, '
              f'deterministic', flush=True)
    # a rulebook whose columns do not ascend: the rows of layer 7, shuffled
    f, rb, g = calls[6]
    perm = torch.randperm(rb.shape[1], device='cuda',
                          generator=torch.Generator('cuda').manual_seed(SEED))
    got = rulebook_conv_dw(f[:1].contiguous(), rb[:1, perm].contiguous(),
                           g[:1, perm].contiguous())
    want = rulebook_conv_dw_plain(f[:1], rb[:1], g[:1])
    torch.cuda.synchronize()
    e, top = float((got - want).abs().max()), float(want.abs().max())
    print(f'K4 rulebook_conv_dw layer 7, rows shuffled: max|kernel-plain| = '
          f'{e:.3g} (max|want| {top:.3g})', flush=True)
    check(e <= 1e-4 * top, 'rulebook_conv_dw on a shuffled rulebook')
    err, rel = max(err, e), max(rel, e / top)

    # the input gradient of a 64 -> 64 submanifold layer: K3 over the
    # forward rulebook with flipped, transposed weights, against autograd
    # of the plain forward. bf16 rounds the gradient and the result, the
    # plain forward's autograd does not: 2e-2 of the largest value there
    layer, f, valid, rb = layers[6]
    g = calls[6][2].float()
    check(layer.subm and tuple(layer.kernel.shape) == (27, 64, 64),
          'layer 7 is a 64 -> 64 submanifold layer')
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        grads = []
        for conv in (lambda a, w: sparse.sparse_conv_apply(a, valid, rb, w,
                                                           subm=True),
                     lambda a, w: rulebook_conv_plain(a, rb, w, valid)):
            a = f.detach().to(dtype).requires_grad_()
            w = layer.kernel.detach().to(dtype).requires_grad_()
            (conv(a, w) * g).sum().backward()
            grads.append((a.grad.float(), w.grad.float()))
        torch.cuda.synchronize()
        for what, got, want in zip(('df', 'dW'), *grads):
            e, top = float((got - want).abs().max()), float(want.abs().max())
            print(f'sparse conv backward, layer 7 {str(dtype)[6:]}: max|'
                  f'{what}(K3 flipped / K4) - autograd of plain| = {e:.3g} '
                  f'(max|want| {top:.3g}, tolerance {tol} * max)', flush=True)
            check(top > 0 and e <= tol * top, f'layer 7 {what} in {dtype}')

    # K2's backward, the row gather, against autograd of the plain version
    # (a gather of rows, whose own backward adds each row back once)
    n_slots = 2 * 200 * 176
    kept = torch.rand((TRAIN_BATCH, 16000), device='cuda',
                      generator=torch.Generator('cuda').manual_seed(SEED)) < 0.7
    enc_keys = torch.where(kept, torch.arange(16000, device='cuda') * 4,
                           n_slots).int().contiguous()
    feats = torch.randn((TRAIN_BATCH, 16000, 128), device='cuda',
                        generator=torch.Generator('cuda').manual_seed(SEED))
    gc = torch.randn((TRAIN_BATCH, n_slots, 128), device='cuda',
                     generator=torch.Generator('cuda').manual_seed(SEED + 1))
    grads = []
    for fn in (scatter_rows, scatter_rows_plain):
        a = feats.clone().requires_grad_()
        (fn(a, enc_keys, n_slots) * gc).sum().backward()
        grads.append(a.grad)
    torch.cuda.synchronize()
    print(f'K2 scatter_rows backward (B={TRAIN_BATCH}, C=128, {n_slots} slots): '
          f'bit-exact against autograd of plain: '
          f'{torch.equal(grads[0], grads[1])}', flush=True)
    check(torch.equal(grads[0], grads[1]) and float(grads[0].abs().max()) > 0,
          'scatter_rows backward equals the gather')

    # times at the main path's shape: a step's batch, the model's dtype
    shapes, total = [], {'ms': 0.0, 'old_flush_ms': 0.0, 'plain_ms': 0.0,
                         'bytes_ms': 0.0,
                         'ops_ms': 0.0}
    for n, ((layer, _, valid, _), (f, rb, g)) in enumerate(zip(layers, calls), 1):
        k, c_in, c_out = layer.kernel.shape
        live, hits, n_bytes, n_flop = dw_work(torch, f, rb, g, valid)
        # the card's peak for the inputs' type, as for K3
        rate = BF16_FLOP_PER_S if f.dtype == torch.bfloat16 else F32_FLOP_PER_S
        n_splits = dw_split_plan(rb.shape[0] * rb.shape[1], k, c_in, c_out)
        row = {'layer': n, 'K': k, 'C_in': c_in, 'C_out': c_out,
               'dtype': str(f.dtype)[6:], 'live_rows': live, 'hits': hits,
               'bytes': n_bytes, 'flop': n_flop, 'splits': n_splits,
               'workspace_bytes': n_splits * k * c_in * c_out * 4,
               # the (row, offset) entries that are never read or multiplied
               'entries_skipped': 1 - hits / max(rb.shape[0] * rb.shape[1] * k, 1),
               'ms': cuda_ms(lambda: rulebook_conv_dw(f, rb, g)),
               'old_flush_ms': cuda_ms(lambda: rulebook_conv_dw(f, rb, g),
                                       flush='dirty'),
               'plain_ms': cuda_ms(
                   lambda: rulebook_conv_dw_plain(f, rb, g), iters=10,
                   warmup=2)}
        check(row['workspace_bytes'] <= DW_WORKSPACE_BYTES,
              f'K4 layer {n}: workspace {row["workspace_bytes"]} bytes')
        row['bound_ms'], row['bound_by'] = bound_ms(n_bytes, n_flop, rate)
        row['tflop_per_s_on_hits'] = n_flop / row['ms'] * 1e-9
        total['ms'] += row['ms']
        total['old_flush_ms'] += row['old_flush_ms']
        total['plain_ms'] += row['plain_ms']
        total['bytes_ms'] += n_bytes / HBM_BYTES_PER_S * 1e3
        total['ops_ms'] += n_flop / rate * 1e3
        shapes.append(row)
        print(f'rulebook_conv_dw layer {n:2d} B={rb.shape[0]} {row["dtype"]} '
              f'K={k} C {c_in}->{c_out}: {live} live rows, {hits} hits '
              f'({hits / max(live * k, 1):.3f} of entries; entries skipped '
              f'{row["entries_skipped"]:.3f}), {n_splits} splits, workspace '
              f'{row["workspace_bytes"]} bytes, device {row["ms"]:.4f} ms '
              f'({row["tflop_per_s_on_hits"]:.2f} TFLOP/s on hits), plain '
              f'{row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms '
              f'({row["bound_by"]}; {n_bytes} bytes, {n_flop} FLOP)', flush=True)
    bound = sum(r['bound_ms'] for r in shapes)
    print(f'rulebook_conv_dw, the 12 launches of a step: device '
          f'{total["ms"]:.4f} ms, plain {total["plain_ms"]:.4f} ms, bound '
          f'{bound:.4f} ms; {total["ms"] / backward_ms:.4f} of the backward '
          f'({backward_ms:.2f} ms); largest workspace '
          f'{max(r["workspace_bytes"] for r in shapes)} bytes', flush=True)

    # K3 at a step's shape (B = 4, the train cap), held against its plain
    # version: the 12 forward and the 11 df launches (7 submanifold, 4
    # strided) of one step, in backward order, the model's dtype
    names = [f'forward {n}' for n in range(1, 13)] + \
        [f'df {n}' for n in range(1, 12)]
    step_rows = [conv_timing(torch, name, f'B={f.shape[0]}', f, rb, w, valid)
                 for name, (f, rb, w, valid) in zip(names, convs)]
    k3_step = {key: sum(r[key] for r in step_rows)
               for key in ('ms', 'old_flush_ms', 'plain_ms', 'bound_ms')}
    print(f'rulebook_conv, the 23 launches of a SECOND step (B={TRAIN_BATCH}): '
          f'device {k3_step["ms"]:.4f} ms (12 forward '
          f'{sum(r["ms"] for r in step_rows[:12]):.4f}, 11 df '
          f'{sum(r["ms"] for r in step_rows[12:]):.4f}), plain '
          f'{k3_step["plain_ms"]:.4f} ms, bound {k3_step["bound_ms"]:.4f} ms',
          flush=True)
    return {'name': 'rulebook_conv_dw', 'route': 'cuda',
            'source': 'lidardetection_tpu_torch/csrc/sparse_conv_dw.cu',
            'replaces': 'lidardetection_tpu/ops/sparse_conv_tpu.py:490',
            # the largest error of any check above, and the largest as a
            # share of max|dW| of its check (what the tolerance bounds)
            'max_abs_err': err, 'max_rel_err': rel,
            # per call: the mean over the 12 launches of a training step
            'ms': total['ms'] / 12, 'plain_ms': total['plain_ms'] / 12,
            'old_flush_ms': total['old_flush_ms'] / 12, 'bound_ms': bound / 12,
            'bound_by': 'bytes' if total['bytes_ms'] >= total['ops_ms']
            else 'operations',
            'library_ms': None, 'per_step_ms': total['ms'],
            'per_step_old_flush_ms': total['old_flush_ms'],
            'share_of_backward': total['ms'] / backward_ms, 'layers': shapes}, \
        {'per_step_ms': k3_step['ms'], 'per_step_plain_ms': k3_step['plain_ms'],
         'per_step_old_flush_ms': k3_step['old_flush_ms'],
         'per_step_bound_ms': k3_step['bound_ms'], 'step_layers': step_rows}


def record_ball_selects(run):
    """run() with K5's inputs recorded: the argument tuples of every
    ``ball_select`` call the point ops make, in call order, and run()'s
    result."""
    from lidardetection_tpu_torch.ops import pointnet2

    calls, real = [], pointnet2.ball_select

    def recorder(*args):
        calls.append(args)
        return real(*args)

    pointnet2.ball_select = recorder
    try:
        out = run()
    finally:
        pointnet2.ball_select = real
    return calls, out




def select_held(torch, args, what):
    """K5 against its plain version on one case: bit-equal, and the largest
    |kernel - plain| over entries finite on both sides, plus 1 where one
    side is -inf and the other not. Returns the error and the number of
    runs at the cut."""
    from lidardetection_tpu_torch.ops.select_cuda import (
        ball_select, ball_select_plain,
    )

    got, want = ball_select(*args), ball_select_plain(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = 0.0
    for a, b in zip(got, want):
        both = torch.isfinite(a) & torch.isfinite(b)
        err = max(err, float(torch.where(both, a - b, 0).abs().max())
                  + float((torch.isinf(a) != torch.isinf(b)).any()))
    hits = [int(torch.isfinite(a).sum()) for a in got]
    start, end, max_run = args[2], args[3], args[7]
    cut = int((end - start == max_run).sum())
    print(f'K5 ball_select {what}: runs {tuple(start.shape)}, {cut} runs '
          f'at the {max_run}-row cut, hits selected per radius {hits}: '
          f'bit-equal to plain {same}, max abs err {err}', flush=True)
    check(same and err == 0 and sum(hits) > 0, f'ball_select {what} bit-equal')
    return err, cut


def select_timings(torch, named_args):
    """For each (name, K5 arguments): its device time, its plain version's,
    and its bound from `select_work`."""
    from lidardetection_tpu_torch.ops.select_cuda import (
        ball_select, ball_select_plain,
    )

    rows = []
    for src, args in named_args:
        pairs, rows_read, n_bytes, n_flop, most = select_work(args)
        row = {'source': src, 'n_row': args[2].shape[-1],
               'rows': args[1].shape[1], 'centres': args[4].shape[1],
               'rows_read': rows_read, 'most_rows_a_centre': most,
               'radii': list(args[5]),
               'nsamples': list(args[6]), 'live_pairs': pairs,
               'bytes': n_bytes, 'flop': n_flop,
               'ms': cuda_ms(lambda: ball_select(*args)),
               'old_flush_ms': cuda_ms(lambda: ball_select(*args),
                                       flush='dirty'),
               'plain_ms': cuda_ms(lambda: ball_select_plain(*args))}
        row['bound_ms'], row['bound_by'] = bound_ms(n_bytes, n_flop)
        rows.append(row)
        print(f'ball_select {src} B=1: n_row {row["n_row"]}, {row["rows"]} rows '
              f'({rows_read} read), {row["centres"]} centres, {pairs} live '
              f'pairs (at most {most} a centre), device {row["ms"]:.4f} ms, '
              f'plain {row["plain_ms"]:.4f} ms, bound {row["bound_ms"]:.5f} ms '
              f'({row["bound_by"]}; {n_bytes} bytes, {n_flop} FLOP)', flush=True)
    return rows


def select_kernel_phase(torch, det):
    """K5 against its plain version on the card, bit for bit: the five
    sources' (table, runs, centres) of a real request at B = 2 (the yaml's
    batch) and B = 1, the original indices shuffled, a third of the
    centres invalid, and a cloud whose cells hold more than the 64 cap;
    then its time per source at one request's shape."""
    from lidardetection_tpu_torch.ops import pointnet2
    from lidardetection_tpu_torch.ops.select_cuda import select_launch_plan

    clouds = make_clouds(det, 2, SEED + 500)
    calls, _ = record_ball_selects(lambda: det.forward(det.make_batch(clouds)))
    sources = det.model.pfe.sa_sources
    check(len(calls) == len(sources) == 5,
          f'one K5 call per SA source ({len(calls)} for {sources})')
    g = torch.Generator(device='cuda').manual_seed(SEED)

    def held(args, what):
        return select_held(torch, args, what)

    ones, errs = [], []
    for src, args in zip(sources, calls):
        errs.append(held(args, f'{src} B=2')[0])
        one = tuple(a[:1].contiguous() if torch.is_tensor(a) else a
                    for a in args)
        errs.append(held(one, f'{src} B=1')[0])
        ones.append(one)
    xyz, orig, start, end, centers, *static = calls[0]
    perm = torch.randperm(orig.shape[1], device='cuda', generator=g)
    errs.append(held((xyz, perm[orig.long()].int().contiguous(), start, end,
                      centers, *static), 'raw_points, original indices shuffled')[0])
    every_third = (torch.arange(start.shape[1], device='cuda') % 3 == 0)[
        None, :, None]
    errs.append(held((xyz, orig, start,
                      torch.where(every_third, start, end).contiguous(), centers,
                      *static), 'raw_points, a third of the centres invalid')[0])
    lo = torch.tensor(det.info['point_cloud_range'][:3], device='cuda')
    hi = torch.tensor(det.info['point_cloud_range'][3:], device='cuda')
    knobs = det.model.pfe.knobs

    def clump(n_points, corner, size):
        """K5's arguments for a cloud of 40000 valid points, n_points of
        them in one cube, and 2048 centres, the first 256 in the cube."""
        cloud = lo + (hi - lo) * torch.rand((1, 131072, 3), device='cuda',
                                             generator=g)
        cloud[0, :n_points] = torch.tensor(corner, device='cuda') \
            + size * torch.rand((n_points, 3), device='cuda', generator=g)
        ctr = cloud[:, torch.randperm(131072, device='cuda', generator=g)[:2048]]
        ctr[0, :256] = cloud[0, :256]
        calls, _ = record_ball_selects(lambda: pointnet2.grid_ball_query_multi(
            (0.4, 0.8), (16, 16), cloud, torch.tensor([40000], device='cuda'),
            ctr, bounds=knobs.bq_grid[0], cell_cap=knobs.bq_grid[1]))
        return calls[0]

    # 6000 points in one 0.5 m cube: its cells hold far more than the cap
    err, cut = held(clump(6000, [20.0, 3.0, -1.0], 0.5),
                    'a clump over the cell cap')
    errs.append(err)
    check(cut > 0, f'the clump reaches the run cut ({cut} runs at it)')
    # every candidate of every run in radius, on a cloud whose 27 cells
    # around its centres (0.8 m, grid-aligned) hold ~1500 points each: 9
    # full runs, more hits than a warp's buffer, the kernel's second pass
    xyz_c, orig_c, start_c, end_c, ctr_c, _, _, run_c = clump(
        40000, [20.0, 3.2, -1.4], 2.4)
    plan = select_launch_plan(start_c.shape[-1], run_c, (16, 32))
    most = int((torch.minimum(end_c - start_c, torch.full_like(start_c, run_c))
                .clamp(min=0).sum(-1)).max())
    check(most > plan.cap, f'a centre with {most} hits overflows the '
          f'{plan.cap}-hit buffer')
    errs.append(held((xyz_c, orig_c, start_c, end_c, ctr_c, (1e3, 2e3),
                      (16, 32), run_c),
                     f'every candidate in radius, up to {most} hits a centre '
                     f'(buffer {plan.cap})')[0])
    for radius, ns in ((0.8, 1), (0.8, 64)):
        errs.append(held((xyz, orig, start, end, centers, (radius,), (ns,),
                          static[-1]), f'raw_points, nsample {ns}')[0])
    n_src = orig.shape[1]
    descending = (n_src - 1 - torch.arange(n_src, device='cuda', dtype=torch.int32)
                  ).expand_as(orig).contiguous()
    errs.append(held((xyz, descending, start, end, centers, *static),
                     'raw_points, orig descending along each run')[0])

    rows = select_timings(torch, zip(sources, ones))
    total = {key: sum(r[key] for r in rows)
             for key in ('ms', 'old_flush_ms', 'plain_ms')}
    total['bytes_ms'] = sum(r['bytes'] for r in rows) / HBM_BYTES_PER_S * 1e3
    total['ops_ms'] = sum(r['flop'] for r in rows) / F32_FLOP_PER_S * 1e3
    bound = sum(r['bound_ms'] for r in rows)
    print(f'ball_select, the 5 launches of a request: device {total["ms"]:.4f} '
          f'ms, plain {total["plain_ms"]:.4f} ms, bound {bound:.5f} ms',
          flush=True)
    return {'name': 'ball_select', 'route': 'cuda',
            'source': 'lidardetection_tpu_torch/csrc/ball_select.cu',
            'replaces': 'lidardetection_tpu/ops/select_tpu.py:64',
            'max_abs_err': max(errs),  # the largest of every case above
            # per call: the mean over the 5 launches of a request
            'ms': total['ms'] / 5, 'plain_ms': total['plain_ms'] / 5,
            'old_flush_ms': total['old_flush_ms'] / 5, 'bound_ms': bound / 5,
            'bound_by': 'bytes' if total['bytes_ms'] >= total['ops_ms']
            else 'operations',
            'library_ms': None, 'per_request_ms': total['ms'],
            'per_request_old_flush_ms': total['old_flush_ms'], 'sources': rows}


def pvrcnn_split(torch, det, points, k5):
    """The PV-RCNN forward by module, with FPS, the five ball queries and
    the proposal layer timed apart; each ball query beside its K5 launch
    (the rest of it is the prep: sort, cell boundaries, row runs)."""
    from lidardetection_tpu_torch.models.roi_heads import roi_head_utils
    from lidardetection_tpu_torch.ops import pointnet2

    sources = det.model.pfe.sa_sources
    med = forward_split(det, points, functions=(
        (pointnet2, 'fps', ['fps']),
        (pointnet2, 'ball_query_multi', [f'ball query {s}' for s in sources]),
        (roi_head_utils, 'proposal_layer', ['proposal layer'])))
    queries = sum(med[f'ball query {s}'] for s in sources)
    for row in k5['sources']:
        q = med[f'ball query {row["source"]}']
        print(f'ball query {row["source"]}: {q:.3f} ms (host clock, device '
              f'drained), K5 {row["ms"]:.4f} ms (CUDA events), the prep the '
              f'rest, {q - row["ms"]:.3f} ms', flush=True)
    print(f'the five ball queries: {queries:.3f} ms, K5 {k5["per_request_ms"]:.4f} '
          f'ms, the preps {queries - k5["per_request_ms"]:.3f} ms', flush=True)
    print(f'PV-RCNN forward: VSA {med["pfe"]:.2f} ms = FPS {med["fps"]:.2f} + '
          f'ball queries {queries:.2f} + the rest {med["pfe"] - med["fps"] - queries:.2f}; '
          f'RoI head {med["roi_head"]:.2f} ms = proposal layer '
          f'{med["proposal layer"]:.2f} + RoI-grid pooling and FC '
          f'{med["roi_head"] - med["proposal layer"]:.2f}', flush=True)


def compare_plain_phase(torch, det, cfg_file, points, wrappers):
    """One f32 request on the card with the kernels against the same request
    on the card with the plain versions (same weights and cloud, so only
    the kernels differ): the same kept count and labels; scores within
    1e-5, boxes within 1e-5 of max(1, |box|) (f32 spacing at 70 m is 7.6e-6:
    K3's sums in another order move the last bits)."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.serve import Detector

    cfg = cfg_from_yaml_file(cfg_file)
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    state = {k: v.cpu() for k, v in det.model.state_dict().items()}
    twin = Detector(cfg, device='cuda', state_dict=state)
    batch = twin.make_batch([points])  # once: a point config samples anew
    results = {}
    for name, plain in (('kernels', False), ('plain versions', True)):
        for k in wrappers:
            k.launches = 0
        with plain_versions() if plain else contextlib.nullcontext():
            out = twin.forward(batch)
            preds = twin.postprocess(out)
        launched = sum(k.launches for k in wrappers)
        check((launched == 0) == plain, f'f32 request with {name}: {launched} '
              'kernel launches')
        results[name] = (out, preds)
    (out_k, pk), (out_p, pp) = results['kernels'], results['plain versions']
    for key in ('point_features', 'rois', 'batch_box_preds'):
        d = float((out_k[key] - out_p[key]).abs().max())
        print(f'f32 request, kernels vs plain versions on the card: max|d {key}| '
              f'= {d:.3g} (max {float(out_p[key].abs().max()):.3g})', flush=True)
    n = int(pk['num_preds'][0])
    check(n == int(pp['num_preds'][0]) and n > 0,
          f'kept counts {n} vs {int(pp["num_preds"][0])}')
    check(torch.equal(pk['pred_labels'], pp['pred_labels']), 'same labels')
    ds = float((pk['pred_scores'] - pp['pred_scores']).abs().max())
    db = (pk['pred_boxes'] - pp['pred_boxes']).abs() \
        / pp['pred_boxes'].abs().clamp(min=1.0)
    print(f'f32 request, kernels vs plain versions on the card: {n} kept, '
          f'labels equal, max|d score| {ds:.3g}, max|d box| / max(1, |box|) '
          f'{float(db.max()):.3g} (tolerance 1e-5 each)', flush=True)
    check(ds <= 1e-5 and float(db.max()) <= 1e-5, 'kept detections agree')


def gradient_distance(got, want):
    """Per leaf, the largest |got - want| as a share of the leaf's largest
    |want|, and the leaf's relative L2 distance; the relative L2 distance
    of the whole gradient."""
    shares, leaf_l2, err2, norm2 = {}, {}, 0.0, 0.0
    for key, ref in want.items():
        diff, ref = got[key].double() - ref.double(), ref.double()
        shares[key] = float(diff.abs().max()) / max(float(ref.abs().max()), 1e-30)
        leaf_l2[key] = float(diff.norm()) / max(float(ref.norm()), 1e-30)
        err2 += float(diff.pow(2).sum())
        norm2 += float(ref.pow(2).sum())
    return shares, leaf_l2, (err2 / norm2) ** 0.5


@contextlib.contextmanager
def plain_versions():
    """While it is open the model's sparse convolutions, its scatter and its
    ball selection run their plain versions (under autograd where there is
    a gradient), on whatever device the tensors lie, so a request or a
    gradient can be taken on the card with no kernel of csrc/ in it."""
    from lidardetection_tpu_torch.models.backbones_2d import map_to_bev
    from lidardetection_tpu_torch.ops import pointnet2, sparse
    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows_plain
    from lidardetection_tpu_torch.ops.select_cuda import ball_select_plain
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import rulebook_conv_plain

    kept = (sparse.sparse_conv_apply, sparse.scatter_rows,
            map_to_bev.scatter_rows, pointnet2.ball_select)
    sparse.sparse_conv_apply = lambda f, valid, rb, w, **kwargs: \
        rulebook_conv_plain(f, rb, w, valid)
    sparse.scatter_rows = map_to_bev.scatter_rows = scatter_rows_plain
    pointnet2.ball_select = ball_select_plain
    try:
        yield
    finally:
        (sparse.sparse_conv_apply, sparse.scatter_rows,
         map_to_bev.scatter_rows, pointnet2.ball_select) = kept


def compare_train_phase(torch, trainer, cfg_file, batch, wrappers):
    """One f32 training step on the card with the kernels, held against the
    same forward and backward (same weights, the batch's first two scenes)
    taken twice more with the plain versions under autograd: on the card
    and on the CPU.

    Card against card, only the kernels differ (K3 forward and flipped for
    df, K4, K2 and its gather, against autograd of the plain versions), so
    every gradient leaf is held within 1e-3 of its largest value (the
    library's backward adds atomically, so two runs of one code differ in
    the last bits). Card against CPU the dense library differs too: the
    activations agree to rounding, but a ReLU whose input lies within that
    rounding of 0 passes the gradient on one device and not on the other,
    and every leaf below it inherits the difference, whole entries of a
    leaf at a time. So there the loss terms are held within 1e-3 relative,
    every leaf within 0.2 in relative L2 norm and the whole gradient within
    0.05; a wrong kernel shows as an error of order 1 in both comparisons.

    A detector with an RoI head (PV-RCNN) is compared on the card alone,
    both runs drawing from the same per-step generator: on the CPU its
    point ops take their exact paths and a CPU generator draws other
    numbers. Its two runs must first sample the same RoIs."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.parallel.train_step import step_draw
    from lidardetection_tpu_torch.train import Trainer
    from lidardetection_tpu_torch.utils.precision import full_f32

    cfg = cfg_from_yaml_file(cfg_file)
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    two_stage = bool(cfg.MODEL.get('ROI_HEAD'))
    state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    results, sampled = {}, {}
    runs = (('card, kernels', 'cuda', False), ('card, plain', 'cuda', True))
    if not two_stage:
        runs += (('cpu, plain', 'cpu', True),)
    for name, device, plain in runs:
        t0 = time.perf_counter()
        twin = Trainer(cfg, device=device, state_dict=state, total_steps=4,
                       seed=trainer.seed)
        part = {k: v[:2].to(device) for k, v in batch.items()}
        for k in wrappers:
            k.launches = 0
        if plain or two_stage:  # in f32 as Trainer.step holds it
            with plain_versions() if plain else contextlib.nullcontext(), \
                    full_f32():
                out = twin.model(part, step_draw(trainer.seed, 0, device))
                tb = twin.model.loss(out)[1]
                tb['loss'].backward()
            if two_stage:
                sampled[name] = out['roi_head_fwd']['sampled_inds']
        else:
            tb = twin.step(part)
        launched = sum(k.launches for k in wrappers)
        check((launched == 0) == plain,
              f'step on {name}: {launched} kernel launches')
        results[name] = (
            {k: float(v.detach()) for k, v in tb.items()},
            {k: p.grad.cpu() for k, p in twin.model.named_parameters()})
        print(f'f32 step on {name}: {results[name][0]} '
              f'({time.perf_counter() - t0:.1f} s with set-up)', flush=True)
    if two_stage:
        got, want = sampled['card, kernels'], sampled['card, plain']
        check(torch.equal(got, want), 'f32 step: the kernels and the plain '
              f'versions sample the same RoIs ({int((got != want).sum())} differ)')
        print(f'f32 step, card with kernels vs plain: the same {got.numel()} '
              'sampled RoIs', flush=True)
    tb_g, grads_g = results['card, kernels']
    for other, tol_loss, measure, limit in (
            ('card, plain', 1e-6, 'largest entry', 1e-3),
            ('cpu, plain', 1e-3, 'relative L2', 0.2))[:len(runs) - 1]:
        tb_o, grads_o = results[other]
        for key, want in tb_o.items():
            check(abs(tb_g[key] - want) <= tol_loss * abs(want),
                  f'f32 {key}: card, kernels {tb_g[key]} vs {other} {want}')
        shares, leaf_l2, rel_l2 = gradient_distance(grads_g, grads_o)
        by_share, by_l2 = max(shares, key=shares.get), max(leaf_l2, key=leaf_l2.get)
        print(f'f32 gradient, card with kernels vs {other}: {len(shares)} '
              f'leaves; the largest difference of an entry as a share of its '
              f'leaf\'s largest value {shares[by_share]:.3g} ({by_share}), the '
              f'largest relative L2 distance of a leaf {leaf_l2[by_l2]:.3g} '
              f'({by_l2}), of the whole gradient {rel_l2:.3g}; tolerances: '
              f'{measure} of a leaf {limit}, whole gradient 0.05', flush=True)
        held = shares[by_share] if measure == 'largest entry' else leaf_l2[by_l2]
        check(held <= limit, f'gradient, card, kernels vs {other}: {measure} '
              f'of a leaf {held} above {limit}')
        check(rel_l2 <= 0.05, f'gradient, card, kernels vs {other}: L2 {rel_l2}')


@contextlib.contextmanager
def atomic_gathers():
    """While it is open every module of the port that reads rows with
    ``ops/gather.py::gather_rows`` reads them with ``torch.gather`` instead,
    whose backward adds with float atomics (``scatter_add_``): the form
    before the repair, for the comparisons of ``deterministic_cost``
    only."""
    import torch
    from lidardetection_tpu_torch.ops import gather

    def library(features, idx):
        b, n = features.shape[:2]
        flat = features.reshape(b, n, -1)
        rows = torch.gather(flat, 1, idx.reshape(b, -1, 1).long().expand(
            -1, -1, flat.shape[-1]))
        return rows.reshape(*idx.shape, *features.shape[2:])

    repaired = gather.gather_rows
    owners = [m for name, m in list(sys.modules.items())
              if name.startswith('lidardetection_tpu_torch')
              and getattr(m, 'gather_rows', None) is repaired]
    for m in owners:
        m.gather_rows = library
    try:
        yield
    finally:
        for m in owners:
            m.gather_rows = repaired


def reproducibility_phase(torch, trainer, batch, held=True, label=''):
    """Two identical training steps from the same state on the same batch,
    deterministic mode off: every parameter, BatchNorm statistic and Adam
    moment after the step compared bit for bit. Where a leaf differs, the
    differing leaves are printed by kind and module; then, if `held`, the
    run fails. The state is put back. Returns the differing leaves."""
    import copy

    saved = copy.deepcopy(trainer.state.state_dict())

    def leaves():
        state = trainer.state.state_dict()
        out = {f'model/{k}': v.clone() for k, v in state['model'].items()}
        for kind in ('mu', 'nu'):
            out.update({f'{kind}/{k}': v.clone()
                        for k, v in state['optimizer'][kind].items()})
        return out

    runs = []
    for _ in range(2):
        trainer.state.load_state_dict(copy.deepcopy(saved))
        trainer.step(batch)
        runs.append(leaves())
    name = f'{trainer.cfg["MODEL"]["NAME"]}{label}'
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    print(f'two identical {name} steps: {len(runs[0]) - len(differ)} of '
          f'{len(runs[0])} leaves bit-equal', flush=True)
    if differ:
        groups = {}
        for k in differ:
            kind, leaf = k.split('/', 1)
            group = f'{kind}/{leaf.split(".")[0]}'
            groups[group] = groups.get(group, 0) + 1
        print(f'{name}: differing leaves by kind and module: {groups}; the '
              f'first: {differ[:12]}', flush=True)
    trainer.state.load_state_dict(saved)
    if held:
        check(not differ, f'two identical {name} steps: {len(differ)} leaves '
              'differ')
    return differ


def deterministic_step(torch, trainer, batch):
    """One training step under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``, the mode switched off after it."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        trainer.step(batch)
    finally:
        torch.use_deterministic_algorithms(False)


def profiled_step(torch, trainer, batch):
    """One training step under the profiler: the device's kernel ms (every
    kernel, copy and fill of the step), and the row gathers' backward (the
    autograd nodes of ``torch.gather``, GatherBackward0, and of
    ``gather_rows``, _GatherRowsBackward): its device ms and its host ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(batch)
        torch.cuda.synchronize()
    device = gathers_device = gathers_host = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            device += e.self_device_time_total / 1e3
        elif e.key.startswith('autograd::engine::evaluate_function') and (
                'GatherBackward0' in e.key or '_GatherRowsBackward' in e.key):
            gathers_device += getattr(e, 'device_time_total',
                                      getattr(e, 'cuda_time_total', 0.0)) / 1e3
            gathers_host += e.cpu_time_total / 1e3
    return device, gathers_device, gathers_host


COST_CONFIGS = ((CFG_PVRCNN, SEED + 600), (CFG_MULTIFRAME, SEED + 1400),
                (CFG_POINTRCNN, SEED + 1000))
COST_STEPS = 25      # host-clock steps of each form
PROFILED_COST_STEPS = 5  # profiled steps of each form


def deterministic_cost(torch, trainer_for):
    """The repair's cost: for PV-RCNN, multiframe PV-RCNN and PointRCNN,
    from one state on one batch, the step as the package runs it (the
    repaired gathers), with the atomic gathers patched in
    (``atomic_gathers``, the form before the repair), and the atomic form
    in deterministic mode (the library's own repair).

    First, for each config, 2 warm-up steps of each form, then 25 of each,
    alternating, on the host clock (the device drained around each step,
    the garbage collected before it): p50 and quartiles, printed. Then two
    identical steps of the atomic form, compared leaf by leaf and printed
    (not held: the fault the repair closes). Then, after every host-clock
    reading (the profiler's callbacks slow later launches), 5 profiled
    steps of the repaired and the atomic form, alternating: the step's
    device kernel time, and the gathers' backward on the device and the
    host. Held: the repaired step's device time p50 within +5% of the
    atomic form's. The host-clock p50 is printed, not held: its quartiles
    on one batch span more than the 5% it would decide.
    `trainer_for(cfg_file)` gives the trainer."""
    import copy
    import gc
    import warnings

    forms = ('repaired', 'atomic', 'atomic in deterministic mode')

    def timed(trainer, batch, form):
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if form == 'atomic in deterministic mode':
            deterministic_step(torch, trainer, batch)
        else:
            trainer.step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    host = {}
    for cfg_file, seed in COST_CONFIGS:
        trainer = trainer_for(cfg_file)
        batch = train_batches(trainer, 1, seed)[0][0]
        saved = copy.deepcopy(trainer.state.state_dict())
        times = {form: [] for form in forms}
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            for i in range((COST_STEPS + 2) * len(forms)):
                form = forms[i % len(forms)]
                trainer.state.load_state_dict(copy.deepcopy(saved))
                with contextlib.nullcontext() if form == 'repaired' \
                        else atomic_gathers():
                    ms = timed(trainer, batch, form)
                if i >= 2 * len(forms):
                    times[form].append(ms)
        trainer.state.load_state_dict(copy.deepcopy(saved))
        with atomic_gathers():
            reproducibility_phase(torch, trainer, batch, held=False,
                                  label=' (atomic gathers)')
        p50 = {form: float(np.median(t)) for form, t in times.items()}
        spread = {form: [round(float(q), 2) for q in np.percentile(t, [25, 75])]
                  for form, t in times.items()}
        rep, atomic, det = (p50[f] for f in forms)
        print(f'{trainer.cfg["MODEL"]["NAME"]} ({cfg_file}) step p50 of '
              f'{COST_STEPS} (host clock, not held): repaired {rep:.2f} ms, '
              f'atomic {atomic:.2f} ms ({100 * (rep / atomic - 1):+.1f}%), '
              f'atomic in deterministic mode {det:.2f} ms '
              f'({100 * (det / atomic - 1):+.1f}%); quartiles {spread}',
              flush=True)
        host[cfg_file] = (rep, atomic)
        del trainer, batch, saved
    for cfg_file, seed in COST_CONFIGS:
        trainer = trainer_for(cfg_file)
        batch = train_batches(trainer, 1, seed)[0][0]
        saved = copy.deepcopy(trainer.state.state_dict())
        readings = {'repaired': [], 'atomic': []}
        for i in range(2 * (PROFILED_COST_STEPS + 1)):
            form = ('repaired', 'atomic')[i % 2]
            trainer.state.load_state_dict(copy.deepcopy(saved))
            with contextlib.nullcontext() if form == 'repaired' \
                    else atomic_gathers():
                if i < 2:  # a warm-up step of each form, not profiled
                    trainer.step(batch)
                else:
                    readings[form].append(profiled_step(torch, trainer, batch))
        trainer.state.load_state_dict(saved)
        dev = {f: np.asarray(r) for f, r in readings.items()}
        p50 = {f: np.median(r, axis=0) for f, r in dev.items()}
        width = {f: float((r[:, 0].max() - r[:, 0].min()) / p50[f][0])
                 for f, r in dev.items()}
        rep, atomic = p50['repaired'][0], p50['atomic'][0]
        print(f'{trainer.cfg["MODEL"]["NAME"]} ({cfg_file}) step device time '
              f'p50 of {PROFILED_COST_STEPS} (profiler, held): repaired '
              f'{rep:.3f} ms, atomic {atomic:.3f} ms '
              f'({100 * (rep / atomic - 1):+.2f}%; each form\'s range '
              f'{100 * width["repaired"]:.2f}% and {100 * width["atomic"]:.2f}% '
              f'of its p50); the gathers\' backward: device repaired '
              f'{p50["repaired"][1]:.3f} ms, atomic {p50["atomic"][1]:.3f} ms; '
              f'host repaired {p50["repaired"][2]:.3f} ms, atomic '
              f'{p50["atomic"][2]:.3f} ms (profiler on); host-clock step p50 '
              f'repaired {host[cfg_file][0]:.2f} ms, atomic '
              f'{host[cfg_file][1]:.2f} ms', flush=True)
        check(rep <= 1.05 * atomic, f'{cfg_file}: the repaired step\'s device '
              f'time p50 {rep:.3f} ms above +5% of the atomic form\'s '
              f'{atomic:.3f}')
        del trainer, batch, saved


def host_plan_phase(trainer):
    """The host side at a config's train cap, per scan of a training
    batch: the voxelizer and the training plan's rulebook build, the host
    library against the numpy plain version (equal arrays), median times."""
    from lidardetection_tpu_torch import native
    from lidardetection_tpu_torch.datasets.synthetic import SyntheticScenes
    from lidardetection_tpu_torch.ops.sparse_plan import build_host_rulebooks
    from lidardetection_tpu_torch.ops.voxelize import (
        mask_points_by_range, voxelize_np,
    )

    info, plan = trainer.info, trainer.plan
    dataset = SyntheticScenes(trainer.class_names, info['point_cloud_range'],
                               num_scenes=TRAIN_BATCH, seed=SEED + 700)
    times = {k: [] for k in ('voxelize native', 'voxelize numpy',
                             'plan native', 'plan numpy')}
    args = (info['point_cloud_range'], info['voxel_size'],
            trainer.max_points_per_voxel, trainer.max_voxels)
    for i in range(TRAIN_BATCH):
        points, _ = dataset[i]
        points = points[mask_points_by_range(points, np.asarray(
            info['point_cloud_range'], np.float32))]
        out = {}
        for plain, what in ((False, 'native'), (True, 'numpy')):
            with native.plain_host(plain):
                t0 = time.perf_counter()
                table = voxelize_np(points, *args)
                t1 = time.perf_counter()
                rb = build_host_rulebooks(plan, table[1], table[3])
                t2 = time.perf_counter()
            times[f'voxelize {what}'].append((t1 - t0) * 1e3)
            times[f'plan {what}'].append((t2 - t1) * 1e3)
            out[what] = (table, rb)
        (t_n, rb_n), (t_p, rb_p) = out['native'], out['numpy']
        check(t_n[3] == t_p[3] and all(np.array_equal(a, b)
                                       for a, b in zip(t_n[:3], t_p[:3])),
              f'scan {i}: native and numpy voxel tables equal')
        check(list(rb_n) == list(rb_p) == plan.batch_keys() and all(
            rb_n[k].dtype == rb_p[k].dtype and np.array_equal(rb_n[k], rb_p[k])
            for k in rb_n), f'scan {i}: native and numpy rulebooks equal')
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f'{trainer.cfg["MODEL"]["NAME"]} host side per scan at the train '
          f'cap of {trainer.max_voxels} '
          f'({TRAIN_BATCH} scans, {len(plan.ops)} plan ops, '
          f'{len(plan.batch_keys())} tables; native and numpy bit-equal), '
          'median ms: ' + ', '.join(f'{k} {v:.2f}' for k, v in med.items()),
          flush=True)


def bucketed_eval_phase(torch, cfg_file):
    """A config's eval on the bucketed host tables (the eval phase's path)
    against the unbucketed device-built path on the same scenes, weights
    and eval step: the same detections, equal tensors."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
    from lidardetection_tpu_torch.datasets.synthetic import build_test_loader
    from lidardetection_tpu_torch.models import build_network
    from lidardetection_tpu_torch.parallel.train_step import (
        device_batch, make_eval_step,
    )

    cfg = cfg_from_yaml_file(cfg_file)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES),
                          dataset_info(cfg.DATA_CONFIG), seed=SEED).to('cuda')
    with torch.no_grad():
        model.dense_head.conv_cls_bias.zero_()
    step = make_eval_step(model, cfg.MODEL.POST_PROCESSING,
                          len(cfg.CLASS_NAMES))
    _, bucketed = build_test_loader(cfg, EVAL_BATCH, EVAL_SCENES,
                                    seed=SEED + 500)
    cfg.DATA_CONFIG.VOXEL_BUCKETING = False
    _, whole = build_test_loader(cfg, EVAL_BATCH, EVAL_SCENES, seed=SEED + 500)
    keys = ('pred_boxes', 'pred_scores', 'pred_labels', 'num_preds')
    stages = ('down2', 'down3', 'down4', 'out')
    for i, (host, dev) in enumerate(zip(bucketed, whole)):
        dev = {k: v for k, v in dev.items() if not k.startswith('rb_')}
        got, want = step(device_batch(host, 'cuda')), \
            step(device_batch(dev, 'cuda'))
        same = all(torch.equal(got[k], want[k]) for k in keys)
        print(f'eval batch {i}: bucketed host tables (voxels '
              f'{host["voxels"].shape[1]}, stage rows '
              f'{[host[f"rb_{n}_coords"].shape[1] for n in stages]}) '
              f'vs the unbucketed device-built path (voxels '
              f'{dev["voxels"].shape[1]}): detections equal {same} '
              f'({got["num_preds"].tolist()} kept)', flush=True)
        check(same, f'eval batch {i}: bucketed host-plan detections equal '
              'the device-built ones')
        check(host['voxels'].shape[1] < dev['voxels'].shape[1],
              f'eval batch {i}: bucketing cut the table')


class CountedLoader:
    """An eval loader whose batches are each one run of the main path: every
    launch count set to 0 just before a batch is handed to the evaluator and
    read when it asks for the next (the step of a batch ends before the
    next is asked for). `per_batch` maps each kernel's wrapper to the
    launches one batch must make."""

    def __init__(self, loader, per_batch):
        self.loader, self.per_batch = loader, per_batch
        self.dataset = loader.dataset
        self.total = {k.__name__: 0 for k in per_batch}
        self.largest_num_voxels = 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if 'num_voxels' in batch:
                self.largest_num_voxels = max(self.largest_num_voxels,
                                              int(np.max(batch['num_voxels'])))
            for k in self.per_batch:
                k.launches = 0
            yield batch
            for k, each in self.per_batch.items():
                check(k.launches == each, f'eval batch {i}: {k.__name__} '
                      f'launched {k.launches} times, expected {each}')
                self.total[k.__name__] += k.launches


def eval_phase(torch, cfg_file, per_batch):
    """The evaluation main path: ``engine/evaluator.py::eval_one_epoch`` on
    the card over EVAL_SCENES synthetic scenes at EVAL_BATCH, the yaml's
    full width and test cap, random weights from SEED with the dense
    head's class-logit bias 0 (live NMS candidates), after one warm-up
    batch through the same
    eval step. Returns the launches of the run, the annos and the
    dataset."""
    import logging

    from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
    from lidardetection_tpu_torch.datasets.synthetic import build_test_loader
    from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
    from lidardetection_tpu_torch.models import build_network
    from lidardetection_tpu_torch.parallel.train_step import (
        device_batch, make_eval_step,
    )

    cfg = cfg_from_yaml_file(cfg_file)
    classes = list(cfg.CLASS_NAMES)
    post = cfg.MODEL.POST_PROCESSING
    model = build_network(cfg.MODEL, len(classes), dataset_info(cfg.DATA_CONFIG),
                          seed=SEED, class_names=classes).to('cuda')
    zero_class_bias(torch, model)
    _, loader = build_test_loader(cfg, EVAL_BATCH, EVAL_SCENES, seed=SEED + 500)
    make_eval_step(model, post, len(classes))(
        device_batch(next(iter(loader)), 'cuda'))  # warm-up
    torch.cuda.synchronize()
    counted = CountedLoader(loader, per_batch)
    result, annos = eval_one_epoch(model, counted, post, classes,
                                   logging.getLogger('chip_smoke.eval'))
    name = cfg.MODEL.NAME
    recall = {k: v for k, v in result.items() if k.startswith('recall/')}
    live = [a['num_candidates'] for a in annos]
    kept = [len(a['name']) for a in annos]
    print(f'{name} eval: {len(annos)} scenes at B={EVAL_BATCH}, '
          f'sec_per_example {result["sec_per_example"]:.4f} s (host clock, '
          f'voxelizing, forward, NMS and annos), recall {recall}, live NMS '
          f'candidates min / median / max {min(live)} / '
          f'{float(np.median(live)):.1f} / {max(live)}, kept {kept}, Car 3D '
          f'moderate R40 {result["Car_3d/moderate_R40"]:.2f} (random weights)',
          flush=True)
    check(len(annos) == EVAL_SCENES and sorted(int(a['frame_id']) for a in annos)
          == list(range(EVAL_SCENES)), f'{name} eval: one anno per scene')
    check(all(np.isfinite(a['boxes_lidar']).all() and a['boxes_lidar'].shape
              == (len(a['name']), 7) for a in annos), f'{name} eval: finite boxes')
    check(min(live) > 0 and sum(kept) > 0, f'{name} eval: live candidates')
    stages = ('rcnn', 'roi') if cfg.MODEL.get('ROI_HEAD') else ('rcnn',)
    check(sorted(recall) == sorted(f'recall/{k}_{t}' for k in stages
                                   for t in post.RECALL_THRESH_LIST)
          and all(0 <= v <= 1 for v in recall.values()), f'{name} eval: recall')
    check(result['sec_per_example'] > 0 and 'Car_3d/moderate_R40' in result,
          f'{name} eval: the protocol ran')
    return counted.total, annos, counted.dataset


def protocol_phase(evals):
    """The KITTI protocol on this machine (its native host library built by
    the machine's g++ at the start of the run): on each eval run's annos and on perfect predictions (each
    scene's gt as detections, score 1) over PERFECT_SCENES scenes, the
    native path against the numpy plain version: equal result strings and
    dicts (within 1e-9, the JAX package's own bar between them); the
    perfect set reads 100.0 for every class's 3D moderate R40."""
    from lidardetection_tpu_torch import native
    from lidardetection_tpu_torch.datasets.synthetic import kitti_anno_from_lidar

    runs = [(f'{name} eval annos', dataset, annos)
            for name, (dataset, annos) in evals.items()]
    dataset = next(iter(evals.values()))[0]
    perfect = []
    for i in range(PERFECT_SCENES):
        _, boxes, names = dataset.scene(i)
        anno = kitti_anno_from_lidar(boxes, names)
        anno['frame_id'] = i
        perfect.append(anno)
    runs.append((f'perfect predictions, {PERFECT_SCENES} scenes', dataset,
                 perfect))
    classes = list(dataset.class_names)
    for what, ds, annos in runs:
        ms, out = [], []
        for plain in (False, True):
            t0 = time.perf_counter()
            with native.plain_host(plain):
                out.append(ds.evaluation(annos, classes))
            ms.append((time.perf_counter() - t0) * 1e3)
        (s_nat, r_nat), (s_np, r_np) = out
        diff = max(abs(float(r_nat[k]) - float(r_np[k])) for k in r_np)
        print(f'KITTI protocol, {what}: native {ms[0]:.1f} ms, numpy plain '
              f'{ms[1]:.1f} ms, largest result difference {diff:.3g}, Car 3D '
              f'moderate R40 {r_nat["Car_3d/moderate_R40"]:.4f}', flush=True)
        check(s_nat == s_np and list(r_nat) == list(r_np) and diff <= 1e-9,
              f'{what}: native and numpy plain results equal')
    check(all(r_nat[f'{c}_3d/moderate_R40'] == 100.0 for c in classes),
          'perfect predictions read 100.0 for every class')


def precise_bn_phase(torch):
    """``recalibrate_bn_stats`` on the card against the same call on the CPU:
    f32, the reduced PointPillar of the CPU tests (0.64 m pillars, one
    layer a block, narrow filters), the same 3 training batches of 2
    scenes. Every statistics leaf within 1e-3 of its largest magnitude."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
    from lidardetection_tpu_torch.datasets.synthetic import SyntheticScenes
    from lidardetection_tpu_torch.engine.bn_recalibrate import (
        recalibrate_bn_stats,
    )
    from lidardetection_tpu_torch.models import build_network
    from lidardetection_tpu_torch.ops.voxelize import build_batch
    from lidardetection_tpu_torch.parallel.train_step import device_batch

    cfg = cfg_from_yaml_file(CFG)
    data, m = cfg.DATA_CONFIG, cfg.MODEL
    vox = [p for p in data.DATA_PROCESSOR
           if p.NAME == 'transform_points_to_voxels'][0]
    m.COMPUTE_DTYPE = 'float32'
    data.POINT_CLOUD_RANGE = [0, -40.96, -3, 71.68, 40.96, 1]
    vox.VOXEL_SIZE = [0.64, 0.64, 4]
    vox.MAX_NUMBER_OF_VOXELS = {'train': 6000, 'test': 6000}
    m.VFE.NUM_FILTERS = [32]
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.LAYER_NUMS = [1, 1, 1]
    m.BACKBONE_2D.NUM_FILTERS = [32, 32, 64]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [32, 32, 32]
    info = dataset_info(data)
    dataset = SyntheticScenes(cfg.CLASS_NAMES, info['point_cloud_range'],
                               num_scenes=6, seed=SEED + 600)
    batches = []
    for i in range(3):
        scenes = [dataset[2 * i + j] for j in range(2)]
        batch = build_batch([p for p, _ in scenes], info['point_cloud_range'],
                            info['voxel_size'], int(vox.MAX_POINTS_PER_VOXEL),
                            6000)
        batch['gt_boxes'] = np.stack([gt for _, gt in scenes])
        batches.append(batch)
    models = {}
    for dev in ('cuda', 'cpu'):
        model = build_network(m, len(cfg.CLASS_NAMES), info, seed=SEED).to(dev)
        recalibrate_bn_stats(model, batches, lambda b: device_batch(b, dev),
                             n_batches=3)
        models[dev] = model
    worst, n_leaves = 0.0, 0
    card = dict(models['cuda'].named_modules())
    for name, mod in models['cpu'].named_modules():
        for buf in getattr(mod, 'bn_statistics', ()):
            want = getattr(mod, buf)
            got = getattr(card[name], buf).cpu()
            top = float(want.abs().max())
            err = float((got - want).abs().max()) / top
            check(top > 0 and err <= 1e-3, f'precise-BN {name}.{buf} card vs cpu')
            worst, n_leaves = max(worst, err), n_leaves + 1
    check(n_leaves == 20, f'precise-BN: 20 statistics leaves ({n_leaves})')
    print(f'precise-BN card vs cpu (f32, reduced PointPillar, 3 batches of 2): '
          f'{n_leaves} leaves, largest max|card - cpu| / max|cpu| = {worst:.3g} '
          f'(tolerance 1e-3)', flush=True)


def request_kernel_phase(torch, det, points, label, groups, inverse_from=None):
    """K3 against its plain version at every sparse convolution of one
    request of `det` on `points` (the rulebooks and activations of a real
    voxelized scan), in bf16 and f32 (within 1e-4 of the largest output),
    then each layer's time at the request's shape and dtype. `groups`
    names consecutive runs of layers, (name, count), for the print; with
    `inverse_from` the strided layers from that one on are inverse
    convolutions (UNetV2's decoder)."""
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv, rulebook_conv_plain,
    )

    batch = det.make_batch([points])
    records, _ = record_sparse_layers(det.model, lambda: det.forward(batch))
    n_layers = sum(n for _, n in groups)
    check(len(records) == n_layers,
          f'{n_layers} sparse layers in a {label} forward ({len(records)})')
    err = 0.0
    for n, (layer, f, valid, rb) in enumerate(records, 1):
        for dtype in (torch.bfloat16, torch.float32):
            fd = f.to(dtype).contiguous()
            wd = layer.kernel.detach().to(dtype).contiguous()
            got = rulebook_conv(fd, rb.contiguous(), wd, valid.contiguous())
            want = rulebook_conv_plain(fd, rb, wd, valid)
            torch.cuda.synchronize()
            e, top = float((got - want).abs().max()), float(want.abs().max())
            check(top > 0 and e <= 1e-4 * top and bool(torch.isfinite(got).all()),
                  f'{label} layer {n} {dtype}: max error {e} against max|want| {top}')
            err = max(err, e)
    names = [f'{n} (inverse)' if inverse_from and n >= inverse_from
             and not layer.subm else f'{n}'
             for n, (layer, *_) in enumerate(records, 1)]
    rows = [conv_timing(torch, name, f'{label} B=1',
                        f.to(layer.dtype or torch.float32), rb,
                        layer.kernel.detach().to(layer.dtype or torch.float32),
                        valid)
            for name, (layer, f, valid, rb) in zip(names, records)]
    total = {key: sum(r[key] for r in rows)
             for key in ('ms', 'old_flush_ms', 'plain_ms', 'bound_ms')}
    parts, start = [], 0
    for name, count in groups:
        parts.append(f'{name} {count}: '
                     f'{sum(r["ms"] for r in rows[start:start + count]):.4f}')
        start += count
    print(f'rulebook_conv, the {n_layers} launches of a {label} request (bf16 '
          f'and f32 within 1e-4 * max|want| at every layer, largest error '
          f'{err:.3g}): device {total["ms"]:.4f} ms ({", ".join(parts)}), '
          f'plain {total["plain_ms"]:.4f} ms, bound {total["bound_ms"]:.4f} ms',
          flush=True)
    return {'per_request_ms': total['ms'],
            'per_request_old_flush_ms': total['old_flush_ms'],
            'per_request_plain_ms':
            total['plain_ms'], 'per_request_bound_ms': total['bound_ms'],
            'max_abs_err': err, 'layers': rows}


def unet_kernel_phase(torch, det):
    """K3 at the 28 convolutions of a Part-A² request (UNetV2: the
    encoder's 12, the decoder's 16, three of them inverse)."""
    return request_kernel_phase(
        torch, det, make_clouds(det, 1, SEED + 210)[0], 'Part-A2',
        (('encoder', 12), ('decoder', 16)), inverse_from=13)


def parta2_split(torch, det, points, repeats=3):
    """A Part-A² request's forward by module (``forward_split``, with the
    proposal layer, the RoI point sample and the two pools apart), then
    inside it the UNet's encoder and decoder (split where the first UR
    block starts) and the RoI head's masked dense convolutions and its FCs,
    the device drained around each, median of `repeats`."""
    from lidardetection_tpu_torch.models.roi_heads import (
        parta2_head, roi_head_utils,
    )

    med = forward_split(det, points, functions=(
        (roi_head_utils, 'proposal_layer', ['proposal layer']),
        (parta2_head, 'roi_point_sample', ['RoI point sample']),
        (parta2_head, 'roiaware_pool3d',
         ['part pool (avg)', 'feature pool (max)'])))
    unet, head = det.model.backbone_3d, det.model.roi_head
    stamps, spans, hooks = {}, {}, []

    def stamp(name):
        def hook(*_):
            torch.cuda.synchronize()
            stamps[name] = time.perf_counter()
        return hook

    def summed(name, module):
        def before(*_):
            torch.cuda.synchronize()
            stamps[name + ' start'] = time.perf_counter()

        def after(*_):
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() \
                - stamps[name + ' start']
        hooks.extend([module.register_forward_pre_hook(before),
                      module.register_forward_hook(after)])

    hooks += [unet.register_forward_pre_hook(stamp('unet start')),
              unet.blocks[0].register_forward_pre_hook(stamp('decoder start')),
              unet.register_forward_hook(stamp('unet end'))]
    for conv in head.sub_convs:
        summed('RCNN convs', conv)
    for module in (*head.dense, *head.bn, *head.fc_heads):
        summed('RCNN FCs', module)
    runs = []
    try:
        for _ in range(repeats):
            spans.clear()
            det.forward(det.make_batch([points]))
            runs.append({'UNet encoder': stamps['decoder start']
                         - stamps['unet start'],
                         'UNet decoder': stamps['unet end']
                         - stamps['decoder start'], **spans})
    finally:
        for hook in hooks:
            hook.remove()
    inner = {k: float(np.median([r[k] for r in runs])) * 1e3 for k in runs[0]}
    print('Part-A2 forward inside the modules, ms (device drained around '
          'each): ' + ', '.join(f'{k} {v:.2f}' for k, v in inner.items())
          + f'; the RoI head {med["roi_head"]:.2f} = proposal layer '
          f'{med["proposal layer"]:.2f} + point sample '
          f'{med["RoI point sample"]:.2f} + pools '
          f'{med["part pool (avg)"] + med["feature pool (max)"]:.2f} + convs '
          f'{inner["RCNN convs"]:.2f} + FCs {inner["RCNN FCs"]:.2f} + the rest',
          flush=True)
    return {**med, **inner}


def avg_pool_cost(torch, det, points):
    """The avg pool of a real request (Part-A²'s part pool) as the port
    computes it, summed cell by cell in the rows' order (deterministic),
    against the simpler ``index_add_`` of the rows and of their counts,
    which adds in no fixed order on the card: agreement, and the time of
    each as a caller sees it, the forward alone and with its backward."""
    from lidardetection_tpu_torch.models.roi_heads import parta2_head
    from lidardetection_tpu_torch.ops.roi_pool import pool_cells, roiaware_pool3d

    calls = []
    with recorded(parta2_head, 'roiaware_pool3d', calls):
        det.forward(det.make_batch([points]))
    (args, _, _), = [c for c in calls if c[0][5] == 'avg']
    # plain copies: the request's are inference tensors, which autograd
    # does not save for a backward
    pts, feats, rois = (t.clone() for t in args[:3])
    sample, size = tuple(t.clone() for t in args[3]), args[4]

    def index_added(feats):
        ox, oy, oz = size
        idx, _ = sample
        b, r, n = idx.shape
        c, rows = feats.shape[-1], r * ox * oy * oz + 1
        key = (pool_cells(pts, rois, sample, size) + torch.arange(
            b, device=idx.device)[:, None] * rows).reshape(-1)
        g = torch.gather(feats, 1, idx.reshape(b, r * n)[..., None].expand(
            -1, -1, c)).reshape(b * r * n, c)
        total = g.new_zeros((b * rows, c)).index_add(0, key, g)
        count = g.new_zeros(b * rows).index_add_(0, key, torch.ones_like(
            key, dtype=g.dtype))
        return (total / count.clamp(min=1)[:, None]).reshape(b, rows, c)[
            :, :-1].reshape(b, r, ox, oy, oz, c)

    def ported(feats):
        return roiaware_pool3d(pts, feats, rois, sample, size, 'avg')

    want, got = ported(feats), index_added(feats)
    torch.cuda.synchronize()
    e, top = float((got - want).abs().max()), float(want.abs().max())
    check(top > 0 and e <= 1e-5 * top,
          f'avg pool: index_add_ against the port max error {e} (max {top})')
    ct = torch.randn_like(want)
    row = {}
    for name, fn in (('sorted', ported), ('index_add', index_added)):
        leaf = feats.detach().clone().requires_grad_()
        row[f'{name}_ms'] = cuda_ms(lambda: fn(feats), queued=False)
        row[f'{name}_with_backward_ms'] = cuda_ms(
            lambda: torch.autograd.grad((fn(leaf) * ct).sum(), leaf), queued=False)
    print(f'avg pool of a Part-A2 request ({feats.shape[1]} rows of '
          f'{feats.shape[2]} channels, {sample[0].shape[1]} RoIs x '
          f'{sample[0].shape[2]} samples): index_add_ within {e:.3g} of the '
          f'port (max {top:.3g}); the port (sorted, deterministic) '
          f'{row["sorted_ms"]:.4f} ms, with backward '
          f'{row["sorted_with_backward_ms"]:.4f} ms; index_add_ '
          f'{row["index_add_ms"]:.4f} ms, with backward '
          f'{row["index_add_with_backward_ms"]:.4f} ms (as a caller sees it)',
          flush=True)
    return row


def parta2_step_split(torch, trainer, batch):
    """The Part-A² step split, with the proposal layer (its NMS apart), the
    three target assigners, the RoI point sample and the pools timed inside
    the forward."""
    from lidardetection_tpu_torch.models.dense_heads import (
        point_head, target_assigner,
    )
    from lidardetection_tpu_torch.models.roi_heads import (
        parta2_head, roi_head_utils,
    )

    split = step_split(torch, trainer, batch, functions=(
        (target_assigner, 'assign_targets', 'anchor targets'),
        (point_head, 'assign_point_targets', 'point targets'),
        (roi_head_utils, 'proposal_layer', 'proposal layer'),
        (roi_head_utils, 'nms_bev_batched', 'proposal NMS'),
        (roi_head_utils, 'assign_roi_targets', 'RoI targets'),
        (parta2_head, 'roi_point_sample', 'RoI point sample'),
        (parta2_head, 'roiaware_pool3d', 'pools')))
    step = split['forward'] + split['backward'] + split['optimizer']
    print(f'Part-A2 step: {step:.2f} ms split; the proposal layer '
          f'{split["proposal layer"]:.2f} (its NMS {split["proposal NMS"]:.2f}), '
          f'the targets {split["anchor targets"] + split["point targets"] + split["RoI targets"]:.2f}, '
          f'the point sample {split["RoI point sample"]:.2f} and the pools '
          f'{split["pools"]:.2f} ms (forward)', flush=True)
    return split


def step_kernel_phase(torch, trainer, batch, label, n_layers, n_df,
                      df_pairs):
    """At the shapes of a full-width training step on the training plan:
    K4 against its plain version at each of the `n_layers` layers' (f,
    rulebook, g) in bf16 and f32, B = 1 and the step's B, and its time; K3
    against its plain version at each of the step's n_layers + `n_df`
    launches and its time; each df of `df_pairs`, (what, the rulebook K3
    walks for it, the forward rulebook's key), against the plain
    scatter-add over the forward rulebook."""
    from lidardetection_tpu_torch.ops import sparse
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv, rulebook_conv_dw, rulebook_conv_dw_plain,
    )

    layers, calls, convs = record_weight_gradients(trainer, batch)
    check(len(layers) == len(calls) == n_layers
          and len(convs) == n_layers + n_df,
          f'{n_layers} sparse layers, {n_layers} weight gradients and '
          f'{n_layers + n_df} K3 calls ({len(layers)}, {len(calls)}, '
          f'{len(convs)})')
    dfs = convs[n_layers:]
    for what, rb_t, fwd_name in df_pairs:
        (g, _, wb, in_valid), = [c for c in dfs
                                 if c[1].data_ptr() == rb_t.data_ptr()]
        got = rulebook_conv(g, rb_t, wb, in_valid)
        want = sparse._conv_input_grad_plain(
            g, batch[fwd_name], wb.transpose(1, 2), rb_t.shape[1]) \
            * in_valid[..., None]
        torch.cuda.synchronize()
        e, top = float((got - want).abs().max()), float(want.abs().max())
        print(f'{what} df ({str(g.dtype)[6:]}, V {rb_t.shape[1]} <- '
              f'{g.shape[1]}, K={wb.shape[0]}): max|K3 - scatter-add over '
              f'{fwd_name}| = {e:.3g} (max|want| {top:.3g}, tolerance 1e-4 * '
              f'max)', flush=True)
        check(top > 0 and e <= 1e-4 * top, f'{what} df on K3')

    err, shapes = 0.0, []
    b_step = batch['voxels'].shape[0]
    for n, ((layer, _, valid, _), (f, rb, g)) in enumerate(zip(layers, calls), 1):
        check((rb.shape[2], f.shape[2], g.shape[2]) == tuple(layer.kernel.shape),
              f'{label} layer {n}: the recorded gradient belongs to it')
        for dtype in (torch.bfloat16, torch.float32):
            fd, gd = f.to(dtype), g.to(dtype)
            for b in (1, b_step):
                args = (fd[:b].contiguous(), rb[:b].contiguous(),
                        gd[:b].contiguous())
                got = rulebook_conv_dw(*args)
                want = rulebook_conv_dw_plain(*args)
                torch.cuda.synchronize()
                e, top = float((got - want).abs().max()), float(want.abs().max())
                check(top > 0 and e <= 1e-4 * top and bool(torch.isfinite(got).all()),
                      f'rulebook_conv_dw {label} layer {n} B={b} {dtype}: max '
                      f'error {e} against max|want| {top}')
                err = max(err, e)
        k, c_in, c_out = layer.kernel.shape
        live, hits, n_bytes, n_flop = dw_work(torch, f, rb, g, valid)
        rate = BF16_FLOP_PER_S if f.dtype == torch.bfloat16 else F32_FLOP_PER_S
        row = {'layer': n, 'K': k, 'C_in': c_in, 'C_out': c_out,
               'live_rows': live, 'hits': hits, 'bytes': n_bytes,
               'ms': cuda_ms(lambda: rulebook_conv_dw(f, rb, g)),
               'old_flush_ms': cuda_ms(lambda: rulebook_conv_dw(f, rb, g),
                                       flush='dirty'),
               'plain_ms': cuda_ms(lambda: rulebook_conv_dw_plain(f, rb, g), iters=5, warmup=1)}
        row['bound_ms'], row['bound_by'] = bound_ms(n_bytes, n_flop, rate)
        shapes.append(row)
    k4 = {key: sum(r[key] for r in shapes) for key in ('ms', 'old_flush_ms', 'plain_ms',
                                                       'bound_ms')}
    print(f'rulebook_conv_dw, the {n_layers} launches of a {label} step '
          f'(B={b_step}; bf16 and f32, B=1 and B={b_step} within 1e-4 * '
          f'max|want| at every layer, largest error {err:.3g}): device '
          f'{k4["ms"]:.4f} ms, plain {k4["plain_ms"]:.4f} ms, bound '
          f'{k4["bound_ms"]:.4f} ms; per layer '
          + ', '.join(f'{r["layer"]}:{r["ms"]:.4f}' for r in shapes), flush=True)

    names = [f'forward {n}' for n in range(1, n_layers + 1)] + \
        [f'df {n}' for n in range(1, n_df + 1)]
    rows = [conv_timing(torch, name, f'{label} step B={f.shape[0]}', f, rb, w,
                        valid) for name, (f, rb, w, valid) in zip(names, convs)]
    k3 = {key: sum(r[key] for r in rows) for key in ('ms', 'old_flush_ms', 'plain_ms',
                                                     'bound_ms')}
    print(f'rulebook_conv, the {n_layers + n_df} launches of a {label} step '
          f'(B={b_step}): device {k3["ms"]:.4f} ms ({n_layers} forward '
          f'{sum(r["ms"] for r in rows[:n_layers]):.4f}, {n_df} df '
          f'{sum(r["ms"] for r in rows[n_layers:]):.4f}), plain '
          f'{k3["plain_ms"]:.4f} ms, bound {k3["bound_ms"]:.4f} ms', flush=True)
    return ({'per_step_ms': k4['ms'], 'per_step_plain_ms': k4['plain_ms'],
             'per_step_old_flush_ms': k4['old_flush_ms'],
             'per_step_bound_ms': k4['bound_ms'], 'max_abs_err': err,
             'layers': shapes},
            {'per_step_ms': k3['ms'], 'per_step_plain_ms': k3['plain_ms'],
             'per_step_old_flush_ms': k3['old_flush_ms'],
             'per_step_bound_ms': k3['bound_ms'], 'step_layers': rows})


def strided_df_pairs(batch, names):
    """Each strided layer's df: K3 over ``rb_<name>_bwd`` against the
    scatter-add over ``rb_<name>``."""
    return [(f'strided {name}', batch[f'rb_{name}_bwd'], f'rb_{name}')
            for name in names]


def unet_gradient_phase(torch, trainer, batch):
    """A Part-A² step (B = 2): 28 layers, 27 df (the inverse
    convolutions' over the paired strided layer's forward rulebook
    ``rb_down<n>``, W[k]^T; the strided layers' over ``rb_<name>_bwd``)."""
    pairs = [(f'inverse {n}', batch[f'rb_down{n}'], f'rb_inv{n}')
             for n in (4, 3, 2)] + \
        strided_df_pairs(batch, ('down2', 'down3', 'down4', 'out'))
    return step_kernel_phase(torch, trainer, batch, 'Part-A2', 28, 27, pairs)


def pointrcnn_kernel_phase(torch, det):
    """K5 at PointRCNN's two shapes against its plain version on the card,
    bit for bit: the (table, runs, centres) of the two MSG levels of a
    real request (16384 sources and 4096 centres at radii (0.1, 0.5); 4096
    and 1024 at (0.5, 1.0); nsample (16, 32)) at B = 1 and at B = 2, and
    with a third of the centres invalid; then its time at each level of a
    request beside its bound and its plain version's. Returns the rows and
    the largest error."""
    clouds = make_clouds(det, 2, SEED + 900)
    one, _ = record_ball_selects(lambda: det.forward(det.make_batch(clouds[:1])))
    two, _ = record_ball_selects(lambda: det.forward(det.make_batch(clouds)))
    check(len(one) == len(two) == 2, f'two K5 calls a request ({len(one)})')
    levels = ('SA level 1', 'SA level 2')
    errs = []
    for level, args_1, args_2 in zip(levels, one, two):
        errs.append(select_held(torch, args_1, f'PointRCNN {level} B=1')[0])
        errs.append(select_held(torch, args_2, f'PointRCNN {level} B=2')[0])
        xyz, orig, start, end, centers, *static = args_1
        third = (torch.arange(start.shape[1], device='cuda') % 3 == 0)[
            None, :, None]
        errs.append(select_held(
            torch, (xyz, orig, start,
                    torch.where(third, start, end).contiguous(), centers,
                    *static),
            f'PointRCNN {level}, a third of the centres invalid')[0])
    rows = select_timings(torch, zip(levels, one))
    print(f'ball_select, the 2 launches of a PointRCNN request: device '
          f'{sum(r["ms"] for r in rows):.4f} ms, plain '
          f'{sum(r["plain_ms"] for r in rows):.4f} ms, bound '
          f'{sum(r["bound_ms"] for r in rows):.5f} ms', flush=True)
    return rows, max(errs)


def pointrcnn_split(torch, det, points):
    """A PointRCNN request's forward by module (``forward_split``): the 4
    set abstraction and 4 feature propagation levels of the backbone, the
    point head, and in the RoI head the proposal layer, the RoI point pool,
    its 3 set abstraction levels and its FCs, the device drained around
    each."""
    from lidardetection_tpu_torch.models.roi_heads import (
        pointrcnn_head, roi_head_utils,
    )

    backbone, head = det.model.backbone_3d, det.model.roi_head
    levels = [(f'SA{i + 1}', m) for i, m in enumerate(backbone.sa_layers)]
    # fp_layers.0 is the deepest: level 4 onto level 3
    fps = [(f'FP{4 - i}', m) for i, m in enumerate(backbone.fp_layers)]
    roi_sa = [(f'RoI SA{i + 1}', m) for i, m in enumerate(head.sa_layers)]
    med = forward_split(det, points,
        modules=levels + fps + roi_sa + [('RoI FCs', m) for m in head.fc_heads],
        functions=((roi_head_utils, 'proposal_layer', ['proposal layer']),
                   (pointrcnn_head, 'roipoint_pool3d', ['RoI pool'])))
    sa = sum(med[k] for k, _ in levels)
    fp = sum(med[k] for k, _ in fps)
    roi = sum(med[k] for k, _ in roi_sa)
    print(f'PointRCNN forward: backbone {med["backbone_3d"]:.2f} ms = SA '
          f'{sa:.2f} + FP {fp:.2f} + the rest '
          f'{med["backbone_3d"] - sa - fp:.2f}; point head '
          f'{med["point_head"]:.2f}; RoI head {med["roi_head"]:.2f} = proposal '
          f'layer {med["proposal layer"]:.2f} + RoI pool {med["RoI pool"]:.2f} + '
          f'RoI SA {roi:.2f} + FCs {med["RoI FCs"]:.2f} + the rest '
          f'{med["roi_head"] - med["proposal layer"] - med["RoI pool"] - roi - med["RoI FCs"]:.2f}',
          flush=True)
    return med


def pointrcnn_step_split(torch, trainer, batch):
    """The PointRCNN step split, with the point targets, the proposal layer
    (its NMS apart), the RoI targets and the RoI point pool timed inside the
    forward."""
    from lidardetection_tpu_torch.models.dense_heads import point_head
    from lidardetection_tpu_torch.models.roi_heads import (
        pointrcnn_head, roi_head_utils,
    )

    split = step_split(torch, trainer, batch, functions=(
        (point_head, 'assign_point_targets', 'point targets'),
        (roi_head_utils, 'proposal_layer', 'proposal layer'),
        (roi_head_utils, 'nms_bev_batched', 'proposal NMS'),
        (roi_head_utils, 'assign_roi_targets', 'RoI targets'),
        (pointrcnn_head, 'roipoint_pool3d', 'RoI pool')))
    step = split['forward'] + split['backward'] + split['optimizer']
    print(f'PointRCNN step: {step:.2f} ms split; the proposal layer '
          f'{split["proposal layer"]:.2f} (its NMS {split["proposal NMS"]:.2f}), '
          f'the targets {split["point targets"] + split["RoI targets"]:.2f}, '
          f'the RoI pool {split["RoI pool"]:.2f} ms (forward)', flush=True)
    return split


def write_data_trees(root):
    """The data phase's dataset trees under `root`, timed: a KITTI tree
    (KITTI_TRAIN + KITTI_VAL frames of an HDL-64E scan, labels with a
    DontCare line, calib, PNGs, planes) with the infos and gt database of
    ``create_kitti_infos``, and a NuScenes tree (NUSCENES_TRAIN +
    NUSCENES_VAL key frames of an HDL-32E scan with 9 sweeps each, gt with
    velocities) with its gt database. Returns the two roots."""
    import os

    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.datasets import synthetic_trees
    from lidardetection_tpu_torch.datasets.kitti.kitti_dataset import (
        create_kitti_infos,
    )
    from lidardetection_tpu_torch.datasets.nuscenes.nuscenes_dataset import (
        NuScenesDataset,
    )

    kitti, nuscenes = root / 'kitti', root / 'nuscenes'
    t0 = time.perf_counter()
    synthetic_trees.write_kitti_tree(kitti, KITTI_TRAIN, KITTI_VAL, seed=SEED)
    points = [len(np.fromfile(f, np.float32)) // 4
              for f in sorted((kitti / 'training' / 'velodyne').iterdir())]
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(None):  # a line per frame and object
        create_kitti_infos(
            cfg_from_yaml_file('tools/cfgs/dataset_configs/kitti_dataset.yaml'),
            ['Car', 'Pedestrian', 'Cyclist'], kitti, kitti,
            workers=os.cpu_count() or 1)
    t2 = time.perf_counter()
    print(f'KITTI tree: {KITTI_TRAIN} train and {KITTI_VAL} val frames of '
          f'{min(points)}-{max(points)} returns written in {t1 - t0:.2f} s; '
          f'create_kitti_infos (infos and gt database) {t2 - t1:.2f} s',
          flush=True)
    base = synthetic_trees.write_nuscenes_tree(
        nuscenes, NUSCENES_TRAIN, NUSCENES_VAL, sweeps=NUSCENES_SWEEPS - 1,
        seed=SEED)
    sweep = len(np.fromfile(next((base / 'sweeps' / 'LIDAR_TOP').iterdir()),
                            np.float32)) // 5
    t3 = time.perf_counter()
    cfg = cfg_from_yaml_file(CFG_CBGS_SECOND)
    with contextlib.redirect_stdout(None):
        NuScenesDataset(cfg.DATA_CONFIG, None, training=True,
                        root_path=nuscenes).create_groundtruth_database(
            np.random.RandomState(SEED), max_sweeps=NUSCENES_SWEEPS)
    t4 = time.perf_counter()
    print(f'NuScenes tree: {NUSCENES_TRAIN} train and {NUSCENES_VAL} val key '
          f'frames with {NUSCENES_SWEEPS - 1} sweeps each ({sweep} returns in '
          f'a sweep) written in {t3 - t2:.2f} s; its gt database '
          f'{t4 - t3:.2f} s', flush=True)
    return kitti, nuscenes


def loader_train_phase(torch, trainer, name, batches, per_step, warmup, steps):
    """The training main path fed by the loader: `warmup` + `steps`
    optimizer steps, each on the next batch of the loader's iterator
    `batches` (forked workers build them ahead); every launch count set to
    0 just before each step and read just after. The warm-up takes at
    least the batches the workers were sent when the iterator started
    (workers x PREFETCH), so the timed steps read the loader at its steady
    state. Per timed step, on the host clock: the wait for the batch, its
    copy to the card (device drained after it) and the step (device
    drained). Returns the launches of the timed steps, the timings and the
    last batch on the card."""
    from lidardetection_tpu_torch.parallel.train_step import device_batch

    total = {k.__name__: 0 for k in per_step}
    rows = []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        on_card = device_batch(batch, 'cuda')
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for k in per_step:
            k.launches = 0
        tb = trainer.step(on_card)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        terms = {k: float(v) for k, v in tb.items()}
        counts = {k.__name__: k.launches for k in per_step}
        timed = i >= warmup
        if i == 0 or i == warmup:
            print(f'{name} step {i} from the loader'
                  f'{"" if timed else " (warm-up)"}: loss {terms["loss"]:.4f}, '
                  f'frames {batch["frame_id"].tolist()}, gt '
                  f'{(batch["gt_boxes"][..., -1] > 0).sum(1).tolist()}, voxels '
                  f'{batch["num_voxels"].tolist()}, launches {counts}',
                  flush=True)
        check(all(np.isfinite(v) for v in terms.values()),
              f'{name} step {i} from the loader: finite loss terms')
        check(finite_gradients(torch, trainer.model),
              f'{name} step {i} from the loader: finite gradients')
        for k, each in per_step.items():
            check(k.launches == each, f'{name} step {i} from the loader: '
                  f'{k.__name__} launched {k.launches} times, expected {each}')
        rows.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                     (t3 - t0) * 1e3))
        if timed:
            for key, n in counts.items():
                total[key] += n
    warm, timed_rows = rows[:warmup], rows[warmup:]
    print(f'{name} from the loader, wait / copy / step ms a step (host clock):'
          f' warm-up {[round(r[0], 1) for r in warm]} / '
          f'{[round(r[1], 1) for r in warm]} / {[round(r[2], 1) for r in warm]};'
          f' timed {[round(r[0], 1) for r in timed_rows]} / '
          f'{[round(r[1], 1) for r in timed_rows]} / '
          f'{[round(r[2], 1) for r in timed_rows]}', flush=True)
    wait, copy, step, whole = (float(np.median(c)) for c in zip(*timed_rows))
    return total, {'warmup': warmup, 'steps': steps, 'p50_wait_ms': wait,
                   'mean_wait_ms': float(np.mean([r[0] for r in timed_rows])),
                   'p50_copy_ms': copy, 'p50_step_ms': step,
                   'p50_iteration_ms': whole,
                   'mean_iteration_ms': float(np.mean(
                       [r[3] for r in timed_rows]))}, on_card


def quiet_step_ms(torch, trainer, on_card, repeats=3):
    """The step alone on a batch already on the card, with no loader worker
    alive: p50 of `repeats` (host clock, device drained), beside the same
    step taken while the workers build batches."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        trainer.step(on_card)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def eval_kernels_held(torch, step, batch):
    """K1 and K2 on one bucketed eval batch from the loader: the eval step
    run with their wrappers recorded, then each recorded call held against
    its plain version on the card (K1 in bf16 and f32, K2 at the call's
    dtype): the same bits required. Returns max|kernel - plain| of each,
    by the wrapper's name."""
    from lidardetection_tpu_torch.models.backbones_2d import map_to_bev
    from lidardetection_tpu_torch.models.backbones_3d import vfe
    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows_plain
    from lidardetection_tpu_torch.parallel.train_step import device_batch

    k1_calls, k2_calls = [], []
    with recorded(vfe, 'pillar_vfe', k1_calls), \
            recorded(map_to_bev, 'scatter_rows', k2_calls):
        step(device_batch(batch, 'cuda'))
    check(len(k1_calls) == 1 and len(k2_calls) == 1,
          f'eval batch from the loader: {len(k1_calls)} K1 and '
          f'{len(k2_calls)} K2 calls, expected 1 each')
    (vox, centers, pb, counts, w4, shift), _, _ = k1_calls[0]
    e1 = vfe_held(torch, f'eval batch from the loader (V={vox.shape[1]}, '
                  f'{int((counts > 0).sum())} live)', vox, centers, pb,
                  counts, w4, shift)
    args, _, got = k2_calls[0]
    want = scatter_rows_plain(*args)
    e2 = float((got.float() - want.float()).abs().max())
    print(f'K2 scatter_rows, eval batch from the loader ({tuple(args[0].shape)}'
          f' rows into {args[2]} slots): max|kernel-plain| = {e2} (bit-exact '
          f'required: {torch.equal(got, want)})', flush=True)
    check(torch.equal(got, want), 'scatter_rows on the eval batch from the '
          'loader bit-exact')
    return {'pillar_vfe': e1, 'scatter_rows': e2}


def batch_build_ms(loader, repeats=3):
    """The host time of one batch as a worker builds it (its samples
    through ``prepare_data``, then the collate), in this process, median
    of `repeats`."""
    dataset, size = loader.dataset, loader.sampler.batch_size
    times = []
    for r in range(repeats):
        t0 = time.perf_counter()
        loader.collate([dataset[(r * size + j) % len(dataset)]
                        for j in range(size)])
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def step_kernels_held(torch, trainer, batch, label, n_k3, n_k4, n_k5=0):
    """Every kernel launch of one training step's forward and backward on
    `batch` (the trainer's own precision), each held against its plain
    version on the same inputs on the card: K3 (forward and df) and K4
    within 1e-4 of max|want|, as the step kernel phases hold them, K2 and
    K5 (`n_k5` calls: the point ops of a two-stage detector) bit for bit.
    Returns max|kernel - plain| of each, by the wrapper's name."""
    from lidardetection_tpu_torch.ops import sparse
    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows_plain
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv, rulebook_conv_dw, rulebook_conv_dw_plain,
        rulebook_conv_plain,
    )

    k2_calls = []
    with recorded(sparse, 'scatter_rows', k2_calls):
        k5_calls, (_, dws, convs) = record_ball_selects(
            lambda: record_weight_gradients(trainer, batch))
    check(len(convs) == n_k3 and len(dws) == n_k4 and len(k2_calls) == 1
          and len(k5_calls) == n_k5,
          f'{label} step: {len(convs)} K3, {len(dws)} K4, {len(k2_calls)} '
          f'K2 and {len(k5_calls)} K5 calls, expected {n_k3}, {n_k4}, 1 and '
          f'{n_k5}')
    errors = {}
    for i, args in enumerate(k5_calls):
        e, _ = select_held(torch, args, f'call {i} of a {label} step on a '
                           'loader batch')
        errors['ball_select'] = max(errors.get('ball_select', 0.0), e)
    for name, calls, kernel, plain in (
            ('rulebook_conv', convs, rulebook_conv, rulebook_conv_plain),
            ('rulebook_conv_dw', dws, rulebook_conv_dw, rulebook_conv_dw_plain)):
        worst, share = 0.0, 0.0
        for i, args in enumerate(calls):
            with torch.no_grad():
                got, want = kernel(*args), plain(*args)
            e, top = float((got - want).abs().max()), float(want.abs().max())
            check(top > 0 and e <= 1e-4 * top and bool(torch.isfinite(got).all()),
                  f'{name} call {i} of a {label} step: max error {e} against '
                  f'plain (max|want| {top})')
            worst, share = max(worst, e), max(share, e / top)
        errors[name] = worst
        print(f'{name}, the {len(calls)} calls of a {label} step on a loader '
              f'batch ({str(calls[0][0].dtype)[6:]}): max|kernel-plain| '
              f'{worst:.3g}, at most {share:.3g} of the call\'s max|want| '
              f'(tolerance 1e-4)', flush=True)
    args, _, got = k2_calls[0]
    want = scatter_rows_plain(*args)
    errors['scatter_rows'] = float((got.float() - want.float()).abs().max())
    check(torch.equal(got, want), f'scatter_rows of a {label} step on a '
          'loader batch bit-exact')
    print(f'scatter_rows of a {label} step on a loader batch: bit-exact',
          flush=True)
    return errors


def data_layer_phase(torch, wrappers, root):
    """Training and evaluation from dataset trees on disk through
    ``datasets.build_dataloader`` (forked workers, min(8, cores) of them).
    PointPillar evaluates the KITTI val split, bucketed, through the KITTI
    protocol (1 K1, 1 K2 a batch; K1 and K2 held against their plain
    versions on one of its batches). The CBGS SECOND multi-head trains
    from the NuScenes tree with CBGS (37 K3, 19 K4, 1 K2 a step; each
    kernel call of a step on its first batch held against the plain
    version on the same inputs) and evaluates its val frames through
    ``_kitti_style_eval`` (19 K3, 1 K2 a batch). SECOND (second.yaml,
    bf16, B = 4) trains from the KITTI tree last (23 K3, 12 K4, 1 K2 a
    step; one f32 step on its first batch, kernels against the plain
    versions on the card and on the CPU). Each training run warms up on the batches its
    workers were sent at the start (workers x PREFETCH) before the timed
    steps. Returns the launches of each run, the largest K1 and K2 error
    against the plain versions, the SECOND run's trainer and batch
    iterator (warm-up + PROFILED_STEPS batches left) for the profiler,
    and the warm-up's length."""
    import logging
    import os

    from lidardetection_tpu_torch.config import cfg_from_yaml_file, dataset_info
    from lidardetection_tpu_torch.datasets import PREFETCH, build_dataloader
    from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
    from lidardetection_tpu_torch.models import build_network
    from lidardetection_tpu_torch.parallel.train_step import (
        device_batch, make_eval_step,
    )
    from lidardetection_tpu_torch.train import Trainer

    cores = os.cpu_count() or 1
    workers = min(8, cores)
    print(f'host: os.cpu_count() {cores}, loader workers {workers}', flush=True)
    kitti, nuscenes = write_data_trees(root)
    logger = logging.getLogger('chip_smoke.data')
    runs, loader_json = {}, {'cpu_count': cores, 'workers': workers}

    print('-- PointPillar evaluation from the KITTI tree --', flush=True)
    pcfg = cfg_from_yaml_file(CFG)
    classes = list(pcfg.CLASS_NAMES)
    model = build_network(pcfg.MODEL, len(classes), dataset_info(pcfg.DATA_CONFIG),
                          seed=SEED, class_names=classes).to('cuda')
    zero_class_bias(torch, model)
    _, test_loader = build_dataloader(
        pcfg.DATA_CONFIG, classes, EVAL_BATCH, training=False, root_path=kitti,
        workers=workers, logger=logger, model_cfg=pcfg.MODEL, seed=SEED)
    step = make_eval_step(model, pcfg.MODEL.POST_PROCESSING, len(classes))
    batch = next(iter(test_loader))
    step(device_batch(batch, 'cuda'))  # warm-up
    errors = eval_kernels_held(torch, step, batch)
    torch.cuda.synchronize()
    counted = CountedLoader(test_loader, dict(zip(wrappers, (1, 1, 0, 0, 0))))
    result, annos = eval_one_epoch(model, counted, pcfg.MODEL.POST_PROCESSING,
                                   classes, logger)
    runs['PointPillar eval from files'] = counted.total
    cap = int(pcfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS['test'])
    print(f'PointPillar eval from files: {len(annos)} val frames at B='
          f'{EVAL_BATCH}, sec_per_example {result["sec_per_example"]:.4f} s '
          f'(host clock), largest num_voxels {counted.largest_num_voxels} of '
          f'the {cap} cap, Car 3D moderate R40 '
          f'{result["Car_3d/moderate_R40"]:.2f} (random weights), recall '
          f'{ {k: v for k, v in result.items() if k.startswith("recall/")} }',
          flush=True)
    check([a['frame_id'] for a in annos] ==
          [f'{i:06d}' for i in range(KITTI_TRAIN, KITTI_TRAIN + KITTI_VAL)],
          'PointPillar eval from files: one anno per val frame')
    check(0 < counted.largest_num_voxels < cap,
          'PointPillar eval from files: the test cap is not saturated')
    check(all(np.isfinite(a['boxes_lidar']).all() for a in annos)
          and 'Car_3d/moderate_R40' in result,
          'PointPillar eval from files: finite boxes, the protocol ran')
    loader_json['PointPillar eval'] = {
        'sec_per_example': result['sec_per_example'],
        'largest_num_voxels': counted.largest_num_voxels}
    del model, step

    print('-- CBGS SECOND multi-head from the NuScenes tree --', flush=True)
    ctrainer = Trainer(CFG_CBGS_SECOND, device='cuda', seed=SEED,
                       total_steps=1000)
    ccfg = ctrainer.cfg
    cclasses = list(ccfg.CLASS_NAMES)
    warmup = workers * PREFETCH
    n_batches = 1 + warmup + CBGS_LOADER_STEPS
    cdataset, cloader = build_dataloader(
        ccfg.DATA_CONFIG, cclasses, TRAIN_BATCH, training=True,
        root_path=nuscenes, workers=workers, logger=logger,
        model_cfg=ccfg.MODEL, merge_all_iters_to_one_epoch=True,
        total_epochs=-(-n_batches * TRAIN_BATCH // NUSCENES_TRAIN), seed=SEED)
    print(f'CBGS: {NUSCENES_TRAIN} train frames resampled to '
          f'{len(cdataset.infos)} a pass', flush=True)
    check(len(cdataset.infos) > NUSCENES_TRAIN and len(cloader) >= n_batches,
          f'CBGS resampled the train frames; {len(cloader)} batches')
    build = batch_build_ms(cloader, repeats=1)  # no worker alive yet
    t0 = time.perf_counter()
    cbatches = iter(cloader)
    first = next(cbatches)
    startup = (time.perf_counter() - t0) * 1e3
    for name, e in step_kernels_held(
            torch, ctrainer, device_batch(first, 'cuda'),
            'CBGS SECOND multi-head', 19 + 18, 19).items():
        errors[name] = max(errors.get(name, 0.0), e)
    whole_step_phase(torch, ctrainer, CFG_CBGS_SECOND,
                     device_batch(first, 'cuda'), wrappers,
                     'CBGS SECOND multi-head')
    launches, timing, on_card = loader_train_phase(
        torch, ctrainer, 'CBGS SECOND multi-head', cbatches,
        dict(zip(wrappers, (0, 1, 19 + 18, 19, 0))), warmup, CBGS_LOADER_STEPS)
    cbatches.close()  # the workers end
    quiet = quiet_step_ms(torch, ctrainer, on_card)
    runs['CBGS SECOND multi-head training from files'] = launches
    timing.update({'first_batch_ms': startup, 'batch_build_ms': build,
                   'step_without_workers_ms': quiet})
    loader_json['CBGS SECOND multi-head'] = timing
    print(f'CBGS SECOND from files, {CBGS_LOADER_STEPS} steps after {warmup} '
          f'of warm-up: iteration p50 {timing["p50_iteration_ms"]:.2f} ms '
          f'(mean {timing["mean_iteration_ms"]:.2f}) = wait on the loader '
          f'{timing["p50_wait_ms"]:.2f} ms (mean {timing["mean_wait_ms"]:.2f})'
          f' + copy {timing["p50_copy_ms"]:.2f} ms + step '
          f'{timing["p50_step_ms"]:.2f} ms; the same step with no worker '
          f'alive {quiet:.2f} ms; a batch of {TRAIN_BATCH} built in one '
          f'process {build:.2f} ms; the first batch {startup:.2f} ms',
          flush=True)
    zero_class_bias(torch, ctrainer.model)
    _, ctest = build_dataloader(
        ccfg.DATA_CONFIG, cclasses, NUSCENES_VAL, training=False,
        root_path=nuscenes, workers=workers, logger=logger,
        model_cfg=ccfg.MODEL, seed=SEED)
    counted = CountedLoader(ctest, dict(zip(wrappers, (0, 1, 19, 0, 0))))
    result, annos = eval_one_epoch(ctrainer.model, counted,
                                   ccfg.MODEL.POST_PROCESSING, cclasses, logger)
    runs['CBGS SECOND multi-head eval from files'] = counted.total
    ap = {k: round(float(v), 4) for k, v in result.items()
          if k.endswith('moderate_R40')}
    print(f'CBGS SECOND eval from files (_kitti_style_eval): {len(annos)} val '
          f'frames, sec_per_example {result["sec_per_example"]:.4f} s, '
          f'largest num_voxels {counted.largest_num_voxels}, moderate R40 AP '
          f'keys {ap}', flush=True)
    check(len(annos) == NUSCENES_VAL and {
        'Car_3d/moderate_R40', 'Truck_3d/moderate_R40',
        'Pedestrian_3d/moderate_R40'} <= set(ap),
        'CBGS SECOND eval from files: the KITTI protocol over car, truck '
        'and pedestrian')
    del ctrainer, on_card

    print('-- SECOND training from the KITTI tree --', flush=True)
    trainer = Trainer(CFG_SECOND, device='cuda', seed=SEED, total_steps=1000)
    cfg = trainer.cfg
    n_batches = 1 + 2 * warmup + LOADER_STEPS + PROFILED_STEPS
    _, loader = build_dataloader(
        cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), TRAIN_BATCH, training=True,
        root_path=kitti, workers=workers, logger=logger, model_cfg=cfg.MODEL,
        merge_all_iters_to_one_epoch=True,
        total_epochs=-(-n_batches * TRAIN_BATCH // KITTI_TRAIN), seed=SEED)
    check(len(loader) >= n_batches and loader.num_workers == workers,
          f'SECOND loader: {len(loader)} batches, {loader.num_workers} workers')
    build = batch_build_ms(loader)  # no worker alive yet
    t0 = time.perf_counter()
    batches = iter(loader)
    first = next(batches)
    startup = (time.perf_counter() - t0) * 1e3
    check(any(k.startswith('rb_') for k in first) and 'points' not in first,
          'SECOND loader batches carry the host plan and no raw points')
    compare_train_phase(torch, trainer, CFG_SECOND, device_batch(first, 'cuda'),
                        wrappers)
    launches, timing, _ = loader_train_phase(
        torch, trainer, 'SECOND', batches,
        dict(zip(wrappers, (0, 1, 12 + 11, 12, 0))), warmup, LOADER_STEPS)
    runs['SECONDNet training from files'] = launches
    timing.update({'first_batch_ms': startup, 'batch_build_ms': build})
    loader_json['SECONDNet'] = timing
    print(f'SECOND from files, {LOADER_STEPS} steps after {warmup} of '
          f'warm-up: iteration p50 {timing["p50_iteration_ms"]:.2f} ms (mean '
          f'{timing["mean_iteration_ms"]:.2f}) = wait on the loader '
          f'{timing["p50_wait_ms"]:.2f} ms (mean {timing["mean_wait_ms"]:.2f})'
          f' + copy {timing["p50_copy_ms"]:.2f} ms + step '
          f'{timing["p50_step_ms"]:.2f} ms (host clock); a batch of '
          f'{TRAIN_BATCH} built in one process {build:.2f} ms; the first '
          f'batch (workers forked) {startup:.2f} ms', flush=True)
    print(json.dumps({'loader': loader_json}), flush=True)
    return runs, errors, trainer, batches, warmup


def rounding_units(torch, kernel, plain, args, n_terms):
    """A kernel call against its plain version in units of float32
    rounding: max |kernel - plain| / (eps x sum of |terms|) over the
    outputs (the sum of |terms| is the plain version on |inputs|), beside
    sqrt(n_terms), the size of a correct summation's error in those
    units (a wrong row or offset reads as ~1 / eps of them)."""
    with torch.no_grad():
        got, want = kernel(*args), plain(*args)
        scale = plain(*(a.abs() if torch.is_tensor(a) and a.is_floating_point()
                        else a for a in args))
    err = (got - want).abs()
    return float((err / (2.0 ** -24 * scale).clamp(min=1e-30)).max()), \
        n_terms ** 0.5


def rule_reading(rule):
    """A ``float64_rule`` reading in words: the leaves within it, the
    tightest one with its distance and what it allows."""
    from lidardetection_tpu_torch.tools.step_precision import broken_leaves

    worst = max(rule, key=lambda k: rule[k][0] / max(rule[k][1], 1e-300))
    return (f'{len(rule) - len(broken_leaves(rule))} of {len(rule)} leaves '
            f'within the rule, the tightest {worst} ({rule[worst][0]:.3g} of '
            f'{rule[worst][1]:.3g} allowed)')


def whole_step_phase(torch, trainer, cfg_file, batch, wrappers, label):
    """The whole f32 step with the kernels against the plain f32 step and
    a float64 step, on the first two scenes of `batch` with the trainer's
    weights (``tools/step_precision.py``). The float64 step runs in
    float64 from end to end (weights, sparse convolutions, BatchNorm
    statistics, the heads' outputs and the losses; the anchor targets
    assigned in float32 as the f32 steps assign them).

    Held: every K3 and K4 call of the kernels' step within sqrt(terms)
    units of eps x sum|terms| of its plain version (``rounding_units``: a
    correct sum in another order; a wrong row or offset reads as ~1/eps);
    the loss within 1e-6 of the plain step's; no operation of the float64
    step rounds a float64 value to float32 (``Float32Audit``), and its
    anchor labels equal the f32 steps'; and ``float64_rule`` (each leaf's
    distance from the float64 step within 3 x the plain f32 step's, plus
    4 float32 ulps of the leaf's largest entry) in every leaf of the
    kernels' step against the plain step, both on the float64 step's ReLU
    branch (``ReluBranch``: each ReLU keeps the float64 step's sign
    pattern; the entries whose own f32 sign differs are counted).

    Read: the same rule on the free f32 steps, where a few hundred ReLU
    entries within rounding of 0 take the other side and the leaves
    behind them jump (ROADMAP section 3); on the plain step summed in the
    three orders of ``REORDERINGS``; on both steps with only the
    BatchNorm statistics in float64 (``float64_batch_statistics``); and
    the layer walk over the sparse, 2D backbone and head layers
    (``first_parting_layer``: each layer's output and the gradient
    reaching it, the first where the kernels' distance from the float64
    step exceeds 3 x the plain step's)."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.models.backbones_3d.spconv_backbone import (
        SparseConvLayer,
    )
    from lidardetection_tpu_torch.models.layers import ConvBNReLU
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv, rulebook_conv_dw, rulebook_conv_dw_plain,
        rulebook_conv_plain,
    )
    from lidardetection_tpu_torch.parallel.train_step import step_draw
    from lidardetection_tpu_torch.tools import step_precision as sp
    from lidardetection_tpu_torch.train import Trainer
    from lidardetection_tpu_torch.utils.precision import full_f32

    cfg = cfg_from_yaml_file(cfg_file)
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    twin = Trainer(cfg, device='cuda', state_dict=state, total_steps=4,
                   seed=trainer.seed)
    part = {k: v[:2] for k, v in batch.items()}
    # the layer walk: the sparse layers, the 2D backbone's and the heads',
    # in order
    walked = [n for n, m in twin.model.named_modules()
              if isinstance(m, (SparseConvLayer, ConvBNReLU))
              and n.startswith(('backbone_3d.', 'backbone_2d.', 'dense_head.'))]
    sparse = [n for n in walked if n.startswith('backbone_3d.')]

    def gradient(ctx, plain, against=None):
        """The f32 step inside `ctx`; the plain versions too when
        `plain`. Returns the loss, the gradient, the labels and, given the
        float64 step's layer readings `against`, each walked layer's
        shares."""
        for k in wrappers:
            k.launches = 0
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_versions())
            stack.enter_context(ctx)
            stack.enter_context(full_f32())
            seen = stack.enter_context(sp.layer_readings(
                twin.model, walked, against)) if against else None
            loss, grads, labels = sp.step_gradient(
                twin.model, part, step_draw(trainer.seed, 0, 'cuda'))
        launched = sum(k.launches for k in wrappers)
        check((launched == 0) == plain, f'{label} f32 step '
              f'({"plain" if plain else "kernels"}): {launched} launches')
        return loss, grads, labels, seen

    def distance(g):
        return gradient_distance(g, exact)[2]

    t0 = time.perf_counter()
    with full_f32():
        _, dws, convs = record_weight_gradients(twin, part)
    for name, calls, kernel, plain in (
            ('K3', convs, rulebook_conv, rulebook_conv_plain),
            ('K4', dws, rulebook_conv_dw, rulebook_conv_dw_plain)):
        units = []
        for args in calls:
            f, rb = args[0], args[1]
            n = rb.shape[-1] * f.shape[-1] if name == 'K3' else \
                rb.shape[0] * rb.shape[1]
            got, most = rounding_units(torch, kernel, plain, args, n)
            check(got <= most, f'{label} f32 {name} call: {got:.3g} units of '
                  f'eps x sum|terms| from plain, above sqrt(terms) {most:.3g}')
            units.append(got)
        print(f'{label} f32 step, its {len(calls)} {name} calls against their '
              f'plain versions in units of eps x sum|terms|: largest '
              f'{max(units):.3g}, {sum(u == 0 for u in units)} calls '
              f'bit-equal', flush=True)
    branch, seen_x = sp.ReluBranch(), {}

    @contextlib.contextmanager
    def watch_exact(model):
        with sp.layer_readings(model, walked) as seen:
            yield
        seen_x.update(seen)

    torch.cuda.synchronize()
    t64 = time.perf_counter()
    loss_x, exact, rounded, labels_x = sp.float64_step_gradient(
        cfg, state, part, trainer.seed, 'cuda',
        context=_stacked(plain_versions(), branch), watch=watch_exact)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t64  # the process's first float64 kernels
    none = contextlib.nullcontext
    loss_k, kernels, labels_k, seen_k = gradient(none(), False, seen_x)
    loss_p, plain, labels_p, seen_p = gradient(none(), True, seen_x)
    del seen_x
    check(not rounded, f'{label} float64 step: operations that round a '
          f'float64 value to float32 {rounded}')
    check(torch.equal(labels_k, labels_x) and torch.equal(labels_p, labels_x),
          f'{label}: the float64 step assigns the f32 steps\' anchor labels')
    check(abs(loss_k - loss_p) <= 1e-6 * abs(loss_p),
          f'{label} f32 loss: kernels {loss_k} vs plain {loss_p}')
    rule = sp.float64_rule(kernels, plain, exact)
    jumps = sorted(k for k, r in rule.items() if r[2] > 1e-3 * r[3])
    print(f'{label} f32 step on a loader batch '
          f'({tuple(part["voxels"].shape)} voxel table): loss kernels '
          f'{loss_k}, plain {loss_p}, float64 {loss_x}; the float64 step '
          f'({t64:.1f} s): {len(branch.masks)} ReLUs, no float32 rounding, '
          f'the same anchor labels; whole gradient from the float64 step (relative '
          f'L2): kernels {distance(kernels):.3g}, plain '
          f'{distance(plain):.3g}; all f32, kernels against the plain step: '
          f'{rule_reading(rule)}', flush=True)
    print(f'{label}: leaves where the plain f32 step lies more than 1e-3 of '
          f'the leaf\'s largest entry from the float64 step: {len(jumps)} '
          f'{jumps[:24]}', flush=True)
    for name, d_k, d_p in sorted(
            ((k, r[0], r[2]) for k, r in sp.broken_leaves(rule).items()),
            key=lambda t: -t[1] / max(rule[t[0]][1], 1e-300))[:8]:
        print(f'  {name}: kernels {d_k:.3g} from float64, allowed '
              f'{rule[name][1]:.3g} (plain {d_p:.3g}), max|float64| '
              f'{rule[name][3]:.3g}', flush=True)
    first = sp.first_parting_layer(seen_k, seen_p, walked)
    print(f'{label} layer walk over {len(walked)} layers (sparse, 2D and the '
          f'heads\'; largest distance from the float64 step as a share of its '
          f'largest entry): the first layer whose kernels\' share exceeds 3 x '
          f'the plain step\'s, outputs in forward order, gradients in '
          f'backward order: {first}; the last sparse layer\'s output kernels '
          f'/ plain {seen_k[sparse[-1]][0]:.3g} / {seen_p[sparse[-1]][0]:.3g}, '
          f'the first sparse layer\'s gradient {seen_k[sparse[0]][1]:.3g} / '
          f'{seen_p[sparse[0]][1]:.3g}', flush=True)

    for name, reorder in sp.REORDERINGS:
        _, g, _, _ = gradient(sp.summed_in_order(reorder), True)
        print(f'{label} plain f32 step, {name}: whole gradient from the '
              f'float64 step {distance(g):.3g}; against the plain step: '
              f'{rule_reading(sp.float64_rule(g, plain, exact))}', flush=True)
    _, k64, _, _ = gradient(sp.float64_batch_statistics(), False)
    _, p64, _, _ = gradient(sp.float64_batch_statistics(), True)
    print(f'{label} f32 step with float64 BatchNorm statistics: whole '
          f'gradient from the float64 step kernels {distance(k64):.3g}, plain '
          f'{distance(p64):.3g}; kernels against plain: '
          f'{rule_reading(sp.float64_rule(k64, p64, exact))}', flush=True)
    # the rule held where the diagnosis puts the cause: the ReLUs' kinks
    # (tests/test_torch_cbgs_float64.py); on the float64 step's branch the
    # f32 steps differ from it by rounding alone
    pair, flips = [], {}
    for plain_step in (False, True):
        imposed = sp.ReluBranch(branch.masks)
        pair.append(gradient(imposed, plain_step)[1])
        flips['plain' if plain_step else 'kernels'] = imposed.flips
    rule = sp.float64_rule(*pair, exact)
    print(f'{label} f32 step on the float64 step\'s ReLU branch (each '
          f'step\'s ReLU entries whose own sign differs there: {flips} of '
          f'{sum(int(m.numel()) for m in branch.masks)}): whole gradient from '
          f'the float64 step kernels {distance(pair[0]):.3g}, plain '
          f'{distance(pair[1]):.3g}; kernels against plain: '
          f'{rule_reading(rule)} ({time.perf_counter() - t0:.1f} s)',
          flush=True)
    check(not sp.broken_leaves(rule), f'{label} f32 step on the float64 '
          f'step\'s ReLU branch: leaves beyond the float64 rule '
          f'{sorted(sp.broken_leaves(rule))}')
    del twin


@contextlib.contextmanager
def _stacked(*contexts):
    """The given context managers entered in order, as one."""
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def write_fork_trees(root):
    """The fork's trees under `root`, timed: a PlusAI multiframe tree
    (PLUSAI_SCENES scenes of PLUSAI_FRAMES single frames, stacked three at
    a time by the port's gen_mot_dataset; the last scene in val) with the
    infos and gt database of ``create_plusai_infos``, and a Mix tree
    (MIX_FRAMES frames of a Livox tree and a fake-lidar tree mixed by
    ``generate_mix_dataset``, MIX_VAL in val) with those of
    ``create_livox_infos`` for mix_data_models/pointpillars_xy.yaml.
    Returns the two roots."""
    import os

    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.datasets import synthetic_trees
    from lidardetection_tpu_torch.datasets.livox.livox_dataset import (
        create_livox_infos,
    )
    from lidardetection_tpu_torch.datasets.plusai.plusai_dataset import (
        create_plusai_infos,
    )

    cores = os.cpu_count() or 1
    t0 = time.perf_counter()
    plusai = synthetic_trees.write_plusai_tree(
        root / 'plusai', PLUSAI_SCENES, PLUSAI_FRAMES, seed=SEED)
    frames = [len(np.fromfile(f, np.float32)) // 4
              for f in sorted((root / 'plusai').glob('mot_dataset/*/pointcloud/*'))]
    stacked = [len(np.fromfile(f, np.float32)) // 5
               for f in sorted(plusai.glob('*/pointcloud/*.bin'))]
    t1 = time.perf_counter()
    cfg = cfg_from_yaml_file(CFG_MULTIFRAME)
    create_plusai_infos(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), plusai, plusai,
                        workers=cores)
    t2 = time.perf_counter()
    print(f'PlusAI tree: {PLUSAI_SCENES} scenes of {PLUSAI_FRAMES} frames of '
          f'{min(frames)}-{max(frames)} returns, {len(stacked)} stacked '
          f'samples of {min(stacked)}-{max(stacked)} points, written and '
          f'stacked in {t1 - t0:.2f} s; create_plusai_infos {t2 - t1:.2f} s',
          flush=True)
    mix = synthetic_trees.write_mix_tree(root / 'mix', MIX_FRAMES, MIX_VAL,
                                         seed=SEED)
    points = [len(np.fromfile(f)) // 3
              for f in sorted((mix / 'pointcloud').iterdir())]
    t3 = time.perf_counter()
    mcfg = cfg_from_yaml_file(CFG_MIX_PP)
    create_livox_infos(mcfg.DATA_CONFIG, list(mcfg.CLASS_NAMES), mix,
                       workers=cores)
    t4 = time.perf_counter()
    print(f'Mix tree: {MIX_FRAMES} frames of {min(points)}-{max(points)} '
          f'points (Livox frames and fake-lidar scenes) written in '
          f'{t3 - t2:.2f} s; create_livox_infos {t4 - t3:.2f} s', flush=True)
    return plusai, mix


def train_eval_from_files(torch, label, cfg_file, root, per_step, per_batch,
                          workers, logger, n_held=None):
    """A fork config trained and evaluated from its tree at `root` through
    ``build_dataloader`` (`workers` forked workers): with `n_held` (the
    K3, K4 and K5 calls of a step) the kernel calls of a step on the
    first batch held against their plain versions (``step_kernels_held``);
    warm-up on workers x PREFETCH batches, FORK_LOADER_STEPS timed steps
    with `per_step` launches each (``loader_train_phase``); precise-BN over
    8 training batches; then ``eval_one_epoch`` over the val split with
    `per_batch` launches a batch (K1 and K2 held bit for bit on its first
    batch where it launches K1).
    Returns the trainer, the launches of the training run and of the eval,
    the loader timings, the kernel errors and the last batch on the card."""
    from lidardetection_tpu_torch.datasets import PREFETCH, build_dataloader
    from lidardetection_tpu_torch.engine.bn_recalibrate import (
        recalibrate_bn_stats,
    )
    from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
    from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe
    from lidardetection_tpu_torch.parallel.train_step import (
        device_batch, make_eval_step,
    )
    from lidardetection_tpu_torch.train import Trainer

    trainer = Trainer(cfg_file, device='cuda', seed=SEED, total_steps=1000)
    cfg = trainer.cfg
    classes = list(cfg.CLASS_NAMES)
    size = train_batch_size(trainer)
    warmup = workers * PREFETCH
    n_batches = 1 + warmup + FORK_LOADER_STEPS
    dataset, loader = build_dataloader(
        cfg.DATA_CONFIG, classes, size, training=True, root_path=root,
        workers=workers, logger=logger, model_cfg=cfg.MODEL, seed=SEED)
    n_train = len(dataset)
    dataset, loader = build_dataloader(
        cfg.DATA_CONFIG, classes, size, training=True, root_path=root,
        workers=workers, logger=logger, model_cfg=cfg.MODEL,
        merge_all_iters_to_one_epoch=True,
        total_epochs=-(-n_batches * size // n_train), seed=SEED)
    check(len(loader) >= n_batches and loader.num_workers == workers,
          f'{label} loader: {len(loader)} batches, {loader.num_workers} workers')
    build = batch_build_ms(loader, repeats=1)  # no worker alive yet
    t0 = time.perf_counter()
    batches = iter(loader)
    first = next(batches)
    startup = (time.perf_counter() - t0) * 1e3
    errors = {}
    if n_held is not None:
        errors = step_kernels_held(torch, trainer, device_batch(first, 'cuda'),
                                   label, *n_held)
    launches, timing, on_card = loader_train_phase(
        torch, trainer, label, batches, per_step, warmup, FORK_LOADER_STEPS)
    batches.close()  # the workers end
    timing.update({'first_batch_ms': startup, 'batch_build_ms': build,
                   'batch_size': size, 'train_frames': n_train})
    print(f'{label} from files, {FORK_LOADER_STEPS} steps at B={size} after '
          f'{warmup} of warm-up: iteration p50 {timing["p50_iteration_ms"]:.2f}'
          f' ms (mean {timing["mean_iteration_ms"]:.2f}) = wait on the loader '
          f'{timing["p50_wait_ms"]:.2f} ms (mean {timing["mean_wait_ms"]:.2f})'
          f' + copy {timing["p50_copy_ms"]:.2f} ms + step '
          f'{timing["p50_step_ms"]:.2f} ms (host clock); a batch built in one '
          f'process {build:.2f} ms; the first batch {startup:.2f} ms',
          flush=True)

    # the running statistics of a short run lag the weights, and the eval
    # then overflows as the reference's does (fork_data_phase): precise-BN
    # over training batches from the tree first, as the train-to-AP gates do
    t0 = time.perf_counter()
    recalibrate_bn_stats(trainer.model, loader,
                         lambda b: device_batch(b, 'cuda'), n_batches=8)
    print(f'{label}: precise-BN over 8 training batches from files '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    zero_class_bias(torch, trainer.model)
    test_set, test_loader = build_dataloader(
        cfg.DATA_CONFIG, classes, size, training=False, root_path=root,
        workers=workers, logger=logger, model_cfg=cfg.MODEL, seed=SEED)
    if per_batch.get(pillar_vfe):
        step = make_eval_step(trainer.model, cfg.MODEL.POST_PROCESSING,
                              len(classes))
        batch = next(iter(test_loader))
        step(device_batch(batch, 'cuda'))  # warm-up
        errors.update(eval_kernels_held(torch, step, batch))
        torch.cuda.synchronize()
    counted = CountedLoader(test_loader, per_batch)
    result, annos = eval_one_epoch(trainer.model, counted,
                                   cfg.MODEL.POST_PROCESSING, classes, logger)
    frames = [info['point_cloud']['lidar_idx'] for info in test_set.plusai_infos]
    ap = {k: round(float(v), 4) for k, v in result.items()
          if k.endswith('moderate_R40')}
    print(f'{label} eval from files: {len(frames)} val frames at B={size}, '
          f'sec_per_example {result["sec_per_example"]:.4f} s (host clock), '
          f'largest num_voxels {counted.largest_num_voxels}, live detections '
          f'{sum(len(a["name"]) for a in annos[:len(frames)])}, moderate R40 '
          f'AP {ap} (random weights), recall '
          f'{ {k: v for k, v in result.items() if k.startswith("recall/")} }',
          flush=True)
    check([a['frame_id'] for a in annos[:len(frames)]] == frames,
          f'{label} eval from files: one anno per val frame')
    check(all(np.isfinite(a['boxes_lidar']).all() for a in annos)
          and 'Car_3d/moderate_R40' in result and 'Truck_3d/moderate_R40'
          in result, f'{label} eval from files: finite boxes, the KITTI '
          'protocol over Car and Truck')
    timing['sec_per_example'] = result['sec_per_example']
    return trainer, launches, counted.total, timing, errors, on_card


def distributed_phase(torch, trainer, batch, test_loader, logger):
    """A one-process NCCL group (``tcp://localhost``, world size 1, rank 0)
    against no group, from the trainer's state: the group's training step
    on `batch` (BatchNorm's sums, the loss normalisers and the gradient
    average through NCCL, parallel/dist.py) against two bare steps, every
    parameter, BatchNorm statistic and Adam moment bit for bit where the
    two bare steps agree; the group's eval of `test_loader` (the annos and
    the recall counters through ``merge_results_dist``) against the bare
    eval, every anno and result key equal. The state is put back."""
    import copy
    import socket

    from lidardetection_tpu_torch.engine.evaluator import eval_one_epoch
    from lidardetection_tpu_torch.parallel import dist

    cfg = trainer.cfg
    classes = list(cfg.CLASS_NAMES)
    saved = copy.deepcopy(trainer.state.state_dict())

    def step():
        trainer.state.load_state_dict(copy.deepcopy(saved))
        tb = trainer.step(batch)
        state = trainer.state.state_dict()
        out = {f'model/{k}': v.clone() for k, v in state['model'].items()}
        for kind in ('mu', 'nu'):
            out.update({f'{kind}/{k}': v.clone()
                        for k, v in state['optimizer'][kind].items()})
        return {k: float(v) for k, v in tb.items()}, out

    def evaluate(**kwargs):
        trainer.state.load_state_dict(copy.deepcopy(saved))
        return eval_one_epoch(trainer.model, test_loader,
                              cfg.MODEL.POST_PROCESSING, classes, logger,
                              **kwargs)

    bare = [step(), step()]
    bare_result, bare_annos = evaluate()
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        'nccl', init_method=f'tcp://localhost:{port}', world_size=1, rank=0)
    try:
        check(dist.in_group() and dist.get_world_size() == 1,
              'a one-process NCCL group')
        grouped = step()
        with tempfile.TemporaryDirectory(prefix='chip_smoke_eval_') as tmp:
            result, annos = evaluate(result_dir=tmp)
            check(not (Path(tmp) / 'tmpdir').exists(),
                  'merge_results_dist removed the part files')
    finally:
        torch.distributed.destroy_process_group()
    trainer.state.load_state_dict(saved)
    (tb0, leaves0), (tb1, leaves1) = bare
    tb_g, leaves_g = grouped
    unstable = {k for k in leaves0 if not torch.equal(leaves0[k], leaves1[k])}
    differ = [k for k in leaves0 if not torch.equal(leaves0[k], leaves_g[k])]
    n = len(test_loader.dataset.plusai_infos)
    same_annos = len(annos) == n and all(
        sorted(a) == sorted(b) and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)
        for a, b in zip(annos, bare_annos[:n]))
    same_result = set(result) == set(bare_result) and all(
        result[k] == bare_result[k] for k in result if k != 'sec_per_example')
    print(f'one-process NCCL group: its step vs the bare step, '
          f'{len(leaves0) - len(differ)} of {len(leaves0)} leaves bit-equal '
          f'({len(unstable)} differ between two bare steps); loss '
          f'{tb_g["loss"]} vs {tb0["loss"]}; its eval through '
          f'merge_results_dist: {len(annos)} annos (the bare eval '
          f'{len(bare_annos)}, its padding cut), equal {same_annos}, result '
          f'keys equal {same_result}', flush=True)
    check(tb_g == tb0 or tb0 != tb1,
          "the group step's loss terms equal the bare step's")
    check(set(differ) <= unstable, f'the group step differs from the bare '
          f'step in leaves the bare steps agree on: '
          f'{sorted(set(differ) - unstable)[:8]}')
    check(same_annos and same_result, 'the group eval equals the bare eval')


def fork_data_phase(torch, wrappers, root):
    """Training and evaluation of the fork's configs from trees on disk
    (``write_fork_trees``; forked workers, min(8, cores) of them):
    livox_models/pv_rcnn_multiframe.yaml from the PlusAI tree (23 K3, 12
    K4, 1 K2 and 5 K5 a step, every kernel call of a step on its first
    batch held against its plain version; 12 K3, 1 K2 and 5 K5 an eval
    batch) and mix_data_models/pointpillars_xy.yaml from the Mix tree (1 K2
    a step; 1 K1 and 1 K2 an eval batch, held bit for bit on its first);
    then the Mix trainer in a one-process NCCL group against no group
    (``distributed_phase``). Each evaluates after precise-BN over 8
    training batches: after a short run the eval with the running
    statistics gives non-finite boxes (multiframe PV-RCNN after its 24
    steps), the outcome that tests/test_torch_eval_after_training.py
    holds for SECOND against the JAX package's eval of the same state
    (non-finite at the same rows: a property of the reference, not a port
    fault; ROADMAP section 3), so precise-BN is how the phase reads a
    finite eval, as the train-to-AP gates do. Returns the launches of each run and the
    largest kernel errors against the plain versions."""
    import logging
    import os

    from lidardetection_tpu_torch.datasets import build_dataloader

    workers = min(8, os.cpu_count() or 1)
    plusai, mix = write_fork_trees(root)
    logger = logging.getLogger('chip_smoke.fork')
    runs, errors, loader_json = {}, {}, {}
    for label, cfg_file, tree, per_step, per_batch, n_held in (
            ('PV-RCNN multiframe', CFG_MULTIFRAME, plusai, (0, 1, 23, 12, 5),
             (0, 1, 12, 0, 5), (23, 12, 5)),
            ('Mix PointPillar', CFG_MIX_PP, mix, (0, 1, 0, 0, 0),
             (1, 1, 0, 0, 0), None)):
        print(f'-- {label} from files --', flush=True)
        trainer, train_runs, eval_runs, timing, errs, on_card = \
            train_eval_from_files(torch, label, cfg_file, tree,
                                  dict(zip(wrappers, per_step)),
                                  dict(zip(wrappers, per_batch)), workers,
                                  logger, n_held)
        runs[f'{label} training from files'] = train_runs
        runs[f'{label} eval from files'] = eval_runs
        loader_json[label] = timing
        for name, e in errs.items():
            errors[name] = max(errors.get(name, 0.0), e)
    print(json.dumps({'fork_loader': loader_json}), flush=True)

    print('-- distributed: a one-process NCCL group --', flush=True)
    cfg = trainer.cfg
    _, test_loader = build_dataloader(
        cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), 2, training=False,
        root_path=mix, workers=0, logger=logger, model_cfg=cfg.MODEL,
        seed=SEED)
    distributed_phase(torch, trainer, on_card, test_loader, logger)
    return runs, errors


@contextlib.contextmanager
def counted_calls(owner, attr, per_call, label):
    """owner.attr wrapped for the block so that each call is one run of a
    main path: every launch count set to 0 just before the call and
    checked after it against `per_call` (each kernel's wrapper -> its
    launches a call). Yields the totals by kernel name."""
    fn = getattr(owner, attr)
    total = {k.__name__: 0 for k in per_call}

    def run(*args, **kwargs):
        for k in per_call:
            k.launches = 0
        result = fn(*args, **kwargs)
        for k, each in per_call.items():
            check(k.launches == each, f'{label}: {k.__name__} launched '
                  f'{k.launches} times a call, expected {each}')
            total[k.__name__] += k.launches
        return result

    setattr(owner, attr, run)
    try:
        yield total
    finally:
        setattr(owner, attr, fn)


def tools_phase(torch, wrappers, kitti, tmp, cfg_pillar=CFG,
                cfg_second=CFG_SECOND):
    """The port's tools (``lidardetection_tpu_torch/tools/``) on the card, at
    full width: ``verify_cuda.main([])`` (every case ok, exit 0); ``demo`` over
    TOOL_SCANS scans of the KITTI tree's val split (PointPillar, 1 K1 and 1
    K2 a scan); ``inference --with_tracking`` and ``mot_benchmark
    --with_tracking`` over TOOL_SCENES synthetic scenes (the table printed,
    the tracker's host ms a frame); ``inference_bag2json`` over the scans
    (the JSON read back: one record a frame, track ids unique in a frame);
    ``test --eval_all --max_waiting_mins 0`` over the checkpoints (each
    evaluated in order, recall finite, 1 K1 and 1 K2 a batch); ``demo_3d``'s
    computing path on SECOND (12 K3, 1 K2 a scene). The tools read
    checkpoint_epoch_1.pth and _2.pth of PointPillar, written by training
    steps here, and a SECOND checkpoint of weights from SEED, each with the
    class-logit bias 0 (``zero_class_bias``), so that every tool sees live
    detections. Each counted run sets the launch counts to 0 before each
    scene or batch and checks them after. The image writers run where the
    machine has their package (cv2, matplotlib, PIL), and a line says
    which ran. Returns the launches of each run and the verifier's
    cases."""
    import importlib.util
    import logging
    import os

    from lidardetection_tpu_torch.tools import (
        common as tool_common, demo, demo_3d, inference,
        inference_bag2json, mot_benchmark, test as test_tool, verify_cuda,
    )
    from lidardetection_tpu_torch.train import Trainer
    from lidardetection_tpu_torch.utils.checkpoint import save_checkpoint

    pillar_vfe, scatter_rows, rulebook_conv, _, _ = wrappers
    per_pillar = {pillar_vfe: 1, scatter_rows: 1}
    logger = logging.getLogger('chip_smoke.tools')
    t_phase = time.perf_counter()
    runs, seconds = {}, {}

    t0 = time.perf_counter()
    calls = []
    with recorded(verify_cuda, 'verify', calls):
        rc = verify_cuda.main([])
    cases = calls[0][2]
    seconds['verify_cuda'] = time.perf_counter() - t0
    check(rc == 0 and cases and all(c['ok'] for c in cases),
          'verify_cuda: every case ok')
    print(json.dumps({'verify_cuda': cases}), flush=True)

    # the checkpoints the tools read: two epochs of PointPillar training
    # steps and SECOND's weights from SEED, each with the dense head's
    # class-logit bias 0 (live NMS candidates: the focal prior puts every
    # random-weight score under SCORE_THRESH)
    t0 = time.perf_counter()
    trainer = Trainer(cfg_pillar, device='cuda', seed=SEED, total_steps=2)
    batches, _ = train_batches(trainer, 2, SEED + 1700)
    ckpt_dir = tmp / 'ckpt'
    for epoch, batch in enumerate(batches, 1):
        trainer.step(batch)
        zero_class_bias(torch, trainer.model)
        save_checkpoint(trainer.state, ckpt_dir, epoch)
    del trainer, batches
    second_ckpt = tmp / 'second' / 'checkpoint_epoch_1.pth'
    second = Trainer(cfg_second, device='cuda', seed=SEED, total_steps=1)
    zero_class_bias(torch, second.model)
    save_checkpoint(second.state, second_ckpt.parent, 1)
    del second
    seconds['checkpoints'] = time.perf_counter() - t0

    scans = tmp / 'scans'
    scans.mkdir()
    val = (kitti / 'ImageSets' / 'val.txt').read_text().split()[:TOOL_SCANS]
    for fid in val:
        os.symlink(kitti / 'training' / 'velodyne' / f'{fid}.bin',
                   scans / f'{fid}.bin')
    pillar = ['--cfg_file', cfg_pillar, '--ckpt', str(ckpt_dir)]

    t0 = time.perf_counter()
    with counted_calls(tool_common.Predictor, 'predict', per_pillar,
                       'demo') as runs['tools: demo']:
        records = demo.main(pillar + ['--data_path', str(scans)])
    seconds['demo'] = time.perf_counter() - t0
    check(len(records) == TOOL_SCANS and all(
        np.isfinite(r['boxes']).all() and r['boxes'].shape[1] == 7
        and len(r['boxes']) > 0 for r in records),
          'demo: finite detections in every scan')
    demo_ms = [r['ms'] for r in records]
    print(f'demo: {TOOL_SCANS} KITTI scans, detections '
          f'{[len(r["boxes"]) for r in records]}, ms a scene {demo_ms} '
          f'(host clock: the batch to the card, the eval step, the '
          f'predictions back), p50 {float(np.median(demo_ms[1:])):.2f} '
          f'after the first', flush=True)

    t0 = time.perf_counter()
    with counted_calls(tool_common.Predictor, 'predict', per_pillar,
                       'inference') as runs['tools: inference']:
        records = inference.run(inference.parse_args(
            pillar + ['--num_scenes', str(TOOL_SCENES), '--with_tracking']),
            logger)
    seconds['inference'] = time.perf_counter() - t0
    tracker_ms = [r['tracker_ms'] for r in records]
    tracks = [len(r['tracked']['object_ids']) for r in records]
    print(f'inference --with_tracking: {TOOL_SCENES} synthetic scenes, '
          f'detections {[len(r["boxes"]) for r in records]}, tracks {tracks}, '
          f'eval step ms {[round(r["ms"], 2) for r in records]}, tracker host '
          f'ms a frame {[round(t, 3) for t in tracker_ms]} (p50 '
          f'{float(np.median(tracker_ms)):.3f})', flush=True)
    check(all(np.isfinite(r['boxes']).all() and len(r['boxes']) > 0
              for r in records) and max(tracks) > 0,
          'inference: finite detections in every scene, confirmed tracks')

    t0 = time.perf_counter()
    with counted_calls(tool_common.Predictor, 'predict', per_pillar,
                       'mot_benchmark') as runs['tools: mot_benchmark']:
        table, mot_records = mot_benchmark.run(mot_benchmark.parse_args(
            pillar + ['--num_scenes', str(TOOL_SCENES), '--with_tracking']),
            logger)
    seconds['mot_benchmark'] = time.perf_counter() - t0
    for row in table:
        print(f'MOT iou {row["iou"]} range <{row["range"]} m: recall '
              f'{row["recall"]:.3f} precision {row["precision"]:.3f} dist_err '
              f'{row["dist_err"]:.3f} m (tp {row["tp"]}, det {row["det"]}, gt '
              f'{row["gt"]})', flush=True)
    check(len(table) == 12 and all(
        np.isfinite([row['recall'], row['precision'], row['dist_err']]).all()
        for row in table), 'mot_benchmark: a finite table')
    check([len(r['boxes']) for r in mot_records]
          == [len(r['boxes']) for r in records],
          'mot_benchmark: the detections of inference on the same scenes')

    t0 = time.perf_counter()
    out = tmp / 'detections.json'
    with counted_calls(tool_common.Predictor, 'predict', per_pillar,
                       'inference_bag2json') as runs['tools: bag2json']:
        inference_bag2json.main(pillar + ['--data_path', str(scans),
                                          '--output', str(out)])
    seconds['inference_bag2json'] = time.perf_counter() - t0
    frames = json.loads(out.read_text())
    check(len(frames) == TOOL_SCANS and all(
        len({o['id'] for o in f['tracked_objects']})
        == len(f['tracked_objects']) for f in frames),
        'inference_bag2json: a record a frame, track ids unique in a frame')
    print(f'inference_bag2json: {len(frames)} frames, detections '
          f'{[len(f["detections"]) for f in frames]}, tracks '
          f'{[len(f["tracked_objects"]) for f in frames]}', flush=True)

    t0 = time.perf_counter()
    eval_runs = []
    real_eval = test_tool.eval_one_epoch

    def counted_eval(model, loader, *args, **kwargs):
        counted = CountedLoader(loader, per_pillar)
        result = real_eval(model, counted, *args, **kwargs)
        eval_runs.append(counted.total)
        return result

    test_tool.eval_one_epoch = counted_eval
    try:
        results = test_tool.main([
            '--cfg_file', cfg_pillar, '--eval_all', '--ckpt_dir', str(ckpt_dir), '--max_waiting_mins',
            '0', '--synthetic', '--num_scenes', str(EVAL_SCENES),
            '--batch_size', str(EVAL_BATCH), '--output_dir', str(tmp / 'eval')])
    finally:
        test_tool.eval_one_epoch = real_eval
    seconds['test --eval_all'] = time.perf_counter() - t0
    runs['tools: test --eval_all'] = {
        k: sum(r[k] for r in eval_runs) for k in eval_runs[0]}
    check([tag for _, tag, _ in results] == ['epoch_1', 'epoch_2'],
          'test --eval_all: both epochs, in order')
    for ckpt, tag, result in results:
        recall = {k: v for k, v in result.items() if k.startswith('recall/')}
        check(recall and all(np.isfinite(v) for v in recall.values()),
              f'test --eval_all: {tag} gives a finite recall')
        print(f'test --eval_all {tag}: recall {recall}, Car 3D moderate R40 '
              f'{result["Car_3d/moderate_R40"]:.2f}, sec_per_example '
              f'{result["sec_per_example"]:.4f}', flush=True)

    t0 = time.perf_counter()
    with counted_calls(tool_common.Predictor, 'predict',
                       {rulebook_conv: 12, scatter_rows: 1},
                       'demo_3d') as runs['tools: demo_3d']:
        records_3d = demo_3d.run(demo_3d.parse_args(
            ['--cfg_file', cfg_second, '--ckpt', str(second_ckpt),
             '--synthetic', '--num_scenes', '2', '--offscreen']), logger)
    seconds['demo_3d'] = time.perf_counter() - t0
    check(all(np.isfinite(r['boxes']).all() and r['detections'] > 0
              for r in records_3d), 'demo_3d: finite detections')
    print(f'demo_3d (SECOND): detections {[r["detections"] for r in records_3d]}'
          f', above the threshold {[len(r["boxes"]) for r in records_3d]}',
          flush=True)

    have = {p: importlib.util.find_spec(p) is not None
            for p in ('cv2', 'matplotlib', 'PIL')}
    ran = []
    if have['matplotlib']:
        from lidardetection_tpu_torch.tools.visual_utils.laserdetvis import (
            LaserDetVis,
        )
        from lidardetection_tpu_torch.utils.data_viz import plot_gt_det_cmp
        r = records[0]
        plot_gt_det_cmp(r['frame'].points[:, :3], r['frame'].gt_boxes,
                        r['boxes'], point_cloud_range(cfg_pillar), save_dir=tmp)
        LaserDetVis.render_offscreen(
            records_3d[0]['points'], boxes=records_3d[0]['boxes'],
            save_path=str(tmp / 'scene.png'))
        ran += ['plot_gt_det_cmp', 'render_offscreen']
    if have['cv2']:
        from lidardetection_tpu_torch.tools.inference_video import write_video
        from lidardetection_tpu_torch.utils.data_viz import (
            bev_canvas, plot_multiframe_boxes,
        )
        canvases = [bev_canvas(r['frame'].points, r['boxes'],
                               point_cloud_range(cfg_pillar)) for r in records]
        canvases.append(plot_multiframe_boxes(
            records[0]['frame'].points, records[0]['boxes'],
            point_cloud_range(cfg_pillar)))
        write_video(canvases, tmp / 'video.avi', 5)
        ran += ['bev_canvas', 'plot_multiframe_boxes', '.avi']
        if have['PIL']:
            write_video(canvases, tmp / 'video.gif', 5)
            ran.append('.gif')
    print(f'tools phase image writers: ran {ran or "none"}; absent packages '
          f'{[p for p, ok in have.items() if not ok] or "none"}', flush=True)
    seconds['phase'] = time.perf_counter() - t_phase
    print(json.dumps({'tools_seconds': seconds}), flush=True)
    return runs, cases


def trace_kernels(trace_path, names):
    """{name: the kernel events of a Chrome trace whose name holds it}."""
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    return {n: sum(n in k for k in kernels) for n in names}


def scalar_tags(event_dir):
    """The scalar tags of a TensorBoard directory's event files (TFRecords
    of ``Event`` protos)."""
    import struct

    from tensorboard.compat.proto import event_pb2

    tags = set()
    for path in Path(event_dir).glob('events.out.tfevents.*'):
        data, at = path.read_bytes(), 0
        while at < len(data):
            n = struct.unpack('<Q', data[at:at + 8])[0]
            event = event_pb2.Event.FromString(data[at + 12:at + 12 + n])
            at += 12 + n + 4
            tags.update(v.tag for v in event.summary.value)
    return tags


def train_cli_phase(torch, wrappers, tmp):
    """The training CLI's main path, ``train.main`` on the card at full
    width: CFG_SECOND (bf16, the host plan) on CLI_SCENES scenes of the
    registered SyntheticDataset through ``build_dataloader`` (8 forked
    workers), CLI_EPOCHS epochs at B = 4 (8 steps each, 23 K3, 12 K4 and 1
    K2 checked after every step), a checkpoint each epoch, the profile
    window (steps 10-15) traced, then the eval of the final state and the
    repeat-eval of epoch 1 (12 K3 and 1 K2 a batch); then
    ``tools.test.evaluate --eval_all`` on the same YAML with no
    ``--ckpt_dir``, which must find both checkpoints through the default
    layout and read each epoch's recall and detections as the training
    run's own eval read them; then ``finite_boxes_held`` on the final
    state. Both runs take ``--set
    MODEL.POST_PROCESSING.SCORE_THRESH 0.001``, so that the
    random-weight model's evals have detections to compare. The working directory is
    `tmp`, with ``tools`` linked to the repository's (the configs'
    _BASE_CONFIG_ paths). Returns the launches of the three runs."""
    import copy
    import os
    import re

    from lidardetection_tpu_torch import train
    from lidardetection_tpu_torch.engine import trainer as loop
    from lidardetection_tpu_torch.tools import test as test_tool

    _, scatter_rows, rulebook_conv, rulebook_conv_dw, _ = wrappers
    per_step = {rulebook_conv: 12 + 11, rulebook_conv_dw: 12, scatter_rows: 1}
    per_batch = {rulebook_conv: 12, scatter_rows: 1}
    t_phase = time.perf_counter()
    steps = {k.__name__: 0 for k in per_step}
    # host clock at each batch's arrival from the loader, its copy's end
    # and its step's end
    arrived, copied, step_ends = [], [], []
    make_step = loop.make_train_step
    real_device_batch = loop.device_batch

    def timed_device_batch(batch, device):
        arrived.append(time.perf_counter())
        out = real_device_batch(batch, device)
        torch.cuda.synchronize()
        copied.append(time.perf_counter())
        return out

    def counted_make_step(state):
        step = make_step(state)

        def run(batch):
            for k in per_step:
                k.launches = 0
            tb = step(batch)
            torch.cuda.synchronize()
            step_ends.append(time.perf_counter())
            for k, each in per_step.items():
                check(k.launches == each, f'training CLI step {len(step_ends)}'
                      f': {k.__name__} launched {k.launches} times, expected '
                      f'{each}')
                steps[k.__name__] += k.launches
            return tb

        return run

    evals, final = [], []

    def counted_eval(real_eval, model, loader, *args, **kwargs):
        if not final:  # the training run's eval of its final state
            post_cfg, class_names = args[:2]
            final.append((copy.deepcopy(model), loader, post_cfg,
                          len(class_names)))
        counted = CountedLoader(loader, per_batch)
        result, annos = real_eval(model, counted, *args, **kwargs)
        evals.append((counted.total, result, annos))
        return result, annos

    scenes, epochs, batch = str(CLI_SCENES), str(CLI_EPOCHS), str(TRAIN_BATCH)
    scores = ['--set', 'MODEL.POST_PROCESSING.SCORE_THRESH', '0.001']
    cwd = os.getcwd()
    os.symlink(Path(cwd) / 'tools', tmp / 'tools')
    os.chdir(tmp)
    real_eval = train.eval_one_epoch
    loop.make_train_step = counted_make_step
    loop.device_batch = timed_device_batch
    train.eval_one_epoch = lambda *a, **k: counted_eval(real_eval, *a, **k)
    try:
        t0 = time.perf_counter()
        result = train.main([
            '--cfg_file', CFG_SECOND, '--synthetic', '--num_scenes', scenes,
            '--batch_size', batch, '--epochs', epochs, '--workers', '8',
            '--extra_tag', 'smoke', '--max_ckpt_save_num', '2',
            '--num_epochs_to_eval', '2', '--profile', *scores])
        train_s = time.perf_counter() - t0
        loop.make_train_step = make_step
        loop.device_batch = real_device_batch
        train.eval_one_epoch = real_eval
        trained = evals[:]
        evals.clear()
        test_tool.eval_one_epoch = lambda *a, **k: counted_eval(real_eval, *a,
                                                                **k)
        t0 = time.perf_counter()
        tested = test_tool.evaluate(test_tool.parse_args([
            '--cfg_file', CFG_SECOND, '--synthetic', '--num_scenes', scenes,
            '--extra_tag', 'smoke', '--eval_all', '--max_waiting_mins', '0',
            *scores]))
        test_s = time.perf_counter() - t0
    finally:
        loop.make_train_step = make_step
        loop.device_batch = real_device_batch
        train.eval_one_epoch = real_eval
        test_tool.eval_one_epoch = real_eval
        os.chdir(cwd)

    out = tmp / 'output' / 'kitti_models' / 'second' / 'smoke'
    n_steps = CLI_EPOCHS * CLI_SCENES // TRAIN_BATCH
    ckpts = sorted(p.name for p in (out / 'ckpt').iterdir())
    check(ckpts == ['checkpoint_epoch_1.pth', 'checkpoint_epoch_2.pth'],
          f'training CLI: the checkpoints of both epochs under {out}/ckpt: '
          f'{ckpts}')
    check(len(step_ends) == n_steps, f'training CLI: {n_steps} steps')
    check(all(steps[k.__name__] == n_steps * each
              for k, each in per_step.items()),
          f'training CLI: launches {steps} over {n_steps} steps')
    check((out / 'eval' / 'result.pkl').exists()
          and (out / 'eval' / 'epoch_1' / 'result.pkl').exists(),
          'training CLI: eval/ and eval/epoch_1/ each hold a result')
    logs = list(out.glob('log_train_*.txt'))
    check(len(logs) == 1, f'training CLI: one log, {logs}')
    log = logs[0].read_text()
    check('cfg.TAG: second' in log and 'cfg.MODEL.NAME: SECONDNet' in log
          and 'cfg.DATA_CONFIG.DATASET: SyntheticDataset' in log,
          'training CLI: the config dumped in the log')
    window = re.search(r'profiler: steps (\d+)-(\d+) in ([0-9.]+) s', log)
    check(window and window.groups()[:2] == ('10', '15'),
          'training CLI: the profile window of steps 10-15')
    window_s = float(window.group(3))
    traces = list((out / 'profile').glob('*.json'))
    check(len(traces) == 1, f'training CLI: one trace, {traces}')
    named = trace_kernels(traces[0], ('scatter_rows_kernel', 'conv_mma_kernel',
                                      'dw_mma_kernel'))
    check(all(named.values()), f'training CLI: the trace names K2, K3 and '
          f'K4: {named}')
    if 'tensorboard writer unavailable' in log:
        board = 'TensorBoard absent (torch.utils.tensorboard does not ' \
            'import): no scalars'
    else:
        tags = scalar_tags(out / 'tensorboard')
        check({'train/loss', 'meta_data/learning_rate'} <= tags,
              f'training CLI: TensorBoard scalars {sorted(tags)}')
        board = (f'TensorBoard tags {sorted(t for t in tags if t[:5] != "eval/")}'
                 f' and {sum(t[:5] == "eval/" for t in tags)} eval/ tags')

    # each epoch's eval by the training run against test --eval_all's
    check([tag for _, tag, _ in tested] == ['epoch_1', 'epoch_2'],
          f'test --eval_all: both epochs in order, {[t for _, t, _ in tested]}')
    by_epoch = {'epoch_2': trained[0], 'epoch_1': trained[1]}
    for (_, tag, got), (_, want, want_annos) in zip(
            tested, (by_epoch['epoch_1'], by_epoch['epoch_2'])):
        got_annos = evals[[t for _, t, _ in tested].index(tag)][2]
        recall = {k: v for k, v in want.items() if k.startswith('recall/')}
        same = recall and all(got[k] == v for k, v in recall.items())
        same_annos = len(got_annos) == len(want_annos) and all(
            np.array_equal(g['boxes_lidar'], w['boxes_lidar'])
            and np.array_equal(g['score'], w['score'])
            for g, w in zip(got_annos, want_annos))
        finite = sum(int(np.isfinite(a['boxes_lidar']).all(axis=1).sum())
                     for a in want_annos)
        print(f'training CLI {tag}: recall {recall} (test --eval_all '
              f'{ {k: got[k] for k in recall} }), detections '
              f'{sum(len(a["name"]) for a in want_annos)} ({finite} with '
              f'finite boxes), the same boxes and '
              f'scores {same_annos}, Car 3D moderate R40 '
              f'{want["Car_3d/moderate_R40"]:.2f}, sec_per_example '
              f'{want["sec_per_example"]:.4f} s (test: '
              f'{got["sec_per_example"]:.4f})', flush=True)
        check(same and same_annos and sum(len(a['name']) for a in want_annos),
              f'training CLI {tag}: test --eval_all reads the recall and the '
              'detections of the training run\'s eval')
    finite_boxes_held(torch, *final[0], by_epoch['epoch_2'][2])

    # iterations: step end to step end within an epoch, outside the
    # window: the wait on the loader, the copy to the card, the step
    per_epoch = CLI_SCENES // TRAIN_BATCH
    timed = [i for i in range(1, n_steps)
             if i % per_epoch and not 10 <= i <= 15]
    iteration = [(step_ends[i] - step_ends[i - 1]) * 1e3 for i in timed]
    p50 = {name: float(np.median([(end[i] - start[i]) * 1e3 for i in timed]))
           for name, start, end in (('wait', [None] + step_ends, arrived),
                                    ('copy', arrived, copied),
                                    ('step', copied, step_ends))}
    runs = {'training CLI: train': steps}
    for label, part in (('training CLI: eval', trained),
                        ('training CLI: test --eval_all', evals)):
        runs[label] = {k.__name__: sum(e[0][k.__name__] for e in part)
                       for k in per_batch}
    seconds = time.perf_counter() - t_phase
    print(f'training CLI (SECOND, {CLI_SCENES} synthetic scenes, B='
          f'{TRAIN_BATCH}, {CLI_EPOCHS} epochs, 8 workers): iteration p50 '
          f'{float(np.median(iteration)):.2f} ms from the loader = wait '
          f'{p50["wait"]:.2f} + copy {p50["copy"]:.2f} + step '
          f'{p50["step"]:.2f} (p50s; host clock, step end to step end, device '
          f'synchronised; {len(iteration)} iterations, the first of each epoch '
          f'and the profile window apart: {[round(t, 2) for t in iteration]}'
          f'); the profile window of steps '
          f'10-15 {window_s * 1e3:.2f} ms wall ({window_s * 1e3 / 5:.2f} ms a '
          f'step, profiler on); the trace\'s kernels {named}; eval '
          f'sec_per_example {trained[0][1]["sec_per_example"]:.4f} s; '
          f'{board}; train.main {train_s:.1f} s, test --eval_all '
          f'{test_s:.1f} s, the phase {seconds:.1f} s; launches {runs}',
          flush=True)
    return runs


def finite_boxes_held(torch, model, loader, post_cfg, num_class, annos):
    """The training CLI's eval of its final state (16 bf16 steps) against
    what the diagnosis of its non-finite boxes predicts
    (tests/test_torch_eval_after_training.py: the JAX package's eval of
    such a state overflows at the same rows; the eval batch's own
    BatchNorm statistics decode every box finite). Held: the kept boxes
    of that eval, taken again here with the running statistics, are as
    many and as many non-finite as the training run's annos hold, some
    of them non-finite; with every BatchNorm taking each eval batch's own
    statistics (train-mode BatchNorm, the head in eval mode) every kept
    box is finite."""
    from lidardetection_tpu_torch.models.detectors.post_processing import (
        post_processing,
    )
    from lidardetection_tpu_torch.models.layers import MaskedBatchNorm
    from lidardetection_tpu_torch.parallel.train_step import device_batch

    def kept_boxes(own_statistics):
        model.eval()
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                m.train(own_statistics)
        kept, bad = 0, 0
        with torch.inference_mode():
            for batch in loader:
                preds = post_processing(model(device_batch(batch, 'cuda')),
                                        post_cfg, num_class)
                boxes = preds['pred_boxes'][preds['pred_mask']]
                kept += len(boxes)
                bad += int((~torch.isfinite(boxes).all(-1)).sum())
        return kept, bad

    kept, bad = kept_boxes(False)
    want_bad = sum(int((~np.isfinite(a['boxes_lidar']).all(axis=1)).sum())
                   for a in annos)
    want_kept = sum(len(a['name']) for a in annos)
    own_kept, own_bad = kept_boxes(True)
    print(f'training CLI, the final state\'s eval: {kept} kept boxes, {bad} '
          f'not finite with the running statistics (the training run\'s '
          f'annos: {want_kept}, {want_bad}); with each eval batch\'s own '
          f'BatchNorm statistics {own_kept} kept, {own_bad} not finite',
          flush=True)
    check(kept == want_kept and bad == want_bad and bad > 0,
          'training CLI: the final state\'s eval overflows as the training '
          'run\'s eval read it')
    check(own_kept > 0 and own_bad == 0, 'training CLI: with the eval '
          'batches\' own BatchNorm statistics every kept box is finite')


MEASURE_SCENES, MEASURE_BATCH = 8, 4  # probe_rcnn_refine, ablate_approx
MEASURE_TRAIN_STEPS = 3  # the PV-RCNN steps that write their checkpoint
KITTI_EVAL_FRAMES = 3769     # bench_kitti_eval, the native host library
KITTI_EVAL_NUMPY_FRAMES = 754  # and its numpy plain version, a fifth


def finite_numbers(value):
    """Every number in a tool's result tree is finite (None allowed)."""
    if isinstance(value, dict):
        return all(finite_numbers(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(finite_numbers(v) for v in value)
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return bool(np.isfinite(value))
    return True


def tool_run(module, argv, label, runs, expected):
    """module.main(argv) as one run of a main path: every launch count set
    to 0 just before and read just after into runs[label]; each kernel of
    `expected` launched, every number printed finite. Returns main's
    result and its seconds."""
    from lidardetection_tpu_torch.tools.measure import (
        launches, reset_launches,
    )

    reset_launches()
    t0 = time.perf_counter()
    result = module.main(argv)
    seconds = time.perf_counter() - t0
    runs[label] = launches()
    check(finite_numbers(result), f'{label}: finite numbers')
    for name in expected:
        check(runs[label][name] > 0, f'{label}: {name} launched')
    return result, seconds


def kitti_eval_processes():
    """``bench_kitti_eval`` as users run it, one process each for the
    native host library at the val split's 3769 frames and for its numpy
    plain version at a fifth of them (~4 minutes at 3769 on one core): it
    launches no kernel, so both run on the host's cores while the card's
    tools run here."""
    import os

    cmd = [sys.executable, '-m', 'lidardetection_tpu_torch.tools.bench_kitti_eval']
    procs = {}
    for host, frames in (('native', KITTI_EVAL_FRAMES),
                         ('numpy', KITTI_EVAL_NUMPY_FRAMES)):
        env = {**os.environ, 'LIDARDET_TORCH_PLAIN_HOST': '1' if host == 'numpy'
               else '0'}
        procs[host] = subprocess.Popen(
            cmd + ['--frames', str(frames)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    return procs


def measure_tools_phase(torch, tmp):
    """The measurement and diagnostic tools (``lidardetection_tpu_torch/
    tools/``, each the counterpart of JAX tools) on the card, through their
    ``main`` at reduced iterations, before the first profiler phase (a
    profiler's callbacks slow every later launch in a process): each run a
    main path with its launch counts set to 0 before and read after, each
    kernel it runs launched, every number it returns finite, its headline
    on a line of its own. ``bench_kitti_eval`` runs as two processes
    beside them (``kitti_eval_processes``). ``probe_rcnn_refine`` and
    ``ablate_approx`` read a PV-RCNN checkpoint written here by
    MEASURE_TRAIN_STEPS training steps under the harness's edits: their IoUs
    and APs drive the path, they measure no trained model. Returns the runs'
    launches and the tools' seconds."""
    from lidardetection_tpu_torch.tools import bench_input

    t_phase = time.perf_counter()
    runs, seconds = {}, {}

    # the loader's rate first, before the protocol's processes share the
    # host's cores
    rows = bench_input.main(['--batch_size', '8', '--num_scenes', '48',
                             '--batches', '4', '--workers', '0', '8'])
    check(all(r['value'] and np.isfinite(r['value']) for r in rows),
          'bench_input: finite scans/s')
    print('measure tool bench_input: scans/s ' + ', '.join(
        f'{r["workers"]} workers {r["value"]}' for r in rows), flush=True)
    kitti = kitti_eval_processes()
    try:
        return measure_tools_on_card(torch, tmp, runs, seconds, kitti,
                                     t_phase)
    finally:
        for proc in kitti.values():  # ended already, unless a check failed
            proc.kill()
            proc.wait()


def measure_tools_on_card(torch, tmp, runs, seconds, kitti, t_phase):
    """`measure_tools_phase`'s tools after bench_input, beside the
    protocol's processes `kitti`, whose results it reads last."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.tools import (
        ablate_approx, microbench, microbench_rbconv, microbench_select,
        probe_rcnn_refine, profile_sparse, profile_stages, profile_vsa,
    )
    from lidardetection_tpu_torch.train import Trainer
    from lidardetection_tpu_torch.train_to_ap import overfit_config
    from lidardetection_tpu_torch.utils.checkpoint import save_checkpoint

    k1, k2, k3, k5 = ('pillar_vfe', 'scatter_rows', 'rulebook_conv',
                      'ball_select')

    def headline(name, text):
        print(f'measure tool {name}: {text}', flush=True)

    row, seconds['profile_stages'] = tool_run(
        profile_stages, ['--batch_size', '8', '--iters', '5'],
        'tools: profile_stages', runs, (k1, k2))
    headline('profile_stages', 'PointPillar B=8, cum ms ' + ', '.join(
        f'{name} {ms:.3f}' for name, ms, _ in row['stages']))

    row, seconds['profile_sparse'] = tool_run(
        profile_sparse, ['--batch_size', '8'], 'tools: profile_sparse', runs,
        (k3, k2))
    headline('profile_sparse', f'SECOND B=8, K3 conv total '
             f'{row["conv_total_ms"]:.4f} ms a batch; s2d (K2) '
             f'{row["s2d_ms"]:.4f} ms, bound {row["s2d_bound_ms"]:.4f}; per op '
             + ', '.join(f'{r[0]} {r[5]:.4f} (bound {r[6]:.4f})'
                         for r in row['layers']))

    row, seconds['profile_vsa'] = tool_run(
        profile_vsa, ['--iters', '5'], 'tools: profile_vsa', runs, (k5,))
    headline('profile_vsa', 'B=8, M=2048, ms ' + ', '.join(
        f'{label} {ms:.4f}' for label, ms, _ in row['rows']))

    row, seconds['microbench'] = tool_run(
        microbench, ['--case', 'all', '--iters', '5'], 'tools: microbench',
        runs, (k1, k2))
    check(row['vfe']['bit_equal'] and row['scatter']['max_abs_err'] == 0
          and row['nms']['kept_equal'],
          'microbench: K1 bit-equal, K2 against numpy, the NMS walk\'s lists')
    headline('microbench', json.dumps({
        'conv_blocks_tflop_per_s': {r['case']: round(r['tflop_per_s'], 1)
                                    for r in row['conv_blocks']},
        'conv_ms': {r['shape']: r['ms'] for r in row['conv']},
        'matmul_tflop_per_s': {r['shape']: round(r['tflop_per_s'], 1)
                               for r in row['matmul']},
        'vfe': {k: row['vfe'][k] for k in ('ms', 'plain_ms', 'bound_ms')},
        'scatter': {k: row['scatter'][k] for k in
                    ('ms', 'plain_ms', 'library_ms', 'fill_ms', 'bound_ms')},
        'nms': {k: row['nms'][k] for k in ('ms', 'full_matrix_ms')}}))

    row, seconds['microbench_rbconv'] = tool_run(
        microbench_rbconv, ['--iters', '10'], 'tools: microbench_rbconv', runs,
        (k3,))
    check(row['max_abs_err'] <= 1e-4 * row['max_abs_plain'],
          'microbench_rbconv: K3 within 1e-4 of its plain version')
    headline('microbench_rbconv', f'K3 {row["ms"]:.4f} ms, plain '
             f'{row["plain_ms"]:.4f}, bound {row["bound_ms"]:.4f}')

    row, seconds['microbench_select'] = tool_run(
        microbench_select, ['--case', 'all', '--iters', '5'],
        'tools: microbench_select', runs, (k5,))
    headline('microbench_select', json.dumps(
        {case: {label: round(ms, 4) for label, ms, _ in rows_}
         for case, rows_ in row.items() if isinstance(rows_, list)}))

    # the checkpoint of probe_rcnn_refine and ablate_approx
    t0 = time.perf_counter()
    cfg = overfit_config(cfg_from_yaml_file(CFG_PVRCNN))
    trainer = Trainer(cfg, device='cuda', seed=SEED, total_steps=1000)
    dataset = trainer.dataset(MEASURE_SCENES, seed=SEED)
    for i in range(MEASURE_TRAIN_STEPS):
        trainer.step(trainer.make_batch([dataset[2 * i], dataset[2 * i + 1]]))
    ckpt = tmp / 'pvrcnn_ckpt'
    save_checkpoint(trainer.state, ckpt, MEASURE_TRAIN_STEPS)
    del trainer
    seconds['pvrcnn checkpoint'] = time.perf_counter() - t0
    common = ['--ckpt_dir', str(ckpt), '--scenes', str(MEASURE_SCENES),
              '--batch_size', str(MEASURE_BATCH)]

    row, seconds['probe_rcnn_refine'] = tool_run(
        probe_rcnn_refine, common + ['--batches', '1'],
        'tools: probe_rcnn_refine', runs, (k3, k2, k5))
    headline('probe_rcnn_refine', f'{len(row["rows"])} rows (class, set, n, '
             f'iou before, after, delta, recall@0.7 before, after): '
             f'{row["rows"]}')
    row, seconds['ablate_approx'] = tool_run(
        ablate_approx, common + ['--output_dir', str(tmp / 'ablate')],
        'tools: ablate_approx', runs, (k3, k2, k5))
    check(not any('error' in r for r in row['rows'].values()),
          f'ablate_approx: every variant evaluated ({row["rows"]})')
    headline('ablate_approx', json.dumps({'rows': row['rows'],
                                          'deltas': row['deltas']}))

    for host, proc in kitti.items():
        out, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f'bench_kitti_eval ({host}) exit 0: {err[-2000:]}')
        result = json.loads(out.strip().splitlines()[-1])
        check(result['host'] == host and finite_numbers(result),
              f'bench_kitti_eval ({host}): a finite result')
        headline(f'bench_kitti_eval ({host})', json.dumps(result))
    seconds['phase'] = time.perf_counter() - t_phase
    print(json.dumps({'measure_tools_seconds': seconds}), flush=True)
    return runs


def voxelize_device_phase(torch):
    """``ops/voxelize.py::voxelize_device`` (the JAX package's
    ``voxelize_jax``) on the card, at a KITTI scan (``make_scene``, 18960
    points in range, second.yaml's voxelizer) and a NuScenes 10-sweep scan
    (``make_sweeps``, ~269.5k in range, cbgs_second_multihead.yaml's), each
    cloud put on the card padded by 1024 rows past its valid count, at the
    config's test cap. Held: the card's result bit-equal to its own CPU
    run, and to the host voxelizer's table (``voxelize_np``, sorted by key)
    taken with room for every voxel and cut to the cap: below the cap the
    same table, above it the lowest keys. Timed: the call on the host
    clock around a drained device (p50 of 10), its device time
    (``cuda_ms``), and the host voxelizer at the cap (p50 of 5)."""
    from lidardetection_tpu_torch.config import (
        cfg_from_yaml_file, voxel_processor_cfg,
    )
    from lidardetection_tpu_torch.datasets.synthetic import (
        make_scene, make_sweeps,
    )
    from lidardetection_tpu_torch.ops.voxelize import (
        voxelize_device, voxelize_np,
    )

    rows = {}
    for label, cfg_file in (('KITTI scan', CFG_SECOND),
                            ('NuScenes 10-sweep scan', CFG_CBGS_SECOND)):
        cfg = cfg_from_yaml_file(cfg_file)
        proc = voxel_processor_cfg(cfg['DATA_CONFIG'])
        pcr = tuple(float(x) for x in cfg['DATA_CONFIG']['POINT_CLOUD_RANGE'])
        vsz = tuple(float(x) for x in proc['VOXEL_SIZE'])
        per = int(proc['MAX_POINTS_PER_VOXEL'])
        cap = int(proc['MAX_NUMBER_OF_VOXELS']['test'])
        rng = np.random.RandomState(SEED)
        if cfg_file == CFG_CBGS_SECOND:
            points = make_sweeps(rng, np.float32(pcr), NUSCENES_SWEEPS,
                                 NUSCENES_GROUND,
                                 class_names=tuple(cfg['CLASS_NAMES']))[0]
        else:
            points = make_scene(rng, np.float32(pcr),
                                class_names=tuple(cfg['CLASS_NAMES']))[0]
        n = len(points)
        padded = torch.from_numpy(np.concatenate(
            [points, np.full((1024, points.shape[1]), 1e4, np.float32)]))
        on_card = padded.cuda()

        def call():
            return voxelize_device(on_card, n, pcr, vsz, per, cap)

        got = [t.cpu() for t in call()]
        cpu = voxelize_device(padded, n, pcr, vsz, per, cap)
        host = voxelize_np(points, pcr, vsz, per, max(n, cap))  # room for all
        kept = min(host[3], cap)
        check(all(torch.equal(a, b) for a, b in zip(got, cpu)),
              f'voxelize_device, {label}: card vs its CPU run')
        check(all(np.array_equal(a.numpy(), b[:cap])
                  for a, b in zip(got[:3], host[:3]))
              and int(got[3]) == kept,
              f'voxelize_device, {label}: card vs the host voxelizer\'s '
              'sorted table')
        host_clock = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            if i >= 2:
                host_clock.append((time.perf_counter() - t0) * 1e3)
        host_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            voxelize_np(points, pcr, vsz, per, cap)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        rows[label] = {
            'points_in_range': in_range(points, pcr), 'voxels': int(host[3]),
            'cap': cap, 'p50_ms': float(np.median(host_clock)),
            'device_ms': cuda_ms(call),
            'host_voxelizer_ms': float(np.median(host_ms))}
        r = rows[label]
        print(f'voxelize_device, {label}: {r["points_in_range"]} points in '
              f'range, {r["voxels"]} voxels, cap {cap}: p50 {r["p50_ms"]:.3f} '
              f'ms (host clock, device drained), device {r["device_ms"]:.4f} '
              f'ms; the host voxelizer {r["host_voxelizer_ms"]:.3f} ms; '
              'bit-equal to its CPU run and to the host voxelizer\'s sorted '
              'table', flush=True)
    return rows


def point_cloud_range(cfg_file):
    """A config's POINT_CLOUD_RANGE."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file

    return cfg_from_yaml_file(cfg_file)['DATA_CONFIG']['POINT_CLOUD_RANGE']


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from lidardetection_tpu_torch.ops import _build
    from lidardetection_tpu_torch.serve import Detector

    card = gpu_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    messages = _build.build()
    print(f'built {sorted(messages)} in {time.perf_counter() - t0:.1f} s '
          f'(nvcc {" ".join(_build.NVCC_FLAGS)})', flush=True)
    for name, text in messages.items():
        for line in text.splitlines():
            # which kernel each line is about, for the two sparse-conv sources
            if 'registers' in line or 'spill' in line or (
                    name.startswith('sparse_conv') and 'Compiling entry' in line):
                print(f'  {name}.cu: {line.strip()}', flush=True)
    from lidardetection_tpu_torch import native
    built = not native.library_path().exists()
    t0 = time.perf_counter()
    native.load()
    print(f'{"built" if built else "found"} the KITTI protocol\'s host library '
          f'{native.library_path().name} in {time.perf_counter() - t0:.1f} s '
          f'(g++ {" ".join(native.CXX_FLAGS)})', flush=True)
    # the TF32 flags stay as PyTorch sets them: the port holds its f32
    # configs in f32 itself (utils/precision.py), as a user's run sees it

    # what cuda_ms reads for a one-element kernel: the floor under every
    # kernel time below (events, launch, a cold L2), beside the earlier
    # timer's (its flush left the L2 dirty)
    tiny = torch.zeros(1, device='cuda')
    print(f'timing floor: a one-element add_ reads '
          f'{cuda_ms(lambda: tiny.add_(1)):.4f} ms (the earlier flush: '
          f'{cuda_ms(lambda: tiny.add_(1), flush="dirty"):.4f} ms)', flush=True)
    # what each flush leaves behind: a 32 MB read and a 32 MB write timed
    # after it pay for the dirty lines they evict
    probe = torch.ones(8 << 20, device='cuda')
    for what, fn in (('read (sum)', probe.sum), ('write (zero_)', probe.zero_)):
        print(f'L2 flush probe, a 32 MB {what}: after the clean flush '
              f'{cuda_ms(fn):.4f} ms, after the earlier (dirty) flush '
              f'{cuda_ms(fn, flush="dirty"):.4f} ms', flush=True)
    del probe

    if sys.argv[1:2] == ['--deterministic-cost']:
        from lidardetection_tpu_torch.train import Trainer
        deterministic_cost(torch, lambda cfg_file: Trainer(
            cfg_file, device='cuda', seed=SEED, total_steps=1000))
        print(card, flush=True)
        return 0
    from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows
    from lidardetection_tpu_torch.ops.select_cuda import ball_select
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv, rulebook_conv_dw,
    )
    from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe
    from lidardetection_tpu_torch.train import Trainer

    def served(cfg_file, n_requests, per_request, earlier, clouds=make_clouds):
        """Detector with live NMS candidates, warmed up, then the main
        path: returns it, its clouds and the launch counts of the run.
        `clouds(det, n, seed)` makes the requests' clouds."""
        det = Detector(cfg_file, device='cuda', seed=SEED)
        zero_class_bias(torch, det.model)
        clouds = clouds(det, n_requests + 2, SEED)
        for points in clouds[:2]:  # warm-up: cuDNN plans, allocator
            det.postprocess(det.forward(det.make_batch([points])))
        torch.cuda.synchronize()
        return det, clouds[2:], serve_phase(torch, det, clouds[2:],
                                            per_request, earlier)

    print('== PointPillar ==', flush=True)
    det, clouds, launches = served(
        CFG, N_REQUESTS, {pillar_vfe: 1, scatter_rows: 1},
        {'latency': 120.99, 'make_batch': 31.35, 'postprocess': 82.63})
    (k1, k2), scatter_case = pillar_kernel_phase(torch, det)
    forward_split(det, clouds[0])
    compare_phase(torch, det, CFG, clouds[:2])
    profiled = [(det, clouds[0])]  # traced last: see profile_run

    print('== SECOND ==', flush=True)
    det, clouds, launches_second = served(
        CFG_SECOND, N_REQUESTS_SECOND, {rulebook_conv: 12, scatter_rows: 1},
        {'latency': 113.77, 'postprocess': 79.39})
    k3, k2_second = sparse_kernel_phase(torch, det)
    k2['second'] = k2_second
    forward_split(det, clouds[0])
    compare_phase(torch, det, CFG_SECOND, clouds[:2])
    profiled.append((det, clouds[0]))
    del det

    print('== PV-RCNN ==', flush=True)
    wrappers = (pillar_vfe, scatter_rows, rulebook_conv, rulebook_conv_dw,
                ball_select)
    det, clouds, launches_pvrcnn = served(
        CFG_PVRCNN, N_REQUESTS_PVRCNN, dict(zip(wrappers, (0, 1, 12, 0, 5))),
        {'latency': 83.04})
    k5 = select_kernel_phase(torch, det)
    pvrcnn_split(torch, det, clouds[0], k5)
    compare_plain_phase(torch, det, CFG_PVRCNN, clouds[0], wrappers)
    profiled.append((det, clouds[0]))
    del det

    print('== Part-A2 ==', flush=True)
    torch.cuda.reset_peak_memory_stats()
    det, clouds, launches_parta2 = served(
        CFG_PARTA2, N_REQUESTS_PARTA2, dict(zip(wrappers, (0, 1, 28, 0, 0))),
        None)
    print(f'Part-A2 serving peak memory {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} '
          'MiB (warm-up and timed requests)', flush=True)
    k3_parta2 = unet_kernel_phase(torch, det)
    parta2_split(torch, det, clouds[0])
    avg_pool_cost(torch, det, clouds[0])
    compare_plain_phase(torch, det, CFG_PARTA2, clouds[0], wrappers)
    profiled.append((det, clouds[0]))
    del det

    print('== PointRCNN ==', flush=True)
    torch.cuda.reset_peak_memory_stats()
    # 2 K5 a request: the first two set abstraction levels (16384 and 4096
    # sources) take the grid query, the others and the RoI head's the
    # brute-force one
    det, clouds, launches_pointrcnn = served(
        CFG_POINTRCNN, N_REQUESTS_POINTRCNN,
        dict(zip(wrappers, (0, 0, 0, 0, 2))), None)
    print(f'PointRCNN serving peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB (warm-up and '
          'timed requests)', flush=True)
    k5_pointrcnn, k5_pointrcnn_err = pointrcnn_kernel_phase(torch, det)
    pointrcnn_split(torch, det, clouds[0])
    compare_plain_phase(torch, det, CFG_POINTRCNN, clouds[0], wrappers)
    profiled.append((det, clouds[0]))
    del det

    print('== NuScenes CBGS SECOND multi-head ==', flush=True)
    # VoxelResBackBone8x: conv_input, 7 residual blocks of two, 3 strided
    # and conv_out, 19 K3; HeightCompression's scatter, 1 K2
    torch.cuda.reset_peak_memory_stats()
    det, clouds, launches_cbgs = served(
        CFG_CBGS_SECOND, N_REQUESTS_VARIANTS,
        dict(zip(wrappers, (0, 1, 19, 0, 0))), None, clouds=dense_clouds)
    print(f'CBGS SECOND serving peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB (warm-up and '
          f'timed requests); points in range per cloud '
          f'{[in_range(c, det.info["point_cloud_range"]) for c in clouds]}',
          flush=True)
    k3_cbgs = request_kernel_phase(
        torch, det, clouds[0], 'CBGS SECOND',
        (('conv_input', 1), ('stage 1', 2), ('stage 2', 5), ('stage 3', 5),
         ('stage 4', 5), ('conv_out', 1)))
    forward_split(det, clouds[0],
                  modules=[('dense head: shared conv', det.model.dense_head.shared_conv)]
                  + [(f'dense head: group {i}', h)
                     for i, h in enumerate(det.model.dense_head.rpn_heads)])
    compare_multiclass_phase(torch, det, CFG_CBGS_SECOND, clouds[0])
    profiled.append((det, clouds[0]))
    del det

    print('== NuScenes CBGS PointPillar multi-head ==', flush=True)
    # 5-feature pillars take the PFN stack (no K1, as in the JAX package)
    torch.cuda.reset_peak_memory_stats()
    det, clouds, launches_cbgs_pp = served(
        CFG_CBGS_PP, N_REQUESTS_VARIANTS, dict(zip(wrappers, (0, 1, 0, 0, 0))),
        None, clouds=dense_clouds)
    print(f'CBGS PointPillar serving peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB', flush=True)
    forward_split(det, clouds[0])
    del det

    print('== PV-RCNN multiframe ==', flush=True)
    det, clouds, launches_multiframe = served(
        CFG_MULTIFRAME, N_REQUESTS_VARIANTS,
        dict(zip(wrappers, (0, 1, 12, 0, 5))), None)
    forward_split(det, clouds[0])
    compare_plain_phase(torch, det, CFG_MULTIFRAME, clouds[0], wrappers)
    del det

    print('== Part-A2 free ==', flush=True)
    # UNetV2 without conv_out (RETURN_ENCODED_TENSOR false): 27 K3, no K2
    det, clouds, launches_free = served(
        CFG_PARTA2_FREE, N_REQUESTS_VARIANTS,
        dict(zip(wrappers, (0, 0, 27, 0, 0))), None)
    compare_plain_phase(torch, det, CFG_PARTA2_FREE, clouds[0], wrappers)
    del det

    def trained(cfg_file, seed, per_step, earlier, schedule_steps=None,
                warmup=TRAIN_WARMUP, steps=TRAIN_STEPS, dense=False):
        """Trainer at full width, its batches (`dense`: as dense as a
        10-sweep NuScenes scan), and the launch counts of the timed steps
        of the training main path. The one-cycle schedule spans
        `schedule_steps` (default: the steps taken here)."""
        n_steps = warmup + steps
        trainer = Trainer(cfg_file, device='cuda', seed=SEED,
                          total_steps=schedule_steps or n_steps)
        batches, make_ms = train_batches(trainer, n_steps, seed, dense)
        what = f'voxelization at the train cap of {trainer.max_voxels}' \
            if trainer.vox is not None else \
            f'point sampling to {trainer.max_points} and shuffling'
        print(f'make_batch B={train_batch_size(trainer)} (host {what} and the '
              f'copy): p50 {make_ms:.2f} ms', flush=True)
        return trainer, batches, train_phase(torch, trainer, batches,
                                             per_step, earlier, warmup)

    print('== PointPillar training ==', flush=True)
    trainer, batches, launches_train = trained(
        CFG, SEED + 300, dict(zip(wrappers, (0, 1, 0, 0, 0))), 42.00)
    step_split(torch, trainer, batches[-1])
    reproducibility_phase(torch, trainer, batches[-1])
    compare_train_phase(torch, trainer, CFG, batches[-1], wrappers)
    trainer_pillar, batch_pillar = trainer, batches[-1]
    del trainer, batches

    print('== SECOND training ==', flush=True)
    # the training plan: 12 K3 forward, 7 submanifold and 4 strided df
    trainer, batches, launches_train_second = trained(
        CFG_SECOND, SEED + 400, dict(zip(wrappers, (0, 1, 12 + 11, 12, 0))),
        97.99)
    split = step_split(torch, trainer, batches[-1])
    reproducibility_phase(torch, trainer, batches[-1])
    host_plan_phase(trainer)
    k4, k3_step = weight_gradient_phase(torch, trainer, batches[-1],
                                        split['backward'])
    k3.update(k3_step)
    compare_train_phase(torch, trainer, CFG_SECOND, batches[-1], wrappers)
    trainer_second, batch_second = trainer, batches[-1]
    del trainer, batches

    print('== PV-RCNN training ==', flush=True)
    # the learning rate of a run's first steps (LR / DIV_FACTOR = 1e-3): a
    # one-cycle squeezed into five steps reaches pv_rcnn.yaml's LR of 0.01
    # at the third, where the random-weight model's boxes grow without bound
    trainer, batches, launches_train_pvrcnn = trained(
        CFG_PVRCNN, SEED + 600, dict(zip(wrappers, (0, 1, 12 + 11, 12, 5))),
        967.02, schedule_steps=1000)
    pvrcnn_step_split(torch, trainer, batches[-1])
    reproducibility_phase(torch, trainer, batches[-1])
    compare_train_phase(torch, trainer, CFG_PVRCNN, batches[-1], wrappers)
    trainer_pvrcnn, batch_pvrcnn = trainer, batches[-1]
    del trainer, batches

    print('== Part-A2 training ==', flush=True)
    # 28 K3 forward, 27 df (7 encoder and 13 decoder submanifold, 4
    # strided, 3 inverse), 28 K4, 1 K2; a run's first learning rate, as
    # for PV-RCNN
    trainer, batches, launches_train_parta2 = trained(
        CFG_PARTA2, SEED + 800, dict(zip(wrappers, (0, 1, 28 + 27, 28, 0))),
        None, schedule_steps=1000)
    split = parta2_step_split(torch, trainer, batches[-1])
    k4_parta2, k3_parta2_step = unet_gradient_phase(torch, trainer, batches[-1])
    print(f'Part-A2 step: K3 {k3_parta2_step["per_step_ms"]:.4f} ms and K4 '
          f'{k4_parta2["per_step_ms"]:.4f} ms of the {split["backward"]:.2f} ms '
          'backward and the forward', flush=True)
    reproducibility_phase(torch, trainer, batches[-1])
    host_plan_phase(trainer)
    compare_train_phase(torch, trainer, CFG_PARTA2, batches[-1], wrappers)
    trainer_parta2, batch_parta2 = trainer, batches[-1]
    del trainer, batches

    print('== PointRCNN training ==', flush=True)
    # 2 K5 a step (forward only: the ball query has no gradient); a run's
    # first learning rate, as for PV-RCNN
    trainer, batches, launches_train_pointrcnn = trained(
        CFG_POINTRCNN, SEED + 1000, dict(zip(wrappers, (0, 0, 0, 0, 2))),
        None, schedule_steps=1000)
    pointrcnn_step_split(torch, trainer, batches[-1])
    reproducibility_phase(torch, trainer, batches[-1])
    compare_train_phase(torch, trainer, CFG_POINTRCNN, batches[-1], wrappers)
    trainer_pointrcnn, batch_pointrcnn = trainer, batches[-1]
    del trainer, batches

    print('== NuScenes CBGS SECOND multi-head training ==', flush=True)
    # 19 K3 forward + 14 submanifold and 4 strided df, 19 K4, 1 K2
    trainer, batches, launches_train_cbgs = trained(
        CFG_CBGS_SECOND, SEED + 1200,
        dict(zip(wrappers, (0, 1, 19 + 18, 19, 0))), None,
        schedule_steps=1000, dense=True)
    split = step_split(torch, trainer, batches[-1])
    k4_cbgs, k3_cbgs_step = step_kernel_phase(
        torch, trainer, batches[-1], 'CBGS SECOND', 19, 18,
        strided_df_pairs(batches[-1], ('down2', 'down3', 'down4', 'out')))
    print(f'CBGS SECOND step: K3 {k3_cbgs_step["per_step_ms"]:.4f} ms and K4 '
          f'{k4_cbgs["per_step_ms"]:.4f} ms of the {split["backward"]:.2f} ms '
          'backward and the forward', flush=True)
    reproducibility_phase(torch, trainer, batches[-1])
    trainer_cbgs, batch_cbgs = trainer, batches[-1]
    del trainer, batches

    print('== NuScenes CBGS PointPillar multi-head training ==', flush=True)
    trainer, batches, launches_train_cbgs_pp = trained(
        CFG_CBGS_PP, SEED + 1300, dict(zip(wrappers, (0, 1, 0, 0, 0))), None,
        schedule_steps=1000, warmup=1, steps=1, dense=True)
    reproducibility_phase(torch, trainer, batches[-1])
    del trainer, batches

    print('== PV-RCNN multiframe training ==', flush=True)
    trainer, batches, launches_train_multiframe = trained(
        CFG_MULTIFRAME, SEED + 1400,
        dict(zip(wrappers, (0, 1, 12 + 11, 12, 5))), None, schedule_steps=1000)
    tracking_phase(torch, trainer, batches[-1])
    reproducibility_phase(torch, trainer, batches[-1])
    del trainer, batches

    print('== Part-A2 free training ==', flush=True)
    # 27 K3 forward, 26 df (20 submanifold, 3 strided, 3 inverse), 27 K4
    trainer, batches, launches_train_free = trained(
        CFG_PARTA2_FREE, SEED + 1500,
        dict(zip(wrappers, (0, 0, 27 + 26, 27, 0))), None, schedule_steps=1000,
        warmup=1, steps=2)
    reproducibility_phase(torch, trainer, batches[-1])
    del trainer, batches

    print('== evaluation ==', flush=True)
    launches_eval, annos, dataset = eval_phase(
        torch, CFG, dict(zip(wrappers, (1, 1, 0, 0, 0))))
    evals = {'PointPillar': (dataset, annos)}
    launches_eval_second, annos, dataset = eval_phase(
        torch, CFG_SECOND, dict(zip(wrappers, (0, 1, 12, 0, 0))))
    evals['SECONDNet'] = (dataset, annos)
    bucketed_eval_phase(torch, CFG_SECOND)
    launches_eval_parta2, annos, dataset = eval_phase(
        torch, CFG_PARTA2, dict(zip(wrappers, (0, 1, 28, 0, 0))))
    evals['PartA2Net'] = (dataset, annos)
    bucketed_eval_phase(torch, CFG_PARTA2)
    launches_eval_pointrcnn, annos, dataset = eval_phase(
        torch, CFG_POINTRCNN, dict(zip(wrappers, (0, 0, 0, 0, 2))))
    evals['PointRCNN'] = (dataset, annos)
    launches_eval_mh, annos, dataset = eval_phase(
        torch, CFG_SECOND_MH, dict(zip(wrappers, (0, 1, 12, 0, 0))))
    evals['SECONDNet multi-head'] = (dataset, annos)
    protocol_phase(evals)
    precise_bn_phase(torch)

    print('== the on-device voxelizer ==', flush=True)
    voxelize_device_phase(torch)

    print('== the data layer: training and evaluation from files ==', flush=True)
    data_root = tempfile.TemporaryDirectory(prefix='chip_smoke_data_')
    t0 = time.perf_counter()
    runs_from_files, errors_from_files, trainer_files, batches_files, \
        refill_files = data_layer_phase(torch, wrappers, Path(data_root.name))
    print(f'data layer phase: {time.perf_counter() - t0:.1f} s', flush=True)

    print('== the fork\'s datasets and the process group ==', flush=True)
    t0 = time.perf_counter()
    fork_root = tempfile.TemporaryDirectory(prefix='chip_smoke_fork_')
    runs_from_fork, errors_from_fork = fork_data_phase(
        torch, wrappers, Path(fork_root.name))
    fork_root.cleanup()
    print(f'fork data phase: {time.perf_counter() - t0:.1f} s', flush=True)

    print('== the measurement tools ==', flush=True)
    measure_root = tempfile.TemporaryDirectory(prefix='chip_smoke_measure_')
    runs_from_measure = measure_tools_phase(torch, Path(measure_root.name))
    measure_root.cleanup()

    print('== under the profiler ==', flush=True)
    scatter_launch_count(torch, *scatter_case)

    def steps_from_files(n):
        from lidardetection_tpu_torch.parallel.train_step import device_batch
        for _ in range(n):
            trainer_files.step(device_batch(next(batches_files), 'cuda'))

    # the workers have built their batches ahead again since the timed
    # steps: take those first, so that the traced steps read the loader at
    # its steady state; the wait inside the traced span gives the device's
    # idle share of training from files
    steps_from_files(refill_files)
    profile_run(f'SECONDNet: {PROFILED_STEPS} training steps fed by '
                'the loader', lambda: steps_from_files(PROFILED_STEPS))
    batches_files.close()  # the loader's workers end
    for det, points in profiled:
        profile_request(torch, det, points)
    for each, batch in ((trainer_pillar, batch_pillar),
                        (trainer_second, batch_second),
                        (trainer_pvrcnn, batch_pvrcnn),
                        (trainer_parta2, batch_parta2),
                        (trainer_pointrcnn, batch_pointrcnn),
                        (trainer_cbgs, batch_cbgs)):
        profile_run(f'{each.cfg["MODEL"]["NAME"]} training step',
                    lambda: each.step(batch))
    # profile_trace, under its own profiler: PV-RCNN's eval step at B = 8
    from lidardetection_tpu_torch.tools import profile_trace
    trace_root = tempfile.TemporaryDirectory(prefix='chip_smoke_trace_')
    row, _ = tool_run(profile_trace, ['--iters', '2', '--top', '12', '--out',
                                      trace_root.name],
                      'tools: profile_trace', runs_from_measure,
                      ('rulebook_conv', 'scatter_rows', 'ball_select'))
    trace_root.cleanup()
    check(row['device_ms_per_iter'] is not None and row['device_ms_per_iter'] > 0,
          'profile_trace: device time recorded')
    print(f'measure tool profile_trace: PV-RCNN eval step B=8, device kernels '
          f'{row["device_ms_per_iter"]:.3f} ms/iter, wall '
          f'{row["wall_ms_per_iter"]:.3f} ms/iter, idle share '
          f'{row["idle_share"]:.3f}, top {row["top"]}', flush=True)

    print('== the tools ==', flush=True)
    tools_root = tempfile.TemporaryDirectory(prefix='chip_smoke_tools_')
    runs_from_tools, verify_cases = tools_phase(
        torch, wrappers, Path(data_root.name) / 'kitti', Path(tools_root.name))
    tools_root.cleanup()
    data_root.cleanup()

    print('== the training CLI ==', flush=True)
    cli_root = tempfile.TemporaryDirectory(prefix='chip_smoke_cli_')
    runs_from_cli = train_cli_phase(torch, wrappers, Path(cli_root.name))
    cli_root.cleanup()

    # launches: the sum over the forty main paths' runs, each counted
    # from 0
    runs = {'PointPillar serving': launches, 'SECONDNet serving': launches_second,
            'PVRCNN serving': launches_pvrcnn,
            'PartA2Net serving': launches_parta2,
            'PointRCNN serving': launches_pointrcnn,
            'PointPillar training': launches_train,
            'SECONDNet training': launches_train_second,
            'PVRCNN training': launches_train_pvrcnn,
            'PartA2Net training': launches_train_parta2,
            'PointRCNN training': launches_train_pointrcnn,
            'PointPillar eval': launches_eval,
            'SECONDNet eval': launches_eval_second,
            'PartA2Net eval': launches_eval_parta2,
            'PointRCNN eval': launches_eval_pointrcnn,
            'CBGS SECOND multi-head serving': launches_cbgs,
            'CBGS PointPillar multi-head serving': launches_cbgs_pp,
            'PV-RCNN multiframe serving': launches_multiframe,
            'PartA2-free serving': launches_free,
            'CBGS SECOND multi-head training': launches_train_cbgs,
            'CBGS PointPillar multi-head training': launches_train_cbgs_pp,
            'PV-RCNN multiframe training': launches_train_multiframe,
            'PartA2-free training': launches_train_free,
            'SECOND multi-head eval': launches_eval_mh, **runs_from_files,
            **runs_from_fork, **runs_from_tools, **runs_from_cli,
            **runs_from_measure}
    # Part-A²'s per-layer rows on a line of their own, its totals in the
    # kernels line
    parta2_rows = {'K3 request': k3_parta2.pop('layers'),
                   'K3 step': k3_parta2_step.pop('step_layers'),
                   'K4 step': k4_parta2.pop('layers')}
    print(json.dumps({'parta2_layers': parta2_rows}), flush=True)
    k3['parta2'] = {**k3_parta2, **k3_parta2_step}
    k4['parta2'] = k4_parta2
    # VoxelResBackBone8x's (the CBGS SECOND multi-head) likewise
    print(json.dumps({'cbgs_layers': {
        'K3 request': k3_cbgs.pop('layers'),
        'K3 step': k3_cbgs_step.pop('step_layers'),
        'K4 step': k4_cbgs.pop('layers')}}), flush=True)
    k3['cbgs'] = {**k3_cbgs, **k3_cbgs_step}
    k4['cbgs'] = k4_cbgs
    # K5 at PointRCNN's two levels: its rows beside PV-RCNN's five sources
    k5['pointrcnn'] = k5_pointrcnn
    k5['max_abs_err'] = max(k5['max_abs_err'], k5_pointrcnn_err)
    k3['max_abs_err'] = max(k3['max_abs_err'], k3_parta2['max_abs_err'],
                            k3_cbgs['max_abs_err'])
    k4['max_abs_err'] = max(k4['max_abs_err'], k4_parta2['max_abs_err'],
                            k4_cbgs['max_abs_err'])
    # K1 and K2 on an eval batch from the loader, K2-K4 on a CBGS training
    # batch from it
    for k in (k1, k2, k3, k4, k5):
        k['max_abs_err'] = max(k['max_abs_err'],
                               errors_from_files.get(k['name'], 0.0),
                               errors_from_fork.get(k['name'], 0.0))
    kernels = [k1, k2, k3, k4, k5]
    for k in kernels:  # the verifier's cases of each kernel
        mine = [c for c in verify_cases if c['kernel'] == k['name']]
        k['verify_cuda'] = [{'case': c['case'], 'max_abs_err': c['max_abs_err']}
                            for c in mine]
        check(mine, f'verify_cuda checked {k["name"]}')
        k['max_abs_err'] = max([k['max_abs_err']]
                               + [c['max_abs_err'] for c in mine])
    for k in kernels:
        k['launches'] = sum(run.get(k['name'], 0) for run in runs.values())
        check(k['launches'] > 0, f'{k["name"]} ran on a main path')
    for k in kernels:  # the timer's flush: clean (now) against dirty (before)
        print(f'{k["name"]}: {k["ms"]:.4f} ms a call with the L2 flushed '
              f'clean, {k["old_flush_ms"]:.4f} ms with the earlier flush (a '
              f'64 MB write, the L2 left dirty)', flush=True)
    print(json.dumps({'launches': runs, 'card': card}), flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
