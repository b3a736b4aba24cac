"""The host C++ of the port, bound with ctypes (a copy of
lidardetection_tpu/native/__init__.py:90-203 for these functions).

``rotated_iou.cpp`` (the rotated BEV IoU of box pairs), ``kitti_stats.cpp``
(the KITTI protocol's matching loops), ``voxelizer.cpp`` (the hard
voxelizer) and ``rulebooks.cpp`` (the sparse-conv rulebook chain of a
host plan) are compiled at first use with the host ``g++ -O3 -shared
-fPIC -std=c++17`` into
``build/libhost-<hash>.so`` at the repository root, beside the CUDA
kernels of ``ops/_build.py``; the hash covers the sources and the flags,
so an edited source is rebuilt. A build writes to a temporary name and
renames it. A library that fails to build raises with the compiler's
messages: nothing gives way in silence.

The numpy code of ``core/np_geometry.py``, of the protocol
(``datasets/kitti/kitti_object_eval/eval.py``), of ``ops/voxelize.py`` and
of ``ops/sparse_plan.py`` is the plain version of this library. It is taken only when asked for: set the environment
variable ``LIDARDET_TORCH_PLAIN_HOST=1``, or run inside ``plain_host()``.
"""

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PLAIN_ENV = 'LIDARDET_TORCH_PLAIN_HOST'
SOURCES = tuple(Path(__file__).resolve().parent / name
                for name in ('rotated_iou.cpp', 'kitti_stats.cpp',
                             'voxelizer.cpp', 'rulebooks.cpp'))
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_lock = threading.Lock()
_lib = None


def plain_requested():
    """Whether the caller asked for the numpy plain version."""
    return os.environ.get(PLAIN_ENV, '') not in ('', '0')


@contextlib.contextmanager
def plain_host(plain=True):
    """Run the block with (or without) the numpy plain version; the
    variable's earlier value is put back."""
    before = os.environ.get(PLAIN_ENV)
    os.environ[PLAIN_ENV] = '1' if plain else '0'
    try:
        yield
    finally:
        if before is None:
            del os.environ[PLAIN_ENV]
        else:
            os.environ[PLAIN_ENV] = before


def library_path():
    digest = hashlib.sha1(' '.join(CXX_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f'libhost-{digest.hexdigest()[:12]}.so'


def _build(out):
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = ['g++', *CXX_FLAGS, *map(str, SOURCES), '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'cannot run the host compiler ({" ".join(cmd)}): '
                           f'{e}') from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed to build {out.name} '
                           f'({" ".join(cmd)}):\n{proc.stderr}')
    os.replace(tmp, out)


def load():
    """The loaded library, built if needed; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            f32p = ctypes.POINTER(ctypes.c_float)
            f64p = ctypes.POINTER(ctypes.c_double)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.voxelize_f32.restype = ctypes.c_int32
            lib.voxelize_f32.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int32, f32p, f32p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f32p, i32p,
                i32p]
            lib.build_rulebooks.restype = ctypes.c_int32
            lib.build_rulebooks.argtypes = [
                i32p, ctypes.c_int32, ctypes.c_int32, i64p, i32p,
                ctypes.c_int32, i32p, i32p, i32p]
            lib.rotated_iou_bev.restype = None
            lib.rotated_iou_bev.argtypes = [
                f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_int32,
                f32p]
            lib.kitti_tp_scores.restype = ctypes.c_int32
            lib.kitti_tp_scores.argtypes = [
                f64p, ctypes.c_int32, ctypes.c_int32, f64p, i32p, i32p,
                ctypes.c_double, f64p]
            lib.kitti_fused_stats.restype = None
            lib.kitti_fused_stats.argtypes = [
                f64p, ctypes.c_int32, ctypes.c_int32, f64p, f64p, f64p,
                f64p, ctypes.c_int32, i32p, i32p, ctypes.c_int32,
                ctypes.c_double, f64p, ctypes.c_int32, ctypes.c_int32, f64p]
            _lib = lib
    return _lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def voxelize(points, point_cloud_range, voxel_size, max_points_per_voxel,
             max_voxels):
    """The hard voxelizer of ``ops/voxelize.py::voxelize_np`` (its
    outputs, the table sorted by linear key)."""
    lib = load()
    points = np.ascontiguousarray(points, dtype=np.float32)
    pc_range = np.ascontiguousarray(point_cloud_range, dtype=np.float32)
    vsz = np.ascontiguousarray(voxel_size, dtype=np.float32)
    n, c = points.shape
    voxels = np.empty((max_voxels, max_points_per_voxel, c), np.float32)
    coords = np.empty((max_voxels, 3), np.int32)
    num_points = np.empty((max_voxels,), np.int32)
    n_vox = lib.voxelize_f32(
        _f32p(points), n, c, _f32p(pc_range), _f32p(vsz),
        max_points_per_voxel, max_voxels, 1,
        _f32p(voxels), _i32p(coords), _i32p(num_points))
    return voxels, coords, num_points, int(n_vox)


def build_rulebooks(coords, n_vox, cap_in, spatial_shape, plan_records,
                    total_rb, total_oc, n_down):
    """The rulebook chain of a plan (``ops/sparse_plan.py``) for one scan:
    flat int32 (rulebooks, out coords, out nums)."""
    lib = load()
    coords = np.ascontiguousarray(coords, dtype=np.int32)
    spatial = np.ascontiguousarray(spatial_shape, dtype=np.int64)
    plan = np.ascontiguousarray(plan_records, dtype=np.int32)
    rb_buf = np.empty(total_rb, np.int32)
    oc_buf = np.empty(max(total_oc, 1), np.int32)
    on_buf = np.empty(max(n_down, 1), np.int32)
    rc = lib.build_rulebooks(
        _i32p(coords), int(n_vox), int(cap_in),
        spatial.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _i32p(plan), plan.shape[0], _i32p(rb_buf), _i32p(oc_buf),
        _i32p(on_buf))
    if rc != 0:
        raise ValueError(f'build_rulebooks failed (rc={rc})')
    return rb_buf, oc_buf[:total_oc], on_buf[:n_down]


def rotated_iou_bev(boxes_a, boxes_b, criterion=-1):
    """(na, 5), (nb, 5) (cx, cy, dx, dy, heading) -> (na, nb) float32 IoU
    (criterion -1), or intersection over the area of a (0) or b (1)."""
    lib = load()
    boxes_a = np.ascontiguousarray(boxes_a, dtype=np.float32)
    boxes_b = np.ascontiguousarray(boxes_b, dtype=np.float32)
    out = np.empty((boxes_a.shape[0], boxes_b.shape[0]), np.float32)
    lib.rotated_iou_bev(_f32p(boxes_a), boxes_a.shape[0],
                        _f32p(boxes_b), boxes_b.shape[0],
                        int(criterion), _f32p(out))
    return out


def kitti_tp_scores(overlaps, dt_scores, ignored_gt, ignored_det,
                    min_overlap):
    """First matching pass of the KITTI protocol: the scores of the
    matched detections."""
    lib = load()
    overlaps = np.ascontiguousarray(overlaps, np.float64)
    dt_scores = np.ascontiguousarray(dt_scores, np.float64)
    ig = np.ascontiguousarray(ignored_gt, np.int32)
    idet = np.ascontiguousarray(ignored_det, np.int32)
    det_size, gt_size = overlaps.shape
    out = np.empty(max(gt_size, 1), np.float64)
    n = lib.kitti_tp_scores(_f64p(overlaps), det_size, gt_size,
                            _f64p(dt_scores), _i32p(ig), _i32p(idet),
                            float(min_overlap), _f64p(out))
    return out[:n]


def kitti_fused_stats(overlaps, dt_scores, dt_alphas, gt_alphas,
                      dt_dc_overlap, ignored_gt, ignored_det, metric,
                      min_overlap, thresholds, compute_aos, pr):
    """The second pass fused over thresholds; adds (tp, fp, fn, similarity)
    into `pr` (T, 4) float64 in place."""
    lib = load()
    overlaps = np.ascontiguousarray(overlaps, np.float64)
    dt_scores = np.ascontiguousarray(dt_scores, np.float64)
    dt_alphas = np.ascontiguousarray(dt_alphas, np.float64)
    gt_alphas = np.ascontiguousarray(gt_alphas, np.float64)
    ig = np.ascontiguousarray(ignored_gt, np.int32)
    idet = np.ascontiguousarray(ignored_det, np.int32)
    thresholds = np.ascontiguousarray(thresholds, np.float64)
    det_size, gt_size = overlaps.shape
    if dt_dc_overlap is None or dt_dc_overlap.size == 0:
        n_dc, dc = 0, np.empty(1, np.float64)
    else:
        dc = np.ascontiguousarray(dt_dc_overlap, np.float64)
        n_dc = dc.shape[1]
    if pr.dtype != np.float64 or not pr.flags.c_contiguous:
        raise ValueError('pr must be a C-contiguous float64 array')
    lib.kitti_fused_stats(_f64p(overlaps), det_size, gt_size,
                          _f64p(dt_scores), _f64p(dt_alphas),
                          _f64p(gt_alphas), _f64p(dc), n_dc, _i32p(ig),
                          _i32p(idet), int(metric), float(min_overlap),
                          _f64p(thresholds), len(thresholds),
                          int(bool(compute_aos)), _f64p(pr))
