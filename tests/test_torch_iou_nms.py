"""Port rotated IoU and greedy NMS against the JAX package's core/iou3d.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.core import iou3d as jax_iou3d
from lidardetection_tpu.core.np_geometry import boxes_bev_iou_cpu
from lidardetection_tpu_torch.core import iou3d


def _boxes(rng, n, spread=20.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-2, 2, (n, 1)),
        rng.uniform(1.0, 4.5, (n, 2)), rng.uniform(1.2, 2.0, (n, 1)),
        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)


def test_iou_bev_and_3d_match_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 70, 6.0), _boxes(rng, 50, 6.0)
    b[:10] = a[:10]  # identical pairs
    b[10:14, 6] = a[10:14, 6] + np.pi / 2  # rotated copies
    b[10:14, :6] = a[10:14, :6]
    for name in ('boxes_iou_bev', 'boxes_iou3d'):
        want = np.asarray(jax.jit(getattr(jax_iou3d, name))(a, b))
        got = getattr(iou3d, name)(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert (want > 0.05).sum() > 20  # the sample has real overlaps


def test_near_identical_cluster_self_iou():
    """The cluster of tools/verify_tpu.py::verify_iou3d: half the probes
    are the same boxes jittered by millimetres. Self-IoU must read 1 with
    TF32 on or off, and the rest of the matrix must equal the JAX
    package's.

    The jittered pairs are compared with the exact polygon reference
    (``boxes_bev_iou_cpu``) only loosely: the clipping formulation with its
    1 mm tie window is discontinuous there, and both packages read a few of
    them up to 0.08 low (0.9235 for 0.9957), by amounts that change with
    the order of f32 rounding (JAX eager and jit differ by 0.03).
    """
    rng = np.random.default_rng(7)
    n = 96
    base = np.concatenate([
        rng.uniform(-60, 60, (n, 2)), rng.uniform(-2, 2, (n, 1)),
        rng.uniform(1.5, 4.5, (n, 2)), rng.uniform(1.2, 2.0, (n, 1)),
        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)
    jit = base.copy()
    jit[: n // 2, :3] += rng.normal(0, 2e-3, (n // 2, 3))
    jit[: n // 2, 6] += rng.normal(0, 1e-4, n // 2)
    want = np.asarray(jax.jit(jax_iou3d.boxes_iou3d)(base, jit))
    jittered = np.zeros((n, n), bool)
    jittered[np.arange(n // 2), np.arange(n // 2)] = True
    exact = boxes_bev_iou_cpu(base[: n // 2], jit[: n // 2]).diagonal()

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = allow
            torch.backends.cudnn.allow_tf32 = allow
            got = iou3d.boxes_iou3d(torch.from_numpy(base),
                                    torch.from_numpy(jit)).numpy()
            # shoelace sums of f32 coordinates up to 60 m: ~1e-4 of IoU
            np.testing.assert_allclose(got[~jittered], want[~jittered],
                                       atol=2e-4, rtol=0)
            diag = np.diagonal(got)[n // 2:]  # exact self-pairs
            np.testing.assert_allclose(diag, np.ones_like(diag), atol=1e-3,
                                       rtol=0)
            assert (np.abs(got[jittered] - exact) < 0.08).all()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize('assume_sorted', [False, True])
def test_nms_matches_jax(assume_sorted):
    rng = np.random.RandomState(1)
    bsz, n = 3, 400
    boxes = np.stack([_boxes(rng, n, 15.0) for _ in range(bsz)])
    scores = rng.rand(bsz, n).astype(np.float32)
    valid = rng.rand(bsz, n) > 0.2
    valid[2] = False  # a sample with no live candidate
    if assume_sorted:  # descending scores, invalid rows at the tail
        scores = np.where(valid, scores, -1.0)
        order = np.argsort(-scores, axis=1, kind='stable')
        scores = np.take_along_axis(scores, order, 1)
        boxes = np.take_along_axis(boxes, order[..., None], 1)
        valid = np.take_along_axis(valid, order, 1)
    for thresh, pre, post in ((0.01, 400, 64), (0.3, 256, 500)):
        want = jax.jit(functools.partial(
            jax_iou3d.nms_bev_batched, thresh=thresh, pre_maxsize=pre,
            post_maxsize=post, assume_sorted=assume_sorted))(
                jnp.asarray(boxes), jnp.asarray(scores),
                valid_mask=jnp.asarray(valid))
        got = iou3d.nms_bev_batched(
            torch.from_numpy(boxes), torch.from_numpy(scores), thresh, pre,
            post, valid_mask=torch.from_numpy(valid),
            assume_sorted=assume_sorted)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert 0 < int(got[2][0]) <= post and int(got[2][2]) == 0


def test_top_k_breaks_ties_to_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = iou3d.top_k(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]] and vals.tolist() == [[3, 3, 3, 2]]
