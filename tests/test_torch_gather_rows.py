"""``ops/gather.py``: the row gather whose backward adds in a fixed order.

``gather_rows`` reads the rows ``torch.gather`` reads; its gradient adds
each source row's contributions left to right in float32, in the order of
their flat position, and rounds once to the row's dtype. Held on the CPU
against ``torch.gather``'s autograd (float32: the CPU's ``scatter_add_``
adds in the same order, so the same bits), against an explicit loop, and
against the gradient of JAX's ``jnp.take_along_axis`` on the same numpy
inputs. ``add_rows`` (the backward, also the sparse convolution's df off
the host plan) against ``scatter_add_``; a gradient with any strides
(a consumer that permutes the rows). The card's runs are in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu_torch.ops import sparse
from lidardetection_tpu_torch.ops.gather import add_rows, gather_rows

jax.config.update('jax_platforms', 'cpu')


def _backfilled(rng, b, n, m, ns):
    """Ball-query-like groups: a random count of hits near a centre, the
    rest of the slots repeating the group's first index."""
    centre = rng.randint(0, max(n - 8, 1), (b, m, 1))
    idx = np.minimum(centre + rng.randint(0, 8, (b, m, ns)), n - 1)
    cnt = rng.randint(1, ns + 1, (b, m, 1))
    return np.where(np.arange(ns) < cnt, idx, idx[..., :1])


def _case(name):
    """(features (B, N, C) float32, idx (B, ...) int64, cotangent)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    b, n, c = 2, 40, 5
    if name == 'heavy duplicates':
        idx = _backfilled(rng, b, n, 30, 16)
    elif name == 'rows nothing reads':
        idx = rng.randint(0, n // 4, (b, 25))  # rows n/4 .. n-1 unread
    elif name == 'empty index':
        idx = np.zeros((b, 0), np.int64)
    elif name == 'scalar rows':  # (B, N) features: the RoIs' IoUs
        idx = rng.randint(0, n, (b, 33))
        f = rng.randn(b, n).astype(np.float32)
        return f, idx, rng.randn(*idx.shape).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    return feats, idx, rng.randn(*idx.shape, c).astype(np.float32)


CASES = ['heavy duplicates', 'rows nothing reads', 'empty index',
         'scalar rows']


def _port(feats, idx, cot, dtype=torch.float32):
    f = torch.from_numpy(feats).to(dtype).requires_grad_(True)
    out = gather_rows(f, torch.from_numpy(idx))
    out.backward(torch.from_numpy(cot).to(dtype))
    return out.detach(), f.grad


def _library(feats, idx, cot):
    f = torch.from_numpy(feats).requires_grad_(True)
    b, n = feats.shape[:2]
    flat = f.reshape(b, n, -1)
    out = torch.gather(flat, 1, torch.from_numpy(idx).reshape(b, -1, 1)
                       .expand(-1, -1, flat.shape[-1]))
    out = out.reshape(*idx.shape, *feats.shape[2:])
    out.backward(torch.from_numpy(cot))
    return out.detach(), f.grad


def _loop_gradient(feats, idx, cot):
    """Each row's contributions summed left to right in float32, in the
    order of their flat position."""
    b, n = feats.shape[:2]
    grad = np.zeros_like(feats)
    flat_idx = idx.reshape(b, -1)
    flat_cot = cot.reshape(b, flat_idx.shape[1], *feats.shape[2:])
    for s in range(b):
        for p, row in enumerate(flat_idx[s]):
            grad[s, row] = (grad[s, row] + flat_cot[s, p]).astype(np.float32)
    return grad


@pytest.mark.parametrize('name', CASES)
def test_values_and_gradient_equal_torch_gather(name):
    feats, idx, cot = _case(name)
    out, grad = _port(feats, idx, cot)
    want_out, want_grad = _library(feats, idx, cot)
    assert out.shape == want_out.shape == (*idx.shape, *feats.shape[2:])
    assert torch.equal(out, want_out)
    assert torch.equal(grad, want_grad)


@pytest.mark.parametrize('name', CASES)
def test_gradient_is_the_left_to_right_float32_sum(name):
    feats, idx, cot = _case(name)
    _, grad = _port(feats, idx, cot)
    want = _loop_gradient(feats, idx, cot)
    assert np.array_equal(grad.numpy(), want)
    read = np.zeros(feats.shape[:2], bool)
    for s in range(feats.shape[0]):
        read[s, idx[s].reshape(-1)] = True
    assert not grad.numpy()[~read].any()  # a row nothing reads gets 0
    if name == 'rows nothing reads':
        assert (~read).sum() > 0


@pytest.mark.parametrize('name', CASES)
def test_bfloat16_gradient_is_one_rounding_of_the_float32_sum(name):
    feats, idx, cot = _case(name)
    f16 = torch.from_numpy(feats).bfloat16().float().numpy()
    c16 = torch.from_numpy(cot).bfloat16().float().numpy()
    out, grad = _port(feats, idx, cot, torch.bfloat16)
    assert grad.dtype == torch.bfloat16
    assert torch.equal(out.float(), _library(f16, idx, c16)[0])
    want = torch.from_numpy(_loop_gradient(f16, idx, c16))
    assert torch.equal(grad, want.bfloat16())
    assert bool(((grad.float() - want).abs()
                 <= 2.0 ** -8 * want.abs()).all())


@pytest.mark.parametrize('name', CASES)
def test_gradient_matches_jax_take_along_axis(name):
    feats, idx, cot = _case(name)
    _, grad = _port(feats, idx, cot)
    b, n = feats.shape[:2]
    flat = jnp.asarray(feats.reshape(b, n, -1))
    index = jnp.asarray(idx.reshape(b, -1, 1))

    def loss(f):
        rows = jnp.take_along_axis(f, index, axis=1)
        return (rows * jnp.asarray(cot.reshape(rows.shape))).sum()

    want = np.asarray(jax.grad(loss)(flat)).reshape(feats.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(grad.numpy() - want).max() <= 1e-6 * scale


def test_add_rows_equals_scatter_add():
    """``add_rows`` on (B, M, C) values, with a spill row as the sparse
    convolution's df uses it, bit-equal to the CPU's ``scatter_add_``."""
    rng = np.random.RandomState(7)
    values = torch.from_numpy(rng.randn(2, 300, 6).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 41, (2, 300)))
    want = torch.zeros(2, 41, 6).scatter_add_(
        1, idx[..., None].expand(-1, -1, 6), values)
    assert torch.equal(add_rows(values, idx, 41), want)


def test_conv_input_grad_off_the_plan_equals_autograd_of_the_plain_conv():
    """The strided df without a transposed rulebook (``ops/sparse.py``)
    against the gradient of the plain convolution, bit for bit on the
    CPU: a miss is dropped, every input row gets its terms."""
    from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
        rulebook_conv_plain,
    )

    rng = np.random.RandomState(8)
    b, v_in, v_out, k, c_in, c_out = 2, 50, 30, 8, 4, 3
    f = torch.from_numpy(rng.randn(b, v_in, c_in).astype(np.float32))
    rb = torch.from_numpy(rng.randint(-1, v_in + 2, (b, v_out, k)).astype(
        np.int32))
    w = torch.from_numpy(rng.randn(k, c_in, c_out).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, v_out, c_out).astype(np.float32))
    fr = f.clone().requires_grad_(True)
    rulebook_conv_plain(fr, rb, w).backward(g)
    got = sparse._conv_input_grad_plain(g, rb, w, v_in)
    np.testing.assert_allclose(got.numpy(), fr.grad.numpy(), rtol=0,
                               atol=1e-6)


def test_sorted_row_sums_adds_each_run_left_to_right():
    """``sorted_row_sums`` over a stable sort's keys and order: each row
    the left-to-right float32 sum of its run, a row past the last key
    0."""
    from lidardetection_tpu_torch.ops.gather import sorted_row_sums

    rng = np.random.RandomState(9)
    keys, order = torch.sort(torch.from_numpy(
        rng.randint(0, 10, 50).astype(np.int32)), stable=True)
    values = torch.from_numpy(rng.randn(50, 4).astype(np.float32))
    got = sorted_row_sums(values, keys, order, 12)
    want = np.zeros((12, 4), np.float32)
    for k, j in zip(keys.tolist(), order.tolist()):
        want[k] = (want[k] + values[j].numpy()).astype(np.float32)
    assert got.shape == (12, 4) and np.array_equal(got.numpy(), want)
    assert not got[10:].any()


@pytest.mark.parametrize('consumer', ['permuted', 'expanded'])
def test_gradient_with_any_strides_at_batch_one(consumer):
    """B = 1, a consumer that permutes the gathered rows or broadcasts them:
    the gradient reaching the backward is not contiguous, and it still
    equals ``torch.gather``'s."""
    rng = np.random.RandomState(10)
    feats = rng.randn(1, 40, 6).astype(np.float32)
    idx = torch.from_numpy(_backfilled(rng, 1, 40, 12, 8))
    shape = (1, 6, 12, 8) if consumer == 'permuted' else (1, 12, 8, 6, 3)
    cot = torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def loss(rows):
        if consumer == 'permuted':
            out = rows.permute(0, 3, 1, 2)
        else:
            out = rows[..., None].expand(-1, -1, -1, -1, 3)
        return (out * cot).sum()

    f = torch.from_numpy(feats).requires_grad_(True)
    loss(gather_rows(f, idx)).backward()
    g = torch.from_numpy(feats).requires_grad_(True)
    loss(torch.gather(g, 1, idx.reshape(1, -1, 1).expand(-1, -1, 6))
         .reshape(1, 12, 8, 6)).backward()
    assert torch.equal(f.grad, g.grad)
