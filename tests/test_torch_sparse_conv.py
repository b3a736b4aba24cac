"""``rulebook_conv_plain`` (the plain version of kernel K3) against the JAX
package on the CPU: the XLA gather-GEMM reference ``_conv_apply_xla`` and
the three Pallas kernels run in interpret mode at small tiles.

Tolerances: f32 sums of up to K*C_in = 432 products taken in another order,
outputs of magnitude ~1: atol 1e-4 with rtol 1e-5 (what the JAX package's
own Pallas-vs-XLA tests use). bf16 inputs give exact products summed in f32
on both sides, so the same tolerance holds; the one exception is the first
Pallas kernel, which rounds each offset's partial product W[k]^T f to bf16
before it adds it (``_rb_kernel``, ``.astype(dt)``): K terms of magnitude
up to ~1, each off by up to 2^-9 of itself, so atol 2e-2 there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidardetection_tpu.ops import sparse as jsparse
from lidardetection_tpu.ops import sparse_conv_tpu
from lidardetection_tpu_torch.ops.sparse import sparse_conv_apply
from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
    rulebook_conv, rulebook_conv_plain,
)

PALLAS = {
    'v1': functools.partial(sparse_conv_tpu.rulebook_conv_pallas,
                            t_out=128, blk=64, n_win=3, interpret=True),
    'v2': functools.partial(sparse_conv_tpu.rulebook_conv_pallas_v2,
                            t_out=128, blk=64, n_win=2, interpret=True),
    'v3': functools.partial(sparse_conv_tpu.rulebook_conv_pallas_v3,
                            kernel_z=3, t_out=128, blk=64, n_wg=3,
                            interpret=True),
}


def monotone_rulebook(rng, b, v_in, v_out, k, hit=0.6):
    """Every column ascends among its hits, as build_*_rulebook's do (the Pallas
    kernels need it); a miss is v_in."""
    rule = np.full((b, v_out, k), v_in, np.int32)
    for i in range(b):
        for j in range(k):
            hits = rng.rand(v_out) < hit
            rule[i, hits, j] = np.sort(rng.choice(v_in, hits.sum(), replace=False))
    return rule


def make_case(seed, k, c_in, c_out, b=2, v_in=600, v_out=500):
    rng = np.random.RandomState(seed)
    rule = monotone_rulebook(rng, b, v_in, v_out, k)
    f = rng.randn(b, v_in, c_in).astype(np.float32)
    w = (rng.randn(k, c_in, c_out) * 0.1).astype(np.float32)
    valid = np.ones((b, v_out), bool)
    valid[:, -7:] = False
    return f, rule, w, valid


# K = 27 at the backbone's first (C_in = 4) and a middle layer, and the
# K = 3 z-compression
CASES = [(27, 4, 16), (27, 16, 32), (3, 16, 32)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('k,c_in,c_out', CASES)
def test_plain_matches_xla_reference(k, c_in, c_out, dtype):
    f, rule, w, valid = make_case(k + c_in, k, c_in, c_out)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jsparse._conv_apply_xla(
        jnp.asarray(f).astype(jdt), jnp.asarray(valid), jnp.asarray(rule),
        jnp.asarray(w).astype(jdt)))
    got = rulebook_conv_plain(torch.from_numpy(f).to(tdt), torch.from_numpy(rule),
                              torch.from_numpy(w).to(tdt),
                              torch.from_numpy(valid))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.abs(want).max() > 0.5 and (got[:, -7:] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('variant', sorted(PALLAS))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('k,c_in,c_out', CASES)
def test_plain_matches_pallas_interpret(k, c_in, c_out, dtype, variant):
    f, rule, w, _ = make_case(k * c_in, k, c_in, c_out)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(PALLAS[variant](
        jnp.asarray(f).astype(jdt), jnp.asarray(rule),
        jnp.asarray(w).astype(jdt)))
    got = rulebook_conv_plain(torch.from_numpy(f).to(tdt), torch.from_numpy(rule),
                              torch.from_numpy(w).to(tdt))
    assert want.dtype == np.float32 and np.abs(want).max() > 0.5
    rounds_partials = variant == 'v1' and dtype == 'bfloat16'
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=2e-2 if rounds_partials else 1e-4)


def test_any_rulebook_order_and_out_of_range_entries():
    """The contract of the Hopper kernel, shown on its plain version: rows
    in any order, every entry outside [0, V_in) a miss."""
    f, rule, w, valid = make_case(9, 27, 8, 24)
    rng = np.random.RandomState(1)
    rule = rule[:, rng.permutation(rule.shape[1])]  # columns no longer ascend
    rule[0, :5, :3] = [-1, 600, 2 ** 31 - 1]
    clean = np.where((rule < 0) | (rule >= 600), 600, rule).astype(np.int32)
    want = np.asarray(jsparse._conv_apply_xla(
        jnp.asarray(f), jnp.asarray(valid), jnp.asarray(clean), jnp.asarray(w)))
    args = [torch.from_numpy(a) for a in (f, rule, w, valid)]
    np.testing.assert_allclose(rulebook_conv_plain(*args).numpy(), want,
                               rtol=1e-5, atol=1e-4)
    # on CPU tensors the wrapper and the engine's entry are the plain version
    assert torch.equal(rulebook_conv(*args), rulebook_conv_plain(*args))
    assert torch.equal(sparse_conv_apply(args[0], args[3], args[1], args[2]),
                       rulebook_conv_plain(*args))
