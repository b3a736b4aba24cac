"""K1, K2 and K3 CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a CUDA device (and nvcc to build csrc/) each test
skips with its reason. On the card:
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from lidardetection_tpu_torch.ops.scatter_cuda import scatter_rows, scatter_rows_plain
from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
    rulebook_conv, rulebook_conv_plain,
)
from lidardetection_tpu_torch.ops.vfe_cuda import pillar_vfe, pillar_vfe_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc (the kernels run only there)')
    return torch.device('cuda')


@pytest.mark.parametrize('p,c', [(32, 64), (20, 100), (70, 16)])
@pytest.mark.parametrize('w_dtype,out_dtype', [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
def test_pillar_vfe_kernel_matches_plain(device, p, c, w_dtype, out_dtype):
    rng = np.random.RandomState(p + c)
    b, v = 2, 3001
    counts = rng.randint(0, p + 1, (b, v)).astype(np.int32)
    counts[0, :3] = [0, p, 1]
    vox = rng.randn(b, v, p, 4).astype(np.float32) * 20
    ctr = np.concatenate([rng.randn(b, v, 3) * 20, np.zeros((b, v, 1))], -1)
    args = [torch.from_numpy(np.asarray(a, dtype)).to(device) for a, dtype in (
        (vox, np.float32), (ctr, np.float32),
        (rng.randn(b, v, c), np.float32), (counts, np.int32),
        (rng.randn(4, c) * 0.2, np.float32), (rng.randn(c) * 0.1, np.float32))]
    args[4] = args[4].to(w_dtype)
    before = pillar_vfe.launches
    got = pillar_vfe(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert pillar_vfe.launches == before + 1
    want = pillar_vfe_plain(*args, out_dtype=out_dtype)
    # same operation order and no FMA contraction: bit-exact
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('dtype,c', [(torch.bfloat16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 3), (torch.float32, 5)])
def test_scatter_rows_kernel_matches_plain(device, dtype, c):
    rng = np.random.RandomState(c)
    n_slots, v = 5000, 1200
    keys = np.full((3, v), n_slots, np.int32)
    for b, n in enumerate((1100, 0, 7)):
        keys[b, :n] = np.sort(rng.choice(n_slots, n, replace=False))
    feats = torch.from_numpy(rng.randn(3, v, c)).to(device, dtype)
    keys_t = torch.from_numpy(keys).to(device)
    before = scatter_rows.launches
    got = scatter_rows(feats, keys_t, n_slots)
    torch.cuda.synchronize()
    assert scatter_rows.launches == before + 1
    torch.testing.assert_close(got, scatter_rows_plain(feats, keys_t, n_slots),
                               rtol=0, atol=0)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('k,c_in,c_out', [
    (27, 4, 16), (27, 16, 32), (27, 64, 64), (3, 64, 128),  # the backbone's
    (27, 70, 100),  # channel counts that fill no tile
    (40, 5, 200),   # more offsets than one staged chunk, two column blocks
])
def test_rulebook_conv_kernel_matches_plain(device, dtype, k, c_in, c_out):
    rng = np.random.RandomState(k + c_in)
    b, v_in, v_out = 3, 700, 1000
    rule = rng.randint(0, v_in, (b, v_out, k)).astype(np.int32)  # any order
    rule[rng.rand(b, v_out, k) < 0.5] = v_in
    rule[0, :4, :3] = [-1, v_in + 5, 2 ** 31 - 1]  # all misses
    valid = rng.rand(b, v_out) < 0.7
    valid[1, 200:] = False  # whole tiles without a valid row
    f = torch.from_numpy(rng.randn(b, v_in, c_in)).to(device, dtype)
    w = torch.from_numpy(rng.randn(k, c_in, c_out) * 0.1).to(device, dtype)
    rule_t = torch.from_numpy(rule).to(device)
    for mask in (torch.from_numpy(valid).to(device), None):
        before = rulebook_conv.launches
        got = rulebook_conv(f, rule_t, w, mask)
        torch.cuda.synchronize()
        assert rulebook_conv.launches == before + 1
        want = rulebook_conv_plain(f, rule_t, w, mask)
        assert got.dtype == torch.float32 and got.shape == want.shape
        if mask is not None:
            assert (got[~mask] == 0).all()
        # the same exact products, summed in f32 in another order
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_rulebook_conv_rejects_what_the_kernel_does_not_take(device):
    f = torch.zeros((1, 8, 4), device=device)
    rule = torch.zeros((1, 8, 27), dtype=torch.int32, device=device)
    w = torch.zeros((27, 4, 16), device=device)
    before = rulebook_conv.launches
    for args in ((f.half(), rule, w.half()), (f, rule.long(), w),
                 (f, rule, w.bfloat16()), (f, rule, w.cpu()),
                 (f.transpose(1, 2).contiguous().transpose(1, 2), rule, w),
                 (f, rule, w, torch.ones((1, 8), device=device))):
        with pytest.raises(ValueError):
            rulebook_conv(*args)
    assert rulebook_conv.launches == before
