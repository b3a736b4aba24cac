"""K1-K5 CUDA kernels against their plain PyTorch versions on the card, and
the autograd functions that launch them in a backward pass.

Marked ``cuda``: without a CUDA device (and nvcc to build csrc/) each test
skips with its reason. On the card:
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from lidardetection_tpu_torch.ops import sparse
from lidardetection_tpu_torch.ops import pointnet2
from lidardetection_tpu_torch.ops.scatter_cuda import (
    scatter_rows, scatter_rows_grad_plain, scatter_rows_plain,
)
from lidardetection_tpu_torch.ops.select_cuda import (
    ball_select, ball_select_plain, select_launch_plan,
)
from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
    DW_WORKSPACE_BYTES, dw_split_plan, rulebook_conv, rulebook_conv_dw,
    rulebook_conv_dw_plain, rulebook_conv_plain,
)
from lidardetection_tpu_torch.ops.vfe_cuda import (
    channels_per_thread, pillar_vfe, pillar_vfe_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc (the kernels run only there)')
    return torch.device('cuda')


@pytest.mark.parametrize('counts_case', ['random', 'empty', 'full', 'out of range'])
@pytest.mark.parametrize('p,c', [(32, 64), (20, 100), (70, 16), (32, 1), (32, 4),
                                 (32, 128), (20, 1024)])
@pytest.mark.parametrize('w_dtype,out_dtype', [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
def test_pillar_vfe_kernel_matches_plain(device, p, c, w_dtype, out_dtype,
                                         counts_case):
    """B * V = 6002 pillars, a multiple of no block's pillars; C = 1 takes
    the scalar path, the others 4 channels a thread (C = 100: 25 threads a
    pillar, blocks of 125; C = 1024: a block a pillar); counts random in
    [0, P], all 0, all P, or from -3 to P + 5."""
    rng = np.random.RandomState(p + c)
    b, v = 2, 3001
    counts = rng.randint(0, p + 1, (b, v)).astype(np.int32)
    counts[0, :3] = [0, p, 1]
    counts = {'random': counts, 'empty': np.zeros_like(counts),
              'full': np.full_like(counts, p),
              'out of range': rng.randint(-3, p + 6, (b, v)).astype(np.int32),
              }[counts_case]
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


def test_pillar_vfe_paths(device):
    """Which widths take 4 channels a thread, and a bias row that is not
    16-byte aligned (a view one float into its buffer) taking the scalar
    path."""
    assert [channels_per_thread(c) for c in (1, 4, 64, 99, 100, 1024)] == \
        [1, 4, 4, 1, 4, 4]
    rng = np.random.RandomState(5)
    b, v, p, c = 1, 1000, 32, 64
    counts = torch.from_numpy(rng.randint(-1, p + 2, (b, v)).astype(np.int32))
    pb = torch.from_numpy(rng.randn(b * v * c + 1).astype(np.float32))
    args = [torch.from_numpy(rng.randn(b, v, p, 4).astype(np.float32)),
            torch.from_numpy(rng.randn(b, v, 4).astype(np.float32)),
            pb, counts,
            torch.from_numpy(rng.randn(4, c).astype(np.float32)).bfloat16(),
            torch.from_numpy(rng.randn(c).astype(np.float32))]
    args = [a.to(device) for a in args]
    args[2] = args[2][1:].view(b, v, c)
    assert args[2].data_ptr() % 16 == 4
    before = pillar_vfe.launches
    got = pillar_vfe(*args)
    torch.cuda.synchronize()
    assert pillar_vfe.launches == before + 1
    torch.testing.assert_close(got, pillar_vfe_plain(*args), rtol=0, atol=0)


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
@pytest.mark.parametrize('c', [4, 16, 64, 128, 256, 7])
def test_scatter_rows_kernel_over_widths(device, dtype, c):
    """B = 4 into 5003 slots (no block's slot count divides it): a full
    sample, an empty one, one of padding alone and one where every slot is
    hit; C = 7 gives rows of 14 or 28 bytes, not a multiple of 16."""
    rng = np.random.RandomState(c)
    n_slots = 5003
    v = n_slots
    keys = np.full((4, v), n_slots, np.int32)
    keys[0, :4000] = np.sort(rng.choice(n_slots, 4000, replace=False))
    keys[1, :3] = [0, 2500, n_slots - 1]
    keys[3] = np.arange(n_slots)
    feats = torch.from_numpy(rng.randn(4, v, c)).to(device, dtype)
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
    (27, 16, 16), (27, 64, 32),  # the submanifold df shapes
    (70, 64, 64),   # more offsets than the tensor-core path stages at once
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
        # the order is fixed by the shape: the same bits on every run
        assert torch.equal(got, rulebook_conv(f, rule_t, w, mask))


def _sparse_hits_case(device, dtype, k, c_in, c_out, b=3, v_in=700,
                      v_out=1000):
    """A rulebook whose hits are rare and clustered: rows 32-47 of every
    128-row tile (one 16-row fragment) hit offset 1, a few single rows hit
    offset k - 1, and no row hits offset 0 or any other."""
    rng = np.random.RandomState(c_in + c_out)
    rule = np.full((b, v_out, k), v_in, np.int32)
    flat = np.arange(b * v_out).reshape(b, v_out)
    frag = (flat % 128 >= 32) & (flat % 128 < 48)
    rule[..., 1] = np.where(frag, rng.randint(0, v_in, (b, v_out)), v_in)
    lone = rng.rand(b, v_out) < 0.01
    rule[..., k - 1] = np.where(lone, rng.randint(0, v_in, (b, v_out)), -1)
    valid = rng.rand(b, v_out) < 0.9
    f = torch.from_numpy(rng.randn(b, v_in, c_in)).to(device, dtype)
    return f, torch.from_numpy(rule).to(device), torch.from_numpy(valid).to(device)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('c_in,c_out', [(4, 16), (16, 32), (64, 64), (5, 24),
                                        (70, 100), (64, 128)])
def test_rulebook_conv_skips_missing_offsets_and_fragments(device, dtype, c_in,
                                                           c_out):
    """Only some 16-row fragments of a tile hit, and offsets that no tile
    hits; v_out = 1000 is no multiple of the tile, so tiles cross samples."""
    k = 27
    f, rule, valid = _sparse_hits_case(device, dtype, k, c_in, c_out)
    w = torch.from_numpy(np.random.RandomState(1).randn(k, c_in, c_out) * 0.1
                         ).to(device, dtype)
    for mask in (valid, None):
        got = rulebook_conv(f, rule, w, mask)
        want = rulebook_conv_plain(f, rule, w, mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
        assert torch.equal(got, rulebook_conv(f, rule, w, mask))
        rows_hit = ((rule >= 0) & (rule < f.shape[1])).any(-1)
        if mask is not None:
            rows_hit &= mask
        assert bool((got[~rows_hit] == 0).all()) and bool(got[rows_hit].abs().max() > 0)


@pytest.mark.parametrize('c_in', [16, 64])
def test_rulebook_conv_takes_unaligned_rows(device, c_in):
    """Features and weights that start 2 bytes past an aligned address (a
    contiguous view at an odd offset) take the element-wise staging path
    of the same kernel."""
    rng = np.random.RandomState(c_in)
    b, v_in, v_out, k, c_out = 2, 300, 500, 27, 32
    rule = rng.randint(0, v_in, (b, v_out, k)).astype(np.int32)
    rule[rng.rand(b, v_out, k) < 0.6] = v_in
    rule_t = torch.from_numpy(rule).to(device)
    f0 = torch.from_numpy(rng.randn(b, v_in, c_in)).to(device, torch.bfloat16)
    w0 = torch.from_numpy(rng.randn(k, c_in, c_out) * 0.1).to(device,
                                                              torch.bfloat16)
    f = torch.empty(f0.numel() + 1, dtype=f0.dtype, device=device)[1:].view(
        f0.shape).copy_(f0)
    w = torch.empty(w0.numel() + 1, dtype=w0.dtype, device=device)[1:].view(
        w0.shape).copy_(w0)
    assert f.data_ptr() % 4 == 2 and f.is_contiguous()
    got = rulebook_conv(f, rule_t, w)
    want = rulebook_conv_plain(f0, rule_t, w0)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    g = torch.from_numpy(rng.randn(b, v_out, c_out)).to(device, torch.bfloat16)
    g1 = torch.empty(g.numel() + 1, dtype=g.dtype, device=device)[1:].view(
        g.shape).copy_(g)
    want = rulebook_conv_dw_plain(f0, rule_t, g)
    torch.testing.assert_close(rulebook_conv_dw(f, rule_t, g1), want, rtol=0,
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


def _dw_case(device, dtype, k, c_in, c_out, b=3, v_in=700, v_out=1000, seed=0):
    rng = np.random.RandomState(seed + k + c_in)
    rule = rng.randint(0, v_in, (b, v_out, k)).astype(np.int32)  # any order
    rule[rng.rand(b, v_out, k) < 0.5] = v_in
    rule[0, :4, :3] = [-1, v_in + 5, 2 ** 31 - 1]  # all misses
    valid = rng.rand(b, v_out) < 0.7
    valid[1, 200:] = False  # whole windows without a valid row
    f = torch.from_numpy(rng.randn(b, v_in, c_in)).to(device, dtype)
    g = torch.from_numpy(rng.randn(b, v_out, c_out)).to(device, dtype)
    return (f, torch.from_numpy(rule).to(device), g,
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('c', [4, 16, 64, 128, 256, 7])
def test_scatter_rows_kernel_over_widths(device, dtype, c):
    """B = 4 into 5003 slots (no block's slot count divides it): a full
    sample, an empty one, one of padding alone and one where every slot is
    hit; C = 7 gives rows of 14 or 28 bytes, not a multiple of 16."""
    rng = np.random.RandomState(c)
    n_slots = 5003
    v = n_slots
    keys = np.full((4, v), n_slots, np.int32)
    keys[0, :4000] = np.sort(rng.choice(n_slots, 4000, replace=False))
    keys[1, :3] = [0, 2500, n_slots - 1]
    keys[3] = np.arange(n_slots)
    feats = torch.from_numpy(rng.randn(4, v, c)).to(device, dtype)
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
    (27, 70, 100),  # channel counts that fill no tile, two row tiles
    (5, 5, 200),    # two column tiles
])
def test_rulebook_conv_dw_kernel_matches_plain(device, dtype, k, c_in, c_out):
    f, rule, g, valid = _dw_case(device, dtype, k, c_in, c_out)
    for mask in (valid, None):
        before = rulebook_conv_dw.launches
        got = rulebook_conv_dw(f, rule, g, mask)
        torch.cuda.synchronize()
        assert rulebook_conv_dw.launches == before + 1
        want = rulebook_conv_dw_plain(f, rule, g, mask)
        assert got.dtype == torch.float32 and got.shape == (k, c_in, c_out)
        # the same exact products, summed in f32 in another order
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
        # rows are added in a fixed order: the same bits on every run
        assert torch.equal(got, rulebook_conv_dw(f, rule, g, mask))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('c_in,c_out', [(4, 16), (16, 32), (64, 64), (5, 24)])
def test_rulebook_conv_dw_sparse_hits(device, dtype, c_in, c_out):
    """Rare, clustered hits (a batch of hit rows far from a multiple of 16)
    and offsets that no row hits."""
    k = 27
    f, rule, valid = _sparse_hits_case(device, dtype, k, c_in, c_out)
    g = torch.from_numpy(np.random.RandomState(2).randn(
        *rule.shape[:2], c_out)).to(device, dtype)
    got = rulebook_conv_dw(f, rule, g, valid)
    want = rulebook_conv_dw_plain(f, rule, g, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(got, rulebook_conv_dw(f, rule, g, valid))
    assert bool((got[0] == 0).all()) and bool((got[2:k - 1] == 0).all())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('k,c_in,c_out', [(3, 64, 128), (27, 32, 32),
                                          (27, 64, 64)])
def test_rulebook_conv_dw_over_many_splits(device, dtype, k, c_in, c_out):
    """A step-sized row count: many row splits, summed in split order, the
    workspace within its bound and the same bits on a second run."""
    f, rule, g, valid = _dw_case(device, dtype, k, c_in, c_out, b=4,
                                 v_in=6000, v_out=8000)
    n_splits = dw_split_plan(4 * 8000, k, c_in, c_out)
    ws_bytes = n_splits * k * c_in * c_out * 4
    assert n_splits > 1 and ws_bytes <= DW_WORKSPACE_BYTES
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = rulebook_conv_dw(f, rule, g, valid)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= ws_bytes + got.numel() * 4 + (4 << 20)
    want = rulebook_conv_dw_plain(f, rule, g, valid)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(got, rulebook_conv_dw(f, rule, g, valid))


def test_rulebook_conv_dw_spans_chunks_and_casts_grad(device):
    """More rows than one chunk of the kernel, and an f32 gradient given
    beside bf16 features (the wrapper rounds it, as the plain version)."""
    f, rule, g, valid = _dw_case(device, torch.bfloat16, 27, 32, 32, b=2,
                                 v_in=3000, v_out=5000)
    g32 = g.float() + 1e-3
    got = rulebook_conv_dw(f, rule, g32, valid)
    want = rulebook_conv_dw_plain(f, rule, g32, valid)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_rulebook_conv_dw_rejects_what_the_kernel_does_not_take(device):
    f = torch.zeros((1, 8, 4), device=device)
    rule = torch.zeros((1, 8, 27), dtype=torch.int32, device=device)
    g = torch.zeros((1, 8, 16), device=device)
    before = rulebook_conv_dw.launches
    for args in ((f.half(), rule, g), (f, rule.long(), g), (f, rule, g.cpu()),
                 (f, rule, g[:, :4]), (f, rule[:, ::2], g[:, ::2]),
                 (f, rule, g, torch.ones((1, 8), device=device))):
        with pytest.raises(ValueError):
            rulebook_conv_dw(*args)
    assert rulebook_conv_dw.launches == before


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_sparse_conv_backward_launches_kernels(device, dtype, tol):
    """The autograd function on the card (K3 forward, K4 and K3 or the
    scatter-add backward) against the same function on the CPU (plain
    versions), on a real submanifold rulebook and a strided one."""
    rng = np.random.RandomState(0)
    shape, b, cap, c_in, c_out = (5, 12, 12), 2, 320, 16, 32
    coords = np.full((b, cap, 3), -1, np.int32)
    for i, n in enumerate((300, 220)):
        keys = np.sort(rng.choice(np.prod(shape), n, replace=False))
        coords[i, :n] = np.stack(np.unravel_index(keys, shape), -1)
    st = sparse.SparseTensor(torch.zeros(b, cap, 1), torch.from_numpy(coords),
                             torch.tensor([300, 220], dtype=torch.int32), shape)
    subm_rb = sparse.build_subm_rulebook(st)
    out_coords, _, out_shape = sparse.build_strided_out_coords(
        st, (3, 3, 3), (2, 2, 2), (1, 1, 1), 200)
    down_rb = sparse.build_strided_rulebook(st, out_coords, out_shape,
                                            (3, 3, 3), (2, 2, 2), (1, 1, 1))
    f0 = rng.randn(b, cap, c_in).astype(np.float32) * (coords[..., :1] >= 0)
    w0 = (rng.randn(27, c_in, c_out) * 0.1).astype(np.float32)
    cases = (('subm', subm_rb, st.valid_mask, True),
             ('strided', down_rb, out_coords[..., 0] >= 0, False))
    for name, rb, valid, subm in cases:
        g0 = rng.randn(b, rb.shape[1], c_out).astype(np.float32)
        grads = {}
        for dev in ('cpu', device):
            f = torch.from_numpy(f0).to(dev, dtype).requires_grad_()
            w = torch.from_numpy(w0).to(dev, dtype).requires_grad_()
            k3, k4 = rulebook_conv.launches, rulebook_conv_dw.launches
            out = sparse.sparse_conv_apply(f, valid.to(dev), rb.to(dev), w,
                                           subm=subm)
            (out * torch.from_numpy(g0).to(dev)).sum().backward()
            launched = (rulebook_conv.launches - k3,
                        rulebook_conv_dw.launches - k4)
            # df of a submanifold layer is a second K3 launch
            assert launched == ((0, 0) if dev == 'cpu' else (1 + subm, 1)), name
            assert f.grad.dtype == dtype and w.grad.dtype == dtype
            grads[dev] = (f.grad.float().cpu(), w.grad.float().cpu())
        for got, want in zip(grads[device], grads['cpu']):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=tol * float(want.abs().max()))


def test_scatter_rows_backward_is_the_gather(device):
    rng = np.random.RandomState(1)
    n_slots, v, c = 900, 400, 24
    keys = np.full((2, v), n_slots, np.int32)
    for b, n in enumerate((350, 40)):
        keys[b, :n] = np.sort(rng.choice(n_slots, n, replace=False))
    keys_t = torch.from_numpy(keys).to(device)
    feats = torch.from_numpy(rng.randn(2, v, c).astype(np.float32)).to(
        device).requires_grad_()
    g = torch.from_numpy(rng.randn(2, n_slots, c).astype(np.float32)).to(device)
    before = scatter_rows.launches
    (scatter_rows(feats, keys_t, n_slots) * g).sum().backward()
    assert scatter_rows.launches == before + 1
    torch.testing.assert_close(
        feats.grad, scatter_rows_grad_plain(g, keys_t, n_slots), rtol=0, atol=0)


def _select_case(device, b, n_row, empty_share, seed, n=5000):
    """A cell-sorted table of a clumped cloud and its row runs, as
    ops/pointnet2.py::grid_ball_query_multi prepares them for K5."""
    rng = np.random.RandomState(seed)
    m, cap = 700, 64
    xyz = rng.uniform(0, 8, (b, n, 3)).astype(np.float32)
    xyz[:, :2000] = rng.uniform(0, 1, (b, 2000, 3)) + np.float32([3, 3, 1])
    orig = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32)
    start = np.sort(rng.randint(0, n - 3 * cap, (b, m, n_row)), -1)
    start += np.arange(n_row) * 3 * cap // n_row  # disjoint runs
    start = np.minimum(start, n - 1).astype(np.int32)
    gaps = np.diff(np.concatenate([start, np.full((b, m, 1), n)], -1), axis=-1)
    end = start + np.minimum(rng.randint(0, 3 * cap + 1, (b, m, n_row)), gaps)
    end = np.where(rng.rand(b, m, n_row) < empty_share, start, end)
    centers = rng.uniform(0, 8, (b, m, 3)).astype(np.float32)
    centers[:, :300] = xyz[:, rng.randint(0, 2000, 300)]  # in the clump
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (xyz, orig, start, end.astype(np.int32), centers)]


@pytest.mark.parametrize('radii,nsamples,n_row', [
    ((0.4, 0.8), (16, 16), 9), ((0.8, 1.2), (16, 32), 9),
    ((1.2, 2.4), (16, 32), 6), ((2.4, 4.8), (16, 32), 3)])
@pytest.mark.parametrize('b', [1, 2])
@pytest.mark.parametrize('empty_share', [0.0, 1.0])
def test_ball_select_kernel_matches_plain(device, radii, nsamples, n_row, b,
                                          empty_share):
    args = _select_case(device, b, n_row, empty_share, seed=n_row + b)
    before = ball_select.launches
    got = ball_select(*args, radii, nsamples, 192)
    torch.cuda.synchronize()
    assert ball_select.launches == before + 1
    want = ball_select_plain(*args, radii, nsamples, 192)
    for g, w in zip(got, want):
        # the plain version's operation order, no FMA: bit for bit
        assert torch.equal(g, w)
    assert bool(torch.isinf(got[0]).all()) == (empty_share == 1.0)


def test_ball_select_rejects_what_the_kernel_does_not_take(device):
    xyz, orig, start, end, centers = _select_case(device, 1, 3, 0.0, seed=0)
    before = ball_select.launches
    for args in ((xyz.double(), orig, start, end, centers),
                 (xyz, orig.long(), start, end, centers),
                 (xyz, orig, start[..., :2], end, centers),
                 (xyz, orig, start, end, centers.cpu())):
        with pytest.raises(ValueError):
            ball_select(*args, (0.4,), (16,), 192)
    with pytest.raises(ValueError):
        ball_select(xyz, orig, start, end, centers, (0.1,) * 5, (4,) * 5, 192)
    assert ball_select.launches == before


def _held_bit_for_bit(args, radii, nsamples, max_run):
    before = ball_select.launches
    got = ball_select(*args, radii, nsamples, max_run)
    torch.cuda.synchronize()
    assert ball_select.launches == before + 1
    want = ball_select_plain(*args, radii, nsamples, max_run)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


def _blocks_case(device, m, n_row, run, hits, orig, seed=0):
    """Center r reads its own block of n_row * run table rows, in n_row
    runs of `run` rows; the first hits[r] rows of its block lie within 0.3
    of it, the others 50 away. orig: (m * n_row * run,) int32."""
    rng = np.random.RandomState(seed)
    k = n_row * run
    centers = rng.uniform(-20, 20, (1, m, 3)).astype(np.float32)
    xyz = np.repeat(centers[0], k, 0) + rng.uniform(-0.17, 0.17, (m * k, 3))
    far = np.arange(k)[None, :] >= np.asarray(hits)[:, None]
    xyz[far.reshape(-1)] += 50.0
    start = (np.arange(m)[:, None] * k + np.arange(n_row) * run)[None]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        xyz[None].astype(np.float32), orig[None].astype(np.int32),
        start.astype(np.int32), (start + run).astype(np.int32), centers)]


@pytest.mark.parametrize('ns', [16, 32])
@pytest.mark.parametrize('delta', [-1, 0, 1])
def test_ball_select_hit_counts_around_nsample(device, ns, delta):
    m, n_row, run = 64, 3, 40
    orig = np.random.RandomState(ns).permutation(m * n_row * run)
    args = _blocks_case(device, m, n_row, run, [ns + delta] * m, orig)
    got = _held_bit_for_bit(args, (0.5, 60.0), (ns, ns), run)
    assert int(torch.isfinite(got[0]).sum(-1).max()) == min(ns + delta, ns)


def test_ball_select_overflows_the_hit_buffer(device):
    """Every candidate in radius at n_row 9 and max_run 192: 1728 hits a
    center, more than a warp's buffer holds, so the kernel reads its runs
    again for each pass."""
    m, n_row, run = 48, 9, 192
    assert n_row * run > select_launch_plan(n_row, run, (16, 32)).cap
    orig = np.random.RandomState(5).permutation(m * n_row * run)
    args = _blocks_case(device, m, n_row, run, [n_row * run] * m, orig)
    _held_bit_for_bit(args, (1e3, 2e3), (16, 32), run)


@pytest.mark.parametrize('ns', [1, 64])
def test_ball_select_nsample_1_and_64(device, ns):
    args = _select_case(device, 2, 9, 0.0, seed=ns)
    _held_bit_for_bit(args, (0.8, 1.6), (ns, ns), 192)


def test_ball_select_hits_in_one_histogram_bin(device):
    """Each center's hits hold consecutive orig but one far above them
    (near 2^27): every histogram level but the last puts all the others in
    one bin, and the selection descends through all four."""
    m, n_row, run = 32, 3, 64
    k = n_row * run
    orig = np.empty((m, k), np.int64)
    orig[:, :-1] = np.arange(m)[:, None] * (k - 1) + np.arange(k - 1)
    orig[:, -1] = 2 ** 27 - 1 - np.arange(m)
    args = _blocks_case(device, m, n_row, run, [k] * m, orig.reshape(-1))
    _held_bit_for_bit(args, (1e3,), (16,), run)


def test_ball_select_on_a_table_of_131072_rows(device):
    args = _select_case(device, 1, 9, 0.0, seed=7, n=131072)
    _held_bit_for_bit(args, (0.4, 0.8), (16, 32), 192)


def test_grid_ball_query_on_the_card_launches_k5(device, monkeypatch):
    """The row-run grid path on the card goes through K5 once for all radii
    and gives what it gives with the plain selection."""
    rng = np.random.RandomState(3)
    src = rng.uniform((0, -8, -2), (16, 8, 2), (2, 5000, 3)).astype(np.float32)
    centers = rng.uniform((0, -8, -2), (16, 8, 2), (2, 300, 3)).astype(np.float32)
    num = torch.tensor([5000, 4100], dtype=torch.int32, device=device)
    src_t, ctr_t = (torch.from_numpy(a).to(device) for a in (src, centers))
    valid = torch.from_numpy(rng.rand(2, 300) > 0.3).to(device)
    knobs = pointnet2.PointOpKnobs(bq_grid=((0.0, -8.0, -2.0, 16.0, 8.0, 2.0), 64))
    before = ball_select.launches
    got = pointnet2.ball_query_multi((0.8, 1.6), (16, 32), src_t, num, ctr_t,
                                     valid, knobs=knobs)
    assert ball_select.launches == before + 1
    monkeypatch.setattr(pointnet2, 'ball_select', ball_select_plain)
    want = pointnet2.ball_query_multi((0.8, 1.6), (16, 32), src_t, num, ctr_t,
                                      valid, knobs=knobs)
    for (gi, ge), (wi, we) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(ge, we)
    assert bool(got[0][1][~valid].all()) and not bool(got[1][1][valid].all())


def test_ball_select_at_pointrcnn_shapes(device, monkeypatch):
    """PointRCNN's two grid ball queries on a sampled synthetic cloud at
    full width: 16384 sources and 4096 sector-FPS centres, radii (0.1,
    0.5); then those 4096 and 1024 of them, radii (0.5, 1.0); nsample
    (16, 32), cell cap 64 over pointrcnn.yaml's range. K5 once each,
    equal to the plain selection."""
    from lidardetection_tpu_torch.datasets.synthetic import make_scene
    from lidardetection_tpu_torch.datasets.processor.data_processor import (
        process_points,
    )
    from lidardetection_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/pointrcnn.yaml')
    pc_range = np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32)
    points = process_points(make_scene(np.random.RandomState(4), pc_range)[0],
                            cfg.DATA_CONFIG.DATA_PROCESSOR, pc_range, False,
                            np.random.RandomState(4))
    assert points.shape == (16384, 4)
    knobs = pointnet2.PointOpKnobs.from_config(cfg.MODEL, pc_range)
    xyz = torch.from_numpy(points[None, :, :3].copy()).to(device)
    num = torch.tensor([16384], dtype=torch.int32, device=device)
    for npoint, radii in ((4096, (0.1, 0.5)), (1024, (0.5, 1.0))):
        idx = pointnet2.fps(xyz, num, npoint, knobs=knobs)
        centers = pointnet2.group_points(xyz, idx[..., None]).squeeze(2)
        valid = torch.ones((1, npoint), dtype=torch.bool, device=device)
        before = ball_select.launches
        got = pointnet2.ball_query_multi(radii, (16, 32), xyz, num, centers,
                                         valid, knobs=knobs)
        assert ball_select.launches == before + 1
        with monkeypatch.context() as mp:
            mp.setattr(pointnet2, 'ball_select', ball_select_plain)
            want = pointnet2.ball_query_multi(radii, (16, 32), xyz, num,
                                              centers, valid, knobs=knobs)
        for (gi, ge), (wi, we) in zip(got, want):
            assert torch.equal(gi, wi) and torch.equal(ge, we)
        assert not bool(got[0][1].any())  # every centre is a source
        xyz, num = centers.contiguous(), torch.full_like(num, npoint)


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def _set_tf32_flags(cudnn, matmul, precision):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.set_float32_matmul_precision(precision)


@pytest.mark.parametrize('cfg_file', ['tools/cfgs/kitti_models/pointpillar.yaml',
                                      'tools/cfgs/kitti_models/pv_rcnn.yaml',
                                      'tools/cfgs/kitti_models/PartA2.yaml',
                                      'tools/cfgs/kitti_models/pointrcnn.yaml'])
def test_f32_forward_ignores_the_tf32_flags(device, cfg_file):
    """An f32 forward with TF32 allowed for cuDNN and matmul, and the matmul
    precision 'high', gives the bits of the same forward with them off
    (every tensor of the output), and leaves the flags as they were set."""
    from lidardetection_tpu_torch.config import cfg_from_yaml_file
    from lidardetection_tpu_torch.datasets.synthetic import make_scene
    from lidardetection_tpu_torch.serve import Detector

    cfg = cfg_from_yaml_file(cfg_file)
    cfg.MODEL.COMPUTE_DTYPE = 'float32'
    det = Detector(cfg, device='cuda', seed=0)
    points = make_scene(np.random.RandomState(0),
                        np.asarray(det.info['point_cloud_range'], np.float32))[0]
    batch = det.make_batch([points])
    found = _tf32_flags()
    outs = {}
    try:
        for flags in ((True, True, 'high'), (False, False, 'highest')):
            _set_tf32_flags(*flags)
            outs[flags] = det.forward(batch)
            torch.cuda.synchronize()
            assert _tf32_flags() == flags
    finally:
        _set_tf32_flags(*found)
    on, off = outs.values()
    tensors = [k for k, v in off.items() if torch.is_tensor(v)]
    assert [k for k in tensors if k.startswith('batch_')]
    for key in tensors:
        assert torch.equal(on[key], off[key]), key


@pytest.mark.parametrize('geometry', [((2, 2, 2), (1, 1, 1)), ((2, 2, 2), (0, 1, 1))])
def test_inverse_rulebook_on_the_card_equals_the_cpu(device, geometry):
    """UNetV2's inverse rulebook built on the card: the integers of the
    same builder on the CPU (floored division and remainder on both)."""
    stride, padding = geometry
    rng = np.random.RandomState(1)
    shape = (21, 40, 36)
    coords = np.full((2, 900, 3), -1, np.int32)
    for b, n in enumerate((800, 500)):
        keys = np.sort(rng.choice(int(np.prod(shape)), n, replace=False))
        coords[b, :n] = np.stack(np.unravel_index(keys, shape), -1)
    num = torch.tensor([800, 500], dtype=torch.int32)
    out = []
    for dev in ('cpu', device):
        up = sparse.SparseTensor(torch.zeros(2, 900, 1, device=dev),
                                 torch.from_numpy(coords).to(dev), num.to(dev),
                                 shape)
        d_coords, d_num, d_shape = sparse.build_strided_out_coords(
            up, (3, 3, 3), stride, padding, 4000)
        down = sparse.SparseTensor(torch.zeros(2, 4000, 1, device=dev),
                                   d_coords, d_num, d_shape)
        out.append(sparse.build_inverse_rulebook(
            down, up.coords, (3, 3, 3), stride, padding).cpu())
    cpu, card = out
    assert torch.equal(cpu, card) and (cpu < 4000).any()


def test_pointrcnn_point_ops_on_the_card_equal_the_cpu(device):
    """three_nn and its interpolation, and the RoI point pool, on the card
    against the CPU: the pooled rows equal; the neighbours equal but where
    the cancelling distance formula (rounded by another matmul on each
    device) reorders near-equal ones, at most 1 in 1000, and the
    distances within 1e-3 m."""
    from lidardetection_tpu_torch.ops.roi_pool import roipoint_pool3d

    rng = np.random.RandomState(6)
    src = rng.uniform((0, -40, -3), (70, 40, 1), (2, 4096, 3)).astype(np.float32)
    query = rng.uniform((0, -40, -3), (70, 40, 1), (2, 16384, 3)).astype(np.float32)
    num = np.array([4096, 3000], np.int32)
    feats = rng.randn(2, 4096, 8).astype(np.float32)
    args = [torch.from_numpy(x) for x in (query, src, num)]
    d, i = pointnet2.three_nn(*args)
    dc, ic = pointnet2.three_nn(*(a.to(device) for a in args))
    assert float((ic.cpu() != i).float().mean()) < 1e-3
    torch.testing.assert_close(dc.cpu(), d, rtol=0, atol=1e-3)
    w = pointnet2.three_nn_weights(d)
    f = torch.from_numpy(feats)
    torch.testing.assert_close(
        pointnet2.three_interpolate(f.to(device), i.to(device), w.to(device)).cpu(),
        pointnet2.three_interpolate(f, i, w), rtol=0, atol=1e-5)
    rois = np.zeros((2, 100, 7), np.float32)
    rois[..., 0:2] = src[:, :100, 0:2]
    rois[..., 3:6] = rng.uniform(1, 5, (2, 100, 3))
    rois[..., 6] = rng.uniform(-3, 3, (2, 100))
    pool = [torch.from_numpy(x) for x in (query, np.concatenate(
        [query, rng.randn(2, 16384, 4).astype(np.float32)], -1),
        np.array([16384, 12000], np.int32), rois, np.ones((2, 100), bool))]
    want = roipoint_pool3d(*pool, num_sampled_points=512)
    got = roipoint_pool3d(*(a.to(device) for a in pool), num_sampled_points=512)
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)


@pytest.mark.parametrize('method', ['avg', 'max'])
def test_roiaware_pool3d_on_the_card(device, method):
    """Both pools on the card: within 1e-6 of the CPU's, and the same bits
    on a second run (the avg pool sums each cell in a fixed order)."""
    from lidardetection_tpu_torch.ops.roi_pool import (
        roi_point_sample, roiaware_pool3d,
    )

    rng = np.random.RandomState(2)
    rois = np.zeros((2, 64, 7), np.float32)
    rois[..., 0:2] = rng.uniform(-10, 10, (2, 64, 2))
    rois[..., 3:6] = rng.uniform(1, 4, (2, 64, 3))
    rois[..., 6] = rng.uniform(-3, 3, (2, 64))
    pts = rng.uniform(-12, 12, (2, 20000, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 2, (2, 20000))
    feats = rng.rand(2, 20000, 16).astype(np.float32)
    num = np.array([20000, 15000], np.int32)
    valid = np.ones((2, 64), bool)
    def pool(p, f, n, r, v):
        return roiaware_pool3d(p, f, r, roi_point_sample(p, n, r, v, 1024),
                               (12, 12, 12), method)

    args = [torch.from_numpy(x) for x in (pts, feats, num, rois, valid)]
    want = pool(*args)
    on_card = [a.to(device) for a in args]
    got, again = pool(*on_card), pool(*on_card)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


def _vsa_group_case(n=16384, m=2048, ns=32, b=2, seed=3):
    """Neighbourhoods of a VSA set abstraction (PV-RCNN's 2048 keypoints,
    nsample 32, over 16384 sources): each keypoint's hits drawn from a
    window of 64 sources around its centre, a random count of them, the
    rest of its slots back-filled with its first hit as the ball query
    fills them, so rows are read many times over."""
    rng = np.random.RandomState(seed)
    centre = rng.randint(0, n - 64, (b, m, 1))
    idx = centre + rng.randint(0, 64, (b, m, ns))
    cnt = rng.randint(1, ns + 1, (b, m, 1))
    idx = np.where(np.arange(ns) < cnt, idx, idx[..., :1])
    return torch.from_numpy(idx)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_gather_rows_backward_is_bit_reproducible(device, dtype):
    """``gather_rows``' backward at a VSA grouping's shape, C = 64: two
    backward calls on the card give the same bits, the same bits as the
    CPU (both add each row's contributions left to right in float32), and
    in bf16 one rounding of the float32 gradient that ``torch.gather``'s
    autograd gives."""
    from lidardetection_tpu_torch.ops.gather import gather_rows

    idx = _vsa_group_case()
    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(2, 16384, 64).astype(np.float32))
    grad = torch.from_numpy(rng.randn(*idx.shape, 64).astype(np.float32))

    def backward(f, i, g):
        f = f.detach().to(dtype).requires_grad_(True)
        gather_rows(f, i).backward(g.to(dtype))
        return f.grad

    on_card = [t.to(device) for t in (feats, idx, grad)]
    first, second = backward(*on_card), backward(*on_card)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), backward(feats, idx, grad))
    f = feats.to(device).requires_grad_(True)
    torch.gather(f, 1, idx.to(device).reshape(2, -1, 1).expand(-1, -1, 64)) \
        .backward(on_card[2].to(dtype).float().reshape(2, -1, 64))
    want = f.grad  # float32 atomics: within float32 rounding of the sums
    slack = 1e-5 * float(want.abs().max())
    rel = 2 ** -8 if dtype == torch.bfloat16 else 0.0
    assert bool(((first.float() - want).abs()
                 <= rel * want.abs() + slack).all())


def test_gather_rows_backward_at_batch_one_with_a_permuted_gradient(device):
    """B = 1 and a consumer that permutes the gathered rows: the gradient
    reaching the backward is a non-contiguous view, and the card's result
    is the CPU's, bit for bit."""
    from lidardetection_tpu_torch.ops.gather import gather_rows

    idx = _vsa_group_case(b=1)
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(1, 16384, 64).astype(np.float32))
    cot = torch.from_numpy(rng.randn(1, 64, 2048, 32).astype(np.float32))

    def backward(f, i, g):
        f = f.detach().requires_grad_(True)
        (gather_rows(f, i).permute(0, 3, 1, 2) * g).sum().backward()
        return f.grad

    got = backward(*(t.to(device) for t in (feats, idx, cot)))
    assert torch.equal(got.cpu(), backward(feats, idx, cot))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize('c', [1, 3, 64, 257, 4100])
def test_sorted_row_sums_on_the_card_match_the_cpu(device, dtype, c):
    """The backward's segmented sum on the card against the CPU, bit for
    bit: rows read by none, by one and by thousands of positions, C from 1
    to 4100, every dtype the gathers take."""
    from lidardetection_tpu_torch.ops.gather import sorted_row_sums

    rng = np.random.RandomState(c)
    n_rows, n = 3000, 20000
    rows = rng.randint(0, n_rows // 2, n)  # the upper half read by none
    rows[:5000] = 7  # one row read 5000 times over
    keys, order = torch.sort(torch.from_numpy(rows.astype(np.int32)),
                             stable=True)
    values = torch.from_numpy(rng.randn(n, c)).to(dtype)
    want = sorted_row_sums(values, keys, order, n_rows)
    got = sorted_row_sums(*(t.to(device) for t in (values, keys, order)),
                          n_rows)
    assert got.dtype == dtype and got.shape == (n_rows, c)
    assert torch.equal(got.cpu(), want)
