"""What the CPU can hold of the sparse-conv kernels K3 and K4: K4's row
split plan, the count of what K3's tensor-core path skips, and the build's
hash over the shared CUDA headers (the kernels themselves run only on the
card: tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from lidardetection_tpu_torch.ops import _build
from lidardetection_tpu_torch.ops.sparse_conv_cuda import (
    DW_BLOCKS, DW_GROUP_ROWS, DW_WINDOW_ROWS, DW_WORKSPACE_BYTES, _dw_tile,
    conv_tile_skips, dw_split_plan,
)

# (K, C_in, C_out) of the 12 sparse layers of tools/cfgs/kitti_models/
# second.yaml's VoxelBackBone8x, in call order
SECOND_LAYERS = [(27, 4, 16), (27, 16, 16), (27, 16, 32), (27, 32, 32),
                 (27, 32, 32), (27, 32, 64), (27, 64, 64), (27, 64, 64),
                 (27, 64, 64), (27, 64, 64), (27, 64, 64), (3, 64, 128)]
TRAIN_CAP = 16000  # second.yaml's MAX_NUMBER_OF_VOXELS for training


def _split_rows(n_rows, n_splits, split):
    """The rows split `split` takes, in its order (csrc/sparse_conv_dw.cu
    split_row: groups split, split + n_splits, ... of DW_GROUP_ROWS rows)."""
    g = DW_GROUP_ROWS
    rows = np.arange(split * g, n_rows, n_splits * g)[:, None] + np.arange(g)
    return rows[rows < n_rows]


def _check_plan(n_rows, k, c_in, c_out):
    n_splits = dw_split_plan(n_rows, k, c_in, c_out)
    rows = [_split_rows(n_rows, n_splits, s) for s in range(n_splits)]
    # every row once, each split in ascending order, no split empty
    assert all(len(r) > 0 and (np.diff(r) > 0).all() for r in rows)
    assert np.array_equal(np.sort(np.concatenate(rows)), np.arange(n_rows))
    # the shape alone decides it
    assert dw_split_plan(n_rows, k, c_in, c_out) == n_splits
    return n_splits, rows


@pytest.mark.parametrize('b', [1, 4])
@pytest.mark.parametrize('layer', range(1, 13))
def test_dw_split_plan_covers_rows_with_a_bounded_workspace(layer, b):
    k, c_in, c_out = SECOND_LAYERS[layer - 1]
    n_rows = b * TRAIN_CAP
    n_splits, rows = _check_plan(n_rows, k, c_in, c_out)
    assert n_splits * k * c_in * c_out * 4 <= DW_WORKSPACE_BYTES
    ct, cot = _dw_tile(c_in, c_out)
    # the backbone's shapes take one tile each
    assert ct >= c_in and cot >= c_out
    assert n_splits * k <= DW_BLOCKS
    assert min(len(r) for r in rows) >= DW_WINDOW_ROWS
    # the padding rows at the end of each sample spread over the splits:
    # no split holds more than its share of the live rows plus a group of
    # each sample
    for live_share in (0.34, 0.65):
        live = (np.arange(n_rows) % TRAIN_CAP) < TRAIN_CAP * live_share
        per_split = [int(live[r].sum()) for r in rows]
        assert max(per_split) <= live.sum() / n_splits + (b + 1) * DW_GROUP_ROWS
    if layer == 12:  # conv_out: K = 3 gets many splits (the row split)
        assert n_splits == min(DW_BLOCKS // 3, n_rows // DW_WINDOW_ROWS)


def test_dw_split_plan_small_and_odd_shapes():
    assert dw_split_plan(1, 27, 4, 16) == 1
    for n_rows in (255, 256, 1000, 4999, 70001):
        for k, c_in, c_out in ((3, 70, 100), (5, 5, 200), (40, 64, 128)):
            n_splits, _ = _check_plan(n_rows, k, c_in, c_out)
            ct, cot = _dw_tile(c_in, c_out)
            blocks = k * -(-c_in // ct) * -(-c_out // cot)
            assert n_splits == 1 or n_splits * blocks <= DW_BLOCKS


def _skips_brute_force(rb, valid, v_in, tile, fragment):
    b, v_out, k = rb.shape
    hit = (rb >= 0) & (rb < v_in)
    if valid is not None:
        hit &= valid[..., None]
    live = np.ones((b, v_out), bool) if valid is None else valid
    hit, live = hit.reshape(-1, k), live.reshape(-1)
    out = dict(tiles=0, pairs=0, pairs_skipped=0, fragments=0,
               fragments_skipped=0)
    for t0 in range(0, hit.shape[0], tile):
        if not live[t0:t0 + tile].any():
            continue
        out['tiles'] += 1
        for kk in range(k):
            out['pairs'] += 1
            if not hit[t0:t0 + tile, kk].any():
                out['pairs_skipped'] += 1
                continue
            for f0 in range(t0, t0 + tile, fragment):
                out['fragments'] += 1
                out['fragments_skipped'] += not hit[f0:f0 + fragment, kk].any()
    return out


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('tile,fragment', [(128, 16), (64, 16), (32, 8)])
def test_conv_tile_skips_matches_brute_force(masked, tile, fragment):
    rng = np.random.RandomState(tile + fragment + masked)
    b, v_in, v_out, k = 3, 200, 301, 27
    rb = rng.randint(0, v_in, (b, v_out, k)).astype(np.int32)
    # hits get sparser towards the end of each sample and some offsets miss
    # everywhere in some tiles
    rb[rng.rand(b, v_out, k) < np.linspace(0.3, 0.995, v_out)[None, :, None]] = v_in
    rb[:, :, 5] = -1
    rb[0, :40, :] = v_in + 3
    valid = rng.rand(b, v_out) < 0.8
    valid[1, 100:] = False
    mask = valid if masked else None
    got = conv_tile_skips(torch.from_numpy(rb),
                          None if mask is None else torch.from_numpy(mask),
                          v_in, tile=tile, fragment=fragment)
    want = _skips_brute_force(rb, mask, v_in, tile, fragment)
    assert got == want
    assert want['pairs_skipped'] > 0 and want['fragments_skipped'] > 0


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    csrc, build = tmp_path / 'csrc', tmp_path / 'build'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('#include "common.cuh"\n')
    (csrc / 'common.cuh').write_text('#pragma once\n')
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD_DIR', build)
    first = _build._library_path('k')
    assert first.parent == build and first.name.startswith('libk-')
    assert _build._library_path('k') == first
    (csrc / 'common.cuh').write_text('#pragma once\n// edited\n')
    edited = _build._library_path('k')
    assert edited != first
    (csrc / 'other.cuh').write_text('#pragma once\n')  # a new header counts
    assert _build._library_path('k') != edited
    (csrc / 'k.cu').write_text('#include "common.cuh"\n// edited\n')
    assert _build._library_path('k') not in (first, edited)
