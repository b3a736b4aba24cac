"""PointNet++ point ops in fixed-capacity batches (counterpart of
lidardetection_tpu/ops/pointnet2.py): farthest point sampling, ball query,
grouping, the RoI-grid candidate selection, and the feature propagation's
three nearest neighbours and their interpolation.

Layout as in the JAX package: padded (B, N, ...) batches with valid counts.

Which path runs where. The JAX package engages its ``PointOpKnobs`` only
on the TPU and runs the exact paths on the CPU. The port keeps that rule
with the card in the TPU's place: the knobs apply when the tensors lie on
a CUDA device, and the exact paths run on the CPU, so on the CPU the port
computes what the JAX package computes on the CPU, at any size. On the
card:
  * ``fps`` runs ``sector_fps`` with ``knobs.fps_sectors`` sectors;
  * ``ball_query_multi`` over sources of at least 4096 rows runs
    ``grid_ball_query_multi``: the JAX package's row-run
    formulation (pointnet2.py:446-562: x-run merge, NW = 4 window blocks,
    each run cut to 3 * cell_cap rows), whose selection is kernel K5
    (ops/select_cuda.py). The JAX package's per-cell CPU formulation
    (:564-627) is not ported: it differs from the row-run one when a cell
    holds more than cell_cap sources.
The JAX package's ``approx_max_k`` (MODEL.BALL_QUERY_APPROX_RECALL) is an
exact top-k here: the card has no approximate top-k, so the knob is not
read. At PV-RCNN's full width every source has at least 4096 rows of
capacity, so the brute-force path it would apply to is not taken there
anyway.

Rounding-sensitive values follow the JAX functions' formulas and
operation order in float32: ``_pairwise_d2`` (cross term a full-f32
product, no TF32), cells ``floor((p - origin) / cell)``, FPS distances;
``argmax`` and top-k ties go to the lower index.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.precision import full_f32
from .gather import gather_rows
from .select_cuda import ball_select

_BIG = 1e10
_GRID_MIN_SOURCES = 4096
NW = 4  # window blocks per run in the JAX package: runs hold <= 3 * cap rows
_CENTER_CHUNK = 256  # brute-force ball query: centers per (M, N) distance block
_THREE_NN_BLOCK = 1 << 26  # three_nn: entries of a (B, rows, N) distance block


@dataclasses.dataclass(frozen=True)
class PointOpKnobs:
    """The JAX package's point-op knobs (pointnet2.py:30-67), engaged on
    the card only.

    bq_grid: (bounds6, cell_cap) enabling the grid ball query for sources
        of at least 4096 rows; fps_sectors: sector count of sector FPS.
    ``PointOpKnobs()`` means the exact paths everywhere.
    """

    bq_grid: tuple | None = None
    fps_sectors: int | None = None

    @staticmethod
    def from_config(model_cfg, point_cloud_range):
        sectors = model_cfg.get('FPS_SECTORS', 32)
        cap = model_cfg.get('BALL_QUERY_GRID_CELL_CAP', None)
        grid = None
        if cap and point_cloud_range is not None:
            grid = (tuple(float(v) for v in point_cloud_range), int(cap))
        return PointOpKnobs(bq_grid=grid, fps_sectors=sectors)


def _on_card(t):
    return t.device.type == 'cuda'


def _sum3(v):
    """(..., 3) -> (...): (v0 + v1) + v2, a 3-term reduction's order."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _sq_dist(a, b):
    """Elementwise squared distance of broadcastable (..., 3) points."""
    d = a - b
    return _sum3(d * d)


def fps(xyz, num_valid, npoint, knobs=None):
    """Sector FPS on the card (knobs.fps_sectors > 1), exact elsewhere."""
    s = knobs.fps_sectors if knobs is not None else None
    if s and s > 1 and _on_card(xyz):
        return sector_fps(xyz, num_valid, npoint, s)
    return farthest_point_sample(xyz, num_valid, npoint)


def _pairwise_d2(a, b):
    """Squared distances (..., M, N) of (..., M, 3) and (..., N, 3) points:
    ``max((|a|^2 + |b|^2) - 2 a.b, 0)``, the cross term one float32 product
    in full float32 whatever the process's matmul precision (the JAX
    package pins ``Precision.HIGHEST`` there)."""
    a2 = _sum3(a * a)
    b2 = _sum3(b * b)
    with full_f32():
        cross = a @ b.transpose(-1, -2)
    return ((a2[..., :, None] + b2[..., None, :]) - 2.0 * cross).clamp(min=0.0)


def _fps_loop(pts, valid, k):
    """Exact FPS over the last point axis of (..., c, 3), in parallel over
    the leading axes; row 0 seeds each set (sampling_gpu.cu:101). Returns
    (..., k) int64 local indices."""
    lead = pts.shape[:-2]
    dist = torch.where(valid, torch.full_like(pts[..., 0], _BIG),
                       torch.full_like(pts[..., 0], -1.0))
    out = torch.zeros((*lead, k), dtype=torch.long, device=pts.device)
    last = torch.zeros(lead, dtype=torch.long, device=pts.device)
    for i in range(1, k):
        lastpt = torch.gather(pts, -2, last[..., None, None].expand(
            *lead, 1, 3))
        d = _sq_dist(pts, lastpt)
        dist = torch.minimum(dist, torch.where(valid, d, torch.full_like(d, -1.0)))
        last = torch.argmax(dist, dim=-1)
        out[..., i] = last
    return out


def farthest_point_sample(xyz, num_valid, npoint):
    """Exact iterative FPS (pointnet2.py:100-135): (B, N, 3), (B,) ->
    (B, npoint) indices, padding rows never chosen."""
    n = xyz.shape[1]
    valid = torch.arange(n, device=xyz.device) < num_valid[:, None]
    return _fps_loop(xyz, valid, npoint)


def sector_fps(xyz, num_valid, npoint, n_sectors=32):
    """Sectorized FPS (pointnet2.py:163-211): valid points sorted by BEV
    angle (a stable sort), split into equal-count chunks, exact FPS inside
    all chunks at once. Returns (B, npoint) indices, sector-major."""
    b, n, _ = xyz.shape
    s = int(n_sectors)
    while npoint % s or n % s:  # fewer sectors if misaligned
        s //= 2
    if s <= 1:
        return farthest_point_sample(xyz, num_valid, npoint)
    k, c = npoint // s, -(-n // s)
    dev = xyz.device
    valid = torch.arange(n, device=dev) < num_valid[:, None]
    ang = torch.where(valid, torch.atan2(xyz[..., 1], xyz[..., 0]),
                      torch.full_like(xyz[..., 0], _BIG))
    perm = torch.argsort(ang, dim=1, stable=True)  # valid ranks first
    sec = torch.arange(s, device=dev)
    nv = num_valid.long()[:, None]
    start = (sec * nv) // s  # (B, S)
    end = ((sec + 1) * nv) // s
    rank = start[..., None] + torch.arange(c, device=dev)  # (B, S, c)
    valid_s = rank < end[..., None]
    rank = rank.clamp(max=n - 1)
    idx_sorted = torch.gather(perm, 1, rank.reshape(b, -1)).reshape(b, s, c)
    pts = torch.gather(xyz, 1, idx_sorted.reshape(b, -1, 1).expand(-1, -1, 3))
    loc = _fps_loop(pts.reshape(b, s, c, 3), valid_s, k)  # (B, S, k)
    idx = torch.gather(idx_sorted, 2, loc)
    ok = torch.gather(valid_s, 2, loc)
    return torch.where(ok, idx, perm[:, :1, None]).reshape(b, -1)


def decode(top, nsample):
    """(..., k) -scores -> ball_query's contract (pointnet2.py:530-540):
    (..., nsample) int32 indices back-filled with the first hit (0 when
    there is none) and the (...,) empty mask."""
    if top.shape[-1] < nsample:
        top = torch.cat([top, top.new_full((*top.shape[:-1],
                                            nsample - top.shape[-1]), -np.inf)],
                        dim=-1)
    got = torch.isfinite(top)
    out = torch.where(got, -top, torch.zeros_like(top)).int()
    empty = got.sum(-1) <= 0
    fill = torch.where(empty, torch.zeros_like(out[..., 0]), out[..., 0])
    return torch.where(got, out, fill[..., None]), empty


def ball_query(radius, nsample, xyz, xyz_num, new_xyz, new_xyz_valid=None):
    """First ``nsample`` sources within ``radius`` by index, brute force
    (pointnet2.py:214-281), slots back-filled with the first hit. Returns
    (B, M, nsample) int32 indices and the (B, M) empty mask."""
    r2 = float(np.float32(radius * radius))
    n = xyz.shape[1]
    dev = xyz.device
    valid = torch.arange(n, device=dev) < xyz_num[:, None]
    neg_index = -torch.arange(n, device=dev, dtype=torch.float32)
    k = min(nsample, n)
    tops = []
    for m0 in range(0, new_xyz.shape[1], _CENTER_CHUNK):
        centers = new_xyz[:, m0:m0 + _CENTER_CHUNK]
        mask = (_pairwise_d2(centers, xyz) < r2) & valid[:, None, :]
        if new_xyz_valid is not None:
            mask &= new_xyz_valid[:, m0:m0 + _CENTER_CHUNK, None]
        score = torch.where(mask, neg_index, torch.full_like(neg_index, -np.inf))
        tops.append(torch.topk(score, k, dim=-1).values)
    return decode(torch.cat(tops, dim=1), nsample)


def ball_query_multi(radii, nsamples, xyz, xyz_num, new_xyz,
                     new_xyz_valid=None, knobs=None):
    """Ball query for several radii over the same sources and centers: on
    the card with the grid engaged, one grid and one K5 launch for all
    radii; otherwise `ball_query` per radius. [(idx, empty)] per radius."""
    bq_grid = knobs.bq_grid if knobs is not None else None
    if (bq_grid is not None and xyz.shape[1] >= _GRID_MIN_SOURCES
            and _on_card(xyz)):
        bounds, cap = bq_grid
        return grid_ball_query_multi(radii, nsamples, xyz, xyz_num, new_xyz,
                                     new_xyz_valid, bounds=bounds,
                                     cell_cap=cap)
    return [ball_query(r, ns, xyz, xyz_num, new_xyz, new_xyz_valid)
            for r, ns in zip(radii, nsamples)]


def grid_ball_query_multi(radii, nsamples, xyz, xyz_num, new_xyz,
                          new_xyz_valid=None, bounds=None, cell_cap=64):
    """Multi-radius grid ball query, the row-run formulation of
    pointnet2.py:379-562 (the TPU's path), selection by kernel K5.

    Sources are sorted (stably) by the key of their cell of size
    ``max(radii)``; a center reads ``n_row`` runs of the sorted table,
    each the three x-consecutive cells of one (y, z) row around its cell
    (z layers absolute when the grid has at most 2 of them), cut to
    ``3 * cell_cap`` rows and emptied for invalid centers. Exact against
    ``ball_query`` whenever no run is cut. Returns [(idx, empty)] per
    radius, each with ``ball_query``'s contract.
    """
    tops = ball_select(*grid_select_args(radii, nsamples, xyz, xyz_num,
                                         new_xyz, new_xyz_valid, bounds,
                                         cell_cap))
    return [decode(t, ns) for t, ns in zip(tops, nsamples)]


class GridGeometry(NamedTuple):
    """The grid of `grid_ball_query_multi`: cells of size ``max(radii)``
    over `bounds`, and each centre's runs (``row_ds`` key offsets, with
    their y and z steps; z layers absolute when the grid has at most 2)."""
    origin: torch.Tensor
    size: torch.Tensor
    hi: torch.Tensor
    gx: int
    gy: int
    gz: int
    n_cells: int
    row_ds: list
    row_dy: list
    row_dz: list


def grid_geometry(radii, bounds, device):
    assert bounds is not None, 'grid_ball_query needs a static range'
    x0, y0, z0, x1, y1, z1 = (float(v) for v in bounds)
    cell = float(max(radii))
    gx = max(int(np.ceil((x1 - x0) / cell)), 1)
    gy = max(int(np.ceil((y1 - y0) / cell)), 1)
    gz = max(int(np.ceil((z1 - z0) / cell)), 1)
    if gz <= 2:  # rows: absolute z layers x dy
        row_ds = [zz * gx * gy + dy * gx for dy in (-1, 0, 1) for zz in range(gz)]
        row_dy = [dy for dy in (-1, 0, 1) for _ in range(gz)]
        row_dz = [None] * len(row_ds)
    else:
        row_ds = [(dz * gy + dy) * gx for dz in (-1, 0, 1) for dy in (-1, 0, 1)]
        row_dy = [dy for _ in (-1, 0, 1) for dy in (-1, 0, 1)]
        row_dz = [dz for dz in (-1, 0, 1) for _ in (-1, 0, 1)]
    return GridGeometry(
        torch.tensor([x0, y0, z0], dtype=torch.float32, device=device),
        torch.full((3,), cell, dtype=torch.float32, device=device),
        torch.tensor([gx - 1, gy - 1, gz - 1], device=device),
        gx, gy, gz, gx * gy * gz, row_ds, row_dy, row_dz)


def _cell_of(p, geo):
    c = torch.floor((p - geo.origin) / geo.size).long()
    return torch.minimum(c.clamp(min=0), geo.hi)


def _cell_key(c, geo):
    return (c[..., 2] * geo.gy + c[..., 1]) * geo.gx + c[..., 0]


def source_order(xyz, xyz_num, geo):
    """The sources' stable sort by cell key (padding last): the order and
    the sorted keys."""
    n = xyz.shape[1]
    valid = torch.arange(n, device=xyz.device) < xyz_num[:, None]
    ck = torch.where(valid, _cell_key(_cell_of(xyz, geo), geo), geo.n_cells)
    order = torch.argsort(ck, dim=1, stable=True)
    return order, torch.gather(ck, 1, order)


def cell_first_rows(sk, geo):
    """first_row[k]: the first sorted row whose key is >= k, k <= n_cells
    + 2."""
    keys = torch.arange(geo.n_cells + 3, device=sk.device).expand(
        sk.shape[0], -1).contiguous()
    return torch.searchsorted(sk, keys)


def center_runs(first_row, new_xyz, new_xyz_valid, geo, cell_cap):
    """Each centre's runs of the sorted table: (start, end) (B, M,
    n_row), each cut to ``(NW - 1) * cell_cap`` rows, empty for an
    invalid centre; and that cap."""
    gx, gy, gz = geo.gx, geo.gy, geo.gz
    cc = _cell_of(new_xyz, geo)
    key = cc[..., 1] * gx + cc[..., 0] if gz <= 2 else _cell_key(cc, geo)
    kx, ky, kz = key % gx, (key // gx) % gy, key // (gx * gy)

    def shifted(d):  # first_row[key + d], edge-clamped
        return torch.gather(first_row, 1, (key + d).clamp(0, geo.n_cells + 2))

    starts, ends = [], []
    for d, dy, dz in zip(geo.row_ds, geo.row_dy, geo.row_dz):
        ok = (ky + dy >= 0) & (ky + dy < gy)
        if dz is not None:
            ok &= (kz + dz >= 0) & (kz + dz < gz)
        start = torch.where(kx > 0, shifted(d - 1), shifted(d))
        end = torch.where(kx < gx - 1, shifted(d + 2), shifted(d + 1))
        starts.append(start)
        ends.append(torch.where(ok, torch.maximum(end, start), start))
    start = torch.stack(starts, -1)
    max_run = (NW - 1) * cell_cap
    end = torch.minimum(torch.stack(ends, -1), start + max_run)
    if new_xyz_valid is not None:
        end = torch.where(new_xyz_valid[..., None], end, start)
    return start, end, max_run


def sorted_sources(xyz, order):
    """The candidate table K5 reads: the sources' xyz in cell order."""
    return torch.gather(xyz.float(), 1, order[..., None].expand(-1, -1, 3))


def grid_select_args(radii, nsamples, xyz, xyz_num, new_xyz,
                     new_xyz_valid=None, bounds=None, cell_cap=64):
    """``ball_select``'s arguments for `grid_ball_query_multi`: the
    cell-sorted sources, their original indices, each centre's row runs,
    the centres, radii, nsamples and the run cap. Its pieces (the sort,
    the boundary table, the centres' runs, the candidate table) are
    functions of their own, which ``tools/microbench_select.py`` times
    one by one."""
    geo = grid_geometry(radii, bounds, xyz.device)
    order, sk = source_order(xyz, xyz_num, geo)
    first_row = cell_first_rows(sk, geo)
    start, end, max_run = center_runs(first_row, new_xyz, new_xyz_valid, geo,
                                      cell_cap)
    return (sorted_sources(xyz, order).contiguous(), order.int().contiguous(),
            start.int().contiguous(), end.int().contiguous(),
            new_xyz.float().contiguous(), tuple(radii), tuple(nsamples),
            max_run)


def roi_candidates(src, src_num, centers, r_cand, k_cand):
    """Per RoI, the ``k_cand`` lowest-index sources within ``r_cand`` of its
    center, ascending (pointnet2.py:662-700). Returns cand_idx (B, R, K)
    int64 and cand_live (B, R, K) bool."""
    n = src.shape[1]
    dev = src.device
    valid = torch.arange(n, device=dev) < src_num[:, None]
    d2 = _pairwise_d2(centers, src)  # (B, R, N)
    mask = (d2 < (r_cand * r_cand)[..., None]) & valid[:, None, :]
    neg_index = -torch.arange(n, device=dev, dtype=torch.float32)
    score = torch.where(mask, neg_index, torch.full_like(neg_index, -np.inf))
    k = min(k_cand, n)
    top = torch.topk(score, k, dim=-1).values
    if k < k_cand:
        top = torch.cat([top, top.new_full((*top.shape[:-1], k_cand - k),
                                           -np.inf)], dim=-1)
    live = torch.isfinite(top)
    return torch.where(live, -top, torch.zeros_like(top)).long(), live


def candidate_rank_select(cand_xyz, cand_live, grid, radius, nsample):
    """Per grid point, the candidate lanes of its first ``nsample``
    in-radius candidates in lane (ascending index) order, later slots
    repeating the first hit (pointnet2.py:703-730, which builds the same
    selection as a one-hot tensor for an MXU product; here it is the
    index of the rank-th hit, for a gather).

    Args: cand_xyz (B, R, K, 3); cand_live (B, R, K); grid (B, R, G, 3).
    Returns idx (B, R, G, nsample) int64 lanes in [0, K), empty (B, R, G).
    """
    k = cand_xyz.shape[2]
    d2 = _sq_dist(grid[:, :, :, None, :], cand_xyz[:, :, None, :, :])
    hit = cand_live[:, :, None, :] & (d2 < float(np.float32(radius * radius)))
    cnt = hit.sum(-1)
    lanes = torch.arange(k, device=cand_xyz.device)
    order = torch.where(hit, lanes, k)  # misses sort past every hit
    first = torch.topk(order, min(nsample, k), dim=-1, largest=False).values
    if nsample > k:
        first = torch.cat([first, first.new_full((*first.shape[:-1],
                                                  nsample - k), k)], -1)
    slots = torch.arange(nsample, device=cand_xyz.device)
    idx = torch.where(slots < cnt[..., None], first, first[..., :1])
    return idx.clamp(max=k - 1), cnt == 0


def group_points(features, idx):
    """(B, N, C), (B, M, ns) -> (B, M, ns, C), a batched row gather."""
    return gather_rows(features, idx)


def three_nn(query, src, src_num):
    """The 3 nearest of the first ``src_num`` sources to each query point
    (pointnet2.py:742-771): squared distances by ``_pairwise_d2``, padding
    sources at 1e10, then three passes of a first-index ``argmin``, each
    setting its pick to 1e10 for the next, so ties go to the lowest index.
    The (B, M, N) distances are built in blocks of query rows.

    Args: query (B, M, 3); src (B, N, 3); src_num (B,).
    Returns dists (B, M, 3) float32, the square roots, and idx (B, M, 3)
    int64.
    """
    b, m, _ = query.shape
    n = src.shape[1]
    valid = (torch.arange(n, device=src.device) < src_num[:, None])[:, None, :]
    rows = max(1, _THREE_NN_BLOCK // max(b * n, 1))
    dists, idxs = [], []
    for m0 in range(0, m, rows):
        d2 = torch.where(valid, _pairwise_d2(query[:, m0:m0 + rows], src),
                         _BIG)
        d, i = [], []
        for _ in range(3):
            i.append(d2.argmin(-1, keepdim=True))
            d.append(torch.gather(d2, -1, i[-1]))
            d2.scatter_(-1, i[-1], _BIG)
        dists.append(torch.cat(d, -1))
        idxs.append(torch.cat(i, -1))
    return torch.sqrt(torch.cat(dists, 1).clamp(min=0.0)), torch.cat(idxs, 1)


def three_nn_weights(dists):
    """Inverse-distance weights ``(1 / (d + 1e-8)) / sum`` (pointnet2.py:783)."""
    recip = 1.0 / (dists + 1e-8)
    return recip / recip.sum(-1, keepdim=True)


def three_interpolate(features, idx, weight):
    """Weighted sum of the 3 neighbours' features (pointnet2.py:774-780):
    (B, N, C), (B, M, 3), (B, M, 3) -> (B, M, C). bf16 features times the
    float32 weights promote to float32, as in the JAX package."""
    return (group_points(features, idx) * weight[..., None]).sum(2)
