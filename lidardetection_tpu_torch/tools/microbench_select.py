"""The live grid ball query (``ops/pointnet2.py::grid_ball_query_multi``,
its selection kernel K5) in pieces at the VSA's shapes (counterpart of
tools/microbench_select.py, microbench_bq.py, microbench_gbq.py,
microbench_gbq2.py and microbench_cap.py).

Cases (``--case``, default split):
  pieces  each piece alone at the raw-points source (``--n_src`` rows,
          radii 0.4 / 0.8, nsample 16 / 16): the sources' sort by cell
          (``source_order``), the cell boundary table (``cell_first_rows``),
          the centres' runs (``center_runs``), the candidate table
          (``sorted_sources``, the gather K5 reads) and K5 (microbench_bq.py's
          decomposition, :19-147);
  prefix  the cumulative prefixes of the same (sort, + boundaries, + runs,
          + candidate table, + K5: the whole query), each marginal cost
          (microbench_gbq.py's prefixes, :60-141);
  split   per VSA source (profile_vsa.py's five) the prep, K5 alone and the
          whole query (microbench_gbq2.py:77-131, microbench_select.py:
          69-88), K5 beside its bound;
  cap     the whole query at the raw-points source for each cell cap of
          ``--caps`` (microbench_cap.py:49-75).

The retired path that microbench_bq.py and microbench_gbq.py replicate
(27 cells, ``top_k`` / ``approx_max_k`` selection over a ~600 MB window
tensor) exists in neither package's live code, so their cases time the
port's pieces that take its place; their ``--n_row`` and ``--nsample``
set that path's shapes and are not taken (the port's run count follows
from the grid's z layers, its nsamples from the config). Points are
uniform over PV-RCNN's range from ``default_rng(0)``, the sources 128
rows short of full; times are ``measure.cuda_ms``'s (CUDA events, the L2
flushed clean, the median of ``--iters``).

    python -m lidardetection_tpu_torch.tools.microbench_select --case split
    python -m lidardetection_tpu_torch.tools.microbench_select --case cap \\
        --caps 64,32,16

``--cpu`` runs on the host clock, K5 as its plain version.
"""

import argparse

import numpy as np
import torch

from ..ops import pointnet2 as p2
from ..ops.select_cuda import ball_select
from . import measure
from .common import tool_device
from .profile_vsa import BOUNDS, SOURCES, uniform_points

CASES = ('pieces', 'prefix', 'split', 'cap')
RAW = SOURCES[0][3:]  # the raw-points source's radii and nsamples


def stages(radii, nsamples, src, n_valid, centers, valid, cap):
    """The query's pieces in order, each a function of the one before:
    [(label, fn(state) -> state)]; the last state is K5's output."""
    geo = p2.grid_geometry(radii, BOUNDS, src.device)
    return [
        ('sort', lambda _: p2.source_order(src, n_valid, geo)),
        ('boundaries', lambda s: (*s, p2.cell_first_rows(s[1], geo))),
        ('runs', lambda s: (*s, p2.center_runs(s[2], centers, valid, geo, cap))),
        ('candidates', lambda s: (*s, p2.sorted_sources(src, s[0]))),
        ('K5', lambda s: ball_select(
            s[4].contiguous(), s[0].int().contiguous(),
            s[3][0].int().contiguous(), s[3][1].int().contiguous(),
            centers.float().contiguous(), radii, nsamples, s[3][2])),
    ]


def case_pieces(device, src, n_valid, centers, valid, args, timed):
    fns = stages(*RAW, src, n_valid, centers, valid, args.cell_cap)
    state = None
    for label, fn in fns:
        before = state
        timed(f'{label} alone', lambda: fn(before))
        state = fn(before)


def case_prefix(device, src, n_valid, centers, valid, args, timed):
    fns = stages(*RAW, src, n_valid, centers, valid, args.cell_cap)
    prev = 0.0
    for k in range(1, len(fns) + 1):
        def run(k=k):
            state = None
            for _, fn in fns[:k]:
                state = fn(state)
            return state
        ms = timed(f'prefix to {fns[k - 1][0]}', run, marginal=prev)
        prev = ms


def case_split(device, centers, valid, args, timed, rng):
    b = centers.shape[0]
    for name, n, _, radii, ns in SOURCES:
        src = uniform_points(rng, b, n, device)
        n_valid = torch.full((b,), n - 128, dtype=torch.int32, device=device)
        k5_args = p2.grid_select_args(radii, ns, src, n_valid, centers, valid,
                                      BOUNDS, args.cell_cap)
        *_, n_bytes, n_flop, _ = measure.select_work(k5_args)
        timed(f'{name} V={n}: prep', lambda: p2.grid_select_args(
            radii, ns, src, n_valid, centers, valid, BOUNDS, args.cell_cap))
        timed(f'{name} V={n}: K5 alone', lambda: ball_select(*k5_args),
              bound=measure.bound_ms(n_bytes, n_flop)[0])
        timed(f'{name} V={n}: full query', lambda: p2.grid_ball_query_multi(
            radii, ns, src, n_valid, centers, valid, BOUNDS, args.cell_cap))


def case_cap(device, src, n_valid, centers, valid, args, timed):
    for cap in (int(c) for c in args.caps.split(',')):
        timed(f'cap={cap}', lambda: p2.grid_ball_query_multi(
            *RAW, src, n_valid, centers, valid, BOUNDS, cap))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--case', default='split', choices=CASES + ('all',))
    ap.add_argument('--batch_size', type=int, default=8)
    ap.add_argument('--num_kp', '--num_centers', dest='num_kp', type=int,
                    default=2048)
    ap.add_argument('--n_src', '--num_sources', dest='n_src', type=int,
                    default=32768)
    ap.add_argument('--cell_cap', type=int, default=64)
    ap.add_argument('--caps', default='64,32,16')
    ap.add_argument('--iters', type=int, default=15)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f'# device: {measure.device_line(device)}', flush=True)
    b, m, n = args.batch_size, args.num_kp, args.n_src
    rng = np.random.default_rng(0)
    src = uniform_points(rng, b, n, device)
    n_valid = torch.full((b,), n - 128, dtype=torch.int32, device=device)
    centers = uniform_points(rng, b, m, device)
    valid = torch.ones((b, m), dtype=torch.bool, device=device)
    rows = {}

    def timed(label, fn, bound=None, marginal=None):
        ms = measure.time_ms(fn, device, iters=args.iters)
        rows[case].append([label, ms, bound])
        tail = f'{bound:>10.4f}' if bound is not None else (
            f'{ms - marginal:>+10.4f}' if marginal is not None else '')
        print(f'{label:<40}{ms:>10.4f}{tail}', flush=True)
        return ms

    measure.reset_launches()
    for case in CASES:
        if args.case not in (case, 'all'):
            continue
        rows[case] = []
        print(f'--- {case} (B={b}, M={m}, N={n}, cap {args.cell_cap}): ms'
              + (', bound ms' if case == 'split' else
                 ', marginal ms' if case == 'prefix' else ''), flush=True)
        if case == 'pieces':
            case_pieces(device, src, n_valid, centers, valid, args, timed)
        elif case == 'prefix':
            case_prefix(device, src, n_valid, centers, valid, args, timed)
        elif case == 'split':
            case_split(device, centers, valid, args, timed, rng)
        else:
            case_cap(device, src, n_valid, centers, valid, args, timed)
    return measure.summary_line('microbench_select', device, **rows)


if __name__ == '__main__':
    main()
