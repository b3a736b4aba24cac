"""K3 (``rulebook_conv``) at one table shape on a synthetic rulebook
(counterpart of tools/microbench_rbconv.py:1-103): its result and time
against its plain version's, and its bound.

The JAX tool sweeps Pallas tilings (``rulebook_conv_pallas`` and eleven
``_v3`` configurations) by ``fori_loop`` chains; the port has one K3, so
this tool times that kernel against its plain version. K4 is read by
``chip_smoke.py``'s ``weight_gradient_phase``: the JAX tool has no dW
case.

    python -m lidardetection_tpu_torch.tools.microbench_rbconv \\
        --vin 3072 --cin 64 --cout 64 --b 8

The rulebook is ``make_rulebook``'s (microbench_rbconv.py:22-41, copied;
``tools/verify_cuda.py`` reads this copy): ascending columns, in-plane
offsets near the diagonal, the z groups shifted by ~vin / 3, ~55% hits.
Features and weights are bf16, as on the main path. ``--cpu`` runs the
plain version on the host clock.
"""

import argparse

import numpy as np
import torch

from ..ops.sparse_conv_cuda import rulebook_conv, rulebook_conv_plain
from . import measure
from .common import tool_device


def make_rulebook(rng, b, vi, vo, k=27, hit=0.55):
    """A banded rulebook (microbench_rbconv.py:22-41): ascending columns,
    in-plane offsets near the diagonal, the z groups shifted by ~vi / 3,
    as real sorted tables are; a miss is vi."""
    rule = np.full((b, vo, k), vi, np.int32)
    for bi in range(b):
        for kk in range(k):
            shift = (kk // 9 - 1) * (vi // 3)
            jitter = (kk % 9 - 4) * 3
            rows = np.arange(vo)
            cand = rows * vi // vo + shift + jitter
            hits = (rng.rand(vo) < hit) & (cand >= 0) & (cand < vi)
            c = np.maximum.accumulate(cand[hits])
            _, first = np.unique(c, return_index=True)
            keep = np.zeros(len(c), bool)
            keep[first] = True
            idx = np.where(hits)[0][keep]
            rule[bi, idx, kk] = c[keep]
    return rule


def inputs(args, device, seed=0):
    """The rulebook, bf16 features and weights of `args`' shape, from
    ``RandomState(seed)`` in the JAX tool's order."""
    vo = args.vout or args.vin
    rng = np.random.RandomState(seed)
    rule = torch.from_numpy(make_rulebook(rng, args.b, args.vin, vo, args.k))
    f = torch.from_numpy(rng.randn(args.b, args.vin, args.cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(args.k, args.cin, args.cout) * 0.1)
                         .astype(np.float32))
    return (rule.to(device), f.to(device, torch.bfloat16),
            w.to(device, torch.bfloat16))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--b', type=int, default=8)
    ap.add_argument('--vin', type=int, default=3072)
    ap.add_argument('--vout', type=int, default=0, help='0 = same as vin')
    ap.add_argument('--cin', type=int, default=64)
    ap.add_argument('--cout', type=int, default=64)
    ap.add_argument('--k', type=int, default=27)
    ap.add_argument('--iters', type=int, default=30)
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args.cpu)
    print(f'# device: {measure.device_line(device)}', flush=True)
    rule, f, w = inputs(args, device)
    valid = torch.ones(rule.shape[:2], dtype=torch.bool, device=device)
    measure.reset_launches()
    got = rulebook_conv(f, rule, w, valid)
    want = rulebook_conv_plain(f, rule, w, valid)
    err = float((got.float() - want.float()).abs().max())
    top = float(want.abs().max())
    live, hits, n_bytes, n_flop = measure.conv_work(f, rule, w, valid)
    bound, by = measure.bound_ms(n_bytes, n_flop, measure.BF16_FLOP_PER_S)
    ms = measure.time_ms(lambda: rulebook_conv(f, rule, w, valid), device,
                         iters=args.iters)
    plain_ms = measure.time_ms(lambda: rulebook_conv_plain(f, rule, w, valid),
                               device, iters=max(args.iters // 3, 1))
    print(f'K3 rulebook_conv B={args.b} V {args.vin}->{rule.shape[1]} '
          f'K={args.k} C {args.cin}->{args.cout} bf16: {hits} hits '
          f'({hits / max(live * args.k, 1):.3f} of entries)', flush=True)
    print(f'{"":<10}{"ms":>10}{"bound_ms":>10}{"max|k-p|":>12}{"max|p|":>10}',
          flush=True)
    print(f'{"kernel":<10}{ms:>10.4f}{bound:>10.4f}{err:>12.3g}{top:>10.3g}',
          flush=True)
    print(f'{"plain":<10}{plain_ms:>10.4f}', flush=True)
    print(f'bound by {by}: {n_bytes} bytes, {n_flop} FLOP; '
          f'{n_flop / ms * 1e-9:.2f} TFLOP/s on hits', flush=True)
    return measure.summary_line('microbench_rbconv', device, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=by, max_abs_err=err, max_abs_plain=top)


if __name__ == '__main__':
    main()
