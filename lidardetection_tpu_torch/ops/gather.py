"""Row gathers whose backward adds in a fixed order.

The backward of ``torch.gather`` is ``scatter_add_``, which on the card adds
a source row's contributions with float atomics, in whatever order the
threads arrive: where several outputs read one row (a ball query's
neighbourhoods overlap and back-fill a group with its first index, RoIs
share candidates), two identical training steps differ in the last bits,
and the difference spreads into every leaf upstream.

``gather_rows`` reads rows as ``torch.gather`` does. Its backward
(``add_rows``) sorts the flat row index once with a stable sort, then sums
each row's contributions left to right in float32 (float64 rows in
float64) and rounds once to the row's dtype (``sorted_row_sums``): every
row's gradient is the sum of its contributions in the ascending order of
their flat position. The forward's indices fix that order, so two runs
give the same bits on any device, the card and the CPU alike; on the CPU,
where ``scatter_add_`` adds in position order too, the float32 result is
the library's.

It is plain PyTorch on every device (``torch.sort``, ``index_select`` and
``torch.segment_reduce``, whose kernels add each segment serially). No TPU
kernel stands behind it: the JAX package's row gathers differentiate into
XLA's scatter-add.
"""

import torch


def sorted_row_sums(values, keys, order, n_rows):
    """``out[r] = sum of values[order[j]] over the j with keys[j] == r``, j
    ascending, from 0 in float32 (float64 rows in float64), rounded once to
    the rows' dtype.

    Args: values (L, C); keys (L,) integer, ascending, in [0, n_rows);
    order (L,) int64. Returns (n_rows, C) in the dtype of values.
    """
    acc = torch.promote_types(values.dtype, torch.float32)
    # each row's run starts where the sorted keys first reach it: no host
    # sync, where bincount's output size would take one
    offsets = torch.searchsorted(
        keys, torch.arange(n_rows + 1, dtype=keys.dtype, device=keys.device))
    rows = values.index_select(0, order).to(acc)
    return torch.segment_reduce(rows, 'sum', offsets=offsets, axis=0,
                                unsafe=True, initial=0.0).to(values.dtype)


def add_rows(values, idx, n_rows):
    """``out[b, n] = sum of values[b, p] over the p with idx[b, p] == n``,
    in ascending p, from 0 in float32 (float64 for float64 values), rounded
    once to the dtype of values: the fixed-order transpose of a row gather.

    Args: values (B, M, *F), any strides; idx (B, M) integer rows in [0,
    n_rows). Returns (B, n_rows, *F) in the dtype of values; a row that
    nothing reads is 0.
    """
    b, m = idx.shape
    feat = values.shape[2:]
    if values.numel() == 0:
        return values.new_zeros((b, n_rows, *feat))
    if b * n_rows >= 2 ** 31:
        raise ValueError(f'{b} x {n_rows} rows: the keys are int32')
    base = torch.arange(0, b * n_rows, n_rows, dtype=torch.int32,
                        device=idx.device)
    keys, order = torch.sort((idx.int() + base[:, None]).reshape(-1),
                             stable=True)
    out = sorted_row_sums(values.reshape(b * m, -1), keys, order, b * n_rows)
    return out.reshape(b, n_rows, *feat)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, idx):
        b, n = features.shape[:2]
        flat = features.reshape(b, n, -1)
        rows = torch.gather(flat, 1, idx.reshape(b, -1, 1).long().expand(
            -1, -1, flat.shape[-1]))
        ctx.save_for_backward(idx)
        ctx.shape = features.shape
        return rows.reshape(*idx.shape, *features.shape[2:])

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape = ctx.shape
        b, n = shape[:2]
        g = grad.reshape(b, -1, *shape[2:])
        return add_rows(g, idx.reshape(b, -1), n).reshape(shape), None


def gather_rows(features, idx):
    """``features[b, idx[b, ...]]``: (B, N, *F), (B, *I) integer rows in [0,
    N) -> (B, *I, *F), the values of ``torch.gather`` along the rows axis,
    with a backward that adds each row's contributions in a fixed order
    (``add_rows``)."""
    return _GatherRows.apply(features, idx)
