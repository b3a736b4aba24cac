"""K2 ``scatter_rows``: key-sorted rows into a dense BEV canvas (kernel in
csrc/scatter.cu).

Replaces the forward of the TPU kernel ``lidardetection_tpu/ops/
scatter_tpu.py::scatter_rows_sorted`` (Pallas ``_scatter_pallas`` /
``_tile_kernel``):

    canvas[b, s] = feats[b, v] where keys[b, v] == s, else 0, for s < n_slots

Contract, the TPU kernel's: in each sample the keys ascend, the kept keys
(in [0, n_slots)) are unique, and the rows keyed outside [0, n_slots) are
dropped; the padding rows, keyed n_slots, sit at the tail. Both callers
hand such keys: the voxelizer sorts its table by linear key
(``map_to_bev.PointPillarScatter``), and sparse tensors are sorted by
``sparse.linear_key`` with the padding keyed D*H*W (``sparse_to_dense``).
The kernel relies on the order (it finds each block's rows by a search);
the plain version does not.

The TPU kernel turns the sorted keys into one-hot matmuls over tile
windows with a host tile histogram (``bev_tile_starts``); Hopper stores
rows natively, and the kernel searches the keys on the device instead.

Bound on the H100: memory bytes (the canvas written once, the kept rows
and keys read once). One launch writes every canvas byte exactly once, the
zeros included: the canvas comes from ``torch.empty``, with no zero fill.

``scatter_rows`` takes the plain PyTorch version for tensors on the CPU and
launches the kernel for tensors on a CUDA device;
``scatter_rows.launches`` counts the launches.

The backward is the transpose of the scatter, a row gather of the canvas
gradient (a dropped row gets zeros). It is plain PyTorch on both devices,
as it is plain XLA in the JAX package (``scatter_tpu.py::_scatter_bwd``):
no TPU kernel stands behind it.
"""

import ctypes
import functools

import torch

from . import _build


def scatter_rows_plain(feats, keys, n_slots):
    """Plain PyTorch version: scatter row ids to an inverse map, then
    gather feature rows (slots no row maps to read an appended zero row).

    Args: feats (B, V, C); keys (B, V) integer. Returns (B, n_slots, C).
    """
    b, v, c = feats.shape
    keys = keys.long()
    slot = torch.where((keys >= 0) & (keys < n_slots), keys,
                       torch.full_like(keys, n_slots))  # n_slots: spill slot
    inv = torch.full((b, n_slots + 1), v, dtype=torch.long, device=feats.device)
    inv.scatter_(1, slot, torch.arange(v, device=feats.device).expand(b, v))
    ext = torch.cat([feats, feats.new_zeros((b, 1, c))], dim=1)
    return torch.gather(ext, 1, inv[:, :n_slots, None].expand(b, n_slots, c))


@functools.cache  # one ctypes binding per process
def _launcher():
    fn = _build.load('scatter').scatter_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scatter_rows_grad_plain(grad_canvas, keys, n_slots):
    """Gradient of `scatter_rows` to its rows: ``grad_canvas[b, keys[b, v]]``,
    zeros for a key outside [0, n_slots). (B, n_slots, C), (B, V) -> (B, V, C).
    """
    keys = keys.long()
    kept = (keys >= 0) & (keys < n_slots)
    index = keys.clamp(0, max(n_slots - 1, 0))[..., None].expand(
        *keys.shape, grad_canvas.shape[-1])
    rows = torch.gather(grad_canvas, 1, index)
    return torch.where(kept[..., None], rows, torch.zeros_like(rows))


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, keys, n_slots):
        ctx.save_for_backward(keys)
        ctx.n_slots = n_slots
        return _scatter_forward(feats, keys, n_slots)

    @staticmethod
    def backward(ctx, grad_canvas):
        (keys,) = ctx.saved_tensors
        return scatter_rows_grad_plain(grad_canvas, keys, ctx.n_slots), None, None


def scatter_rows(feats, keys, n_slots):
    """Scatter (B, V, C) rows to a (B, n_slots, C) canvas, zero where no
    row lands, by keys sorted as the module docstring states.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything the kernel does not take raises. Differentiable in feats.
    """
    if feats.requires_grad and torch.is_grad_enabled():
        return _ScatterRows.apply(feats, keys, n_slots)
    return _scatter_forward(feats, keys, n_slots)


def _scatter_forward(feats, keys, n_slots):
    if feats.device.type == 'cpu':
        return scatter_rows_plain(feats, keys, n_slots)
    if feats.device.type != 'cuda':
        raise ValueError(f'scatter_rows runs on cpu or cuda, not {feats.device}')
    if feats.dim() != 3 or tuple(keys.shape) != tuple(feats.shape[:2]):
        raise ValueError(f'want feats (B, V, C) and keys (B, V), got '
                         f'{tuple(feats.shape)} and {tuple(keys.shape)}')
    if keys.dtype != torch.int32 or keys.device != feats.device:
        raise ValueError('keys must be int32 on the device of feats')
    if not (feats.is_contiguous() and keys.is_contiguous()):
        raise ValueError('feats and keys must be contiguous')
    b, v, c = feats.shape
    if not (0 <= n_slots < 2 ** 31 and v < 2 ** 31 and b < 2 ** 16
            and c * feats.element_size() <= 2 ** 26):
        raise ValueError(f'sizes out of range: B {b}, V {v}, C {c}, n_slots '
                         f'{n_slots}')
    # every byte is written by the kernel: no zero fill
    canvas = torch.empty((b, n_slots, c), dtype=feats.dtype, device=feats.device)
    if b * n_slots * c == 0:
        return canvas
    with torch.cuda.device(feats.device):
        rc = _launcher()(
            feats.data_ptr(), keys.data_ptr(), canvas.data_ptr(), b, v,
            c * feats.element_size(), n_slots,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'scatter_rows kernel launch failed: CUDA error {rc}')
    scatter_rows.launches += 1
    return canvas


scatter_rows.launches = 0
