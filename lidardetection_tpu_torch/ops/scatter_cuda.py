"""K2 ``scatter_rows``: rows into a zeroed BEV canvas by key (kernel in
csrc/scatter.cu).

Replaces the forward of the TPU kernel ``lidardetection_tpu/ops/
scatter_tpu.py::scatter_rows_sorted`` (Pallas ``_scatter_pallas`` /
``_tile_kernel``):

    canvas[b, keys[b, v]] = feats[b, v]   for 0 <= keys[b, v] < n_slots

Rows keyed outside [0, n_slots) (padding rows carry n_slots) are dropped;
kept keys are unique. The TPU kernel needs the keys sorted and a host tile
histogram (``bev_tile_starts``) to turn the scatter into one-hot matmuls;
Hopper stores rows natively, so neither is needed here.

Bound on the H100: memory bytes (the canvas written once, the kept rows
and all keys read once). The wrapper zero-fills the canvas with
``torch.zeros``; the kernel then copies each kept row in 16-byte words.

``scatter_rows`` takes the plain PyTorch version for tensors on the CPU and
launches the kernel for tensors on a CUDA device;
``scatter_rows.launches`` counts the launches. The backward (a row gather)
comes with the training slice.
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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scatter_rows(feats, keys, n_slots):
    """Scatter (B, V, C) rows to a zeroed (B, n_slots, C) canvas by keys.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything the kernel does not take raises.
    """
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
    if not 0 <= n_slots < 2 ** 31:
        raise ValueError(f'n_slots {n_slots} out of int32 range')
    b, v, c = feats.shape
    canvas = torch.zeros((b, n_slots, c), dtype=feats.dtype, device=feats.device)
    if b * v * c == 0:
        return canvas
    with torch.cuda.device(feats.device):
        rc = _launcher()(
            feats.data_ptr(), keys.data_ptr(), canvas.data_ptr(), b * v, v,
            c * feats.element_size(), n_slots,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'scatter_rows kernel launch failed: CUDA error {rc}')
    scatter_rows.launches += 1
    return canvas


scatter_rows.launches = 0
