"""K1 ``pillar_vfe``: fused eval pillar VFE (kernel in csrc/vfe.cu).

Replaces the TPU kernel ``lidardetection_tpu/ops/vfe_tpu.py::
pillar_vfe_fused`` (Pallas ``_vfe_bd_kernel``, and ``_vfe_kernel`` through
``_pillar_vfe_fused_rowwise`` for P not a power of two). It computes

    out[b, v, c] = relu(max(max_{p < cnt} (xc[b, v, p] @ W4[:, c])
                            + pillar_bias[b, v, c],
                            shift[c] if cnt < P))

with ``xc = vox4 - centers`` rounded to W4's dtype, without materializing
the (B, V, P, C) point activations (module docstring of vfe_tpu.py for the
algebra that turns PillarVFE's Linear+BN into this form).

Bound on the H100: memory bytes (the valid points, centers, bias rows and
counts read once, the output written once) and the latency of those
loads. A thread owns one pillar's 4 consecutive channels (1 where C is not
a multiple of 4 or the bias rows are not 16-byte aligned:
``channels_per_thread``) and strides over the pillars: an empty pillar's
row (``relu(shift)``) is stored from registers, a live pillar's loads
depend only on its count, which each thread loads four pillars ahead. No
shared memory and no barrier; the csrc note says what else was tried. The
block-diagonal ``kron`` weight of the TPU kernel fills the MXU's lanes and
has no counterpart here.

``pillar_vfe`` takes the plain PyTorch version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; ``pillar_vfe.launches``
counts the launches.
"""

import ctypes
import functools

import torch

from . import _build


def pillar_vfe_plain(vox4, centers, pillar_bias, counts, w4, shift,
                     out_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel, same arithmetic order.

    Args:
        vox4 (B, V, P, 4) f32: raw [xyz, intensity] per point.
        centers (B, V, 4) f32: [pillar center xyz, 0].
        pillar_bias (B, V, C) f32: per-pillar linear terms + BN shift.
        counts (B, V) int32: valid points per pillar.
        w4 (4, C) f32 or bf16: per-point weight; the centered points are
            rounded to its dtype before the product.
        shift (C,) f32: BN shift, the pre-relu value of a padding point.
    Returns (B, V, C) out_dtype.
    """
    p = vox4.shape[2]
    xc = (vox4 - centers[:, :, None, :]).to(w4.dtype).float()
    w = w4.float()
    z = (xc[..., 0:1] * w[0] + xc[..., 1:2] * w[1]
         + xc[..., 2:3] * w[2] + xc[..., 3:4] * w[3])  # (B, V, P, C) f32
    rows = torch.arange(p, device=vox4.device)
    z = z.masked_fill(~(rows < counts[..., None])[..., None], -float('inf'))
    m = z.amax(dim=2) + pillar_bias
    pad = torch.where((counts < p)[..., None], shift,
                      torch.tensor(-float('inf'), device=shift.device))
    return torch.relu(torch.maximum(m, pad)).to(out_dtype)


def _check(vox4, centers, pillar_bias, counts, w4, shift, out_dtype):
    b, v, p, f = vox4.shape
    c = w4.shape[-1]
    want = {
        'vox4': (vox4, (b, v, p, 4), (torch.float32,)),
        'centers': (centers, (b, v, 4), (torch.float32,)),
        'pillar_bias': (pillar_bias, (b, v, c), (torch.float32,)),
        'counts': (counts, (b, v), (torch.int32,)),
        'w4': (w4, (4, c), (torch.float32, torch.bfloat16)),
        'shift': (shift, (c,), (torch.float32,)),
    }
    for name, (t, shape, dtypes) in want.items():
        if t.device != vox4.device:
            raise ValueError(f'{name} is on {t.device}, vox4 on {vox4.device}')
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, want {shape}')
        if t.dtype not in dtypes:
            raise ValueError(f'{name} has dtype {t.dtype}, want one of {dtypes}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'out_dtype {out_dtype} is not float32 or bfloat16')
    if not 1 <= c <= 1024 or p < 1:
        raise ValueError(f'need 1 <= C <= 1024 and P >= 1, got C={c} P={p}')
    for name in ('vox4', 'centers'):
        if want[name][0].data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')


@functools.cache  # one ctypes binding per process
def _library():
    lib = _build.load('vfe')
    lib.pillar_vfe_launch.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pillar_vfe_launch.restype = ctypes.c_int
    lib.pillar_vfe_channels_per_thread.argtypes = [ctypes.c_int]
    lib.pillar_vfe_channels_per_thread.restype = ctypes.c_int
    return lib


def channels_per_thread(c):
    """Channels a kernel thread takes at width C with 16-byte aligned bias
    rows: 4, or 1 on the scalar path (builds the kernel)."""
    return _library().pillar_vfe_channels_per_thread(c)


def pillar_vfe(vox4, centers, pillar_bias, counts, w4, shift,
               out_dtype=torch.bfloat16):
    """Fused pillar VFE; arguments as in `pillar_vfe_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything the kernel does not take raises.
    """
    if vox4.device.type == 'cpu':
        return pillar_vfe_plain(vox4, centers, pillar_bias, counts, w4, shift,
                                out_dtype)
    if vox4.device.type != 'cuda':
        raise ValueError(f'pillar_vfe runs on cpu or cuda, not {vox4.device}')
    _check(vox4, centers, pillar_bias, counts, w4, shift, out_dtype)
    b, v, p, _ = vox4.shape
    c = w4.shape[1]
    out = torch.empty((b, v, c), dtype=out_dtype, device=vox4.device)
    if b * v == 0:
        return out
    with torch.cuda.device(vox4.device):
        rc = _library().pillar_vfe_launch(
            vox4.data_ptr(), centers.data_ptr(), pillar_bias.data_ptr(),
            counts.data_ptr(), w4.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b * v, p, c, int(w4.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'pillar_vfe kernel launch failed: CUDA error {rc}')
    pillar_vfe.launches += 1
    return out


pillar_vfe.launches = 0
