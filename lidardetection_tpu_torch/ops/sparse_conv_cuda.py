"""K3 ``rulebook_conv``: the sparse convolution's gather and product
(kernel in csrc/sparse_conv.cu).

Replaces the three TPU kernels of ``lidardetection_tpu/ops/
sparse_conv_tpu.py`` that share one contract, ``rulebook_conv_pallas_v3``
(the default), ``rulebook_conv_pallas_v2`` and ``rulebook_conv_pallas``:

    out[b, o] = sum_k W[k]^T f[b, rb[b, o, k]]     (rb outside [0, V_in): + 0)

with f (B, V_in, C_in) and W (K, C_in, C_out) in bf16 or f32, products
summed in f32, out (B, V_out, C_out) f32. The TPU kernels turn the row
gather into one-hot matmuls over windows of a transposed (B, C, V) table
and need every rulebook column to ascend; this kernel gathers rows by
index and takes any rulebook. It also takes the output rows' validity, so
padding rows are written as zeros and never computed, where the TPU
callers multiply by the mask afterwards.

Bound on the H100, by the roofline at the SECOND backbone's shapes: memory
bytes in bf16 (the live rulebook rows, the input rows they name and the
weights read once, the output written once), operations in f32 on the
wider layers (2 * hits * C_in * C_out on the f32 units). This first
version is far from both: it multiplies on the f32 FMA units out of shared
memory, misses included (the csrc note says how).

``rulebook_conv`` takes the plain PyTorch version for tensors on the CPU
and launches the kernel for tensors on a CUDA device;
``rulebook_conv.launches`` counts the launches. The gradient comes with
the training slice.
"""

import ctypes
import functools

import torch

from . import _build


def rulebook_conv_plain(features, rulebook, weights, valid_mask=None):
    """Plain PyTorch version: gather rows (a zero row for a miss), then one
    (V_out, K*C_in) x (K*C_in, C_out) product per sample.

    Both operands are upcast to f32 first: bf16 products are exact in f32,
    so this is the kernel's arithmetic in another summation order.

    Args: features (B, V_in, C_in); rulebook (B, V_out, K) integer;
    weights (K, C_in, C_out); valid_mask (B, V_out) bool or None.
    Returns (B, V_out, C_out) float32.
    """
    b, v_in, c_in = features.shape
    k, _, c_out = weights.shape
    rb = rulebook.long()
    rb = torch.where((rb < 0) | (rb >= v_in), v_in, rb)
    f_ext = torch.cat([features.float(), features.new_zeros(
        (b, 1, c_in), dtype=torch.float32)], dim=1)
    gathered = torch.gather(
        f_ext, 1, rb.flatten(1)[..., None].expand(b, rb.shape[1] * k, c_in))
    out = gathered.view(b, rb.shape[1], k * c_in) \
        @ weights.float().reshape(k * c_in, c_out)
    if valid_mask is not None:
        out = out * valid_mask[..., None]
    return out


def _check(features, rulebook, weights, valid_mask):
    if features.dim() != 3 or rulebook.dim() != 3 or weights.dim() != 3:
        raise ValueError(
            f'want features (B, V_in, C_in), rulebook (B, V_out, K) and '
            f'weights (K, C_in, C_out), got {tuple(features.shape)}, '
            f'{tuple(rulebook.shape)} and {tuple(weights.shape)}')
    b, v_in, c_in = features.shape
    if rulebook.shape[0] != b or tuple(weights.shape[:2]) != \
            (rulebook.shape[2], c_in):
        raise ValueError(
            f'shapes disagree: features {tuple(features.shape)}, rulebook '
            f'{tuple(rulebook.shape)}, weights {tuple(weights.shape)}')
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'features must be float32 or bfloat16, not '
                         f'{features.dtype}')
    if weights.dtype != features.dtype:
        raise ValueError(f'weights are {weights.dtype}, features '
                         f'{features.dtype}')
    if rulebook.dtype != torch.int32:
        raise ValueError(f'rulebook must be int32, not {rulebook.dtype}')
    tensors = {'features': features, 'rulebook': rulebook, 'weights': weights}
    if valid_mask is not None:
        if valid_mask.dtype != torch.bool or \
                tuple(valid_mask.shape) != tuple(rulebook.shape[:2]):
            raise ValueError('valid_mask must be bool of shape (B, V_out)')
        tensors['valid_mask'] = valid_mask
    for name, t in tensors.items():
        if t.device != features.device:
            raise ValueError(f'{name} is on {t.device}, features on '
                             f'{features.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if max(b * v_in, b * rulebook.shape[1]) >= 2 ** 31:
        raise ValueError('B * V must stay below 2**31 rows')


@functools.cache  # one ctypes binding per process
def _launcher():
    fn = _build.load('sparse_conv').rulebook_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rulebook_conv(features, rulebook, weights, valid_mask=None):
    """Rulebook convolution; arguments as in `rulebook_conv_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything the kernel does not take raises.
    """
    if features.device.type == 'cpu':
        return rulebook_conv_plain(features, rulebook, weights, valid_mask)
    if features.device.type != 'cuda':
        raise ValueError(f'rulebook_conv runs on cpu or cuda, not '
                         f'{features.device}')
    _check(features, rulebook, weights, valid_mask)
    b, v_in, c_in = features.shape
    _, v_out, k = rulebook.shape
    c_out = weights.shape[2]
    out = torch.empty((b, v_out, c_out), dtype=torch.float32,
                      device=features.device)
    if b * v_out * c_out == 0:
        return out
    if k * c_in * v_in == 0:
        return out.zero_()
    with torch.cuda.device(features.device):
        rc = _launcher()(
            features.data_ptr(), rulebook.data_ptr(), weights.data_ptr(),
            None if valid_mask is None else valid_mask.data_ptr(),
            out.data_ptr(), b * v_out, v_out, v_in, k, c_in, c_out,
            int(features.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'rulebook_conv kernel launch failed: CUDA error {rc}')
    rulebook_conv.launches += 1
    return out


rulebook_conv.launches = 0
