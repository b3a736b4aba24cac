"""K3 ``rulebook_conv`` and K4 ``rulebook_conv_dw``: the sparse convolution's
gather and product, and its weight gradient (kernels in csrc/sparse_conv.cu
and csrc/sparse_conv_dw.cu).

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
wider layers (2 * hits * C_in * C_out on the f32 units). The bf16 kernel
multiplies on the tensor cores and skips every miss: an offset with no hit
in a 128-row tile costs nothing, a 16-row fragment with no hit no product
(the csrc note says how); `conv_tile_skips` counts both for a rulebook.

``rulebook_conv`` takes the plain PyTorch version for tensors on the CPU
and launches the kernel for tensors on a CUDA device;
``rulebook_conv.launches`` counts the launches.

``rulebook_conv_dw`` replaces the TPU kernel ``rulebook_conv_dw_pallas``
of the same file:

    dW[k] = sum_{b,o} f[b, rb[b, o, k]] (x) g[b, o]      (a miss adds nothing)

with g (B, V_out, C_out) already masked by the caller and taken in the
dtype of f, products summed in f32, dW (K, C_in, C_out) f32. It gathers by
index, takes any rulebook, and adds the rows in a fixed order (csrc note),
so it returns the same bits from run to run. The rows are cut into splits
that `dw_split_plan` picks from the shape alone; each split's partial dW
goes to a workspace of at most 16 MB, summed in split order. CPU tensors
take ``rulebook_conv_dw_plain``; ``rulebook_conv_dw.launches`` counts the
launches. The input gradient of the convolution is K3 again, over a
transposed rulebook (ops/sparse.py).
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
    _check_common(features, rulebook, {'weights': weights}, valid_mask)


def _check_common(features, rulebook, others, valid_mask):
    """Types, devices and contiguity shared by K3 and K4; `others` are the
    float tensors that must share the dtype of features."""
    b, v_in, _ = features.shape
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'features must be float32 or bfloat16, not '
                         f'{features.dtype}')
    for name, t in others.items():
        if t.dtype != features.dtype:
            raise ValueError(f'{name} are {t.dtype}, features '
                             f'{features.dtype}')
    if rulebook.dtype != torch.int32:
        raise ValueError(f'rulebook must be int32, not {rulebook.dtype}')
    tensors = {'features': features, 'rulebook': rulebook, **others}
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


# K4's row splits (csrc/sparse_conv_dw.cu): the splits take groups of
# DW_GROUP_ROWS rows in turn, a block looks up DW_WINDOW_ROWS rows at once;
# as many splits as the workspace (at most DW_WORKSPACE_BYTES) and one
# window a split allow, up to DW_BLOCKS blocks: short splits keep the block
# that holds the centre offset of a submanifold layer (a hit on every live
# row of its split) short, but every block also walks its split's rulebook
# column and writes a partial tile, so more blocks cost more.
DW_BLOCKS = 8 * 132  # eight blocks for each of the H100's 132 SMs
DW_GROUP_ROWS = 4
DW_WINDOW_ROWS = 512
DW_WORKSPACE_BYTES = 16_000_000
_DW_GATHER_ROWS = 4096    # rows the plain version gathers at once


def _dw_tile(c_in, c_out):
    """K4's block tile of dW (csrc note): 16, 32 or 64 rows, the least that
    covers C_in, and as many columns, or twice as many where C_out is
    wider."""
    ct = 16 if c_in <= 16 else 32 if c_in <= 32 else 64
    return ct, 2 * ct if c_out > ct else ct


def dw_split_plan(n_rows, k, c_in, c_out):
    """How many splits K4 cuts n_rows output rows into.

    The rows are cut into groups of DW_GROUP_ROWS; split s takes groups
    s, s + n_splits, s + 2 * n_splits, ..., so every row falls in one split,
    each split walks its rows in ascending order, and the padding rows at
    the end of each sample spread evenly over the splits. A block takes one
    kernel offset of one split and one dW tile; the number of splits gives
    at most DW_BLOCKS such blocks, at least DW_WINDOW_ROWS rows a split (a
    block's window), and an f32 workspace (n_splits, K, C_in, C_out) of at
    most DW_WORKSPACE_BYTES. It depends on the shape alone, never on the
    data.
    """
    ct, cot = _dw_tile(c_in, c_out)
    blocks = k * -(-c_in // ct) * -(-c_out // cot)
    return min(max(1, DW_BLOCKS // blocks), max(1, n_rows // DW_WINDOW_ROWS),
               max(1, DW_WORKSPACE_BYTES // (k * c_in * c_out * 4)))


def conv_tile_skips(rulebook, valid_mask, v_in, tile=128, fragment=16):
    """What K3's bf16 kernel skips on a rulebook: its blocks own `tile`
    output rows (batch and row flattened), its warps `fragment` rows each.

    Returns a dict: `tiles`, the tiles with a valid row (the others write
    zeros and stop); `pairs` and `pairs_skipped`, the (tile, offset) pairs
    of those tiles and the ones with no hit (no weight load, no gather, no
    product); `fragments` and `fragments_skipped`, the (fragment, offset)
    pairs of the pairs that are not skipped and those with no hit (no
    product). rulebook (B, V_out, K); valid_mask (B, V_out) bool or None.
    """
    k = rulebook.shape[-1]
    hit = (rulebook >= 0) & (rulebook < v_in)
    live = torch.ones(rulebook.shape[:2], dtype=torch.bool,
                      device=rulebook.device)
    if valid_mask is not None:
        live = valid_mask.bool()
        hit = hit & live[..., None]
    hit, live = hit.reshape(-1, k), live.reshape(-1)
    pad = -hit.shape[0] % tile
    hit = torch.cat([hit, hit.new_zeros((pad, k))])
    live = torch.cat([live, live.new_zeros(pad)])
    frag_hit = hit.view(-1, tile // fragment, fragment, k).any(2)
    tile_hit = frag_hit.any(1)                      # (tiles, K)
    kept = live.view(-1, tile).any(1)
    pairs = tile_hit[kept]
    frags = frag_hit[kept].transpose(1, 2)[pairs]   # (pairs kept, fragments)
    return {'tiles': int(kept.sum()), 'pairs': pairs.numel(),
            'pairs_skipped': int((~pairs).sum()), 'fragments': frags.numel(),
            'fragments_skipped': int((~frags).sum())}


def rulebook_conv_dw_plain(features, rulebook, grad, valid=None):
    """Plain PyTorch version of K4: gather rows (a zero row for a miss), then
    ``einsum('okc,od->kcd')`` in f32 over chunks of output rows, so that the
    (rows, K * C_in) gather stays small.

    Args: features (B, V_in, C_in); rulebook (B, V_out, K) integer; grad
    (B, V_out, C_out), rounded to the dtype of features first, as the
    kernel takes it; valid (B, V_out) bool or None: rows outside it add
    nothing. Returns (K, C_in, C_out) float32.
    """
    b, v_in, c_in = features.shape
    _, v_out, k = rulebook.shape
    flat = torch.arange(b, device=features.device)[:, None, None] * (v_in + 1)
    rb = rulebook.long()
    rb = (torch.where((rb < 0) | (rb >= v_in), v_in, rb) + flat).view(-1, k)
    f_ext = torch.cat([features, features.new_zeros((b, 1, c_in))],
                      dim=1).view(-1, c_in)
    g = grad.to(features.dtype).reshape(b * v_out, -1)
    if valid is not None:
        g = g * valid.reshape(-1, 1).to(g.dtype)
    dw = torch.zeros((k, c_in, g.shape[1]), dtype=torch.float32,
                     device=features.device)
    for r in range(0, b * v_out, _DW_GATHER_ROWS):
        rows = rb[r:r + _DW_GATHER_ROWS]
        gathered = f_ext[rows.reshape(-1)].view(rows.shape[0], k, c_in)
        dw += torch.einsum('okc,od->kcd', gathered.float(),
                           g[r:r + _DW_GATHER_ROWS].float())
    return dw


@functools.cache  # one ctypes binding per process
def _dw_launcher():
    fn = _build.load('sparse_conv_dw').rulebook_conv_dw_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rulebook_conv_dw(features, rulebook, grad, valid=None):
    """Weight gradient of the rulebook convolution; arguments as in
    `rulebook_conv_dw_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and anything the kernel does not take raises.
    """
    if features.device.type == 'cpu':
        return rulebook_conv_dw_plain(features, rulebook, grad, valid)
    if features.device.type != 'cuda':
        raise ValueError(f'rulebook_conv_dw runs on cpu or cuda, not '
                         f'{features.device}')
    if features.dim() != 3 or rulebook.dim() != 3 or grad.dim() != 3 or \
            rulebook.shape[0] != features.shape[0] or \
            tuple(grad.shape[:2]) != tuple(rulebook.shape[:2]):
        raise ValueError(
            f'want features (B, V_in, C_in), rulebook (B, V_out, K) and '
            f'grad (B, V_out, C_out), got {tuple(features.shape)}, '
            f'{tuple(rulebook.shape)} and {tuple(grad.shape)}')
    if grad.dtype != features.dtype:
        grad = grad.to(features.dtype)
    _check_common(features, rulebook, {'grad': grad}, valid)
    b, v_in, c_in = features.shape
    _, v_out, k = rulebook.shape
    c_out = grad.shape[2]
    out = torch.empty((k, c_in, c_out), dtype=torch.float32,
                      device=features.device)
    if k * c_in * c_out == 0:
        return out
    if b * v_out * v_in == 0:
        return out.zero_()
    n_splits = dw_split_plan(b * v_out, k, c_in, c_out)
    workspace = torch.empty((n_splits, k, c_in, c_out), dtype=torch.float32,
                            device=features.device)
    with torch.cuda.device(features.device):
        rc = _dw_launcher()(
            features.data_ptr(), rulebook.data_ptr(), grad.data_ptr(),
            None if valid is None else valid.data_ptr(),
            workspace.data_ptr(), out.data_ptr(), b * v_out, v_out, v_in, k,
            c_in, c_out, n_splits, int(features.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f'rulebook_conv_dw kernel launch failed: CUDA error {rc}')
    rulebook_conv_dw.launches += 1
    return out


rulebook_conv_dw.launches = 0
