"""Sparse 3D convolution engine: rulebooks in plain PyTorch, the product in
kernel K3 and its weight gradient in kernel K4 (counterpart of
lidardetection_tpu/ops/sparse.py).

Same layout as the JAX package at every public function:

  * active voxels live in a batched fixed-capacity table: coords (B, V, 3)
    int32 (z, y, x), -1 padded; rows sorted by linear key with the padding
    rows (key D*H*W) at the tail;
  * a rulebook is a dense (B, V_out, K) int32 table of input rows, with
    V_in for a miss; kernel offsets run row-major over (kz, ky, kx);
  * a convolution is ``out[b, o] = sum_k W[k]^T f[b, rb[b, o, k]]``
    (ops/sparse_conv_cuda.py), outputs already in table order.

Neighbour lookup is a binary search of the sorted keys
(``torch.searchsorted``); the active outputs of a strided convolution are
the sorted unique candidate keys (``torch.unique``), cut at the capacity.
Both run the same on the CPU and on the card, and every integer result
equals the JAX package's, the inverse convolution's rulebook included.
"""

from typing import NamedTuple

import numpy as np
import torch

from .gather import add_rows
from .scatter_cuda import scatter_rows
from .sparse_conv_cuda import rulebook_conv, rulebook_conv_dw


class SparseTensor(NamedTuple):
    """Batched fixed-capacity sparse voxel tensor.

    features (B, V, C) float; coords (B, V, 3) int32 (z, y, x), -1 pad;
    num_voxels (B,) int32; spatial_shape: static (D, H, W). Rows are sorted
    by linear key, padding at the tail (`from_unsorted` establishes it).
    """

    features: torch.Tensor
    coords: torch.Tensor
    num_voxels: torch.Tensor
    spatial_shape: tuple

    @property
    def valid_mask(self):
        return self.coords[..., 0] >= 0


def linear_key(coords, spatial_shape):
    """(..., 3) zyx -> int64 linear key; rows with z < 0 get D*H*W."""
    d, h, w = (int(s) for s in spatial_shape)
    c = coords.long()
    key = (c[..., 0] * h + c[..., 1]) * w + c[..., 2]
    return torch.where(c[..., 0] < 0, d * h * w, key)


def from_unsorted(features, coords, num_voxels, spatial_shape):
    """Sort rows by linear key (stable) -> canonical SparseTensor."""
    order = torch.argsort(linear_key(coords, spatial_shape), dim=1, stable=True)
    f = torch.gather(features, 1, order[..., None].expand_as(features))
    c = torch.gather(coords, 1, order[..., None].expand_as(coords))
    return SparseTensor(f, c, num_voxels, tuple(int(s) for s in spatial_shape))


def _lookup_rows(sorted_keys, query_keys, sentinel):
    """Row of each query key in the sorted table, or V for a miss.

    sorted_keys (B, V) ascending with the sentinel-padded tail; query_keys
    (B, Q). Returns (B, Q) int32.
    """
    v = sorted_keys.shape[1]
    pos = torch.searchsorted(sorted_keys, query_keys).clamp_(max=v - 1)
    hit = (torch.gather(sorted_keys, 1, pos) == query_keys) \
        & (query_keys < sentinel)
    return torch.where(hit, pos, v).to(torch.int32)


def _kernel_offsets(kernel_size):
    """(K, 3) zyx offsets, row-major (the weight layout's order). For an odd
    centred kernel offset K-1-k is the negative of offset k, which the
    submanifold backward of `sparse_conv_apply` relies on."""
    kz, ky, kx = kernel_size
    oz, oy, ox = np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx),
                             indexing='ij')
    return np.stack([oz, oy, ox], axis=-1).reshape(-1, 3)


def _lookup_positions(coords, spatial_shape, pos, row_ok):
    """Rulebook of input positions pos (B, V_out, K, 3) in the table coords
    (B, V_in, 3); row_ok (B, V_out) marks the live output rows."""
    d, h, w = spatial_shape
    sentinel = d * h * w
    bound = torch.tensor([d, h, w], device=pos.device)
    ok = ((pos >= 0) & (pos < bound)).all(-1) & row_ok[..., None]
    q = torch.where(ok, linear_key(pos, spatial_shape), sentinel)
    rows = _lookup_rows(linear_key(coords, spatial_shape),
                        q.flatten(1), sentinel)
    return rows.view(q.shape)


def build_subm_rulebook(st, kernel_size=(3, 3, 3)):
    """Submanifold rulebook: outputs = inputs, kernel centred (odd sizes).

    Returns (B, V, K) int32 rows into the input table (V = miss).
    """
    center = (np.asarray(kernel_size) - 1) // 2
    rel = torch.from_numpy(_kernel_offsets(kernel_size) - center).to(
        st.coords.device)  # (K, 3)
    nbr = st.coords.long()[:, :, None, :] + rel
    return _lookup_positions(st.coords, st.spatial_shape, nbr, st.valid_mask)


def build_strided_out_coords(st, kernel_size, stride, padding, out_capacity):
    """Active output set of a strided sparse convolution, fixed capacity.

    Output o (per dim) receives input i iff o*s - p + k == i for some k in
    [0, K): each input has ceil(K/s) candidate parents per dim. The
    outputs are the sorted unique candidate keys, the first `out_capacity`
    of them when there are more.

    Returns out_coords (B, out_capacity, 3) int32, out_num (B,) int32 and
    the static out_spatial_shape.
    """
    ks, s, p = ([int(x) for x in t] for t in (kernel_size, stride, padding))
    out_shape = tuple((n + 2 * p[i] - (ks[i] - 1) - 1) // s[i] + 1
                      for i, n in enumerate(st.spatial_shape))
    coords = st.coords.long()
    cands = []
    for dim in range(3):
        i = coords[..., dim]
        # the smallest k >= 0 with (i + p - k) % s == 0, then steps of s
        k0 = (i + p[dim]) % s[dim]
        per_dim = []
        for j in range(-(-ks[dim] // s[dim])):
            kk = k0 + j * s[dim]
            o = (i + p[dim] - kk) // s[dim]
            ok = (kk < ks[dim]) & (o >= 0) & (o < out_shape[dim])
            per_dim.append(torch.where(ok, o, -1))
        cands.append(torch.stack(per_dim, dim=-1))  # (B, V, n_cand)
    cz = cands[0][:, :, :, None, None]
    cy = cands[1][:, :, None, :, None]
    cx = cands[2][:, :, None, None, :]
    od, oh, ow = out_shape
    sentinel = od * oh * ow
    good = (cz >= 0) & (cy >= 0) & (cx >= 0) \
        & st.valid_mask[:, :, None, None, None]
    keys = torch.where(good, (cz * oh + cy) * ow + cx, sentinel).flatten(1)

    out_keys = keys.new_full((keys.shape[0], out_capacity), sentinel)
    out_num = []
    for b in range(keys.shape[0]):
        uniq = torch.unique(keys[b])  # ascending
        uniq = uniq[uniq < sentinel][:out_capacity]
        out_keys[b, :uniq.shape[0]] = uniq
        out_num.append(uniq.shape[0])
    oyx = out_keys % (oh * ow)
    out_coords = torch.stack([out_keys // (oh * ow), oyx // ow, oyx % ow], -1)
    out_coords = torch.where((out_keys < sentinel)[..., None], out_coords, -1)
    return (out_coords.to(torch.int32),
            torch.tensor(out_num, dtype=torch.int32, device=keys.device),
            out_shape)


def build_strided_rulebook(st, out_coords, out_spatial_shape, kernel_size,
                           stride, padding):
    """Rulebook of a strided convolution: the input row feeding (output o,
    offset k) sits at o*s - p + k per dim. Returns (B, V_out, K) int32."""
    dev = st.coords.device
    offsets = torch.from_numpy(_kernel_offsets(kernel_size)).to(dev)
    s = torch.tensor([int(x) for x in stride], device=dev)
    p = torch.tensor([int(x) for x in padding], device=dev)
    in_pos = out_coords.long()[:, :, None, :] * s - p + offsets
    return _lookup_positions(st.coords, st.spatial_shape, in_pos,
                             out_coords[..., 0] >= 0)


def build_inverse_rulebook(down, up_coords, kernel_size, stride, padding):
    """Rulebook of an inverse convolution (SparseInverseConv3d): back onto
    the table `up_coords` that the paired strided convolution read.

    Up voxel u receives down voxel o at kernel offset k iff o*s - p + k ==
    u, so o = (u + p - k) / s where that divides exactly. ``u + p - k`` is
    negative at the grid's low edges (and wherever the padding is 0), so
    the remainder and the quotient are floored, as JAX's ``%`` and ``//``
    are. Offsets index the same (K,) weight layout as the forward
    convolution. Returns (B, V_up, K) int32 rows into the `down` table
    (V_down = miss).
    """
    dev = down.coords.device
    offsets = torch.from_numpy(_kernel_offsets(kernel_size)).to(dev)
    s = torch.tensor([int(x) for x in stride], device=dev)
    p = torch.tensor([int(x) for x in padding], device=dev)
    num = up_coords.long()[:, :, None, :] + p - offsets  # (B, V_up, K, 3)
    div_ok = (torch.remainder(num, s) == 0).all(-1)
    o = torch.div(num, s, rounding_mode='floor')
    row_ok = up_coords[..., 0] >= 0
    rows = _lookup_positions(down.coords, down.spatial_shape, o, row_ok)
    return torch.where(div_ok, rows, down.coords.shape[1])


class _SparseConv(torch.autograd.Function):
    """K3 forward; backward: dW through K4, df through K3 over a transposed
    rulebook where one is known (lidardetection_tpu/ops/sparse.py:194-228).
    The wrappers launch the kernels for CUDA tensors or raise."""

    @staticmethod
    def forward(ctx, features, weights, valid_mask, rulebook, rb_bwd,
                in_valid, subm):
        ctx.save_for_backward(features, weights, valid_mask, rulebook, rb_bwd,
                              in_valid)
        ctx.subm = subm
        return rulebook_conv(features, rulebook, weights, valid_mask)

    @staticmethod
    def backward(ctx, grad_out):
        f, w, valid_mask, rulebook, rb_bwd, in_valid = ctx.saved_tensors
        need_df, need_dw = ctx.needs_input_grad[:2]
        gm = grad_out * valid_mask[..., None]
        # both kernels take the gradient in the dtype of the features
        g = gm.to(f.dtype).contiguous()
        dw = rulebook_conv_dw(f, rulebook, g).to(w.dtype) if need_dw else None
        df = None
        if need_df and (ctx.subm or rb_bwd is not None):
            # on a shared table rb[i, k] = o <=> rb[o, K-1-k] = i, so the
            # forward rulebook with the offsets reversed is its own
            # transpose; a given transposed rulebook keeps the offset index
            wb = (torch.flip(w, (0,)) if ctx.subm else w).transpose(1, 2)
            df = rulebook_conv(
                g, rulebook if ctx.subm else rb_bwd, wb.contiguous(),
                valid_mask if ctx.subm else in_valid).to(f.dtype)
        elif need_df:
            df = _conv_input_grad_plain(gm, rulebook, w, f.shape[1]).to(f.dtype)
        return df, dw, None, None, None, None, None


def _conv_input_grad_plain(grad_out, rulebook, weights, v_in):
    """df of the convolution without a transposed rulebook: the scatter-add
    that autograd derives from the plain version, each input row's terms
    added in rulebook order (``gather.add_rows``), so two runs agree.

    df[b, rb[b, o, k]] += W[k] g[b, o], a miss dropped. Computed in f32;
    (B, V_out, C_out) -> (B, V_in, C_in) float32.
    """
    b, v_out, c_out = grad_out.shape
    k, c_in, _ = weights.shape
    rb = rulebook.long()
    rb = torch.where((rb < 0) | (rb >= v_in), v_in, rb)
    contrib = grad_out.float() @ weights.float().reshape(k * c_in, c_out).T
    df = add_rows(contrib.view(b, v_out * k, c_in), rb.reshape(b, v_out * k),
                  v_in + 1)
    return df[:, :v_in]


def sparse_conv_apply(features, valid_mask, rulebook, weights, rb_bwd=None,
                      in_valid=None, subm=False):
    """Gather-GEMM ``out[o] = sum_k W[k]^T in[rule[o, k]]`` through K3.

    Args: features (B, V_in, C_in); valid_mask (B, V_out) bool, rows that
    are not valid come out 0; rulebook (B, V_out, K) int32 rows into V_in
    (V_in = miss); weights (K, C_in, C_out) in the dtype of features.
    For the backward: rb_bwd (B, V_in, K), the transposed rulebook
    (rb_bwd[i, k] = the output row whose offset-k input is i, V_out for
    none) with in_valid (B, V_in) the input table's validity; subm marks a
    submanifold convolution on a shared table, which needs neither.
    Returns (B, V_out, C_out) float32.

    Gradients: dW through K4; df through K3 over the transposed rulebook
    when `subm` or `rb_bwd` gives one, else a plain scatter-add.
    """
    args = (features.contiguous(), weights.contiguous(),
            valid_mask.contiguous(), rulebook.contiguous())
    if torch.is_grad_enabled() and (features.requires_grad
                                    or weights.requires_grad):
        return _SparseConv.apply(
            *args, None if rb_bwd is None else rb_bwd.contiguous(),
            None if in_valid is None else in_valid.contiguous(), subm)
    return rulebook_conv(args[0], args[3], args[1], args[2])


def sparse_to_dense(st):
    """The dense (B, D, H, W, C) volume of a sparse tensor, through K2."""
    d, h, w = st.spatial_shape
    b, _, c = st.features.shape
    keys = linear_key(st.coords, st.spatial_shape).to(torch.int32)
    canvas = scatter_rows(st.features.contiguous(), keys.contiguous(),
                          d * h * w)
    return canvas.view(b, d, h, w, c)
