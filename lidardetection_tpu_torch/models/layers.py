"""Shared building blocks (lidardetection_tpu/models/layers.py:23-126).

BatchNorm uses eps 1e-3 and momentum 0.99 by default, as the detector's
layers do in the reference; the point-based layers (set abstraction, VSA,
point and RoI heads) pass eps 1e-5 and momentum 0.9. Parameters are
float32; `ConvBNReLU` and `Dense` compute in their `dtype` (the config's
COMPUTE_DTYPE) when one is given.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.dist import batch_moments

BN_EPS = 1e-3
BN_MOMENTUM = 0.99  # ra = m * ra + (1 - m) * batch; torch's momentum 0.01
# the point-based layers' BatchNorms (torch defaults in the reference)
POINT_BN = {'eps': 1e-5, 'momentum': 0.9}


def lecun_normal_(tensor, fan_in, generator):
    """flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class MaskedBatchNorm(nn.Module):
    """BatchNorm folded to ``x * inv + shift``, with an entry validity mask.

    Channels are on dim `axis`: 1 (NCHW) where `ConvBNReLU` applies it, -1
    for the channels-last (B, V, C) rows of the sparse layers. The
    affine is computed in float32 and applied in the input dtype, so a
    bf16 activation is not promoted to float32. Buffers ``mean``/``var`` and
    parameters ``scale``/``bias`` carry the flax names.

    Eval uses the running statistics. Training computes the statistics of
    the batch in float32 over the entries whose `mask` (the shape of x
    without its channel dim, or broadcastable to it) is set: ``cnt =
    max(sum(mask), 1)``, ``var = max(s2 / cnt - mean^2, 0)``, and moves the
    running statistics by `momentum` with that biased variance. In a
    process group the count and the sums are the group's
    (``parallel/dist.py::batch_moments``), the counterpart of the JAX
    module's ``psum`` over its ``axis_name``.
    Masked-out entries are still normalized. It is written with tensor
    operations, so autograd differentiates through the statistics;
    ``torch.nn.functional.batch_norm`` computes neither the mask nor the
    biased running variance. ``bn_statistics`` names the running buffers
    for precise-BN (engine/bn_recalibrate.py).
    """

    bn_statistics = ('mean', 'var')

    def __init__(self, features, axis=1, eps=BN_EPS, momentum=BN_MOMENTUM):
        super().__init__()
        self.axis, self.eps, self.momentum = axis, eps, momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def _batch_statistics(self, x, mask):
        axis = self.axis % x.dim()
        dims = [d for d in range(x.dim()) if d != axis]
        xf = x.float()
        if mask is None:
            cnt = float(x.numel() // x.shape[axis])
            s1 = xf.sum(dims)
            s2 = (xf * xf).sum(dims)
        else:
            m = mask.float().unsqueeze(axis)
            cnt = m.sum()
            s1 = (xf * m).sum(dims)
            s2 = (xf * xf * m).sum(dims)
        mean, var = batch_moments(cnt, s1, s2)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var

    def forward(self, x, mask=None):
        mean, var = self._batch_statistics(x, mask) if self.training \
            else (self.mean, self.var)
        inv = torch.rsqrt(var + self.eps) * self.scale
        shift = self.bias - mean * inv
        shape = [1] * x.dim()
        shape[self.axis] = -1
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class ConvBNReLU(nn.Module):
    """Conv2d (or ConvTranspose2d, padding VALID) without bias + BN + ReLU.

    Operates on NCHW tensors (channels_last in memory on the BEV path).
    ``weight`` is (out, in, k, k) for a convolution and (in, out, k, k) for
    a transposed one, PyTorch's layouts.
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, transpose=False, dtype=None, generator=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.transpose, self.dtype = transpose, dtype
        k = kernel_size
        shape = (in_channels, out_channels, k, k) if transpose \
            else (out_channels, in_channels, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        lecun_normal_(self.weight, in_channels * k * k, generator)
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        w = self.weight.to(x.dtype)
        if self.transpose:
            x = F.conv_transpose2d(x, w, stride=self.stride)
        else:
            x = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        return torch.relu(self.bn(x))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel (+ bias)`` over the last dim, with the
    flax layout and names (``kernel`` (in, out), ``bias``) and lecun_normal
    initialization. Computes in `dtype` when one is given, else in float32.
    """

    def __init__(self, in_features, out_features, bias=True, dtype=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        lecun_normal_(self.kernel, in_features, generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        dt = self.dtype or torch.float32
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


def dropout(x, u, rate):
    """flax's ``nn.Dropout`` on given uniforms: entries with ``u < 1 -
    rate`` kept and scaled by ``1 / (1 - rate)``, the rest 0. `u` holds
    float32 draws in [0, 1) of x's shape."""
    keep_prob = 1.0 - rate
    return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))
