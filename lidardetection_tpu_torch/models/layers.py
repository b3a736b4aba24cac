"""Shared building blocks, eval path (lidardetection_tpu/models/layers.py:23-126).

BatchNorm uses eps 1e-3 everywhere, as the reference does. Parameters are
float32; `ConvBNReLU` computes in its `dtype` (the config's COMPUTE_DTYPE)
when one is given.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3

TRAINING_NOT_PORTED = (
    'training (batch statistics, target assignment, losses) is not ported '
    'yet: see ROADMAP.md queue 1, "Training"')


def lecun_normal_(tensor, fan_in, generator):
    """flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class MaskedBatchNorm(nn.Module):
    """BatchNorm with running statistics, folded to ``x * inv + shift``.

    Channels are on dim `axis`: 1 (NCHW) where `ConvBNReLU` applies it, -1
    for the channels-last (B, V, C) rows of the sparse layers. The
    affine is computed in float32 and applied in the input dtype, so a
    bf16 activation is not promoted to float32. Buffers ``mean``/``var`` and
    parameters ``scale``/``bias`` carry the flax names. Eval only: the
    masked batch statistics come with the training slice.
    """

    def __init__(self, features, axis=1):
        super().__init__()
        self.axis = axis
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        inv = torch.rsqrt(self.var + BN_EPS) * self.scale
        shift = self.bias - self.mean * inv
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
