"""Dense 2D BEV backbone (lidardetection_tpu/models/backbones_2d/bev_backbone.py:15-86).

Stride blocks of Conv+BN+ReLU with transposed-conv upsampling and channel
concat. The public tensors (``spatial_features`` in,
``spatial_features_2d`` and ``spatial_features_<s>x`` out) are NHWC as in
the JAX package; inside, the convolutions run on NCHW views of the same
channels_last memory, so no layout copy is made at either end.
"""

import numpy as np
import torch
from torch import nn

from ..layers import ConvBNReLU


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels, dtype=None, generator=None):
        super().__init__()
        layer_nums = list(model_cfg.get('LAYER_NUMS', []))
        layer_strides = list(model_cfg.get('LAYER_STRIDES', []))
        num_filters = list(model_cfg.get('NUM_FILTERS', []))
        upsample_strides = list(model_cfg.get('UPSAMPLE_STRIDES', []))
        num_upsample = list(model_cfg.get('NUM_UPSAMPLE_FILTERS', []))
        self.num_bev_features = sum(num_upsample) if upsample_strides \
            else num_filters[-1]

        # units in the JAX module's creation order (ConvBNReLU_<n> there is
        # units.<n> here); `levels` holds (block unit ids, deblock unit id)
        units, self.levels = [], []

        def add(*args, **kwargs):
            units.append(ConvBNReLU(*args, dtype=dtype, generator=generator,
                                    **kwargs))
            return len(units) - 1

        c_in = input_channels
        for i, (n_layers, stride, nf) in enumerate(
                zip(layer_nums, layer_strides, num_filters)):
            block = [add(c_in, nf, 3, stride, padding=1)]
            block += [add(nf, nf, 3, 1, padding=1) for _ in range(n_layers)]
            c_in = nf
            deblock = None
            if upsample_strides:
                us = upsample_strides[i]
                if us >= 1:
                    deblock = add(nf, num_upsample[i], int(us), int(us),
                                  transpose=True)
                else:
                    ds = int(np.round(1 / us))
                    deblock = add(nf, num_upsample[i], ds, ds, padding=0)
            self.levels.append((block, deblock))
        self.final = None
        if len(upsample_strides) > len(layer_nums):
            us = int(upsample_strides[-1])
            c = sum(num_upsample[:len(layer_nums)]) if layer_nums \
                else input_channels
            self.final = add(c, c, us, us, transpose=True)
        self.units = nn.ModuleList(units)

    def forward(self, batch):
        x = batch['spatial_features'].permute(0, 3, 1, 2)  # NHWC -> NCHW view
        in_h = x.shape[2]
        out = dict(batch)
        ups = []
        for block, deblock in self.levels:
            for u in block:
                x = self.units[u](x)
            out[f'spatial_features_{int(in_h / x.shape[2])}x'] = \
                x.permute(0, 2, 3, 1)
            ups.append(x if deblock is None else self.units[deblock](x))
        if len(ups) > 1:
            x = torch.cat(ups, dim=1)
        elif len(ups) == 1:
            x = ups[0]
        if self.final is not None:
            x = self.units[self.final](x)
        out['spatial_features_2d'] = x.permute(0, 2, 3, 1)  # NHWC
        return out
