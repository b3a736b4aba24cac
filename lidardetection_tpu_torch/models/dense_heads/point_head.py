"""PV-RCNN's keypoint foreground head, eval (lidardetection_tpu/models/
dense_heads/point_head.py:113-164): ``FCLayers`` and ``PointHeadSimple``.
Its training targets and loss are ROADMAP.md queue 1, "PV-RCNN training".
"""

import torch
from torch import nn

from ..layers import POINT_BN, Dense, MaskedBatchNorm


class FCLayers(nn.Module):
    """Dense (no bias) + BatchNorm + ReLU per width, then a plain Dense with
    bias in float32 (point_head.py:113-135; also the RoI head's ``FCHead``,
    roi_heads/pointrcnn_head.py:43-66, which is the same stack without the
    mask). ``dense.<n>`` / ``bn.<n>`` are flax's ``Dense_<n>`` /
    ``MaskedBatchNorm_<n>``."""

    def __init__(self, in_channels, fc_cfg, output_channels, dtype=None,
                 generator=None):
        super().__init__()
        dense, bn = [], []
        for c in fc_cfg:
            dense.append(Dense(in_channels, c, bias=False, dtype=dtype,
                               generator=generator))
            bn.append(MaskedBatchNorm(c, axis=-1, **POINT_BN))
            in_channels = c
        dense.append(Dense(in_channels, output_channels, generator=generator))
        self.dense, self.bn = nn.ModuleList(dense), nn.ModuleList(bn)

    def forward(self, x, valid_mask=None):
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x), mask=valid_mask))
        return self.dense[-1](x.float())


class PointHeadSimple(nn.Module):
    """Per-keypoint class scores: ``point_cls_scores`` = max over classes of
    the sigmoid of ``FCLayers`` (point_head.py:138-164)."""

    def __init__(self, model_cfg, num_class, input_channels, dtype=None,
                 generator=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.fc_layers = FCLayers(input_channels, model_cfg['CLS_FC'],
                                  num_class, dtype=dtype, generator=generator)

    def forward(self, batch):
        key = 'point_features_before_fusion' \
            if self.model_cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False) \
            else 'point_features'
        preds = self.fc_layers(batch[key], batch['point_valid'])
        return {**batch, 'point_cls_scores': torch.sigmoid(preds).amax(-1)}
