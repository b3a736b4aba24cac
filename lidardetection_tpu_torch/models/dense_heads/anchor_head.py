"""AnchorHeadSingle, eval (lidardetection_tpu/models/dense_heads/anchor_head.py:45-248).

The three 1x1 heads (class, box, direction) keep separate parameters with
the flax names and layouts, ``conv_*_kernel`` (C_in, out) and
``conv_*_bias``, and run as ONE product whose output columns are
interleaved per anchor ([a0: cls|box|dir][a1: ...]). Eval defers the box
decode: the head emits ``batch_fused_preds`` (B, H, W, na*tot) and
post-processing decodes only the rows it keeps, through
``anchor_from_idx`` and ``decode_box_fn``.
"""

import math

import numpy as np
import torch
from torch import nn

from ...core.box_coders import build_box_coder
from ...core.geometry import limit_period
from ..layers import lecun_normal_
from .anchor_generator import flatten_anchors, generate_anchors


def build_head_anchors(model_cfg, grid_size, point_cloud_range):
    """Flat anchors (numpy) and the head's anchor and coder facts."""
    agc = model_cfg['ANCHOR_GENERATOR_CONFIG']
    ta_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
    box_coder = build_box_coder(ta_cfg['BOX_CODER'],
                                **ta_cfg.get('BOX_CODER_CONFIG', {}))
    anchors_list, num_per_loc = generate_anchors(
        agc, grid_size, point_cloud_range, anchor_ndim=box_coder.full_code_size)
    flat, _ = flatten_anchors(anchors_list)
    return {
        'flat_anchors': flat,
        'num_anchors_per_location': sum(num_per_loc),
        'box_coder': box_coder,
        'feature_map_size': anchors_list[0].shape[:3],  # (nz, ny, nx)
    }


class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, grid_size,
                 point_cloud_range, dtype=None, generator=None):
        super().__init__()
        info = build_head_anchors(model_cfg, grid_size, point_cloud_range)
        self.model_cfg = model_cfg
        self.box_coder = info['box_coder']
        self.num_class = num_class
        self.dtype = dtype
        na = self.num_anchors_per_location = info['num_anchors_per_location']
        code = self.box_coder.full_code_size
        self.use_dir = model_cfg.get('USE_DIRECTION_CLASSIFIER', False)
        self.num_dir_bins = model_cfg['NUM_DIR_BINS'] if self.use_dir else 0
        c_in = input_channels

        def param(shape, fill=None, std=None):
            t = torch.empty(shape)
            if fill is not None:
                nn.init.constant_(t, fill)
            elif std is not None:
                nn.init.normal_(t, 0.0, std, generator=generator)
            else:
                lecun_normal_(t, shape[0], generator)
            return nn.Parameter(t)

        # focal-style class bias (pi = 0.01), box weights std 0.001
        pi = 0.01
        self.conv_cls_kernel = param((c_in, na * num_class))
        self.conv_cls_bias = param((na * num_class,),
                                   fill=-math.log((1 - pi) / pi))
        self.conv_box_kernel = param((c_in, na * code), std=0.001)
        self.conv_box_bias = param((na * code,), fill=0.0)
        if self.use_dir:
            self.conv_dir_kernel = param((c_in, na * self.num_dir_bins))
            self.conv_dir_bias = param((na * self.num_dir_bins,), fill=0.0)

        # the dense anchor grid is separable: x from the column, y from the
        # row, the rest from an (na, code - 2) table; otherwise gather rows
        nz, ny, nx = (int(v) for v in info['feature_map_size'])
        self.nx = nx
        fa = info['flat_anchors']
        ar = fa.reshape(nz * ny, nx, na, fa.shape[-1])
        xs, ys, tab = ar[0, :, 0, 0], ar[:, 0, 0, 1], ar[0, 0, :, 2:]
        recon = np.concatenate([
            np.broadcast_to(xs[None, :, None, None], ar[..., :1].shape),
            np.broadcast_to(ys[:, None, None, None], ar[..., 1:2].shape),
            np.broadcast_to(tab[None, None], ar[..., 2:].shape)], axis=-1)
        self.separable = bool(np.allclose(recon, ar))
        tables = {'anchor_xs': xs, 'anchor_ys': ys, 'anchor_tab': tab} \
            if self.separable else {'flat_anchors': fa}
        for name, arr in tables.items():
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)),
                                 persistent=False)

    def fused_weights(self):
        """(C_in, na*tot) weight and (na*tot,) bias, columns per anchor."""
        na, nc = self.num_anchors_per_location, self.num_class
        code, nd = self.box_coder.full_code_size, self.num_dir_bins
        ws, bs = [], []
        for a in range(na):
            ws += [self.conv_cls_kernel[:, a * nc:(a + 1) * nc],
                   self.conv_box_kernel[:, a * code:(a + 1) * code]]
            bs += [self.conv_cls_bias[a * nc:(a + 1) * nc],
                   self.conv_box_bias[a * code:(a + 1) * code]]
            if self.use_dir:
                ws.append(self.conv_dir_kernel[:, a * nd:(a + 1) * nd])
                bs.append(self.conv_dir_bias[a * nd:(a + 1) * nd])
        return torch.cat(ws, dim=1), torch.cat(bs)

    def anchor_from_idx(self, idx):
        """Anchors (..., code) of flat anchor ids (..., ) in head row order."""
        if not self.separable:
            return self.flat_anchors[idx]
        na = self.num_anchors_per_location
        a, pos = idx % na, idx // na
        return torch.cat([self.anchor_xs[pos % self.nx][..., None],
                          self.anchor_ys[pos // self.nx][..., None],
                          self.anchor_tab[a]], dim=-1)

    def decode_boxes(self, raw, dir_raw, anchor_rows):
        """Residual decode in float32, then the direction-bin fix-up."""
        boxes = self.box_coder.decode(raw.float(), anchor_rows)
        if self.use_dir:
            dir_offset = self.model_cfg.get('DIR_OFFSET', 0.78539)
            dir_limit = self.model_cfg.get('DIR_LIMIT_OFFSET', 0.0)
            dir_labels = dir_raw.float().argmax(dim=-1)
            period = 2 * np.pi / self.num_dir_bins
            dir_rot = limit_period(boxes[..., 6] - dir_offset, dir_limit, period)
            heading = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
            boxes = torch.cat([boxes[..., :6], heading[..., None],
                               boxes[..., 7:]], dim=-1)
        return boxes

    def forward(self, batch):
        x = batch['spatial_features_2d']  # (B, H, W, C)
        cdt = self.dtype or x.dtype
        w, b = self.fused_weights()
        fused = x.to(cdt) @ w.to(cdt) + b.to(cdt)  # (B, H, W, na*tot)
        code = self.box_coder.full_code_size
        return {
            **batch,
            'batch_fused_preds': fused,
            'head_raw_sizes': (self.num_class, code, self.num_dir_bins),
            'head_layout': (fused.shape[1], fused.shape[2],
                            self.num_anchors_per_location),
            'anchor_from_idx': self.anchor_from_idx,
            'decode_box_fn': self.decode_boxes,
            'cls_preds_normalized': False,
        }
