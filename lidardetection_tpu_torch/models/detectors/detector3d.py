"""Detector assembly (lidardetection_tpu/models/detectors/detector3d.py:
51-268): the slots the MODEL config names, run in the JAX package's module
order, vfe -> backbone_3d -> map_to_bev -> backbone_2d -> dense_head ->
pfe -> point_head -> roi_head. PointPillar has no 3D backbone; SECOND has
one; PV-RCNN has all three point-based slots (``pfe`` runs after the dense
head, whose BEV map and sparse stages it reads); Part-A² has the UNet and
the two heads that read its voxel-centre features; PointRCNN has only a
point backbone (PointNet2MSG over the raw points) and the two heads.
The variants take the same slots: the multi-head dense head
(AnchorHeadMulti, NuScenes CBGS and second_multihead.yaml), the
multiframe point head (PointHeadSimpleMultiFrame), VoxelResBackBone8x and
the PFN stack of PillarVFE.

In train mode the forward assigns each head's targets and
`Detector3D.loss` sums the dense head's, the point head's and the RoI
head's losses. A module name that no slot takes raises KeyError.
"""

import torch
from torch import nn

from ..backbones_2d.bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev import HeightCompression, PointPillarScatter
from ..backbones_3d.pfe import VoxelSetAbstraction
from ..backbones_3d.pointnet2_backbone import PointNet2MSG
from ..backbones_3d.spconv_backbone import VoxelBackBone8x
from ..backbones_3d.spconv_unet import UNetV2
from ..backbones_3d.vfe import MeanVFE, PillarVFE
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..dense_heads.anchor_head_multi import AnchorHeadMulti
from ..dense_heads.point_head import (
    PointHeadBox, PointHeadSimple, PointHeadSimpleMultiFrame,
    PointIntraPartOffsetHead,
)
from ..roi_heads.parta2_head import PartA2FCHead
from ..roi_heads.pointrcnn_head import PointRCNNHead
from ..roi_heads.pvrcnn_head import PVRCNNHead

# the modules each slot takes, as in the JAX package
SLOT_MODULES = {
    'VFE': ('MeanVFE', 'PillarVFE'),
    'BACKBONE_3D': ('VoxelBackBone8x', 'VoxelResBackBone8x', 'UNetV2',
                    'PointNet2MSG'),
    'MAP_TO_BEV': ('PointPillarScatter', 'HeightCompression'),
    'BACKBONE_2D': ('BaseBEVBackbone',),
    'DENSE_HEAD': ('AnchorHeadSingle', 'AnchorHeadMulti'),
    'PFE': ('VoxelSetAbstraction',),
    'POINT_HEAD': ('PointHeadSimple', 'PointIntraPartOffsetHead',
                   'PointHeadBox', 'PointHeadSimpleMultiFrame'),
    'ROI_HEAD': ('PVRCNNHead', 'PartA2FCHead', 'PointRCNNHead'),
}
# the slots in the JAX package's module_order
MODULE_ORDER = ('vfe', 'backbone_3d', 'map_to_bev', 'backbone_2d',
                'dense_head', 'pfe', 'point_head', 'roi_head')


class Detector3D(nn.Module):
    """Detector assembled from the MODEL config.

    Args:
        model_cfg: MODEL section of the yaml config.
        num_class: number of foreground classes.
        dataset_info: dict with grid_size (nx, ny, nz), voxel_size (both
            None without a voxelizer), point_cloud_range,
            num_point_features (config.dataset_info).
        op_knobs: ``ops.pointnet2.PointOpKnobs`` of the point ops (None =
            exact; they engage on the card only).
        generator: torch.Generator for parameter initialization.
        class_names: the config's CLASS_NAMES, which the multi-head dense
            head's head groups name (default: the anchor generator's
            classes, in their order).
    """

    def __init__(self, model_cfg, num_class, dataset_info, op_knobs=None,
                 generator=None, class_names=None):
        super().__init__()
        dtype_name = model_cfg.get('COMPUTE_DTYPE', 'float32')
        dtype = None if dtype_name in (None, 'float32') \
            else getattr(torch, dtype_name)
        self.compute_dtype = dtype or torch.float32
        grid_size = dataset_info['grid_size']
        voxel_size = dataset_info['voxel_size']
        pc_range = tuple(dataset_info['point_cloud_range'])
        kw = {'dtype': dtype, 'generator': generator}

        for slot, names in SLOT_MODULES.items():
            if model_cfg.get(slot) and model_cfg[slot]['NAME'] not in names:
                raise KeyError(f'unknown {slot} module '
                               f'{model_cfg[slot]["NAME"]}')
        for name in MODULE_ORDER:
            setattr(self, name, None)
        num_point_features = dataset_info['num_point_features']
        point_channels = None

        if model_cfg.get('VFE'):
            cfg = model_cfg['VFE']
            self.vfe = MeanVFE() if cfg['NAME'] == 'MeanVFE' else PillarVFE(
                cfg, num_point_features, voxel_size, pc_range, **kw)

        if model_cfg.get('BACKBONE_3D'):
            cfg = model_cfg['BACKBONE_3D']
            if cfg['NAME'] == 'PointNet2MSG':
                self.backbone_3d = PointNet2MSG(cfg, num_point_features,
                                                knobs=op_knobs, **kw)
            elif cfg['NAME'] == 'UNetV2':
                self.backbone_3d = UNetV2(cfg, num_point_features, grid_size,
                                          voxel_size, pc_range, **kw)
            else:
                self.backbone_3d = VoxelBackBone8x(
                    cfg, num_point_features, grid_size,
                    residual=cfg['NAME'] == 'VoxelResBackBone8x', **kw)
            point_channels = getattr(self.backbone_3d, 'num_point_features',
                                     None)

        bev_channels = None
        if model_cfg.get('MAP_TO_BEV'):
            cfg = model_cfg['MAP_TO_BEV']
            bev_channels = cfg['NUM_BEV_FEATURES']
            self.map_to_bev = PointPillarScatter(grid_size, bev_channels) \
                if cfg['NAME'] == 'PointPillarScatter' \
                else HeightCompression(bev_channels)

        if model_cfg.get('BACKBONE_2D'):
            self.backbone_2d = BaseBEVBackbone(model_cfg['BACKBONE_2D'],
                                               bev_channels, **kw)
            bev_channels = self.backbone_2d.num_bev_features

        if model_cfg.get('DENSE_HEAD'):
            cfg = model_cfg['DENSE_HEAD']
            head_kw = dict(
                num_class=1 if cfg.get('CLASS_AGNOSTIC', False) else num_class,
                grid_size=grid_size, point_cloud_range=pc_range,
                predict_boxes_when_training=bool(model_cfg.get('ROI_HEAD')),
                **kw)
            if cfg['NAME'] == 'AnchorHeadMulti':
                names = tuple(class_names or [
                    c['class_name'] for c in cfg['ANCHOR_GENERATOR_CONFIG']])
                self.dense_head = AnchorHeadMulti(
                    cfg, bev_channels, class_names=names, **head_kw)
            else:
                self.dense_head = AnchorHeadSingle(cfg, bev_channels, **head_kw)

        if model_cfg.get('PFE'):
            if not hasattr(self.backbone_3d, 'backbone_channels'):
                raise NotImplementedError('VoxelSetAbstraction reads the '
                                          'sparse stages of a 3D backbone')
            self.pfe = VoxelSetAbstraction(
                model_cfg['PFE'], voxel_size, pc_range,
                model_cfg['MAP_TO_BEV']['NUM_BEV_FEATURES'],
                num_point_features, self.backbone_3d.backbone_channels,
                knobs=op_knobs, **kw)
            point_channels = self.pfe.num_point_features

        if model_cfg.get('POINT_HEAD'):
            cfg = model_cfg['POINT_HEAD']
            nc = 1 if cfg.get('CLASS_AGNOSTIC', False) else num_class
            boxes_for_roi = bool(model_cfg.get('ROI_HEAD'))
            if cfg['NAME'] == 'PointHeadBox':
                self.point_head = PointHeadBox(
                    cfg, nc, point_channels,
                    predict_boxes_when_training=boxes_for_roi, **kw)
            elif cfg['NAME'] == 'PointIntraPartOffsetHead':
                self.point_head = PointIntraPartOffsetHead(
                    cfg, nc, point_channels,
                    predict_boxes_when_training=boxes_for_roi, **kw)
            else:
                c_in = self.pfe.num_point_features_before_fusion \
                    if cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False) \
                    else point_channels
                if cfg['NAME'] == 'PointHeadSimpleMultiFrame':
                    self.point_head = PointHeadSimpleMultiFrame(
                        cfg, nc, c_in, int(model_cfg['STACK_FRAME_SIZE']), **kw)
                else:
                    self.point_head = PointHeadSimple(cfg, nc, c_in, **kw)

        if model_cfg.get('ROI_HEAD'):
            cfg = model_cfg['ROI_HEAD']
            nc = 1 if cfg.get('CLASS_AGNOSTIC', True) else num_class
            if cfg['NAME'] == 'PointRCNNHead':
                self.roi_head = PointRCNNHead(cfg, point_channels, nc,
                                              knobs=op_knobs, **kw)
            else:
                head = PartA2FCHead if cfg['NAME'] == 'PartA2FCHead' \
                    else PVRCNNHead
                self.roi_head = head(cfg, point_channels, nc, **kw)
        self.module_order = tuple(name for name in MODULE_ORDER
                                  if getattr(self, name) is not None)

    def forward(self, batch, draw=None):
        """`draw(name, shape)` gives float32 uniforms in [0, 1): the RoI
        head's sampling and dropout take theirs from it in training
        (``parallel/train_step.py::step_draw``)."""
        if 'points' in batch and 'point_valid' not in batch:
            n = batch['points'].shape[1]
            batch = {**batch, 'point_valid': torch.arange(
                n, device=batch['points'].device) < batch['num_points'][:, None]}
        for name in self.module_order:
            module = getattr(self, name)
            batch = module(batch, draw) if name == 'roi_head' else module(batch)
        return batch

    def loss(self, batch_out):
        """Total training loss and its terms from a train-mode forward."""
        total, tb = 0.0, {}
        for head, key in ((self.dense_head, 'anchor_head_fwd'),
                          (self.point_head, 'point_head_fwd'),
                          (self.roi_head, 'roi_head_fwd')):
            if head is not None:
                loss, terms = head.loss(batch_out[key])
                total = total + loss
                tb.update(terms)
        return total, {**tb, 'loss': total}
