"""Detector assembly (lidardetection_tpu/models/detectors/detector3d.py:
124-245): vfe -> [backbone_3d] -> map_to_bev -> backbone_2d -> dense_head
-> [pfe] -> [point_head -> roi_head] (PointPillar without a 3D backbone,
SECOND with one, PV-RCNN with all three point-based slots, Part-A² with
the UNet and the two heads that read its voxel-centre features; ``pfe``
runs after the dense head, whose BEV map and sparse stages it reads).

In train mode the forward assigns each head's targets and
`Detector3D.loss` sums the dense head's, the point head's and the RoI
head's losses (JAX :247-268). Every other slot or module raises
NotImplementedError naming the ROADMAP.md item that will port it.
"""

import torch
from torch import nn

from ..backbones_2d.bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev import HeightCompression, PointPillarScatter
from ..backbones_3d.pfe import VoxelSetAbstraction
from ..backbones_3d.spconv_backbone import VoxelBackBone8x
from ..backbones_3d.spconv_unet import UNetV2
from ..backbones_3d.vfe import MeanVFE, PillarVFE
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..dense_heads.point_head import PointHeadSimple, PointIntraPartOffsetHead
from ..roi_heads.parta2_head import PartA2FCHead
from ..roi_heads.pvrcnn_head import PVRCNNHead

NOT_PORTED = {  # detector or module name -> ROADMAP.md queue 1 item
    'PointRCNN': 'PointRCNN', 'PointNet2MSG': 'PointRCNN',
    'PointRCNNHead': 'PointRCNN', 'PointHeadBox': 'PointRCNN',
    'AnchorHeadMulti': 'Variants', 'PointHeadSimpleMultiFrame': 'Variants',
}
# the modules each slot takes in the port
PORTED_SLOTS = {
    'BACKBONE_3D': ('VoxelBackBone8x', 'VoxelResBackBone8x', 'UNetV2'),
    'BACKBONE_2D': ('BaseBEVBackbone',), 'DENSE_HEAD': ('AnchorHeadSingle',),
    'PFE': ('VoxelSetAbstraction',),
    'POINT_HEAD': ('PointHeadSimple', 'PointIntraPartOffsetHead'),
    'ROI_HEAD': ('PVRCNNHead', 'PartA2FCHead'),
}


def not_ported(name):
    item = NOT_PORTED.get(name, 'Variants')
    return NotImplementedError(
        f'{name} is not ported yet: see ROADMAP.md queue 1, "{item}"')


class Detector3D(nn.Module):
    """Detector assembled from the MODEL config.

    Args:
        model_cfg: MODEL section of the yaml config.
        num_class: number of foreground classes.
        dataset_info: dict with grid_size (nx, ny, nz), voxel_size,
            point_cloud_range, num_point_features (config.dataset_info).
        op_knobs: ``ops.pointnet2.PointOpKnobs`` of the point ops (None =
            exact; they engage on the card only).
        generator: torch.Generator for parameter initialization.
    """

    def __init__(self, model_cfg, num_class, dataset_info, op_knobs=None,
                 generator=None):
        super().__init__()
        dtype_name = model_cfg.get('COMPUTE_DTYPE', 'float32')
        dtype = None if dtype_name in (None, 'float32') \
            else getattr(torch, dtype_name)
        self.compute_dtype = dtype or torch.float32
        grid_size = tuple(dataset_info['grid_size'])
        pc_range = tuple(dataset_info['point_cloud_range'])
        voxel_size = tuple(dataset_info['voxel_size'])

        for slot, names in PORTED_SLOTS.items():
            if model_cfg.get(slot) and model_cfg[slot]['NAME'] not in names:
                raise not_ported(model_cfg[slot]['NAME'])
        num_point_features = dataset_info['num_point_features']
        bev_channels = model_cfg['MAP_TO_BEV']['NUM_BEV_FEATURES']

        name = model_cfg['VFE']['NAME']
        if name == 'MeanVFE':
            self.vfe = MeanVFE()
        elif name == 'PillarVFE':
            self.vfe = PillarVFE(model_cfg['VFE'], num_point_features,
                                 voxel_size, pc_range, dtype=dtype,
                                 generator=generator)
        else:
            raise not_ported(name)

        self.backbone_3d = None
        point_channels = None
        if model_cfg.get('BACKBONE_3D'):
            name = model_cfg['BACKBONE_3D']['NAME']
            if name == 'UNetV2':
                self.backbone_3d = UNetV2(
                    model_cfg['BACKBONE_3D'], num_point_features, grid_size,
                    voxel_size, pc_range, dtype=dtype, generator=generator)
                point_channels = self.backbone_3d.num_point_features
            else:
                self.backbone_3d = VoxelBackBone8x(
                    model_cfg['BACKBONE_3D'], num_point_features, grid_size,
                    dtype=dtype, residual=name == 'VoxelResBackBone8x',
                    generator=generator)

        name = model_cfg['MAP_TO_BEV']['NAME']
        if name == 'PointPillarScatter':
            self.map_to_bev = PointPillarScatter(grid_size, bev_channels)
        elif name == 'HeightCompression':
            self.map_to_bev = HeightCompression(bev_channels)
        else:
            raise not_ported(name)

        self.backbone_2d = BaseBEVBackbone(
            model_cfg['BACKBONE_2D'], bev_channels, dtype=dtype,
            generator=generator)
        head_cfg = model_cfg['DENSE_HEAD']
        self.dense_head = AnchorHeadSingle(
            head_cfg, self.backbone_2d.num_bev_features,
            num_class=1 if head_cfg.get('CLASS_AGNOSTIC', False) else num_class,
            grid_size=grid_size, point_cloud_range=pc_range, dtype=dtype,
            predict_boxes_when_training=bool(model_cfg.get('ROI_HEAD')),
            generator=generator)

        self.pfe = self.point_head = self.roi_head = None
        if model_cfg.get('PFE'):
            if self.backbone_3d is None:
                raise NotImplementedError('VoxelSetAbstraction reads the '
                                          'sparse stages of a 3D backbone')
            self.pfe = VoxelSetAbstraction(
                model_cfg['PFE'], voxel_size, pc_range, bev_channels,
                num_point_features, self.backbone_3d.backbone_channels,
                knobs=op_knobs, dtype=dtype, generator=generator)
        if self.pfe is not None:
            point_channels = self.pfe.num_point_features
        if model_cfg.get('POINT_HEAD'):
            cfg = model_cfg['POINT_HEAD']
            nc = 1 if cfg.get('CLASS_AGNOSTIC', False) else num_class
            if cfg['NAME'] == 'PointIntraPartOffsetHead':
                self.point_head = PointIntraPartOffsetHead(
                    cfg, nc, point_channels, dtype=dtype, generator=generator)
            else:
                self.point_head = PointHeadSimple(
                    cfg, nc, self.pfe.num_point_features_before_fusion
                    if cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False)
                    else point_channels, dtype=dtype, generator=generator)
        if model_cfg.get('ROI_HEAD'):
            cfg = model_cfg['ROI_HEAD']
            head = PartA2FCHead if cfg['NAME'] == 'PartA2FCHead' \
                else PVRCNNHead
            self.roi_head = head(
                cfg, point_channels,
                1 if cfg.get('CLASS_AGNOSTIC', True) else num_class,
                dtype=dtype, generator=generator)

    def forward(self, batch, draw=None):
        """`draw(name, shape)` gives float32 uniforms in [0, 1): the RoI
        head's sampling and dropout take theirs from it in training
        (``parallel/train_step.py::step_draw``)."""
        if 'points' in batch and 'point_valid' not in batch:
            n = batch['points'].shape[1]
            batch = {**batch, 'point_valid': torch.arange(
                n, device=batch['points'].device) < batch['num_points'][:, None]}
        for module in (self.vfe, self.backbone_3d, self.map_to_bev,
                       self.backbone_2d, self.dense_head, self.pfe,
                       self.point_head):
            if module is not None:
                batch = module(batch)
        return batch if self.roi_head is None else self.roi_head(batch, draw)

    def loss(self, batch_out):
        """Total training loss and its terms from a train-mode forward."""
        total, tb = self.dense_head.loss(batch_out['anchor_head_fwd'])
        for head, key in ((self.point_head, 'point_head_fwd'),
                          (self.roi_head, 'roi_head_fwd')):
            if head is not None:
                loss, terms = head.loss(batch_out[key])
                total = total + loss
                tb.update(terms)
        return total, {**tb, 'loss': total}
