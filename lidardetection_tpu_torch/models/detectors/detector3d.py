"""Detector assembly (lidardetection_tpu/models/detectors/detector3d.py), the
single-stage slots: vfe -> [backbone_3d] -> map_to_bev -> backbone_2d ->
dense_head (PointPillar without a 3D backbone, SECOND with one).

Every other slot or module, and training, raises NotImplementedError
naming the ROADMAP.md item that will port it.
"""

import torch
from torch import nn

from ..backbones_2d.bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev import HeightCompression, PointPillarScatter
from ..backbones_3d.spconv_backbone import VoxelBackBone8x
from ..backbones_3d.vfe import MeanVFE, PillarVFE
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..layers import TRAINING_NOT_PORTED

NOT_PORTED = {  # detector or module name -> ROADMAP.md queue 1 item
    'PVRCNN': 'PV-RCNN', 'PartA2Net': 'Part-A2', 'PointRCNN': 'PointRCNN',
    'VoxelSetAbstraction': 'PV-RCNN', 'PVRCNNHead': 'PV-RCNN',
    'PointHeadSimple': 'PV-RCNN',
    'UNetV2': 'Part-A2', 'PartA2FCHead': 'Part-A2',
    'PointIntraPartOffsetHead': 'Part-A2',
    'PointNet2MSG': 'PointRCNN', 'PointRCNNHead': 'PointRCNN',
    'PointHeadBox': 'PointRCNN',
    'AnchorHeadMulti': 'Variants', 'PointHeadSimpleMultiFrame': 'Variants',
}


def not_ported(name):
    item = NOT_PORTED.get(name, 'Variants')
    return NotImplementedError(
        f'{name} is not ported yet: see ROADMAP.md queue 1, "{item}"')


class Detector3D(nn.Module):
    """Single-stage detector assembled from the MODEL config.

    Args:
        model_cfg: MODEL section of the yaml config.
        num_class: number of foreground classes.
        dataset_info: dict with grid_size (nx, ny, nz), voxel_size,
            point_cloud_range, num_point_features (config.dataset_info).
        generator: torch.Generator for parameter initialization.
    """

    def __init__(self, model_cfg, num_class, dataset_info, generator=None):
        super().__init__()
        dtype_name = model_cfg.get('COMPUTE_DTYPE', 'float32')
        dtype = None if dtype_name in (None, 'float32') \
            else getattr(torch, dtype_name)
        grid_size = tuple(dataset_info['grid_size'])
        pc_range = tuple(dataset_info['point_cloud_range'])
        voxel_size = tuple(dataset_info['voxel_size'])

        for slot in ('PFE', 'POINT_HEAD', 'ROI_HEAD'):
            if model_cfg.get(slot):
                raise not_ported(model_cfg[slot]['NAME'])
        for slot, want in (('BACKBONE_2D', 'BaseBEVBackbone'),
                           ('DENSE_HEAD', 'AnchorHeadSingle')):
            if model_cfg[slot]['NAME'] != want:
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
        if model_cfg.get('BACKBONE_3D'):
            name = model_cfg['BACKBONE_3D']['NAME']
            if name not in ('VoxelBackBone8x', 'VoxelResBackBone8x'):
                raise not_ported(name)
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
            generator=generator)

    def forward(self, batch):
        if self.training:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        for module in (self.vfe, self.backbone_3d, self.map_to_bev,
                       self.backbone_2d, self.dense_head):
            if module is not None:
                batch = module(batch)
        return batch
