"""Detector assembly (lidardetection_tpu/models/detectors/detector3d.py), the
PointPillar slots only: vfe -> map_to_bev -> backbone_2d -> dense_head.

Every other slot, and training, raises NotImplementedError naming the
ROADMAP.md item that will port it.
"""

import torch
from torch import nn

from ..backbones_2d.bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev import PointPillarScatter
from ..backbones_3d.vfe import PillarVFE
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..layers import TRAINING_NOT_PORTED

NOT_PORTED = {  # detector or module name -> ROADMAP.md queue 1 item
    'SECONDNet': 'SECOND', 'PVRCNN': 'PV-RCNN', 'PartA2Net': 'Part-A2',
    'PointRCNN': 'PointRCNN',
    'VoxelBackBone8x': 'SECOND', 'VoxelResBackBone8x': 'SECOND',
    'MeanVFE': 'SECOND', 'HeightCompression': 'SECOND',
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

        for slot in ('BACKBONE_3D', 'PFE', 'POINT_HEAD', 'ROI_HEAD'):
            if model_cfg.get(slot):
                raise not_ported(model_cfg[slot]['NAME'])
        names = {slot: model_cfg[slot]['NAME'] for slot in
                 ('VFE', 'MAP_TO_BEV', 'BACKBONE_2D', 'DENSE_HEAD')}
        for slot, want in (('VFE', 'PillarVFE'),
                           ('MAP_TO_BEV', 'PointPillarScatter'),
                           ('BACKBONE_2D', 'BaseBEVBackbone'),
                           ('DENSE_HEAD', 'AnchorHeadSingle')):
            if names[slot] != want:
                raise not_ported(names[slot])

        self.vfe = PillarVFE(model_cfg['VFE'],
                             dataset_info['num_point_features'], voxel_size,
                             pc_range, dtype=dtype, generator=generator)
        self.map_to_bev = PointPillarScatter(
            grid_size, model_cfg['MAP_TO_BEV']['NUM_BEV_FEATURES'])
        self.backbone_2d = BaseBEVBackbone(
            model_cfg['BACKBONE_2D'],
            model_cfg['MAP_TO_BEV']['NUM_BEV_FEATURES'], dtype=dtype,
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
        for module in (self.vfe, self.map_to_bev, self.backbone_2d,
                       self.dense_head):
            batch = module(batch)
        return batch
