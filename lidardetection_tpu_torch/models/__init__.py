"""Network construction (lidardetection_tpu/models/__init__.py::build_network)."""

import torch

from ..ops.pointnet2 import PointOpKnobs
from .detectors.detector3d import Detector3D

__all__ = ['Detector3D', 'build_network']


def build_network(model_cfg, num_class, dataset_info, seed=0,
                  class_names=None):
    """The detector in eval mode, parameters drawn from ``seed``. The point
    ops' knobs come from MODEL.{FPS_SECTORS, BALL_QUERY_GRID_CELL_CAP,
    BALL_QUERY_APPROX_RECALL} and the point-cloud range, as in the JAX
    package, and engage on the card only (ops/pointnet2.py). `class_names`
    (the config's CLASS_NAMES) names the multi-head's head groups."""
    name = model_cfg['NAME']
    if name not in ('PointPillar', 'SECONDNet', 'PVRCNN', 'PartA2Net',
                    'PointRCNN'):
        raise KeyError(f'unknown detector {name}')
    knobs = PointOpKnobs.from_config(model_cfg,
                                     dataset_info.get('point_cloud_range'))
    generator = torch.Generator().manual_seed(seed)
    return Detector3D(model_cfg, num_class, dataset_info, op_knobs=knobs,
                      generator=generator, class_names=class_names).eval()
