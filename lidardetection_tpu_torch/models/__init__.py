"""Network construction (lidardetection_tpu/models/__init__.py::build_network)."""

import torch

from .detectors.detector3d import NOT_PORTED, Detector3D, not_ported

__all__ = ['Detector3D', 'build_network']


def build_network(model_cfg, num_class, dataset_info, seed=0):
    """The detector in eval mode, parameters drawn from ``seed``."""
    name = model_cfg['NAME']
    if name in NOT_PORTED:
        raise not_ported(name)
    if name not in ('PointPillar', 'SECONDNet'):
        raise KeyError(f'unknown detector {name}')
    generator = torch.Generator().manual_seed(seed)
    return Detector3D(model_cfg, num_class, dataset_info,
                      generator=generator).eval()
