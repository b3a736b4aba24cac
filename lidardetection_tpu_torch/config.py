"""YAML configuration (copy of lidardetection_tpu/config.py:15-86).

An attribute-access dict built from YAML with single-level
``_BASE_CONFIG_`` inheritance, plus `dataset_info`, which derives from the
DATA_CONFIG the static grid facts that ``build_network`` needs (the JAX
package reads them off its dataset object).
"""

import numpy as np
import yaml


class CfgNode(dict):
    """Attribute-access dict; nested dicts are converted recursively."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, CfgNode):
            return value
        if isinstance(value, dict):
            return CfgNode(value)
        if isinstance(value, (list, tuple)):
            return type(value)(CfgNode._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, CfgNode._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        del self[key]


def merge_new_config(config, new_config):
    """Recursive merge with ``_BASE_CONFIG_`` expansion."""
    if '_BASE_CONFIG_' in new_config:
        with open(new_config['_BASE_CONFIG_'], 'r') as f:
            base = yaml.safe_load(f)
        config.update(CfgNode(base))

    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config[key], dict):
                config[key] = CfgNode()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config=None):
    """Load a YAML file into ``config``; ``_BASE_CONFIG_`` paths are
    relative to the working directory, as in the JAX package."""
    if config is None:
        config = CfgNode()
    with open(cfg_file, 'r') as f:
        new_config = yaml.safe_load(f)
    return merge_new_config(config=config, new_config=new_config)


def voxel_processor_cfg(data_cfg):
    """The DATA_PROCESSOR entry that voxelizes (VOXEL_SIZE, capacities)."""
    for p in data_cfg['DATA_PROCESSOR']:
        if p['NAME'] == 'transform_points_to_voxels':
            return p
    raise NotImplementedError(
        'configs without a voxelizer (point-based PointRCNN) are not ported '
        'yet: see ROADMAP.md queue 1, "PointRCNN"')


def grid_size_from_range(point_cloud_range, voxel_size):
    """(nx, ny, nz) = round((hi - lo) / voxel_size), computed in float64."""
    pc_range = np.asarray(point_cloud_range, dtype=np.float64)
    vsz = np.asarray(voxel_size, dtype=np.float64)
    return np.round((pc_range[3:6] - pc_range[0:3]) / vsz).astype(np.int64)


def dataset_info(data_cfg):
    """Static facts that ``build_network`` needs, from a DATA_CONFIG.

    Same keys and values as the JAX package's ``DatasetTemplate.dataset_info``
    (float32-rounded range and voxel size, as its data processor holds them).
    """
    pc_range = np.asarray(data_cfg['POINT_CLOUD_RANGE'], np.float32)
    voxel_size = np.asarray(voxel_processor_cfg(data_cfg)['VOXEL_SIZE'],
                            np.float32)
    encoding = data_cfg['POINT_FEATURE_ENCODING']
    if encoding['encoding_type'] != 'absolute_coordinates_encoding':
        raise NotImplementedError(encoding['encoding_type'])
    return {
        'grid_size': tuple(int(g) for g in
                           grid_size_from_range(pc_range, voxel_size)),
        'voxel_size': tuple(float(v) for v in voxel_size),
        'point_cloud_range': tuple(float(x) for x in pc_range),
        'num_point_features': len(encoding['used_feature_list']),
    }
