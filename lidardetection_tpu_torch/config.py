"""YAML configuration (copy of lidardetection_tpu/config.py:15-131).

An attribute-access dict built from YAML with single-level
``_BASE_CONFIG_`` inheritance, tagged with the YAML's stem (``TAG``) and
folder (``EXP_GROUP_PATH``), which name a run's output directory
``output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>``; ``log_config_to_file``
dumps a config to a logger; `dataset_info` derives from the DATA_CONFIG
the static grid facts that ``build_network`` needs (the JAX package
reads them off its dataset object).
"""

import ast
from pathlib import Path

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
    relative to the working directory, as in the JAX package. ``TAG`` is
    the file's stem and ``EXP_GROUP_PATH`` its folder's name
    (``kitti_models`` for tools/cfgs/kitti_models/second.yaml)."""
    if config is None:
        config = CfgNode()
    with open(cfg_file, 'r') as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    config.TAG = Path(cfg_file).stem
    parts = Path(cfg_file).resolve().parts
    config.EXP_GROUP_PATH = parts[-2] if len(parts) >= 2 else ''
    return config


def cfg_from_list(cfg_list, config):
    """Set keys from a ``['A.B.C', 'value', ...]`` list (the tools' ``--set``),
    each value read as a Python literal, else as YAML, and cast to the type
    of the value it replaces. A key the config lacks raises KeyError."""
    if len(cfg_list) % 2:
        raise ValueError(f'--set takes key / value pairs, got {cfg_list}')
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        *path, subkey = full_key.split('.')
        d = config
        for key in path:
            if key not in d:
                raise KeyError(f'NotFoundKey: {key} of {full_key}')
            d = d[key]
        if subkey not in d:
            raise KeyError(f'NotFoundKey: {subkey} of {full_key}')
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = yaml.safe_load(v)
        if isinstance(value, dict):
            d[subkey].update(CfgNode(value))
        else:
            if type(value) != type(d[subkey]) and d[subkey] is not None:
                if isinstance(d[subkey], (list, tuple)):
                    value = type(d[subkey])(yaml.safe_load(v))
                else:
                    value = type(d[subkey])(value)
            d[subkey] = value
    return config


def log_config_to_file(cfg, pre='cfg', logger=None):
    """Every key of `cfg` to `logger`, a line each (``<pre>.<path>:
    <value>``), a header line before each nested dict."""
    for key, val in cfg.items():
        if isinstance(val, dict):
            logger.info('----------- %s -----------', key)
            log_config_to_file(val, pre=f'{pre}.{key}', logger=logger)
            continue
        logger.info('%s.%s: %s', pre, key, val)


def voxel_processor_cfg(data_cfg):
    """The DATA_PROCESSOR entry that voxelizes (VOXEL_SIZE, capacities), or
    None for a point-based config (PointRCNN), which has none."""
    for p in data_cfg['DATA_PROCESSOR']:
        if p['NAME'] == 'transform_points_to_voxels':
            return p
    return None


def raw_point_capacity(cfg):
    """DATA_CONFIG.MAX_POINTS when the model reads the raw points (a PFE,
    PV-RCNN's VSA, or a point backbone, PointRCNN's PointNet2MSG:
    ``points`` and ``num_points`` padded to it, as the JAX package's data
    processor pads them), else None: Part-A²'s point head reads the UNet's
    voxel centres, not the raw points. 0 where the model reads them and
    the config sets no MAX_POINTS (Livox's and Mix's PV-RCNN): each batch
    is padded to its largest cloud (the JAX package, padding nothing
    there, cannot stack such clouds at B > 1)."""
    model = cfg['MODEL']
    reads_points = model.get('PFE') or (
        model.get('BACKBONE_3D') and model['BACKBONE_3D']['NAME'] == 'PointNet2MSG')
    if not reads_points:
        return None
    return int(cfg['DATA_CONFIG'].get('MAX_POINTS', 0))


def grid_size_from_range(point_cloud_range, voxel_size):
    """(nx, ny, nz) = round((hi - lo) / voxel_size), computed in float64."""
    pc_range = np.asarray(point_cloud_range, dtype=np.float64)
    vsz = np.asarray(voxel_size, dtype=np.float64)
    return np.round((pc_range[3:6] - pc_range[0:3]) / vsz).astype(np.int64)


def dataset_info(data_cfg):
    """Static facts that ``build_network`` needs, from a DATA_CONFIG.

    Same keys and values as the JAX package's ``DatasetTemplate.dataset_info``
    (float32-rounded range and voxel size, as its data processor holds them;
    grid_size and voxel_size None for a config with no voxelizer).
    """
    pc_range = np.asarray(data_cfg['POINT_CLOUD_RANGE'], np.float32)
    encoding = data_cfg['POINT_FEATURE_ENCODING']
    if encoding['encoding_type'] != 'absolute_coordinates_encoding':
        raise NotImplementedError(encoding['encoding_type'])
    vox = voxel_processor_cfg(data_cfg)
    grid_size = voxel_size = None
    if vox is not None:
        vsz = np.asarray(vox['VOXEL_SIZE'], np.float32)
        grid_size = tuple(int(g) for g in grid_size_from_range(pc_range, vsz))
        voxel_size = tuple(float(v) for v in vsz)
    return {
        'grid_size': grid_size,
        'voxel_size': voxel_size,
        'point_cloud_range': tuple(float(x) for x in pc_range),
        'num_point_features': len(encoding['used_feature_list']),
    }
