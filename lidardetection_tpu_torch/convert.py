"""flax variables of the JAX PointPillar, SECOND, PV-RCNN, Part-A² or
PointRCNN, or of a variant of them -> this package's ``state_dict``.

Input: the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of the JAX package's variables); no JAX is
needed here. Names map one to one except:

  * ``ConvBNReLU_<n>`` (creation order in BaseBEVBackbone) -> ``units.<n>``,
    its ``MaskedBatchNorm_0`` -> ``bn``;
  * ``SparseConvLayer_<n>`` -> ``convs.<n>`` and ``SparseBasicBlock_<n>`` ->
    ``blocks.<n>`` (creation order in VoxelBackBone8x or UNetV2 and inside
    a block);
    a sparse layer's ``kernel`` (K, C_in, C_out) keeps its name and layout;
    its ``MaskedBatchNorm_0`` -> ``bn``;
  * the point-based modules: ``PointnetSAModuleMSG_<n>`` -> ``sa_layers.<n>``,
    ``PointnetFPModule_<n>`` -> ``fp_layers.<n>`` (creation order: the
    deepest level first), ``ConvMLP_<n>`` -> ``conv_mlps.<n>``,
    ``SharedMLP_<n>`` -> ``mlps.<n>``, ``FCHead_<n>`` -> ``fc_heads.<n>``,
    ``pre_proj_<i>`` / ``xyz_proj_<i>`` / ``pre_bn_<i>`` -> ``pre_proj.<i>`` /
    ``xyz_proj.<i>`` / ``pre_bn.<i>``, ``RoIGridPool_0`` -> ``roi_grid_pool``,
    ``FCLayers_0`` -> ``fc_layers``, ``MaskedDenseSubMConv3d_<n>`` ->
    ``sub_convs.<n>``; inside them ``Dense_<n>`` -> ``dense.<n>`` (its
    ``kernel`` (in, out) keeps its layout) and ``MaskedBatchNorm_<n>`` ->
    ``bn.<n>`` (a module with one BatchNorm: ``bn``);
  * the multi-head dense head: ``rpn_heads_<i>`` -> ``rpn_heads.<i>``,
    inside a head ``Conv_<n>`` -> ``convs.<n>`` (with its bias) and
    ``BaseBEVBackbone_0`` -> ``backbone``; ``shared_conv`` keeps its name;
  * the PillarVFE stack: ``PFNLayer_<n>`` -> ``pfn_layers.<n>``, its
    ``Dense_0`` -> ``dense.0``;
  * ``Conv_<n>/kernel`` HWIO -> ``weight`` OIHW, and (X, Y, Z, I, O) ->
    ``weight`` (O, I, X, Y, Z) for a three-dimensional one;
  * ``ConvTranspose_0/kernel`` HWIO -> flipped in both spatial axes, then
    ``weight`` (I, O, H, W): flax's transposed convolution does not flip
    its kernel and PyTorch's does.

The VFE's ``pfn_*`` and the head's ``conv_{cls,box,dir}_{kernel,bias}``
keep their names and layouts. ``state_dict_to_flax`` is the inverse map,
which lays this package's parameters or gradients beside the flax trees.
"""

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, 'items'):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


_SCOPES = {'ConvBNReLU': 'units', 'SparseConvLayer': 'convs',
           'SparseBasicBlock': 'blocks', 'PointnetSAModuleMSG': 'sa_layers',
           'PointnetFPModule': 'fp_layers', 'ConvMLP': 'conv_mlps',
           'SharedMLP': 'mlps', 'FCHead': 'fc_heads', 'Dense': 'dense',
           'pre_proj': 'pre_proj', 'xyz_proj': 'xyz_proj', 'pre_bn': 'pre_bn',
           'MaskedDenseSubMConv3d': 'sub_convs', 'rpn_heads': 'rpn_heads',
           'PFNLayer': 'pfn_layers'}
_SINGLE = {'RoIGridPool_0': 'roi_grid_pool', 'FCLayers_0': 'fc_layers',
           'BaseBEVBackbone_0': 'backbone'}
# Dense + BatchNorm stacks: their BatchNorms are the list `bn`, elsewhere a
# module's one BatchNorm is `bn`
_STACKS = ('pfe', 'roi_head', 'SharedMLP_', 'FCLayers_', 'FCHead_',
           'ConvMLP_', 'cls_layers', 'part_reg_layers', 'box_layers')
# a flax convolution kernel (*spatial, I, O) -> PyTorch's (O, I, *spatial)
_TO_TORCH = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_FLAX = {4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _convert(path, value):
    parts = []
    for i, key in enumerate(path[:-1]):
        scope, _, index = key.rpartition('_')
        if key in _SINGLE:
            parts.append(_SINGLE[key])
        elif scope == 'MaskedBatchNorm':
            stack = i > 0 and path[i - 1].startswith(_STACKS)
            parts += ['bn', index] if stack else ['bn']
        elif scope in _SCOPES:
            parts += [_SCOPES[scope], index]
        elif scope == 'Conv' and i > 0 and path[i - 1].startswith('rpn_heads'):
            parts += ['convs', index]
        elif key not in ('Conv_0', 'ConvTranspose_0'):
            parts.append(key)
    scope, leaf = (path[-2] if len(path) > 1 else ''), path[-1]
    if scope.startswith('Conv_') and leaf == 'kernel':
        return '.'.join(parts + ['weight']), value.transpose(
            _TO_TORCH[value.ndim])
    if scope == 'ConvTranspose_0' and leaf == 'kernel':
        return ('.'.join(parts + ['weight']),
                value[::-1, ::-1].transpose(2, 3, 0, 1))
    return '.'.join(parts + [leaf]), value


def flax_to_state_dict(params, batch_stats):
    """Returns {name: float32 torch.Tensor} for ``load_state_dict``."""
    state = {}
    for tree in (params, batch_stats):
        for path, value in _flatten(tree):
            name, value = _convert(path, value)
            state[name] = torch.from_numpy(
                np.asarray(value, dtype=np.float32).copy())  # fresh C order
    return state


def state_dict_to_flax(state, *trees):
    """The inverse of `flax_to_state_dict`: for each flax tree given (for
    example ``params`` and ``batch_stats``) a tree of the same structure
    whose leaves are the tensors of `state` (parameters, statistics, or
    gradients by parameter name), layout transposes undone."""
    def build(tree, prefix=()):
        out = {}
        for key, value in tree.items():
            path = prefix + (key,)
            if isinstance(value, dict) or hasattr(value, 'items'):
                out[key] = build(value, path)
                continue
            name, _ = _convert(path, np.asarray(value))
            leaf = state[name].detach().cpu().numpy()
            scope = path[-2] if len(path) > 1 else ''
            if scope.startswith('Conv_') and key == 'kernel':
                leaf = leaf.transpose(_TO_FLAX[leaf.ndim])  # -> (*spatial, I, O)
            elif scope == 'ConvTranspose_0' and key == 'kernel':
                leaf = leaf.transpose(2, 3, 0, 1)[::-1, ::-1]
            out[key] = np.ascontiguousarray(leaf)
        return out

    return tuple(build(tree) for tree in trees)
