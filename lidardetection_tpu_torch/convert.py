"""flax variables of the JAX PointPillar or SECOND -> this package's
``state_dict``.

Input: the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of the JAX package's variables); no JAX is
needed here. Names map one to one except:

  * ``ConvBNReLU_<n>`` (creation order in BaseBEVBackbone) -> ``units.<n>``,
    its ``MaskedBatchNorm_0`` -> ``bn``;
  * ``SparseConvLayer_<n>`` -> ``convs.<n>`` and ``SparseBasicBlock_<n>`` ->
    ``blocks.<n>`` (creation order in VoxelBackBone8x and inside a block);
    a sparse layer's ``kernel`` (K, C_in, C_out) keeps its name and layout;
  * ``Conv_0/kernel`` HWIO -> ``weight`` OIHW;
  * ``ConvTranspose_0/kernel`` HWIO -> flipped in both spatial axes, then
    ``weight`` (I, O, H, W): flax's transposed convolution does not flip
    its kernel and PyTorch's does.

The VFE's ``pfn_*`` and the head's ``conv_{cls,box,dir}_{kernel,bias}``
keep their names and layouts.
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
           'SparseBasicBlock': 'blocks'}


def _convert(path, value):
    parts = []
    for key in path[:-1]:
        scope, _, index = key.rpartition('_')
        if scope in _SCOPES:
            parts += [_SCOPES[scope], index]
        elif key == 'MaskedBatchNorm_0':
            parts.append('bn')
        elif key not in ('Conv_0', 'ConvTranspose_0'):
            parts.append(key)
    scope, leaf = (path[-2] if len(path) > 1 else ''), path[-1]
    if scope == 'Conv_0' and leaf == 'kernel':
        return '.'.join(parts + ['weight']), value.transpose(3, 2, 0, 1)
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
