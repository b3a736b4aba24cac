"""Host-side sparse-conv rulebook plans (a copy of
lidardetection_tpu/ops/sparse_plan.py).

A *plan* is the static rulebook topology of a sparse 3D backbone: the
ordered list of submanifold / strided / inverse conv geometries the model
will execute. Given a plan and a scan's voxel coordinates, the host builds
every rulebook (and each downsample stage's output voxel table) per scan,
so the device path is gather-GEMMs (kernel K3) with no sort (the
reference builds the same tables on the GPU inside spconv with
`indice_key` caching, pcdet/models/backbones_3d/spconv_backbone.py:84-106).

Semantics match the ops/sparse.py builders bit for bit: fixed-capacity
tables sorted by linear key, rulebook miss = input-table capacity,
monotone columns. A training plan also carries each strided layer's
transposed rulebook, ``rb_<name>_bwd``, so that layer's input gradient
runs through K3 as well.

`build_host_rulebooks` runs the host library's ``build_rulebooks``
(``native/rulebooks.cpp``); the numpy code at the end of this file is its
plain version, taken only when asked for (``native.plain_host()`` or
``LIDARDET_TORCH_PLAIN_HOST=1``).

Batch keys: each op contributes ``rb_<name>`` (cap_out, K) int32; each
down op additionally ``rb_<name>_coords`` (cap_out, 3) int32 and
``rb_<name>_num`` () int32.
"""

from typing import NamedTuple

import numpy as np

from .. import native
from ..config import dataset_info, voxel_processor_cfg


class PlanOp(NamedTuple):
    name: str
    type: str  # 'subm' | 'down' | 'inv' | 'rewind'
    kernel: tuple = (1, 1, 1)
    stride: tuple = (1, 1, 1)
    padding: tuple = (0, 0, 0)
    out_cap: int = 0  # down only
    match: int = -1   # inv: paired down op; rewind: down op whose OUTPUT
    #                   table becomes the current stage (emits nothing)


class SparsePlan(NamedTuple):
    ops: tuple  # of PlanOp
    spatial_shape: tuple  # (D, H, W) of the input table
    cap_in: int

    def batch_keys(self):
        keys = []
        for op in self.ops:
            if op.type == 'rewind':
                continue
            keys.append(f'rb_{op.name}')
            if op.type == 'down':
                keys += [f'rb_{op.name}_coords', f'rb_{op.name}_num']
        return keys

    def bucket_spec(self):
        """Metadata for lossless occupancy bucketing of every voxel table.

        Tables are sorted with padding at the tail, so each stage's arrays
        can be truncated to the batch-max occupancy; rulebook VALUES index
        the stage a conv reads from and clamp to its new capacity (miss
        stays exactly == capacity).

        Returns (stages, rows, values):
            stages: [(num_key, capacity)] per table stage (0 = input);
            rows:   [(batch_key, stage)] arrays whose leading voxel axis
                    is that stage's table (slice);
            values: [(batch_key, stage)] rulebooks whose entries index
                    that stage's table (clamp).
        """
        stages = [('num_voxels', self.cap_in)]
        rows, values = [], []
        op_in, op_out = [], []
        cur = 0
        for op in self.ops:
            op_in.append(cur)
            if op.type == 'subm':
                rows.append((f'rb_{op.name}', cur))
                values.append((f'rb_{op.name}', cur))
            elif op.type == 'down':
                out_stage = len(stages)
                stages.append((f'rb_{op.name}_num', op.out_cap))
                rows.append((f'rb_{op.name}', out_stage))
                rows.append((f'rb_{op.name}_coords', out_stage))
                values.append((f'rb_{op.name}', cur))
                cur = out_stage
            elif op.type == 'inv':
                up = op_in[op.match]
                rows.append((f'rb_{op.name}', up))
                values.append((f'rb_{op.name}', cur))
                cur = up
            else:  # rewind
                cur = op_out[op.match]
            op_out.append(cur)
        return stages, rows, values


_TYPE_CODE = {'subm': 0, 'down': 1, 'inv': 2, 'rewind': 3}


def _with_bwd_rulebooks(ops):
    """Insert, after each down op, an 'inv' op emitting its transposed
    rulebook (batch key rb_<name>_bwd over the down op's INPUT table) and
    a rewind back to the down output: the gradient of a strided conv is
    an inverse conv over the same geometry, so the training backward runs
    the forward kernel (K3) instead of a scatter-add."""
    new_ops = []
    old2new = {}
    inserted = set()
    for i, op in enumerate(ops):
        old2new[i] = len(new_ops)
        new_ops.append(op)
        if op.type == 'down':
            di = len(new_ops) - 1
            inserted.add(len(new_ops))
            new_ops.append(PlanOp(op.name + '_bwd', 'inv', match=di))
            inserted.add(len(new_ops))
            new_ops.append(PlanOp(op.name + '_rw', 'rewind', match=di))
    out = []
    for j, op in enumerate(new_ops):
        if j not in inserted and op.type in ('inv', 'rewind'):
            op = op._replace(match=old2new[op.match])
        out.append(op)
    return out


def backbone_plan(model_cfg, grid_size, cap_in, training=False):
    """Plan for a MODEL cfg's BACKBONE_3D, or None if it has none / is dense.

    grid_size: (nx, ny, nz); cap_in: the voxel table capacity (the
    transform_points_to_voxels MAX_NUMBER_OF_VOXELS for this split).
    training=True additionally emits each down op's transposed rulebook
    (rb_<name>_bwd), so the strided layers' input gradient runs on K3.
    """
    bb = model_cfg.get('BACKBONE_3D', None)
    if bb is None:
        return None
    name = bb.get('NAME', '')
    nx, ny, nz = grid_size
    spatial_shape = (nz + 1, ny, nx)

    def stage_cap(idx):
        caps = bb.get('OUT_CAPACITIES', None)
        return int(caps[idx]) if caps is not None else cap_in

    if name in ('VoxelBackBone8x', 'VoxelResBackBone8x', 'UNetV2'):
        ops = [
            PlanOp('subm1', 'subm', (3, 3, 3)),
            PlanOp('down2', 'down', (3, 3, 3), (2, 2, 2), (1, 1, 1),
                   stage_cap(0)),
            PlanOp('subm2', 'subm', (3, 3, 3)),
            PlanOp('down3', 'down', (3, 3, 3), (2, 2, 2), (1, 1, 1),
                   stage_cap(1)),
            PlanOp('subm3', 'subm', (3, 3, 3)),
            PlanOp('down4', 'down', (3, 3, 3), (2, 2, 2), (0, 1, 1),
                   stage_cap(2)),
            PlanOp('subm4', 'subm', (3, 3, 3)),
        ]
        if name == 'UNetV2':
            ops += [
                PlanOp('inv4', 'inv', (3, 3, 3), match=5),
                PlanOp('inv3', 'inv', (3, 3, 3), match=3),
                PlanOp('inv2', 'inv', (3, 3, 3), match=1),
            ]
            if bb.get('RETURN_ENCODED_TENSOR', True):
                lp = int(bb.get('last_pad', 0))
                ops.append(PlanOp('rw4', 'rewind', match=5))
                ops.append(PlanOp('out', 'down', (3, 1, 1), (2, 1, 1),
                                  (lp, lp, lp), stage_cap(3)))
        else:
            ops.append(PlanOp('out', 'down', (3, 1, 1), (2, 1, 1), (0, 0, 0),
                              stage_cap(3)))
        if training:
            ops = _with_bwd_rulebooks(ops)
        return SparsePlan(tuple(ops), spatial_shape, int(cap_in))
    return None


def config_plan(cfg, training):
    """The host plan of a config's split, as the JAX package's
    ``DatasetTemplate.set_sparse_plan`` derives it (datasets/dataset.py:
    57-68): the backbone's plan over the voxel table at the split's cap,
    with the transposed rulebooks in training; None for a model without a
    sparse 3D backbone or without a voxelizer."""
    data_cfg = cfg['DATA_CONFIG']
    vox = voxel_processor_cfg(data_cfg)
    if vox is None:
        return None
    cap = vox['MAX_NUMBER_OF_VOXELS']['train' if training else 'test']
    return backbone_plan(cfg['MODEL'], dataset_info(data_cfg)['grid_size'],
                         int(cap), training=training)


def _plan_records(plan):
    rec = np.zeros((len(plan.ops), 16), np.int32)
    for i, op in enumerate(plan.ops):
        rec[i, 0] = _TYPE_CODE[op.type]
        rec[i, 1:4] = op.kernel
        rec[i, 4:7] = op.stride
        rec[i, 7:10] = op.padding
        rec[i, 10] = op.out_cap
        rec[i, 11] = op.match
    return rec


def _op_shapes(plan):
    """[(rb_rows, K, is_down, out_cap)] per op + stage caps the builder walks.

    Mirrors the table-chaining of native/rulebooks.cpp to size outputs.
    """
    caps = [plan.cap_in]  # stage capacities; index = stage
    op_in_stage = []
    op_out_stage = []
    cur = 0
    shapes = []
    for op in plan.ops:
        op_in_stage.append(cur)
        k = int(np.prod(op.kernel))
        if op.type == 'subm':
            shapes.append((caps[cur], k, False, 0))
        elif op.type == 'down':
            shapes.append((op.out_cap, k, True, op.out_cap))
            caps.append(op.out_cap)
            cur = len(caps) - 1
        elif op.type == 'inv':
            m_op = plan.ops[op.match]
            km = int(np.prod(m_op.kernel))
            up_stage = op_in_stage[op.match]
            shapes.append((caps[up_stage], km, False, 0))
            cur = up_stage
        else:  # rewind: no output; jump to match op's output stage
            shapes.append((0, 0, False, 0))
            cur = op_out_stage[op.match]
        op_out_stage.append(cur)
    return shapes


def build_host_rulebooks(plan: SparsePlan, coords, n_vox):
    """All rulebooks/tables for one scan -> {batch_key: np.ndarray}.

    coords: (cap_in, 3) int32 zyx sorted by linear key, -1 pad. Runs the
    host library unless the plain version is asked for.
    """
    shapes = _op_shapes(plan)
    total_rb = sum(r * k for r, k, _, _ in shapes)
    n_down = sum(1 for _, _, d, _ in shapes if d)
    if native.plain_requested():
        rb_buf, oc_buf, on_buf = _build_rulebooks_np(plan, coords, int(n_vox))
    else:
        rb_buf, oc_buf, on_buf = native.build_rulebooks(
            coords, int(n_vox), plan.cap_in, plan.spatial_shape,
            _plan_records(plan), total_rb,
            3 * sum(c for _, _, d, c in shapes if d), n_down)

    out = {}
    rb_off = oc_off = on_off = 0
    for op, (rows, k, is_down, ocap) in zip(plan.ops, shapes):
        if op.type == 'rewind':
            continue
        out[f'rb_{op.name}'] = rb_buf[rb_off:rb_off + rows * k].reshape(rows, k)
        rb_off += rows * k
        if is_down:
            out[f'rb_{op.name}_coords'] = (
                oc_buf[oc_off:oc_off + ocap * 3].reshape(ocap, 3))
            oc_off += ocap * 3
            out[f'rb_{op.name}_num'] = on_buf[on_off]
            on_off += 1
    return out


# ---------------------------------------------------------------------------
# numpy plain version of the host library's build_rulebooks
# ---------------------------------------------------------------------------


def _keys_of(coords, shape):
    d, h, w = shape
    key = (coords[:, 0].astype(np.int64) * h + coords[:, 1]) * w + coords[:, 2]
    return np.where(coords[:, 0] < 0, d * h * w, key)


def _lookup(sorted_keys, n, queries, sentinel):
    cap = sorted_keys.shape[0]
    pos = np.searchsorted(sorted_keys[:max(n, 1)], queries)
    pos = np.clip(pos, 0, max(n, 1) - 1)
    hit = (sorted_keys[pos] == queries) & (queries < sentinel)
    return np.where(hit, pos, cap).astype(np.int32)


def _np_subm(coords, n, shape, kernel):
    d, h, w = shape
    off = np.stack(np.meshgrid(*[np.arange(k) for k in kernel],
                               indexing='ij'), -1).reshape(-1, 3)
    rel = off - (np.asarray(kernel) - 1) // 2
    keys = _keys_of(coords, shape)
    nbr = coords[:, None, :] + rel[None]
    ok = np.all((nbr >= 0) & (nbr < np.asarray([d, h, w])), -1)
    ok &= coords[:, :1] >= 0
    q = (nbr[..., 0].astype(np.int64) * h + nbr[..., 1]) * w + nbr[..., 2]
    sent = d * h * w
    q = np.where(ok, q, sent)
    return _lookup(keys, n, q.reshape(-1), sent).reshape(q.shape)


def _np_down(coords, n, shape, op):
    ks, s, p = np.asarray(op.kernel), np.asarray(op.stride), np.asarray(op.padding)
    oshape = tuple((np.asarray(shape) + 2 * p - (ks - 1) - 1) // s + 1)
    od, oh, ow = oshape
    cand = set()
    for v in range(n):
        c = coords[v]
        per_dim = []
        for dim in range(3):
            outs = []
            k0 = (c[dim] + p[dim]) % s[dim]
            for kk in range(k0, ks[dim], s[dim]):
                o = (c[dim] + p[dim] - kk) // s[dim]
                if 0 <= o < oshape[dim]:
                    outs.append(o)
            per_dim.append(outs)
        for a in per_dim[0]:
            for b in per_dim[1]:
                for e in per_dim[2]:
                    cand.add((int(a) * oh + int(b)) * ow + int(e))
    keys = np.sort(np.fromiter(cand, np.int64, len(cand)))[:op.out_cap]
    n_out = len(keys)
    oc = np.full((op.out_cap, 3), -1, np.int32)
    oc[:n_out, 0] = keys // (oh * ow)
    oc[:n_out, 1] = (keys // ow) % oh
    oc[:n_out, 2] = keys % ow

    off = np.stack(np.meshgrid(*[np.arange(k) for k in op.kernel],
                               indexing='ij'), -1).reshape(-1, 3)
    in_pos = oc[:, None, :] * s[None, None] - p + off[None]
    d, h, w = shape
    ok = np.all((in_pos >= 0) & (in_pos < np.asarray([d, h, w])), -1)
    ok &= oc[:, :1] >= 0
    q = ((in_pos[..., 0].astype(np.int64) * h + in_pos[..., 1]) * w
         + in_pos[..., 2])
    sent = d * h * w
    q = np.where(ok, q, sent)
    in_keys = _keys_of(coords, shape)
    rb = _lookup(in_keys, n, q.reshape(-1), sent).reshape(q.shape)
    return rb, oc, np.int32(n_out), oshape


def _np_inv(up_coords, up_n, down_coords, down_n, down_shape, m_op):
    off = np.stack(np.meshgrid(*[np.arange(k) for k in m_op.kernel],
                               indexing='ij'), -1).reshape(-1, 3)
    s, p = np.asarray(m_op.stride), np.asarray(m_op.padding)
    num = up_coords[:, None, :] + p - off[None]
    div_ok = np.all(num % s == 0, -1)
    o = num // s
    d, h, w = down_shape
    ok = div_ok & np.all((o >= 0) & (o < np.asarray([d, h, w])), -1)
    ok &= up_coords[:, :1] >= 0
    q = (o[..., 0].astype(np.int64) * h + o[..., 1]) * w + o[..., 2]
    sent = d * h * w
    q = np.where(ok, q, sent)
    keys = _keys_of(down_coords, down_shape)
    return _lookup(keys, down_n, q.reshape(-1), sent).reshape(q.shape)


def _build_rulebooks_np(plan, coords, n_vox):
    tables = [(np.asarray(coords, np.int32), int(n_vox), plan.spatial_shape)]
    op_in_stage = []
    op_out_stage = []
    cur = 0
    rbs, ocs, ons = [], [], []
    for op in plan.ops:
        op_in_stage.append(cur)
        c, n, shape = tables[cur]
        if op.type == 'subm':
            rbs.append(_np_subm(c, n, shape, op.kernel))
        elif op.type == 'down':
            rb, oc, on, oshape = _np_down(c, n, shape, op)
            rbs.append(rb)
            ocs.append(oc)
            ons.append(on)
            tables.append((oc, int(on), oshape))
            cur = len(tables) - 1
        elif op.type == 'inv':
            up = op_in_stage[op.match]
            uc, un, _ushape = tables[up]
            rbs.append(_np_inv(uc, un, c, n, shape, plan.ops[op.match]))
            cur = up
        else:  # rewind
            cur = op_out_stage[op.match]
        op_out_stage.append(cur)
    rb_buf = np.concatenate([r.reshape(-1) for r in rbs])
    oc_buf = (np.concatenate([o.reshape(-1) for o in ocs])
              if ocs else np.zeros(0, np.int32))
    on_buf = np.asarray(ons, np.int32)
    return rb_buf, oc_buf, on_buf
