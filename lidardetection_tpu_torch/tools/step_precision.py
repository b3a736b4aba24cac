"""A training step's gradient held against a float64 step of the same
batch and weights (``chip_smoke.py::whole_step_phase`` reads the CBGS
SECOND step with it; ``tests/test_torch_cbgs_float64.py`` holds its
finding on the CPU).

* ``float64_step_gradient``: the plain step in float64 from end to end.
  The model's weights, its batch, its sparse convolutions
  (``conv_float64``), its BatchNorm statistics (``float64_statistics``),
  its heads' outputs and its losses all in float64: ``KeepFloat64`` turns
  every cast to float32 and every float32 tensor made on the way into
  float64, without a change to the model's code, and ``Float32Audit``
  counts the operations that still round a float64 value to float32
  (none, on the CBGS step).
* ``float64_rule``: per gradient leaf, a step's largest distance from the
  float64 step within 3x a plain float32 step's own, plus 4 float32 ulps
  of the leaf's largest entry.
* ``summed_in_order(reorder)``: the plain sparse convolution with each
  output's terms summed in another order (``REORDERINGS``: the
  rulebook's offsets and the weights' rows permuted alike), the same
  function under other rounding.
* ``float64_batch_statistics()``: only the BatchNorm batch statistics in
  float64 (their sums, mean and variance), everything else as it was.
  Both packages compute a float32 variance as ``s2 / cnt - mean^2``,
  which cancels where a channel's mean is large against its spread; with
  float64 statistics the f32 CBGS step lies as far from the float64 step
  as without them, so that cancellation is not what moves it.
* ``ReluBranch``: a step's ReLU sign pattern, recorded or imposed. On the
  float64 step's pattern an f32 step differs from it by rounding alone;
  left free, a few ReLU entries within rounding of 0 take the other side
  and the leaves behind them jump, under any change of summation order.
* ``layer_readings`` and ``first_parting_layer``: the layer walk, each
  layer's output and the gradient reaching it against the float64
  step's.
"""

import contextlib
import copy

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

# the plain sparse convolution's sums in other orders: reversed, each
# output's 27 terms summed last to first; rolled by 9 and 18, the sum
# starting a third and two thirds of the way round
REORDERINGS = (
    ('offsets reversed', lambda rb, w: (rb.flip(-1), w.flip(0))),
    ('offsets rolled by 9', lambda rb, w: (rb.roll(9, -1), w.roll(9, 0))),
    ('offsets rolled by 18', lambda rb, w: (rb.roll(18, -1), w.roll(18, 0))),
)


@contextlib.contextmanager
def summed_in_order(reorder=None):
    """While open, every sparse convolution of a model runs its plain
    version under autograd (``rulebook_conv_plain``), with its rulebook
    and weights permuted by ``reorder(rb, w)`` (None: as they are)."""
    from ..ops import sparse
    from ..ops.sparse_conv_cuda import rulebook_conv_plain

    def conv(f, valid, rb, w, **kwargs):
        if reorder is not None:
            rb, w = reorder(rb, w)
        return rulebook_conv_plain(f, rb, w, valid)

    kept = sparse.sparse_conv_apply
    sparse.sparse_conv_apply = conv
    try:
        yield
    finally:
        sparse.sparse_conv_apply = kept


def float64_statistics(self, x, mask):
    """MaskedBatchNorm's batch statistics of x in float64 (the layer sums
    them in float32), the running statistics moved as the layer moves
    them."""
    from ..parallel.dist import batch_moments

    axis = self.axis % x.dim()
    dims = [d for d in range(x.dim()) if d != axis]
    xd = x.double()
    if mask is None:
        cnt = float(x.numel() // x.shape[axis])
        s1, s2 = xd.sum(dims), (xd * xd).sum(dims)
    else:
        m = mask.double().unsqueeze(axis)
        cnt = m.sum()
        s1, s2 = (xd * m).sum(dims), (xd * xd * m).sum(dims)
    mean, var = batch_moments(cnt, s1, s2)
    with torch.no_grad():
        self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
        self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
    return mean, var


@contextlib.contextmanager
def float64_batch_statistics():
    """While open, every MaskedBatchNorm takes its batch statistics in
    float64 (``float64_statistics``); the affine is applied in the
    activation's dtype as before."""
    from ..models.layers import MaskedBatchNorm

    kept = MaskedBatchNorm._batch_statistics
    MaskedBatchNorm._batch_statistics = float64_statistics
    try:
        yield
    finally:
        MaskedBatchNorm._batch_statistics = kept


def conv_float64(features, valid_mask, rulebook, weights, **kwargs):
    """The sparse convolution's plain version in float64."""
    b, v_in, c_in = features.shape
    k, _, c_out = weights.shape
    rb = rulebook.long()
    rb = torch.where((rb < 0) | (rb >= v_in), v_in, rb)
    f_ext = torch.cat([features.double(), features.new_zeros(
        (b, 1, c_in), dtype=torch.float64)], dim=1)
    rows = torch.gather(f_ext, 1, rb.flatten(1)[..., None].expand(
        b, rb.shape[1] * k, c_in))
    out = rows.view(b, rb.shape[1], k * c_in) \
        @ weights.double().reshape(k * c_in, c_out)
    return out * valid_mask[..., None]


class KeepFloat64(TorchFunctionMode):
    """While active, ``.float()``, ``.to(torch.float32)`` and
    ``.type(torch.float32)`` give float64, and a tensor asked for with
    ``dtype=torch.float32`` is made in float64: the model's casts of its
    heads' outputs and loss terms keep float64 without a change to its
    code. ``suspended()`` lets float32 be float32 again for a while."""

    def __init__(self):
        super().__init__()
        self.on = True

    @contextlib.contextmanager
    def suspended(self):
        default = torch.get_default_dtype()
        self.on = False
        torch.set_default_dtype(torch.float32)
        try:
            yield
        finally:
            self.on = True
            torch.set_default_dtype(default)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if not self.on:
            return func(*args, **kwargs)
        if func is torch.Tensor.float:
            func = torch.Tensor.double
        elif func in (torch.Tensor.to, torch.Tensor.type):
            args = tuple(torch.float64 if a is torch.float32 else a
                         for a in args)
        if kwargs.get('dtype') is torch.float32:
            kwargs['dtype'] = torch.float64
        return func(*args, **kwargs)


class Float32Audit(TorchDispatchMode):
    """Counts, by operation, the calls that take a float64 tensor and give
    a float32 one: the places where a float64 step would still round to
    float32; none while `keep` (a ``KeepFloat64``) is suspended."""

    def __init__(self, keep=None):
        super().__init__()
        self.keep, self.rounded = keep, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.keep is not None and not self.keep.on:
            return out
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if any(a.dtype == torch.float64 for a in ins) and \
                any(o.dtype == torch.float32 for o in outs):
            name = str(func.overloadpacket)
            self.rounded[name] = self.rounded.get(name, 0) + 1
        return out


@contextlib.contextmanager
def float32_targets(keep):
    """While open, the anchor target assignment takes its floating
    inputs (anchors, thresholds, gt boxes) in float32 and runs with `keep`
    (a ``KeepFloat64``) suspended, as the float32 step assigns them: the
    targets are the data's, the same labels and regression targets in
    both steps (in float64 an IoU on a threshold can flip an anchor's
    label), and no gradient flows through them."""
    from ..models.dense_heads import target_assigner

    kept = target_assigner.assign_targets

    def cast(t):
        return t.float() if torch.is_tensor(t) \
            and t.dtype == torch.float64 else t

    def assign(*args, **kwargs):
        with keep.suspended():
            return kept(*(cast(a) for a in args),
                        **{k: cast(v) for k, v in kwargs.items()})

    target_assigner.assign_targets = assign
    try:
        yield
    finally:
        target_assigner.assign_targets = kept


def step_gradient(model, batch, draw):
    """One forward and backward of `model` on `batch`: the loss,
    {name: gradient} and the anchors' class labels (None for a model
    without anchor targets)."""
    for p in model.parameters():
        p.grad = None
    out = model(batch, draw)
    _, tb = model.loss(out)
    tb['loss'].backward()
    labels = out.get('anchor_head_fwd', {}).get('box_cls_labels')
    return float(tb['loss'].detach()), {
        k: p.grad.detach().clone() for k, p in model.named_parameters()}, \
        labels


def float64_step_gradient(cfg, state, batch, seed, device, context=None,
                          watch=None):
    """The plain step in float64 from end to end on `batch`: a Trainer of
    `cfg` with the weights of `state` in float64, the batch's floats in
    float64, its sparse convolutions ``conv_float64``, its BatchNorm
    statistics ``float64_statistics``, under ``KeepFloat64`` with float64
    the default dtype (the heads' outputs, the targets' weights and the
    losses in float64 too), inside `context` (a context manager, e.g. one
    that takes the plain versions of the other kernels), with `watch(model)`
    (a context manager, e.g. ``layer_readings``) open around the step when
    given. The anchor
    targets alone are assigned in float32 (``float32_targets``). Returns
    the loss, {name: gradient}, the audit's {operation: calls} that
    rounded a float64 value to float32 outside the target assignment, and
    the anchors' class labels."""
    from ..ops import sparse
    from ..parallel.train_step import step_draw
    from ..train import Trainer

    cfg = copy.deepcopy(cfg)
    cfg.MODEL.COMPUTE_DTYPE = 'float64'
    twin = Trainer(cfg, device=device, state_dict=state, total_steps=4,
                   seed=seed)
    twin.model.double()
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    keep = KeepFloat64()
    audit = Float32Audit(keep)
    default = torch.get_default_dtype()
    kept = sparse.sparse_conv_apply
    with context or contextlib.nullcontext(), float64_batch_statistics(), \
            float32_targets(keep):
        sparse.sparse_conv_apply = conv_float64
        torch.set_default_dtype(torch.float64)
        try:
            with keep, audit, (watch or (lambda m: contextlib.nullcontext()))(
                    twin.model):
                loss, grads, labels = step_gradient(
                    twin.model, b64, step_draw(seed, 0, device))
        finally:
            torch.set_default_dtype(default)
            sparse.sparse_conv_apply = kept
    return loss, grads, audit.rounded, labels


def float64_rule(kernels, plain, exact):
    """Per leaf: the step `kernels`' largest distance from the float64 step
    `exact` against 3 x the plain float32 step's own, plus 4 float32 ulps
    of the leaf's largest float64 entry. Returns {leaf: (kernels'
    distance, allowed, plain's distance, largest entry)}."""
    out = {}
    for k, want in exact.items():
        top = float(want.abs().max())
        d_k = float((kernels[k].double() - want).abs().max())
        d_p = float((plain[k].double() - want).abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 23) if top > 0 else 0.0
        out[k] = (d_k, 3 * d_p + 4 * ulp, d_p, top)
    return out


def broken_leaves(rule):
    """The leaves of a ``float64_rule`` reading whose distance exceeds
    what it allows."""
    return {k: r for k, r in rule.items() if r[0] > r[1]}


class ReluBranch(TorchFunctionMode):
    """The ReLUs' branch of a step. Given no `masks` it records, in call
    order, which entries of each ReLU's input are positive; given the
    masks of another step it imposes them (``where(mask, x, 0)``, whose
    gradient is the mask, as ReLU's is) and counts in ``flips`` the
    entries whose own sign disagrees: a float32 step then follows the
    float64 step's branch through every kink, and differs from it by
    rounding alone. Recording, it also keeps in ``nearest`` each call's
    nonzero input entry nearest 0: (flat index, |x| / max|x|)."""

    RELUS = (torch.relu, torch.nn.functional.relu, torch.Tensor.relu)

    def __init__(self, masks=None):
        super().__init__()
        self.record = masks is None
        self.masks = [] if masks is None else masks
        self.nearest = []
        self.calls, self.flips = 0, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.RELUS:
            return func(*args, **kwargs)
        x = args[0]
        if self.record:
            self.masks.append((x > 0).detach())
            a = x.detach().abs().flatten()
            a = torch.where(a > 0, a, torch.full_like(a, float('inf')))
            j = int(a.argmin())
            self.nearest.append((j, float(a[j]) / max(
                float(x.detach().abs().max()), 1e-300)))
            return func(*args, **kwargs)
        mask = self.masks[self.calls]
        self.calls += 1
        if mask.shape != x.shape:
            raise ValueError(f'ReLU {self.calls}: a mask of {tuple(mask.shape)}'
                             f' for an input of {tuple(x.shape)}')
        self.flips += int(((x > 0) != mask).sum())
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def share(got, want):
    """The largest |got - want| as a share of the largest |want|."""
    return float((got.double() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def nearest_flipped(masks, nearest):
    """`masks` with each ReLU's input entry nearest 0 (``ReluBranch.
    nearest``) put on the other side: the branch that a float32 step takes
    where its rounding moves the entries most exposed to it across 0."""
    out = []
    for mask, (j, _) in zip(masks, nearest):
        mask = mask.contiguous().clone()  # j counts in C order
        mask.view(-1)[j] = ~mask.view(-1)[j]
        out.append(mask)
    return out


@contextlib.contextmanager
def layer_readings(model, names, against=None):
    """While open, the modules of `model` named in `names` record their
    forward output and the gradient that reaches that output in backward.
    Without `against` it yields {name: [output, gradient]} (float64
    copies); given such a dict of another step, it keeps only {name:
    [output's share, gradient's share]}, each the largest distance from
    the other step's as a share of that one's largest entry."""
    seen, handles = {}, []

    def keep(name, i, x):
        if against is None:
            seen[name][i] = x.detach().double()
        elif against[name][i] is not None:
            seen[name][i] = share(x.detach(), against[name][i])

    def hook(name):
        def record(module, args, out):
            seen[name] = [None, None]
            keep(name, 0, out)
            if out.requires_grad:
                out.register_hook(lambda g: keep(name, 1, g))
        return record

    modules = dict(model.named_modules())
    for name in names:
        handles.append(modules[name].register_forward_hook(hook(name)))
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def first_parting_layer(kernels, plain, names):
    """The layer walk over two steps' ``layer_readings`` shares against the
    float64 step's: outputs in forward order (`names`), gradients in
    backward order. Returns {'output' / 'gradient': (name, kernels' share,
    plain's share) of the first layer whose kernels' share exceeds 3 x
    the plain step's, or None}."""
    first = {}
    for part, order in (('output', names), ('gradient', names[::-1])):
        i = 0 if part == 'output' else 1
        first[part] = next(
            ((n, kernels[n][i], plain[n][i]) for n in order
             if kernels[n][i] is not None
             and kernels[n][i] > 3 * plain[n][i]), None)
    return first
