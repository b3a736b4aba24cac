"""Float32 held as float32, whatever the process's precision flags are.

PyTorch lets a process trade float32 accuracy for speed: cuDNN
convolutions run in TF32 by default (``torch.backends.cudnn.allow_tf32``),
and ``torch.set_float32_matmul_precision('high' | 'medium')`` sends float32
matrix products through TF32 on the card and bf16 passes in oneDNN on the
CPU. The JAX package computes its float32 configs in float32 (and pins
``Precision.HIGHEST`` where a product decides a radius test), so the port
turns all of that off where it computes in float32, inside ``full_f32``,
and puts back what it found on exit. No flag is set at import.

PyTorch has two generations of these flags: the legacy ones above and the
per-backend ``fp32_precision`` knobs (PyTorch 2.9 and later). Mixing them
leaves a state in which the legacy getters raise, so the scope sets the
generation the process reads: the legacy flags while they read, else the
per-backend knobs. On exit both generations get back the values found.
The flags are process-wide: a thread that computes outside the scope while
another is inside it sees float32 in full too.
"""

import contextlib

import torch

# the per-backend knobs that decide float32 products and convolutions
_KNOBS = ('cuda.matmul', 'cudnn.conv', 'mkldnn.matmul')


def _knobs():
    found = []
    for path in _KNOBS:
        obj = torch.backends
        for part in path.split('.'):
            obj = getattr(obj, part, None)
        if obj is not None and hasattr(obj, 'fp32_precision'):
            found.append(obj)
    return found


def _legacy_flags():
    """(float32 matmul precision, cuDNN TF32 flag), or None where the
    process set the per-backend knobs so that the legacy getters raise."""
    try:
        return (torch.get_float32_matmul_precision(),
                torch.backends.cudnn.allow_tf32)
    except RuntimeError:
        return None


@contextlib.contextmanager
def full_f32(enabled=True):
    """Within: float32 matmuls and cuDNN convolutions in full float32 (no
    TF32, no reduced-precision passes); the flags found are restored on
    exit. ``enabled=False`` leaves the flags alone (a bf16 model)."""
    if not enabled:
        yield
        return
    legacy = _legacy_flags()
    knobs = _knobs()
    found = [k.fp32_precision for k in knobs]
    if legacy is not None:
        torch.set_float32_matmul_precision('highest')
        torch.backends.cudnn.allow_tf32 = False
    else:
        for k in knobs:
            k.fp32_precision = 'ieee'
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy[0])
            torch.backends.cudnn.allow_tf32 = legacy[1]
        for k, value in zip(knobs, found):
            k.fp32_precision = value
