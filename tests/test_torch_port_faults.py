"""The port's repairs of its two faults against the reference: float32 is
held as float32 whatever the process's TF32 and matmul-precision flags are
(utils/precision.py, and the ball queries' pairwise distances), and the
box-coder error names the ROADMAP item that ports the coders still
missing."""

import math

import numpy as np
import pytest
import torch

from lidardetection_tpu_torch.core.box_coders import build_box_coder
from lidardetection_tpu_torch.ops.pointnet2 import _pairwise_d2
from lidardetection_tpu_torch.utils.precision import full_f32

_KNOBS = (torch.backends.cuda.matmul, torch.backends.cudnn.conv,
          torch.backends.mkldnn.matmul)


def _legacy():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def flags():
    """Puts back the process's precision flags after the test."""
    legacy = _legacy()
    knobs = [k.fp32_precision for k in _KNOBS]
    yield
    torch.set_float32_matmul_precision(legacy[0])
    torch.backends.cudnn.allow_tf32 = legacy[2]
    for k, value in zip(_KNOBS, knobs):
        k.fp32_precision = value


@pytest.mark.parametrize('precision', ['high', 'medium'])
def test_scope_restores_the_legacy_flags(flags, precision):
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision(precision)
    found = _legacy()
    knobs = [k.fp32_precision for k in _KNOBS]
    with full_f32():
        assert _legacy() == ('highest', False, False)
    assert _legacy() == found
    assert [k.fp32_precision for k in _KNOBS] == knobs
    with full_f32(enabled=False):
        assert _legacy() == found


def test_scope_restores_the_per_backend_knobs(flags):
    """Knobs set so that the legacy getters raise: the scope sets the knobs
    alone and puts them back."""
    torch.backends.cuda.matmul.fp32_precision = 'tf32'
    torch.backends.mkldnn.matmul.fp32_precision = 'bf16'
    torch.backends.cudnn.conv.fp32_precision = 'tf32'
    with pytest.raises(RuntimeError):
        torch.get_float32_matmul_precision()
    with full_f32():
        assert [k.fp32_precision for k in _KNOBS] == ['ieee'] * 3
    assert [k.fp32_precision for k in _KNOBS] == ['tf32', 'tf32', 'bf16']


def test_pairwise_d2_is_full_f32_under_medium_precision(flags):
    """The cross term is one float32 product, as the JAX package's with
    Precision.HIGHEST: 'medium' (bf16 passes in oneDNN on the CPU, TF32 on
    the card) must not move it."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.uniform(-70, 70, (2, 256, 3)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-70, 70, (2, 3000, 3)).astype(np.float32))
    torch.set_float32_matmul_precision('highest')
    want = _pairwise_d2(a, b)
    torch.set_float32_matmul_precision('medium')
    got = _pairwise_d2(a, b)
    assert torch.get_float32_matmul_precision() == 'medium'
    assert torch.equal(got, want)


def test_box_coder_error_names_the_point_coder_items():
    """Every coder of the JAX package's registry builds, the two legacy
    decoders among them (decode only: the heading of the RoI one is ``ra
    - rt``); an unknown name raises KeyError, as the JAX package's."""
    assert build_box_coder('PointResidualCoder').code_size == 8
    anchors = torch.tensor([[1.0, 2.0, 0.5, 4.0, 2.0, 1.5, 0.3]])
    codes = torch.tensor([[0.0, 0.0, 0.0, 0.1, 0.2, 0.0, 0.25]])
    headings = []
    for name in ('PreviousResidualDecoder', 'PreviousResidualRoIDecoder'):
        boxes = build_box_coder(name).decode(codes, anchors)
        # size residuals in (w, l, h) order: dx from the second, dy the first
        assert torch.allclose(boxes[0, 3:5], torch.tensor(
            [4.0 * math.exp(0.2), 2.0 * math.exp(0.1)]))
        headings.append(float(boxes[0, 6]))
    assert headings == pytest.approx([0.55, 0.05])
    with pytest.raises(KeyError):
        build_box_coder('NoSuchCoder')
