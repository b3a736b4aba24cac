"""Builds the CUDA sources in ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for sm_90a into ``build/lib<name>-<hash>.so`` at the repository root, then
loaded with ``ctypes``. The hash covers the source, every shared header
``csrc/*.cuh`` (which any source may include) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. A build
writes to a temporary name and renames it, so concurrent processes cannot
load a half-written library.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
KERNELS = ('vfe', 'scatter', 'sparse_conv', 'sparse_conv_dw', 'ball_select')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_loaded = {}  # name -> ctypes.CDLL, one per process


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found: set CUDA_HOME to build '
                           'the kernels under csrc/')
    return str(Path(CUDA_HOME) / 'bin' / 'nvcc')


def _library_path(name):
    digest = hashlib.sha1((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:12]}.so'


def build(names=KERNELS):
    """Compile every named source not built yet, all ``nvcc`` runs at once.

    Returns {name: compiler messages} (register and shared-memory use, from
    ``-Xptxas=-v``) for the sources built by this call; raises on failure.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    messages, failed = {}, []
    for name, out, tmp, proc in jobs:
        messages[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f'{name}.cu:\n{messages[name]}')
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return messages


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _loaded:
        build((name,))
        _loaded[name] = ctypes.CDLL(str(_library_path(name)))
    return _loaded[name]
