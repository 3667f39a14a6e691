"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. It is compiled with
nvcc for sm_90a into a shared library under ``build/haphic_tpu_torch/``
at the repo root, at first use, and loaded with ctypes. The library's
file name carries a hash of its source and flags, so an edited source
is never shadowed by a stale build. Every failure raises: there is no
fallback to the plain torch versions on a CUDA tensor.

``build()`` starts one nvcc per source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..',
                                         '..'))
BUILD_DIR = os.path.join(REPO_ROOT, 'build', 'haphic_tpu_torch')
SOURCES = ('score_population', 'delta_generation', 'sparse_column',
           'mcl_column', 'col_allclose', 'rescore_population',
           'mcl_interpret', 'ell_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v']

# nvcc output (ptxas register / shared-memory report) of the builds in
# this process, by source name
BUILD_LOG: Dict[str, str] = {}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> Optional[str]:
    """The nvcc binary: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    for base in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if base:
            p = os.path.join(base, 'bin', 'nvcc')
            if os.path.exists(p):
                return p
    return shutil.which('nvcc')


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + '.cu'), 'rb') as f:
        h = hashlib.sha256(f.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, 'lib{}-{}.so'.format(
        name, h.hexdigest()[:12]))


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library of ``names`` (one nvcc process per
    source, started together); returns name -> library path."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA '
                           'kernels cannot be built')
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = '{}.{}.tmp'.format(paths[n], os.getpid())
        cmd = [nvcc] + NVCC_FLAGS + ['-o', tmp,
                                     os.path.join(CSRC, n + '.cu')]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            failed.append('{}: nvcc exit {}\n{}'.format(
                n, proc.returncode, out))
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _loaded[name] = lib
    return lib
