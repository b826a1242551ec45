"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header. It is compiled with ``nvcc`` for ``sm_90a`` into
``_build/lib<name>.so`` at first use and loaded with ``ctypes``; a build
takes seconds. Nothing here runs at import: the CPU tests import every
module of the port on machines without ``nvcc``.

A build that fails raises with nvcc's output. There is no fallback: a CUDA
tensor either reaches its kernel or the call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC = osp.join(_PKG, 'csrc')
BUILD_DIR = osp.join(_PKG, '_build')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

# the argument types of each kernel's C entry point; every pointer and the
# stream are c_void_p, or ctypes would pass them as 32-bit ints
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    'dcn_fwd': ('dcn_fwd_f32', [_P] * 6 + [_I] * 13 + [_P]),
    'dcn_bwd': ('dcn_bwd_f32', [_P] * 9 + [_I] * 14 + [_P]),
    'row_gather': ('row_gather_f32', [_P] * 4 + [_I] * 3 + [_P]),
    'blend_matmul': ('blend_matmul_f32', [_P] * 5 + [_I] * 4 + [_P]),
}

# launches of each kernel, counted by its wrapper where the kernel is
# launched and nowhere else; a caller resets them to check that a path
# went through a kernel
LAUNCHES = {name: 0 for name in SIGNATURES}

_libs: dict = {}
_ptxas_logs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = osp.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin',
                    'nvcc')
    if osp.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                       'to build the CUDA kernels')


def _so_path(name: str) -> str:
    with open(osp.join(CSRC, f'{name}.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return osp.join(BUILD_DIR, f'lib{name}-{digest}.so')


def _start_build(name: str):
    """Start nvcc for one source; returns (so_path, tmp_path, Popen), the
    last two None when the library is already built."""
    so = _so_path(name)
    if osp.exists(so):
        return so, None, None
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, osp.join(CSRC, f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, tmp, proc


def _finish_build(name: str, so: str, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed to build {name}.cu '
                           f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    _ptxas_logs[name] = log


def build_all(names=None) -> dict:
    """Build the named kernels (all by default), one nvcc per source, all
    started together. Returns {name: nvcc's -Xptxas -v output} for the
    sources built by this call."""
    names = list(SIGNATURES if names is None else names)
    with _lock:
        started = [(n, *_start_build(n)) for n in names]
        for name, so, tmp, proc in started:
            _finish_build(name, so, tmp, proc)
    return {n: _ptxas_logs.get(n, '(already built)') for n in names}


def load(name: str):
    """The bound C entry point of kernel ``name``, building it if needed."""
    fn = _libs.get(name)
    if fn is not None:
        return fn
    build_all([name])
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(ctypes.CDLL(_so_path(name)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _libs[name] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t '
                           f'{err}')
