"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` has a plain C interface and includes no PyTorch
header (only ``csrc/*.cuh`` beside it). It is compiled with ``nvcc`` for
``sm_90a`` into ``_build/lib<source>-<hash>.so`` at first use and its
entry points are loaded with ``ctypes``; a build takes seconds. Nothing
here runs at import: the CPU tests import every module of the port on
machines without ``nvcc``.

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

import torch

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC = osp.join(_PKG, 'csrc')
BUILD_DIR = osp.join(_PKG, '_build')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

# each kernel entry's C symbol and argument types; every pointer and the
# stream are c_void_p, or ctypes would pass them as 32-bit ints
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD = [_P] * 6 + [_I] * 13 + [_P]
_FWD_ABLATE = [_P] * 6 + [_I] * 14 + [_P]  # ... dg, mode, stream
_BWD = [_P] * 9 + [_I] * 14 + [_P]
SIGNATURES = {
    'dcn_fwd': ('dcn_fwd_f32', _FWD),
    'dcn_fwd_bf16': ('dcn_fwd_bf16', _FWD),
    'dcn_fwd_ablate_f32': ('dcn_fwd_ablate_f32', _FWD_ABLATE),
    'dcn_fwd_ablate_bf16': ('dcn_fwd_ablate_bf16', _FWD_ABLATE),
    'dcn_bwd': ('dcn_bwd_f32', _BWD),
    'dcn_bwd_bf16': ('dcn_bwd_bf16', _BWD),
    'row_gather': ('row_gather_f32', [_P] * 3 + [_I] * 3 + [_P]),
    'blend_matmul': ('blend_matmul_f32', [_P] * 5 + [_I] * 4 + [_P]),
    'blend_matmul_bf16': ('blend_matmul_bf16', [_P] * 5 + [_I] * 4 + [_P]),
}
# entries that launch nothing and answer for a source's launches (not in
# LAUNCHES): the tap chunks of a kh x kw backward, which size its grid
QUERIES = {'dcn_bwd_tap_chunks': [_I, _I]}
# the source in csrc/ that defines each entry
SOURCE = {'dcn_fwd': 'dcn_fwd', 'dcn_fwd_bf16': 'dcn_fwd',
          'dcn_fwd_ablate_f32': 'dcn_fwd', 'dcn_fwd_ablate_bf16': 'dcn_fwd',
          'dcn_bwd': 'dcn_bwd', 'dcn_bwd_bf16': 'dcn_bwd',
          'dcn_bwd_tap_chunks': 'dcn_bwd',
          'row_gather': 'row_gather', 'blend_matmul': 'blend_matmul',
          'blend_matmul_bf16': 'blend_matmul'}
SOURCES = sorted(set(SOURCE.values()))

# the variants of the dcn_fwd_ablate_* entries, in the order of
# csrc/dcn_fwd.cu's enum Mode (ops/dcn_ablate.py)
ABLATE_MODES = ('full', 'no_coef', 'int_coef', 'no_gather', 'coords_only',
                'io_only')
# launches of each kernel entry, counted by its wrapper where the kernel
# is launched and nowhere else (an ablation entry once per variant, as
# dcn_fwd_ablate_<mode>_<f32|bf16>); a caller resets them to check that a
# path went through a kernel
LAUNCHES = {name: 0 for name in SIGNATURES
            if not name.startswith('dcn_fwd_ablate_')}
LAUNCHES.update({f'dcn_fwd_ablate_{mode}_{dt}': 0 for dt in ('f32', 'bf16')
                 for mode in ABLATE_MODES})

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
    """The library of source ``name``, keyed by its text and the shared
    headers' (``csrc/*.cuh``)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh'))
    for fname in [f'{name}.cu', *headers]:
        with open(osp.join(CSRC, fname), 'rb') as f:
            h.update(f.read())
    return osp.join(BUILD_DIR, f'lib{name}-{h.hexdigest()[:12]}.so')


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
    """Build the named sources (all of ``SOURCES`` by default), one nvcc
    per source, all started together. Returns {source: nvcc's -Xptxas -v
    output} for the sources built by this call."""
    names = list(SOURCES if names is None else names)
    with _lock:
        started = [(n, *_start_build(n)) for n in names]
        for name, so, tmp, proc in started:
            _finish_build(name, so, tmp, proc)
    return {n: _ptxas_logs.get(n, '(already built)') for n in names}


def load(name: str):
    """The bound C entry point of kernel entry or query ``name``, building
    its source if needed."""
    fn = _libs.get(name)
    if fn is not None:
        return fn
    symbol, argtypes = SIGNATURES.get(name) or (name, QUERIES[name])
    build_all([SOURCE[name]])
    fn = getattr(ctypes.CDLL(_so_path(SOURCE[name])), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _libs[name] = fn
    return fn


# the current cudaStream_t of a device index, read without building a
# torch.cuda.Stream (PyTorch's private binding; the public form where a
# release no longer has it)
raw_stream = getattr(torch._C, '_cuda_getCurrentRawStream', None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def launch(fn, device, *args) -> int:
    """Call the bound entry ``fn(*args, stream)`` on ``device``'s current
    stream, with ``device`` the current device while it launches; returns
    its error code. The device is switched only when it is not current
    already: this is the whole host path of a small launch."""
    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        return fn(*args, raw_stream(current))
    with torch.cuda.device(index):
        return fn(*args, raw_stream(index))


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t '
                           f'{err}')
