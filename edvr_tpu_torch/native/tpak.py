"""The tpak packed-frame reader and writer, host C++ (``csrc/tpak.cpp``)
bound with ``ctypes``, the counterpart of ``edvr_tpu/native/__init__.py``'s
``TpakReader`` and ``write_tpak``; the file format is the same byte for
byte.

``csrc/tpak.cpp`` is compiled with ``g++`` at first use into
``_build/libtpak-<hash>.so``, keyed by the source's text. A build that
fails raises with the compiler's output: nothing falls back to PNG.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import struct
import subprocess
import threading

import numpy as np

from edvr_tpu_torch.native import BUILD_DIR, CSRC

_SRC = osp.join(CSRC, 'tpak.cpp')
GXX_FLAGS = ['-O3', '-shared', '-fPIC', '-pthread', '-std=c++17']
MAGIC = b'TPAK0001'

_lib = None
_lock = threading.Lock()


def so_path() -> str:
    with open(_SRC, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return osp.join(BUILD_DIR, f'libtpak-{digest}.so')


def build() -> str:
    """Compile ``csrc/tpak.cpp`` unless its library is built; returns the
    library's path."""
    so = so_path()
    if osp.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    proc = subprocess.run(['g++', *GXX_FLAGS, _SRC, '-o', tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed to build tpak.cpp (exit '
                           f'{proc.returncode}):\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    return so


def get_lib():
    """The bound library, building it if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        i64p = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
        for name, res, args in (
                ('tpak_open', vp, [ctypes.c_char_p]),
                ('tpak_close', None, [vp]),
                ('tpak_num_clips', i64, [vp]),
                ('tpak_clip_frames', i64, [vp, i64]),
                ('tpak_clip_shape', None, [vp, i64] + [ctypes.POINTER(i64)]
                 * 3),
                ('tpak_clip_name', ctypes.c_int,
                 [vp, i64, ctypes.c_char_p, i64]),
                ('tpak_read_windows', ctypes.c_int,
                 [vp] + [i64p] * 5 + [i64] * 4 + [
                     np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
                     ctypes.c_int])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


class TpakReader:
    """An mmap-backed packed-frame file: its clips' names, frame counts and
    (h, w, c) shapes, and batched temporal-window crops. A copy made by
    pickling (a loader worker's dataset) opens the file again."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lib = get_lib()
        self._handle = self._lib.tpak_open(self.path.encode())
        if not self._handle:
            raise IOError(f'cannot open tpak file: {self.path}')
        self.num_clips = int(self._lib.tpak_num_clips(self._handle))
        self.clip_names, self.clip_frames, self.clip_shapes = [], [], []
        buf = ctypes.create_string_buffer(512)
        for i in range(self.num_clips):
            self._lib.tpak_clip_name(self._handle, i, buf, 512)
            self.clip_names.append(buf.value.decode())
            self.clip_frames.append(
                int(self._lib.tpak_clip_frames(self._handle, i)))
            h, w, c = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
            self._lib.tpak_clip_shape(self._handle, i, ctypes.byref(h),
                                      ctypes.byref(w), ctypes.byref(c))
            self.clip_shapes.append((h.value, w.value, c.value))
        self.name_to_idx = {n: i for i, n in enumerate(self.clip_names)}

    def __getstate__(self):
        return {'path': self.path}

    def __setstate__(self, state):
        self.__init__(state['path'])

    def read_windows(self, clip_idx, start_frame, interval, y0, x0,
                     crop_h: int, crop_w: int, num_frames: int,
                     n_threads: int = 8) -> np.ndarray:
        """(B, T, crop_h, crop_w, C) uint8 temporal-window crops, copied by
        the library's threads. Frame indices are clamped to the clip
        (replicate padding); a crop outside the frame raises."""
        clip_idx, start_frame, interval, y0, x0 = (
            np.ascontiguousarray(a, np.int64)
            for a in (clip_idx, start_frame, interval, y0, x0))
        batch = clip_idx.shape[0]
        c = self.clip_shapes[int(clip_idx[0])][2]
        out = np.empty((batch, num_frames, crop_h, crop_w, c), np.uint8)
        status = self._lib.tpak_read_windows(
            self._handle, clip_idx, start_frame, interval, y0, x0, crop_h,
            crop_w, num_frames, batch, out, n_threads)
        if status != 0:
            raise ValueError(f'tpak_read_windows failed: {status}')
        return out

    def close(self):
        if getattr(self, '_handle', None):
            self._lib.tpak_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown
            pass


def write_tpak(path: str, clips) -> None:
    """Write a tpak file from ``clips``, (name, frames) pairs where frames
    is a (t, h, w, c) uint8 array or a callable returning one (called
    twice: once for the header's shapes, once for the data, so that only
    one clip is in memory at a time)."""
    clips = list(clips)
    header = len(MAGIC) + 8 + sum(4 + len(name.encode()) + 8 + 4 * 3 + 8
                                  for name, _ in clips)
    with open(path, 'wb') as f:
        f.write(MAGIC)
        f.write(struct.pack('<Q', len(clips)))
        cursor = header
        for name, frames in clips:
            arr = frames() if callable(frames) else frames
            t, h, w, c = arr.shape
            name_b = name.encode()
            f.write(struct.pack('<I', len(name_b)))
            f.write(name_b)
            f.write(struct.pack('<QIIIQ', t, h, w, c, cursor))
            cursor += t * h * w * c
        for _, frames in clips:
            arr = frames() if callable(frames) else frames
            f.write(np.ascontiguousarray(arr, np.uint8).tobytes())
