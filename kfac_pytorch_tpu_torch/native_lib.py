"""ctypes bindings of the repo's native host library,
``native/kfac_native.cc`` (port of ``kfac_pytorch_tpu/native_lib.py``).

The port builds its own copy at first use: ``c++ -O2 -shared -fPIC`` into
the port's build directory (``ops._cuda_build.BUILD_DIR``), named by a
hash of the source, so an edited source rebuilds and concurrent processes
never load a half-written file. It never loads or writes the JAX side's
``native/libkfac_native.so``. Every entry point keeps its numpy branch,
as in the JAX package: without a C++ compiler :func:`get_lib` returns
None (the compiler's error is kept in ``build_error`` and warned about
once) and the callers fall back to numpy.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings

import numpy as np

from kfac_pytorch_tpu_torch.ops._cuda_build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'native', 'kfac_native.cc')

_lock = threading.Lock()
_lib = None
_tried = False
#: why the last build failed (None when it did not)
build_error = None


def lib_path():
    """Where the library of the current source is built."""
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f'libkfac_native-{digest}.so')


def _build(out):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    subprocess.run(['c++', '-O2', '-shared', '-fPIC', '-o', tmp, SOURCE],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, out)


def get_lib():
    """The loaded native library (built on first use), or None."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = lib_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError) as e:
            build_error = getattr(e, 'stderr', None) or str(e)
            warnings.warn(f'native library unavailable, numpy fallback: '
                          f'{build_error}', stacklevel=2)
            return None
        lib.block_partition.restype = ctypes.c_double
        lib.block_partition.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.lpt_assign.restype = ctypes.c_double
        lib.lpt_assign.argtypes = lib.block_partition.argtypes
        lib.augment_crop_flip.restype = None
        lib.augment_crop_flip.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def block_partition(costs, num_devices):
    """Owner array of the optimal contiguous partition of ``costs``."""
    lib = get_lib()
    costs = np.ascontiguousarray(costs, np.float64)
    owners = np.zeros(len(costs), np.int64)
    if lib is None:
        from kfac_pytorch_tpu_torch.parallel import partition
        return partition.block_partition(costs, num_devices)
    lib.block_partition(_ptr(costs, ctypes.c_double), len(costs),
                        num_devices, _ptr(owners, ctypes.c_int64))
    return owners


def lpt_assign(costs, num_devices):
    """Owner array of the greedy longest-processing-time assignment."""
    lib = get_lib()
    costs = np.ascontiguousarray(costs, np.float64)
    owners = np.zeros(len(costs), np.int64)
    if lib is None:
        from kfac_pytorch_tpu_torch.parallel import partition
        return partition.balanced_assign(costs, num_devices)
    lib.lpt_assign(_ptr(costs, ctypes.c_double), len(costs), num_devices,
                   _ptr(owners, ctypes.c_int64))
    return owners


def augment_crop_flip(x, offs, flips, pad=4):
    """Native batched reflect-pad crop and flip of ``x`` ``[N, H, W, C]``
    float32 (``offs`` ``[N, 2]`` int32 crop offsets, ``flips`` ``[N]``
    uint8), or None without the library. Counts its calls in
    ``augment_crop_flip.calls``."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    offs = np.ascontiguousarray(offs, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    out = np.empty_like(x)
    n, h, w, c = x.shape
    lib.augment_crop_flip(_ptr(x, ctypes.c_float), n, h, w, c, pad,
                          _ptr(offs, ctypes.c_int32),
                          _ptr(flips, ctypes.c_uint8),
                          _ptr(out, ctypes.c_float))
    augment_crop_flip.calls += 1
    return out


augment_crop_flip.calls = 0
