"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries land in ``build/kernels/`` at the root of
the checkout, named by a hash of the source and of the headers beside
it, so an edited source or header rebuilds and concurrent processes never
load a half-written file; ``ptxas``'s
report of each kernel's registers, spills and shared memory lands beside
the library (:func:`ptxas_log`). Nothing here runs at import: the first
wrapper call on a CUDA tensor builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
        return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'kfac_pytorch_tpu_torch/csrc on a machine with the '
                       'CUDA toolkit')


def _lib_path(source):
    """The library of ``source``, named by a hash of the source, of every
    header beside it (``*.cuh``, which any source may include) and of the
    target flags."""
    digest = hashlib.sha1(' '.join(ARCH_FLAGS).encode())
    here = os.path.dirname(source)
    headers = sorted(n for n in os.listdir(here) if n.endswith('.cuh'))
    for path in [source] + [os.path.join(here, n) for n in headers]:
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0'
                          + f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f'lib{stem}-{digest.hexdigest()[:12]}.so')


def build(source):
    """Compile one ``.cu`` file (if its library is not built yet) and
    return the library path."""
    out = _lib_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [nvcc_path(), *ARCH_FLAGS, '-std=c++17', '-O3', '-shared',
           '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-o', tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}) on {source}:\n'
                           f'{proc.stdout}\n{proc.stderr}')
    with open(f'{tmp}.log', 'w') as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(f'{tmp}.log', f'{out}.log')
    os.replace(tmp, out)
    return out


def ptxas_log(name):
    """The path of ``ptxas -v``'s report for ``csrc/<name>.cu``'s built
    library (registers, spills and shared memory of each kernel)."""
    return _lib_path(os.path.join(CSRC, f'{name}.cu')) + '.log'


def load(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(os.path.join(CSRC, f'{name}.cu')))
            _libs[name] = lib
        return lib
