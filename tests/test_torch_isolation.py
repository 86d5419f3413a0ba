"""The port stands alone and never quietly leaves the GPU.

1. Every module of kfac_pytorch_tpu_torch (and chip_smoke.py) imports in
   a process where jax, flax and optax cannot be imported, and no module
   of the JAX package ends up loaded.
2. Entry points asked for no device go to the GPU: without one they
   raise instead of running on the CPU.
3. The capture-kernel wrappers run their plain versions only for CPU
   tensors; any other device launches the kernel or raises.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch import training
from kfac_pytorch_tpu_torch.models import cifar_resnet
from kfac_pytorch_tpu_torch.ops import capture_kernels as ck
import kfac_pytorch_tpu_torch as tkfac

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax_or_the_jax_package():
    code = textwrap.dedent('''
        import importlib, pkgutil, re, sys
        for name in ('jax', 'jaxlib', 'flax', 'optax'):
            sys.modules[name] = None
        import kfac_pytorch_tpu_torch as pkg
        mods = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + '.')]
        for m in mods:
            importlib.import_module(m)
        importlib.import_module('chip_smoke')
        bad = [m for m in sys.modules
               if re.match(r'kfac_pytorch_tpu(?!_torch)', m)]
        assert not bad, bad
        print(len(mods))
    ''')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, 'PYTHONPATH': ROOT})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    model = cifar_resnet._make(1)
    tx = training.sgd(0.1)
    pre = tkfac.KFAC(variant='eigen_dp')
    sample = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        training.init_train_state(model, tx, pre, sample)
    from kfac_pytorch_tpu_torch import train_cifar
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cifar.main(['--model', 'resnet20', '--epochs', '1'])
    # the same calls run when the CPU is asked for
    state = training.init_train_state(model, tx, pre, sample, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pre.init()
    assert state.kfac_state.factors['128'].device.type == 'cpu'


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without one: the wrappers
    must take the kernel path (which fails here) and never the plain
    version."""
    device = torch.device('cuda')
    dtype = torch.float32
    ndim = 4
    shape = (2, 5, 5, 3)

    def is_contiguous(self):
        return True

    def reshape(self, *shape):
        return _FakeCuda2D()


class _FakeCuda2D(_FakeCuda):
    ndim = 2
    shape = (50, 3)


class _UsedPlain(Exception):
    pass


def test_wrappers_never_fall_back(monkeypatch):
    def plain(*a, **k):
        raise _UsedPlain('plain version used for a non-CPU tensor')

    monkeypatch.setattr(ck, '_conv_a_plain', plain)
    monkeypatch.setattr(ck, '_stat_rows_plain', plain)
    calls = [
        lambda x: ck.compute_a_conv(x, (3, 3), (1, 1), (1, 1), False),
        lambda x: ck.compute_g_conv(x, True),
    ]
    for call in calls:
        with pytest.raises(Exception) as info:
            call(_FakeCuda())
        assert not isinstance(info.value, _UsedPlain)
    for call in calls:
        with pytest.raises(RuntimeError, match='no capture kernel'):
            call(torch.zeros((2, 5, 5, 3), device='meta'))
