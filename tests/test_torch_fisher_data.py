"""The port's CIFAR data path against the JAX package: the augmentation
(the native library, compiled here with the system ``c++``, and the
numpy branch), the CIFAR-10 pickle reader and the prefetching loader give
JAX's bits, and the CIFAR trainer reads ``--dir``. (The F1mc Fisher and
its sampler: ``tests/test_torch_f1mc.py``.)
"""

import os
import pickle
import tarfile
import threading

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import data as jdata
from kfac_pytorch_tpu_torch import data as tdata
from kfac_pytorch_tpu_torch import native_lib

torch.set_num_threads(2)


def test_augment_matches_jax():
    """The native library builds with the system compiler into the port's
    build directory; native and numpy crops give JAX's bits."""
    lib = native_lib.get_lib()
    assert lib is not None, native_lib.build_error
    assert os.path.exists(native_lib.lib_path())
    assert os.path.dirname(native_lib.lib_path()) != os.path.dirname(
        native_lib.SOURCE)
    x = np.random.RandomState(0).rand(16, 32, 32, 3).astype(np.float32)
    want = jdata.augment_cifar(np.random.RandomState(5), x)
    calls = native_lib.augment_crop_flip.calls
    native = tdata.augment_cifar(np.random.RandomState(5), x)
    assert native_lib.augment_crop_flip.calls == calls + 1
    np.testing.assert_array_equal(native, want)
    r = np.random.RandomState(5)
    offs = r.randint(0, 9, size=(16, 2)).astype(np.int32)
    flips = r.rand(16) < 0.5
    np.testing.assert_array_equal(tdata.crop_flip(x, offs, flips), want)
    costs = np.random.RandomState(1).rand(13)
    from kfac_pytorch_tpu_torch.parallel import partition
    np.testing.assert_array_equal(native_lib.lpt_assign(costs, 3),
                                  partition.balanced_assign(costs, 3))
    np.testing.assert_array_equal(native_lib.block_partition(costs, 3),
                                  partition.block_partition(costs, 3))


def _write_cifar(root, n=6):
    """A CIFAR-10 ``cifar-10-batches-py`` directory with ``n`` images a
    batch, in the archive's pickle format."""
    base = os.path.join(root, 'cifar-10-batches-py')
    os.makedirs(base)
    r = np.random.RandomState(3)
    for name in [f'data_batch_{i}' for i in range(1, 6)] + ['test_batch']:
        d = {b'data': r.randint(0, 256, (n, 3072)).astype(np.uint8),
             b'labels': [int(v) for v in r.randint(0, 10, n)]}
        with open(os.path.join(base, name), 'wb') as f:
            pickle.dump(d, f)
    return base


@pytest.fixture
def cifar_dirs(tmp_path):
    """``(pickles dir, archive-only dir)`` of the same data."""
    plain = tmp_path / 'plain'
    base = _write_cifar(str(plain))
    packed = tmp_path / 'packed'
    packed.mkdir()
    with tarfile.open(packed / 'cifar-10-python.tar.gz', 'w:gz') as tf:
        tf.add(base, arcname='cifar-10-batches-py')
    return str(plain), str(packed)


def test_load_cifar10_and_loader_match_jax(cifar_dirs):
    plain, packed = cifar_dirs
    want = jdata.load_cifar10(plain)
    for d in (plain, packed):
        got = tdata.get_cifar(d)
        for (wx, wy), (gx, gy) in zip(want, got):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    (x, y), _ = want
    jl = jdata.Loader(x, y, 4, train=True, augment=jdata.augment_cifar,
                      seed=42, shard=(0, 1))
    loaders = [tdata.Loader(x, y, 4, train=True, augment=tdata.augment_cifar,
                            seed=42) for _ in range(2)]
    for _ in range(2):   # two epochs: the child seeds agree at any depth
        jb = list(jl.epoch(prefetch_depth=0))
        for loader, depth in zip(loaders, (0, 2)):
            got = list(loader.epoch(prefetch_depth=depth))
            assert len(got) == len(jb) == 7
            for g, w in zip(got, jb):
                np.testing.assert_array_equal(g['input'], w['input'])
                np.testing.assert_array_equal(g['label'], w['label'])


def test_prefetch_close_stops_its_thread():
    def producers():
        return [t for t in threading.enumerate()
                if t.name == 'kfac-prefetch']

    before = len(producers())
    x = np.zeros((64, 32, 32, 3), np.float32)
    it = tdata.Loader(x, np.zeros(64, np.int64), 4).epoch(prefetch_depth=2)
    next(it)
    assert len(producers()) == before + 1
    it.close()
    assert len(producers()) == before
    with pytest.raises(StopIteration):
        next(it)


def test_train_cifar_reads_dir(cifar_dirs, capsys):
    from kfac_pytorch_tpu_torch import train_cifar
    plain, _ = cifar_dirs
    args = ['--device', 'cpu', '--dir', plain, '--model', 'resnet20',
            '--batch-size', '8', '--val-batch-size', '3', '--epochs', '1',
            '--steps-per-epoch', '2', '--kfac-type', 'F1mc']
    tr = train_cifar.Trainer(train_cifar.parse_args(args))
    np.testing.assert_array_equal(tr.train_loader.x,
                                  jdata.load_cifar10(plain)[0][0])
    assert tr.step_fn.health is not None
    train_cifar.main(args)
    assert 'epoch 0: train_loss' in capsys.readouterr().out
